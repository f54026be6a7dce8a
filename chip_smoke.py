#!/usr/bin/env python3
"""
Smoke run of the destripe capsule on an NVIDIA GPU, through the entry
points a user calls, at production plane geometry (1600 x 2000 uint16).

Phases, in order; any failure exits non-zero and prints no result line:

1. device: JAX must report GPU devices (no fallback); prints the card's
   name and power limit as nvidia-smi reports them.
2. codec: rebuilds the native blosc codec from csrc/ (the sources are
   marked newer than the library, so the loader runs ``make -B`` on this
   host) and round-trips a blosc-zstd shuffled chunk through the active
   backend.
3. capsule, single-band: ``run_capsule.run()`` on a synthetic capsule of
   two tiles (one per laser side, per-side flats) x 256 planes, input and
   output blosc-zstd zarr with output chunks (1, 1, 64, 128, 128); checks
   levels 0-2, the NGFF scales, the provenance JSON, and 4 planes per tile
   (dim and bright) against the float64 oracle at >= 60 dB PSNR.
4. capsule, dual-band: one 64-plane tile through
   ``destripe_zarr(parameters={"dual_band": True, ...})`` against the
   float64 dual-band oracle at >= 60 dB PSNR.

The last stdout line is the JSON result
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four-cards`` runs only the multi-card check instead: the plane-sharded
pipeline on 4 cards against 1 card on the same 128 planes (<= 1 LSB, under
1e-3 of pixels differing).

Work files go under ``.smoke_work/`` in the checkout and are removed at the
end. The compile cache follows ``runtime.enable_compile_cache``.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PSNR_GATE_DB = 60.0
H, W = 1600, 2000
PLANES = 256
DUAL_PLANES = 64
FOUR_CARD_PLANES = 128


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def psnr_db(got, want) -> float:
    import numpy as np

    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    mse = float(np.mean(d * d))
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(65535.0**2 / mse))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_codec() -> str:
    """Rebuild the native codec from the tracked sources, then round-trip a
    blosc-zstd shuffled chunk through whichever encoder is active."""
    import numpy as np

    from aind_smartspim_destripe_tpu.io import blosc

    # sources newer than the library: the loader rebuilds it on this host
    src = ROOT / "csrc"
    for f in src.iterdir():
        if f.suffix == ".cpp" or f.name == "Makefile":
            os.utime(f)
    backend = blosc.backend()
    log(f"blosc backend: {backend}")
    if backend == "native":
        check(not blosc._native_stale(str(src / "libdestripe_runtime.so"),
                                      str(src)),
              "the native codec loaded without a rebuild from csrc/")
    check(backend != "none",
          "neither the native codec nor zstandard can encode blosc-zstd")
    chunk = (np.arange(64 * 128 * 128) % 4099).astype(np.uint16)
    frame = blosc.compress(chunk.tobytes(), 2, clevel=3, shuffle=blosc.SHUFFLE,
                           cname="zstd")
    back = np.frombuffer(blosc.decompress(frame), np.uint16)
    check(np.array_equal(back, chunk), "blosc-zstd round trip mismatch")
    return backend


def _sample_planes(z: int):
    """Two dim (even) and two bright (odd) planes spread over the stack."""
    return sorted({0, 1, (z // 2) & ~1, z - 1 if (z - 1) % 2 else z - 2})


def phase_capsule_single(work: Path, seed: int, planes: int = PLANES,
                         h: int = H, w: int = W) -> dict:
    """run_capsule.run() on a synthetic two-tile capsule; verify the store
    and the sampled planes against the float64 oracle."""
    import numpy as np

    from aind_smartspim_destripe_tpu import run_capsule
    from aind_smartspim_destripe_tpu.io.zarr import open_zarr
    from aind_smartspim_destripe_tpu.runtime.device import CompileClock
    from tests.golden import numpy_ref as G
    from tests.test_run_capsule_e2e import (
        CAPSULE_DARK, LASER_TILES, TILES, build_capsule, capsule_flat,
    )

    t0 = time.perf_counter()
    data, results = build_capsule(
        work, h=h, w=w, z=planes, seed=seed, chunks=(1, 1, 64, 128, 128),
        bright_odd=True,
    )
    log(f"single-band: capsule of 2 x {planes} x {h}x{w} written in "
        f"{time.perf_counter() - t0:.1f} s")

    clock = CompileClock()
    t0 = time.perf_counter()
    stats = run_capsule.run(
        data_folder=str(data), results_folder=str(results),
        scratch_folder=str(work / "scratch"),
    )["Ex_488_Em_525"]
    wall = time.perf_counter() - t0
    # per-slab device-loop seconds (H2D + step + D2H); the first slab of
    # each tile carries that tile's compile or cache load
    steady = sorted(
        rec[3] for st in stats.values() for rec in st.slab_records[1:]
    )
    per_slab = steady[len(steady) // 2] if steady else None
    log(f"single-band: run_capsule.run {wall:.1f} s, "
        f"{clock.compiles} XLA compiles, {clock.seconds:.1f} s compiling, "
        f"steady-state {per_slab} s per 64-plane slab (median)")

    params = run_capsule.PRODUCTION_PARAMETERS
    side_of = {t: int(s) for s, ts in LASER_TILES.items() for t in ts}
    dark = np.full((h, w), CAPSULE_DARK, np.float64)
    report = {"wall_s": wall, "compile_s": clock.seconds,
              "compiles": clock.compiles, "slab_s_median": per_slab,
              "psnr_db": {}}
    for tile in TILES:
        tg = open_zarr(
            str(results / "destriped_data" / "Ex_488_Em_525" / f"{tile}.zarr")
        )
        check(set(tg.keys()) == {"0", "1", "2"},
              f"{tile}: pyramid levels {sorted(tg.keys())}")
        lvl0 = tg["0"]
        check(tuple(lvl0.shape) == (1, 1, planes, h, w),
              f"{tile}: level-0 shape {lvl0.shape}")
        check(tuple(lvl0.chunks) == (1, 1, 64, 128, 128),
              f"{tile}: level-0 chunks {lvl0.chunks}")
        for lvl in (1, 2):
            f = 2 ** lvl
            want = (1, 1, planes // f, h // f, w // f)
            check(tuple(tg[str(lvl)].shape) == want,
                  f"{tile}: level {lvl} shape {tg[str(lvl)].shape}")
        ms = tg.attrs["multiscales"][0]
        scales = [d["coordinateTransformations"][0]["scale"]
                  for d in ms["datasets"]]
        check(scales[0] == [1.0, 1.0, 2.0, 1.8, 1.8],
              f"{tile}: NGFF level-0 scale {scales[0]}")
        check(len(scales) == 3, f"{tile}: {len(scales)} NGFF datasets")

        src = open_zarr(str(data / "Ex_488_Em_525" / f"{tile}.zarr"))["0"]
        flat = capsule_flat(h, w, side_of[tile]).astype(np.float64)
        for z in _sample_planes(planes):
            raw = np.asarray(src[0, 0, z]).astype(np.float64)
            want = G.flatfield_correction_ref(
                G.filter_stripes_ref(
                    raw,
                    no_cells_config=params["no_cells_config"],
                    cells_config=params["cells_config"],
                    microscope_high_int=2500.0,
                ),
                flat, dark,
            )
            got = np.asarray(lvl0[0, 0, z])
            p = psnr_db(got, want)
            kind = "bright" if z % 2 else "dim"
            report["psnr_db"][f"{tile}/z{z}/{kind}"] = p
            log(f"single-band: {tile} z={z} ({kind}) PSNR {p:.1f} dB")
            check(p >= PSNR_GATE_DB, f"{tile} z={z}: PSNR {p:.1f} dB < "
                  f"{PSNR_GATE_DB}")

    prov = results / "image_destriping_Ex_488_Em_525_processing.json"
    check(prov.exists(), "provenance JSON missing")
    doc = json.loads(prov.read_text())
    names = [p["name"] for p in doc["processing_pipeline"]["data_processes"]]
    check(names == ["Image destriping", "Image flat-field correction"],
          f"provenance processes {names}")
    return report


def phase_capsule_dual(work: Path, seed: int, planes: int = DUAL_PLANES,
                       h: int = H, w: int = W) -> dict:
    """One tile through destripe_zarr in dual-band mode against the float64
    dual-band oracle (flat-field applied to the blended plane)."""
    import numpy as np

    from aind_smartspim_destripe_tpu import run_capsule, zarr_destriper
    from aind_smartspim_destripe_tpu.io.readers import imread
    from aind_smartspim_destripe_tpu.io.zarr import open_zarr
    from tests.golden import numpy_ref as G
    from tests.test_run_capsule_e2e import CAPSULE_DARK, TILES, build_capsule

    data, results = build_capsule(
        work, h=h, w=w, z=planes, seed=seed + 1,
        chunks=(1, 1, 64, 128, 128), bright_odd=True,
    )
    tile = TILES[0]
    flat_path = data / "estimated_flat_laser_Ex_488_Em_525_0.tif"
    out = results / "destriped_data" / "Ex_488_Em_525" / f"{tile}.zarr"
    params = dict(run_capsule.PRODUCTION_PARAMETERS)
    params.update(dual_band=True, crossover=100.0, dual_threshold=-1.0)
    t0 = time.perf_counter()
    zarr_destriper.destripe_zarr(
        dataset_path=data / "Ex_488_Em_525" / f"{tile}.zarr",
        multiscale="0",
        output_destriped_zarr=out,
        prediction_chunksize=(64, h, w),
        target_size_mb=3072,
        n_workers=0,
        batch_size=1,
        super_chunksize=(384, h, w),
        results_folder=results,
        derivatives_path=data / "derivatives",
        xyz_resolution=(1.8, 1.8, 2.0),
        parameters=params,
        flatfield=imread(str(flat_path)),
    )
    wall = time.perf_counter() - t0
    log(f"dual-band: destripe_zarr {wall:.1f} s")

    lvl0 = open_zarr(str(out))["0"]
    src = open_zarr(str(data / "Ex_488_Em_525" / f"{tile}.zarr"))["0"]
    flat = np.asarray(imread(str(flat_path)), np.float64)
    dark = np.full((h, w), CAPSULE_DARK, np.float64)
    report = {"wall_s": wall, "psnr_db": {}}
    for z in _sample_planes(planes):
        raw = np.asarray(src[0, 0, z]).astype(np.float64)
        blended = G.dual_band_ref(
            raw, params["cells_config"], params["no_cells_config"],
            crossover=100.0,
        )
        want = G.flatfield_correction_ref(blended, flat, dark)
        p = psnr_db(np.asarray(lvl0[0, 0, z]), want)
        kind = "bright" if z % 2 else "dim"
        report["psnr_db"][f"z{z}/{kind}"] = p
        log(f"dual-band: z={z} ({kind}) PSNR {p:.1f} dB")
        check(p >= PSNR_GATE_DB, f"dual z={z}: PSNR {p:.1f} dB < "
              f"{PSNR_GATE_DB}")
    return report


def four_card_inputs(seed: int, planes: int = FOUR_CARD_PLANES, h: int = H,
                     w: int = W):
    """Striped planes alternating dim and bright, flat/dark fields and the
    production plan: the input of the multi-card checks."""
    import numpy as np

    from aind_smartspim_destripe_tpu.ops.filter import (
        FilterConfig, build_plan,
    )
    from aind_smartspim_destripe_tpu.run_capsule import PRODUCTION_PARAMETERS

    rng = np.random.default_rng(seed)
    level = np.where(np.arange(planes) % 2, 3200.0, 280.0)[:, None, None]
    vol = np.clip(
        level.astype(np.float32)
        + rng.standard_normal((planes, h, 1), dtype=np.float32) * 50
        + rng.standard_normal((planes, h, w), dtype=np.float32) * 8,
        0, 65535,
    ).astype(np.uint16)
    flat = np.full((h, w), 1.25, np.float32)
    dark = np.full((h, w), 3.0, np.float32)
    plan = build_plan(
        h, w,
        FilterConfig.from_dict(PRODUCTION_PARAMETERS["cells_config"]),
        FilterConfig.from_dict(PRODUCTION_PARAMETERS["no_cells_config"]),
    )
    return vol, flat, dark, plan


def run_pipeline(inputs, devs):
    """The streaming pipeline over ``devs``: (output, seconds, stats)."""
    import numpy as np

    from aind_smartspim_destripe_tpu.runtime.pipeline import (
        StreamingDestriper,
    )

    vol, flat, dark, plan = inputs
    out = np.zeros_like(vol)
    t0 = time.perf_counter()
    stats = StreamingDestriper(
        vol, out, plan, flatfield=flat, darkfield=dark, slab=64,
        device_batch=64, journal=False, devices=devs,
    ).run()
    return out, time.perf_counter() - t0, stats


def diff_stats(got, want) -> dict:
    import numpy as np

    d = got.astype(np.int32) - want.astype(np.int32)
    return {"max_lsb": int(np.abs(d).max()),
            "frac_differ": float((d != 0).mean()),
            "frac_over_1lsb": float((np.abs(d) > 1).mean()),
            "psnr_db": psnr_db(got, want)}


def phase_four_cards(seed: int, devices, planes: int = FOUR_CARD_PLANES,
                     h: int = H, w: int = W) -> dict:
    """Plane-sharded pipeline on every given device against one device on
    the same planes (<= 1 LSB, under 1e-3 of pixels differing)."""
    inputs = four_card_inputs(seed, planes, h, w)
    one, t1, _ = run_pipeline(inputs, devices[:1])
    log(f"1 card: {t1:.1f} s")
    many, tn, _ = run_pipeline(inputs, devices)
    log(f"{len(devices)} cards (plane-sharded): {tn:.1f} s")
    rep = diff_stats(many, one)
    log(f"plane-sharded vs 1 card: {rep}")
    check(rep["max_lsb"] <= 1 and rep["frac_differ"] < 1e-3,
          f"plane-sharded vs 1 card: {rep}")
    return {"planes": planes, "one_card_s": t1, "plane_sharded_s": tn,
            "plane_sharded": rep}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def result_line(devices) -> str:
    """The one JSON object printed as the last stdout line of a passing run."""
    from aind_smartspim_destripe_tpu.runtime.device import device_record

    return json.dumps({"ok": True, "device": device_record(devices)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card plane-sharded check")
    args = ap.parse_args(argv)

    if not (ROOT / "aind_smartspim_destripe_tpu").is_dir():
        print("chip_smoke: FAIL: run from a checkout of the repository "
              "(package aind_smartspim_destripe_tpu not found beside this "
              "script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from aind_smartspim_destripe_tpu.runtime import enable_compile_cache

    cache = enable_compile_cache()

    from aind_smartspim_destripe_tpu.runtime.device import (
        card_info, require_gpu,
    )

    try:
        devices = require_gpu()
    except SystemExit as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: FAIL: {len(devices)} GPU(s), need {want}",
              file=sys.stderr)
        return 1
    devices = devices[:want]
    card = card_info()
    log(f"card: {card}")
    log(f"jax {__import__('jax').__version__}, {len(devices)} x "
        f"{devices[0].device_kind}, compile cache {cache}")
    found = []
    for mod in ("zstandard", "psutil", "matplotlib", "PIL", "imageio"):
        try:
            __import__(mod)
            found.append(mod)
        except ImportError:
            pass
    log(f"optional packages found: {found or 'none'}")

    work = ROOT / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    report = {"card": card}
    try:
        if args.four_cards:
            report["four_cards"] = phase_four_cards(args.seed, devices)
        else:
            report["codec"] = phase_codec()
            report["single_band"] = phase_capsule_single(
                work / "single", args.seed
            )
            stats = devices[0].memory_stats() or {}
            report["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
            log(f"peak_bytes_in_use {report['peak_bytes_in_use']}")
            report["dual_band"] = phase_capsule_dual(work / "dual", args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "chip_smoke_four_cards.json" if args.four_cards else "chip_smoke.json"
    (out_dir / name).write_text(json.dumps(report, indent=1, default=str))
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
