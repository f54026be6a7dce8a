"""
Device-step profile of the destripe graph on the GPU at production geometry
(B planes of 1600 x 2000 uint16, the capsule's filter configs, flat-field
epilogue): compile seconds, steady-state step time, peak device memory, the
matmul-precision comparison, and the device time of each filter stage from
one jax.profiler trace.

Modes (one JSON file per mode under --out, a summary on stdout):

  precision  for each of Precision.HIGH, DotAlgorithmPreset.BF16_BF16_F32_X3
             and Precision.HIGHEST: what the operator matmuls lower to
             (gemm lines of the compiled HLO), compile seconds, step time,
             and per-plane PSNR against the float64 oracle
             (tests/golden/numpy_ref.py) on two dim and two bright planes
             and an intensity sweep (100 .. 45000 counts).
  trace      single-band (+flat) and dual-band (+flat) steps at the
             configured wavelets.MATMUL_PRECISION: a short traced window,
             reduced to device ms per stage (the jax.named_scope names of
             ops/filter.py and ops/dual_band.py) and the device idle share.
             XLA's CUDA-graph command buffers are turned off for this mode
             so that each kernel names its HLO instruction.

Usage: python benchmarks/step_profile.py {precision,trace} [--batch 64]
       [--iters 10] [--out chiprun_out/step_profile]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H, W = 1600, 2000
CELLS = {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3}
NO_CELLS = {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12}
SAMPLE = (0, 1, 2, 3)  # even = dim (no-cells branch), odd = bright (cells)
# precision mode also replaces planes 4.. with an intensity sweep: the
# absolute error of a matmul precision grows with the signal, so the
# brightest planes bind the PSNR gate
SWEEP_LEVELS = (100.0, 1000.0, 8000.0, 45000.0)

# stage name <- the jax.named_scope path of an HLO instruction's op_name
_STAGES = [
    (re.compile(r"/blend/"), "blend"),
    (re.compile(r"/filter_l\d+/otsu/"), "otsu"),
    (re.compile(r"/filter_l\d+/median/"), "median"),
    (re.compile(r"/filter_l\d+/notch/"), "notch"),
    (re.compile(r"/filter_l(\d+)/"), "filter_other_l{}"),
    (re.compile(r"/analysis_l(\d+)/"), "analysis_l{}"),
    (re.compile(r"/synthesis_l(\d+)/"), "synthesis_l{}"),
    (re.compile(r"/classify/"), "classify"),
    (re.compile(r"/log1p/"), "log1p"),
    (re.compile(r"/epilogue/"), "epilogue"),
]


def stage_of(op_name: str) -> str:
    for pat, name in _STAGES:
        m = pat.search(op_name + "/")
        if m:
            return name.format(*m.groups())
    return "other"


def planes(b: int, seed: int = 0, h: int = H, w: int = W) -> np.ndarray:
    """Striped uint16 planes alternating dim (~300) and bright (~3200)."""
    rng = np.random.default_rng(seed)
    level = np.where(np.arange(b) % 2, 3200.0, 300.0)[:, None, None]
    return np.clip(
        level.astype(np.float32)
        + rng.standard_normal((b, h, 1), dtype=np.float32) * 60
        + rng.standard_normal((b, h, w), dtype=np.float32) * 10,
        0, 65535,
    ).astype(np.uint16)


def make_step(plan, dual: bool):
    """The device step of runtime.pipeline.make_device_step (destripe or
    dual-band blend, then the flat-field epilogue) as one jitted function
    of (images, flat, dark, consts)."""
    import jax

    from aind_smartspim_destripe_tpu.ops.dual_band import (
        dual_band_destripe_batch,
    )
    from aind_smartspim_destripe_tpu.ops.filter import destripe_batch
    from aind_smartspim_destripe_tpu.ops.flatfield import flatfield_correction

    @jax.jit
    def step(images, flat, dark, consts):
        if dual:
            blended = dual_band_destripe_batch(
                plan, images, 100.0, -1.0, consts=consts
            )
            return flatfield_correction(blended, flat, dark)
        return destripe_batch(
            plan, images, 2500.0, consts, flat=flat, dark=dark
        )

    return step


def gemm_lines(hlo_text: str) -> dict:
    """How the operator matmuls lowered: counts of gemm custom-call
    targets, fusion kinds and algorithm/precision attributes."""
    out: dict = {}
    for line in hlo_text.splitlines():
        if "custom_call_target=" in line:
            tgt = re.search(r'custom_call_target="([^"]+)"', line).group(1)
            if "gemm" in tgt.lower() or "matmul" in tgt.lower():
                out[f"custom_call:{tgt}"] = out.get(f"custom_call:{tgt}", 0) + 1
        for key in re.findall(
            r'"(?:algorithm|operand_precision)":(\[[^\]]*\]|"[^"]*")', line
        ):
            out[f"attr:{key}"] = out.get(f"attr:{key}", 0) + 1
        m = re.search(r'"kind":"(__triton_gemm|__cublas[^"]*)"', line)
        if m:
            out[f"fusion_kind:{m.group(1)}"] = (
                out.get(f"fusion_kind:{m.group(1)}", 0) + 1
            )
        if " dot(" in line:
            alg = re.search(r"algorithm=(\w+)", line)
            prec = re.search(r"operand_precision=\{([^}]*)\}", line)
            k = f"dot:{alg.group(1) if alg else ''}:{prec.group(1) if prec else ''}"
            out[k] = out.get(k, 0) + 1
    return out


def sweep_planes(seed: int = 7, h: int = H, w: int = W) -> np.ndarray:
    """One striped plane per SWEEP_LEVELS intensity (2 % pixel noise)."""
    rng = np.random.default_rng(seed)
    out = []
    for level in SWEEP_LEVELS:
        img = (
            level
            + rng.standard_normal((h, 1), dtype=np.float32) * 120
            + rng.standard_normal((h, w), dtype=np.float32)
            * max(2.0, level * 0.02)
        )
        out.append(np.clip(img, 0, 65535))
    return np.stack(out).astype(np.uint16)


def oracle_psnr(out_u16: np.ndarray, base: np.ndarray, flat, dark,
                sample=SAMPLE) -> dict:
    from tests.golden import numpy_ref as G

    res = {}
    for i in sample:
        want = G.flatfield_correction_ref(
            G.filter_stripes_ref(
                base[i].astype(np.float64), no_cells_config=NO_CELLS,
                cells_config=CELLS, microscope_high_int=2500.0,
            ),
            flat.astype(np.float64), dark.astype(np.float64),
        )
        d = out_u16[i].astype(np.float64) - want
        mse = float(np.mean(d * d))
        kind = "bright" if i % 2 else "dim"
        if i >= len(SAMPLE):
            kind = f"level{SWEEP_LEVELS[i - len(SAMPLE)]:.0f}"
        res[f"z{i}/{kind}"] = (
            float("inf") if mse == 0 else 10 * np.log10(65535.0**2 / mse)
        )
    return res


def _setup(batch: int, sweep: bool = False):
    import jax

    from aind_smartspim_destripe_tpu.ops.filter import FilterConfig, build_plan

    plan = build_plan(
        H, W, FilterConfig.from_dict(CELLS), FilterConfig.from_dict(NO_CELLS)
    )
    base = planes(batch, h=H, w=W)
    if sweep:
        n = len(SAMPLE)
        base[n:n + len(SWEEP_LEVELS)] = sweep_planes(h=H, w=W)
    flat = (1.0 + 0.3 * np.hanning(W)[None, :] * np.ones((H, 1))).astype(
        np.float32
    )
    dark = np.full((H, W), 4.0, np.float32)
    dev = jax.devices()[0]
    args = (
        jax.device_put(base, dev), jax.device_put(flat, dev),
        jax.device_put(dark, dev), jax.device_put(plan.constants(), dev),
    )
    return plan, base, flat, dark, args


def _time(compiled, args, iters: int) -> list:
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        compiled(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return ts


def run_precision(batch: int, iters: int) -> dict:
    import jax

    from aind_smartspim_destripe_tpu.ops import wavelets

    plan, base, flat, dark, args = _setup(batch, sweep=True)
    sample = tuple(range(len(SAMPLE) + len(SWEEP_LEVELS)))
    presets = {
        "HIGH": jax.lax.Precision.HIGH,
        "BF16_BF16_F32_X3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
        "HIGHEST": jax.lax.Precision.HIGHEST,
    }
    configured = wavelets.MATMUL_PRECISION
    res = {}
    try:
        for name, p in presets.items():
            wavelets.MATMUL_PRECISION = p
            step = make_step(plan, dual=False)
            t0 = time.perf_counter()
            compiled = step.lower(*args).compile()
            compile_s = time.perf_counter() - t0
            out = compiled(*args)
            out.block_until_ready()
            ts = _time(compiled, args, iters)
            med = statistics.median(ts)
            res[name] = {
                "compile_s": compile_s,
                "step_ms_median": med * 1e3,
                "step_ms_all": [t * 1e3 for t in ts],
                "mpix_per_s": batch * H * W / med / 1e6,
                "lowering": gemm_lines(compiled.as_text()),
                "psnr_db": oracle_psnr(np.asarray(out), base, flat, dark,
                                       sample),
            }
            print(json.dumps({name: {k: v for k, v in res[name].items()
                                     if k != "step_ms_all"}}), flush=True)
            del compiled, out
    finally:
        wavelets.MATMUL_PRECISION = configured
    return res


def reduce_trace(path: str, op_names: dict, window_ns=None) -> dict:
    """Device ms per stage, busy ms and idle share from one .xplane.pb.
    ``op_names`` maps HLO instruction name -> op_name (from the compiled
    HLO text), so a kernel event is attributed through its ``hlo_op``
    stat."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    stages: dict = {}
    intervals = []
    n_events = 0
    sample = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name in ("XLA Modules", "XLA Ops", "Steps",
                             "Source code", "Framework Ops"):
                continue
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                hlo = str(stats.get("hlo_op", ""))
                op = op_names.get(hlo) or op_names.get(ev.name, "")
                st = stage_of(op) if op else "unattributed"
                dur_ms = ev.duration_ns / 1e6
                stages[st] = stages.get(st, 0.0) + dur_ms
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                n_events += 1
                if len(sample) < 40:
                    sample.append({"line": line.name, "name": ev.name,
                                   "hlo_op": hlo, "op_name": op,
                                   "ms": dur_ms})
    intervals.sort()
    busy = 0.0
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    return {
        "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        "busy_ms": busy / 1e6,
        "kernel_span_ms": span / 1e6,
        "idle_share_of_span": 1 - busy / span if span else None,
        "events": n_events,
        "sample": sample,
    }


def hlo_op_names(hlo_text: str) -> dict:
    names = {}
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*metadata=\{[^}]*"
                     r'op_name="([^"]+)"', line)
        if m:
            # kernels are named after their HLO instruction with "." -> "_"
            names[m.group(1)] = m.group(2)
            names[m.group(1).replace(".", "_")] = m.group(2)
    return names


def run_trace(batch: int, iters: int, out_dir: Path) -> dict:
    import jax

    plan, base, flat, dark, args = _setup(batch)
    res = {}
    for dual in (False, True):
        name = "dual_band" if dual else "single_band"
        step = make_step(plan, dual=dual)
        t0 = time.perf_counter()
        compiled = step.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        compiled(*args).block_until_ready()
        ts = _time(compiled, args, iters)
        mem = compiled.memory_analysis()
        tdir = out_dir / f"trace_{name}"
        jax.profiler.start_trace(str(tdir))
        t0 = time.perf_counter()
        for _ in range(3):
            out = compiled(*args)
        out.block_until_ready()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 3
        jax.profiler.stop_trace()
        xp = sorted(glob.glob(str(tdir / "**" / "*.xplane.pb"),
                              recursive=True))[-1]
        red = reduce_trace(xp, hlo_op_names(compiled.as_text()))
        red["stages_ms_per_step"] = {
            k: v / 3 for k, v in red.pop("stages_ms").items()
        }
        red["busy_ms_per_step"] = red.pop("busy_ms") / 3
        res[name] = {
            "compile_s": compile_s,
            "step_ms_median": statistics.median(ts) * 1e3,
            "traced_step_ms": traced_ms,
            "memory_analysis": {
                k: getattr(mem, k) for k in dir(mem)
                if k.endswith("_in_bytes")
            } if mem is not None else None,
            "trace": red,
        }
        print(json.dumps({name: {k: v for k, v in res[name].items()
                                 if k != "trace"}}), flush=True)
        print(json.dumps({name: red["stages_ms_per_step"]}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("precision", "trace"))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "step_profile"))
    args = ap.parse_args(argv)
    if args.mode == "trace":
        # one kernel launch per HLO instruction, so every device event names
        # its instruction (hlo_op) instead of a shared CUDA-graph launch
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()

    from aind_smartspim_destripe_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    from aind_smartspim_destripe_tpu.runtime.device import (
        card_info, device_record, require_gpu,
    )

    devices = require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.mode == "precision":
        res = run_precision(args.batch, args.iters)
    else:
        res = run_trace(args.batch, args.iters, out_dir)
    stats = devices[0].memory_stats() or {}
    doc = {
        "device": device_record(devices[:1]),
        "card": card,
        "batch": args.batch,
        "geometry": [H, W],
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "results": res,
    }
    (out_dir / f"{args.mode}.json").write_text(
        json.dumps(doc, indent=1, default=str)
    )
    print(json.dumps({"mode": args.mode, "device": doc["device"],
                      "peak_bytes_in_use": doc["peak_bytes_in_use"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
