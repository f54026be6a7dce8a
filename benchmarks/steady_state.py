"""
Steady-state multi-slab record on the GPU: drive `destripe_zarr` over a
>=384-plane synthetic tile at production geometry and report PER-SLAB
pipeline stats with compile excluded (a warmup tile at the same geometry
populates the persistent compile cache first).

The reference's production unit is exactly this loop
(zarr_destriper.py:909-1211: stream super-chunks -> filter -> write level 0).
Per-slab "compute" includes H2D and D2H over PCIe; the device-resident step
alone is bench.py's number. The record shows where read/compute/write sit,
that read prefetch overlaps, and that no per-slab cost grows with Z.

Usage: python benchmarks/steady_state.py [z_planes] [dual]
(`dual` appends parameters["dual_band"]=True — the dual-band production
route through the same streaming loop.) Refuses to run without a GPU; work
files go under .bench_work/ in the checkout.
"""

import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np


def main(z=384, h=1600, w=2000, dual=False):
    from aind_smartspim_destripe_tpu import zarr_destriper as zd
    from aind_smartspim_destripe_tpu.io.zarr import group

    params = {
        "no_cells_config": {"wavelet": "db3", "level": None, "sigma": 128,
                            "max_threshold": 12},
        "cells_config": {"wavelet": "db3", "level": None, "sigma": 64,
                         "max_threshold": 3},
    }
    if dual:
        params["dual_band"] = True
    tmp = ROOT / ".bench_work" / "steady_state"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    rng = np.random.default_rng(0)

    def make_tile(name, planes):
        tile = group(str(tmp / name))
        lvl0 = tile.create_dataset(
            0, shape=(1, 1, planes, h, w), chunks=(1, 1, 64, 128, 128),
            dtype=np.uint16,
        )
        for z0 in range(0, planes, 64):
            zz = min(64, planes - z0)
            vol = np.clip(
                300 + (rng.normal(size=(zz, h, 1)) * 60) * np.ones((1, 1, w))
                + rng.normal(size=(zz, h, w)) * 10,
                0, 65535,
            ).astype(np.uint16)
            lvl0[0, 0, z0 : z0 + zz] = vol
        return tmp / name

    flat = np.full((h, w), 1.2, np.float32)

    def run(name, planes):
        src = make_tile(name, planes)
        results = tmp / f"results_{name}"
        results.mkdir()
        t0 = time.perf_counter()
        stats = zd.destripe_zarr(
            dataset_path=src,
            multiscale="0",
            output_destriped_zarr=results / "Ex_488_Em_525" / name,
            prediction_chunksize=(64, h, w),
            target_size_mb=3072,
            n_workers=0,
            batch_size=1,
            super_chunksize=(384, h, w),
            results_folder=results,
            derivatives_path=None,
            xyz_resolution=(1.8, 1.8, 2.0),
            parameters=params,
            flatfield=flat,
        )
        return stats, time.perf_counter() - t0

    # warmup: one-slab tile, same geometry -> compile lands in the
    # persistent cache; the measured run then pays zero compile
    run("warm.zarr", 64)

    stats, wall = run("tile.zarr", z)
    recs = [
        {"slab": f"{z0}:{z1}", "read_wait_s": round(r, 2),
         "compute_s": round(c, 2)}
        for (z0, z1, r, c) in stats.slab_records
    ]
    steady = stats.slab_records[1:]  # slab 0 pays cache-load + first H2D
    per_slab = (
        sum(c for *_x, c in steady) / len(steady) if steady else float("nan")
    )
    print(json.dumps({
        "metric": "steady_state_multislab_onchip"
                  + ("_dual" if dual else ""),
        "z_planes": z,
        "slabs": stats.slabs,
        "wall_s": round(wall, 1),
        "pipeline_wall_s": round(stats.wall_s, 1),
        "read_block_s": round(stats.read_s, 1),
        "compute_s": round(stats.compute_s, 1),
        "write_s": round(stats.write_s, 1),
        "steady_compute_s_per_slab": round(per_slab, 2),
        "mpix_per_s": round(stats.pixels / stats.wall_s / 1e6, 1),
        "per_slab": recs,
        "note": "compute_s includes PCIe H2D/D2H; device-resident floor "
                "is bench.py",
    }), flush=True)


if __name__ == "__main__":
    from aind_smartspim_destripe_tpu.runtime import enable_compile_cache
    from aind_smartspim_destripe_tpu.runtime.device import (
        card_info, require_gpu,
    )

    enable_compile_cache()
    require_gpu()
    print(f"card: {card_info()}", flush=True)
    _nums = [a for a in sys.argv[1:] if a.isdigit()]
    try:
        main(int(_nums[0]) if _nums else 384, dual="dual" in sys.argv[1:])
    finally:
        shutil.rmtree(ROOT / ".bench_work", ignore_errors=True)
