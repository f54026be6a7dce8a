"""
Host-side IO stage benchmarks at production geometry.

Sustaining the device rate is an I/O problem on the host (SURVEY.md §7):
N GPix/s of uint16 in + out needs ~2N GB/s of Zarr decode and ~2N GB/s of
encode on the host, overlapped with the device kernel. The device kernel rate is measured
by bench.py (device-resident); this file measures every HOST stage of the
streaming pipeline (runtime/pipeline.py) in isolation, at the production
chunk geometry of the reference ((1,1,64,128,128) uint16 blosc-zstd-3
SHUFFLE chunks, slabs of (64,1600,2000) — zarr_destriper.py:1066-1074,
:1256 of the reference):

  codec_encode / codec_decode   blosc1 frame codec across the IO thread pool
  zarr_write_slab               ZarrArray slab assignment (encode + file IO)
  zarr_read_slab                ZarrArray slab read (file IO + decode)

Each stage prints one JSON line with GB/s and the equivalent destripe
MPix/s it can feed (uint16: 1 pixel = 2 bytes on each side). The sustained
end-to-end bound of the overlapped pipeline is min(read, compute, write).

Usage: python benchmarks/host_stages.py [--threads N] [--slabs K]
"""

import argparse
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

from aind_smartspim_destripe_tpu.io import blosc
from aind_smartspim_destripe_tpu.io.zarr import ZarrArray

Z, H, W = 64, 1600, 2000
CHUNK = (64, 128, 128)


def _striped_slab(seed=0):
    rng = np.random.default_rng(seed)
    base = 300 + (rng.normal(size=(Z, H, 1)) * 60) * np.ones((1, 1, W))
    return np.clip(base + rng.normal(size=(Z, H, W)) * 10, 0, 65535).astype(
        np.uint16
    )


def _chunks_of(slab):
    out = []
    for y0 in range(0, H, CHUNK[1]):
        for x0 in range(0, W, CHUNK[2]):
            c = np.zeros(CHUNK, np.uint16)
            block = slab[:, y0 : y0 + CHUNK[1], x0 : x0 + CHUNK[2]]
            c[:, : block.shape[1], : block.shape[2]] = block
            out.append(c.tobytes())
    return out


def _report(name, nbytes, seconds, extra=None):
    gbs = nbytes / seconds / 1e9
    rec = {
        "metric": name,
        "value": round(gbs, 3),
        "unit": "GB/s",
        "equiv_mpix_s": round(nbytes / 2 / seconds / 1e6, 1),
        "seconds": round(seconds, 3),
    }
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)
    return gbs


def bench_codec(threads, repeats=3):
    slab = _striped_slab()
    raw_chunks = _chunks_of(slab)
    nbytes = sum(len(c) for c in raw_chunks)
    pool = ThreadPoolExecutor(max_workers=threads)

    # warm (also builds the native lib on first use)
    frames = list(pool.map(lambda c: blosc.compress(c, typesize=2, clevel=3), raw_chunks))

    t0 = time.perf_counter()
    for _ in range(repeats):
        frames = list(
            pool.map(lambda c: blosc.compress(c, typesize=2, clevel=3), raw_chunks)
        )
    enc = _report(
        "host_codec_encode",
        nbytes * repeats,
        time.perf_counter() - t0,
        {"threads": threads, "ratio": round(nbytes / sum(map(len, frames)), 2)},
    )

    list(pool.map(blosc.decompress, frames))  # warm
    t0 = time.perf_counter()
    for _ in range(repeats):
        list(pool.map(blosc.decompress, frames))
    dec = _report(
        "host_codec_decode",
        nbytes * repeats,
        time.perf_counter() - t0,
        {"threads": threads},
    )
    return enc, dec


def bench_codec_batch_threads(threads_list, repeats=4):
    """Thread-scaling of the NATIVE one-call batch API
    (csrc blosc1_{compress,decompress}_batch): the per-chip codec budget in
    BENCH_E2E.md extrapolates single-core rates through this fan-out, so a
    production host should run exactly this sweep:

        python benchmarks/host_stages.py --batch-sweep

    On a 1-vCPU box the threads serialize — the flat/declining curve that
    produces is the expected signal there, not a defect."""
    slab = _striped_slab()
    raw_chunks = [np.frombuffer(c, np.uint16).reshape(CHUNK) for c in _chunks_of(slab)]
    nbytes = sum(c.nbytes for c in raw_chunks)
    if blosc._load_native() is None:
        print(json.dumps({"metric": "host_codec_batch_sweep",
                          "error": "native runtime unavailable"}))
        return []
    rows = []
    for t in threads_list:
        frames = blosc.compress_batch(raw_chunks, typesize=2, threads=t)  # warm
        best_e = best_d = 0.0
        for _ in range(repeats):  # best-of: the shared vCPU is noisy +-25%
            t0 = time.perf_counter()
            frames = blosc.compress_batch(raw_chunks, typesize=2, threads=t)
            best_e = max(best_e, nbytes / (time.perf_counter() - t0) / 1e9)
        frames = [bytes(f) for f in frames]
        blosc.decompress_batch(frames, threads=t)  # warm
        for _ in range(repeats):
            t0 = time.perf_counter()
            blosc.decompress_batch(frames, threads=t)
            best_d = max(best_d, nbytes / (time.perf_counter() - t0) / 1e9)
        row = {
            "metric": "host_codec_batch_sweep",
            "threads": t,
            "encode_gbs": round(best_e, 3),
            "decode_gbs": round(best_d, 3),
            "host_cpus": os.cpu_count(),
            "unit": "GB/s best-of-%d" % repeats,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def bench_zarr_store(slabs):
    tmp = os.path.join(ROOT, ".bench_work", "host_stages")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arr = ZarrArray.create(
        os.path.join(tmp, "bench.zarr"),
        (1, 1, slabs * Z, H, W),
        (1, 1) + CHUNK,
        np.uint16,
    )
    slab = _striped_slab()
    nbytes = slab.nbytes

    arr[0:1, 0:1, 0:Z] = slab[None, None]  # warm
    # best-of per slab: the shared vCPU swings far more than +-25% when
    # anything else runs; a sum over slabs reports the noise, not the stage
    best_w = float("inf")
    for k in range(slabs):
        t0 = time.perf_counter()
        arr[0:1, 0:1, k * Z : (k + 1) * Z] = slab[None, None]
        best_w = min(best_w, time.perf_counter() - t0)
    wr = _report("host_zarr_write_slab", nbytes, best_w,
                 {"timing": f"best-of-{slabs} slabs"})

    os.sync()  # drain writeback so the read phase isn't polluted by it
    _ = np.asarray(arr[0, 0, 0:Z])  # warm
    best_r = float("inf")
    for k in range(slabs):
        t0 = time.perf_counter()
        _ = np.asarray(arr[0, 0, k * Z : (k + 1) * Z])
        best_r = min(best_r, time.perf_counter() - t0)
    rd = _report("host_zarr_read_slab", nbytes, best_r,
                 {"timing": f"best-of-{slabs} slabs"})
    return rd, wr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=min(32, os.cpu_count() or 4))
    ap.add_argument("--slabs", type=int, default=4)
    ap.add_argument(
        "--batch-sweep", action="store_true",
        help="native batch-API thread scaling at 1/2/4/8 threads, then exit",
    )
    args = ap.parse_args()

    if args.batch_sweep:
        bench_codec_batch_threads([1, 2, 4, 8])
        return

    enc, dec = bench_codec(args.threads)
    rd, wr = bench_zarr_store(args.slabs)

    # The overlapped pipeline sustains min(stage) — report the IO-side bound
    bound_gbs = min(rd, wr)
    shutil.rmtree(os.path.join(ROOT, ".bench_work"), ignore_errors=True)
    print(
        json.dumps(
            {
                "metric": "host_io_bound",
                "value": round(bound_gbs, 3),
                "unit": "GB/s",
                "equiv_mpix_s": round(bound_gbs * 1e3 / 2, 1),
                "note": "sustained e2e = min(read, device_compute, write); "
                "device rate from bench.py",
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
