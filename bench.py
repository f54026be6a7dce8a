"""
Benchmark: destripe throughput of the device step on one NVIDIA GPU at the
production SmartSPIM geometry.

Measures the destripe + flat-field device step (uint16 in / uint16 out) on
(B, 1600, 2000) planes with the production filter configs
(run_capsule.py:374-390 of the reference). Scope: DEVICE-RESIDENT — the
timed loop is a lax.scan chained on device, so host<->device transfer is not
included (benchmarks/run_configs.py times the IO-inclusive configs).

Refuses to run without a GPU. Prints the card's name and power limit, then
ONE JSON line: throughput, the device as JAX reports it, and per-plane PSNR
of the step's own output against the float64 oracle
(tests/golden/numpy_ref.py); exits non-zero if any sampled plane is below
the 60 dB gate.

Environment: BENCH_BATCH (planes per step, 64), BENCH_ITERS (chained steps
in the timed window, 64), DESTRIPE_TRACE_DIR (write a jax.profiler trace of
the timed window there).
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PSNR_GATE_DB = 60.0


def main():
    sys.path.insert(0, ROOT)
    from aind_smartspim_destripe_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from aind_smartspim_destripe_tpu.ops.filter import (
        FilterConfig,
        build_plan,
        destripe_batch,
    )
    from aind_smartspim_destripe_tpu.runtime.device import (
        card_info,
        device_record,
        require_gpu,
    )
    from aind_smartspim_destripe_tpu.runtime.tracing import device_trace
    from tests.golden import numpy_ref as G

    devices = require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)

    H, W = 1600, 2000
    B = int(os.environ.get("BENCH_BATCH", "64"))
    iters = int(os.environ.get("BENCH_ITERS", "64"))
    cells = {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3}
    no_cells = {"wavelet": "db3", "level": None, "sigma": 128,
                "max_threshold": 12}
    plan = build_plan(
        H, W, FilterConfig.from_dict(cells), FilterConfig.from_dict(no_cells)
    )
    consts = jax.device_put(plan.constants())

    @partial(jax.jit, static_argnums=(0,))
    def step(plan, images, flat, dark, consts):
        return destripe_batch(
            plan, images, 2500.0, consts, flat=flat, dark=dark
        )

    @partial(jax.jit, static_argnums=(0, 1))
    def step_loop(plan, n, images, flat, dark, consts):
        """n chained steps in ONE dispatch (lax.scan). The carry is a scalar
        token (the input rides through an optimization barrier so each
        iteration re-executes): carrying the full uint16 output would add a
        full-output copy per iteration that production never pays."""

        def body(tok, _):
            x, _tok = jax.lax.optimization_barrier((images, tok))
            out = destripe_batch(
                plan, x, 2500.0, consts, flat=flat, dark=dark
            )
            return out[0, 0, 0].astype(jnp.float32) + _tok, ()

        tok, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n)
        return tok

    rng = np.random.default_rng(0)
    # alternate dim/bright planes so both classifier branches (no-cells /
    # cells, filtering.py:462) appear in the PSNR sample
    level = np.where(np.arange(B) % 2 == 0, 300.0, 3200.0)[:, None, None]
    base = np.clip(
        level
        + (rng.normal(size=(B, H, 1)) * 60) * np.ones((1, 1, W))
        + rng.normal(size=(B, H, W)) * 10,
        0,
        65535,
    ).astype(np.uint16)
    flat = jax.device_put(np.full((H, W), 1.2, np.float32))
    dark = jax.device_put(np.full((H, W), 4.0, np.float32))

    dev = jax.device_put(base)
    out = step(plan, dev, flat, dark, consts)
    out.block_until_ready()
    looped = step_loop(plan, iters, dev, flat, dark, consts)
    _ = float(np.asarray(looped))  # compile + warm

    with device_trace(os.environ.get("DESTRIPE_TRACE_DIR")):
        t0 = time.perf_counter()
        looped = step_loop(plan, iters, dev, flat, dark, consts)
        _ = float(np.asarray(looped))
        dt = time.perf_counter() - t0
    mpix_s = iters * B * H * W / dt / 1e6

    # PSNR of the step's own uint16 output against the float64 oracle
    got_all = np.asarray(out[: min(4, B)])
    psnr_planes = []
    for i in range(got_all.shape[0]):
        want = G.flatfield_correction_ref(
            G.filter_stripes_ref(
                base[i].astype(np.float64), no_cells_config=no_cells,
                cells_config=cells, microscope_high_int=2500,
            ),
            np.full((H, W), 1.2), np.full((H, W), 4.0),
        )
        mse = np.mean((got_all[i].astype(np.float64) - want) ** 2)
        psnr_planes.append(
            float(10 * np.log10(65535.0**2 / mse)) if mse > 0 else None
        )
    finite = [p for p in psnr_planes if p is not None]

    print(
        json.dumps(
            {
                "metric": "destripe_throughput_1600x2000_u16",
                "value": mpix_s,
                "unit": "MPix/s",
                "device": device_record(devices[:1]),
                "card": card,
                "scope": "device_resident",
                "batch": B,
                "iters": iters,
                "psnr_vs_reference_db": min(finite) if finite else None,
                "psnr_planes_db": psnr_planes,
            }
        )
    )
    if finite and min(finite) < PSNR_GATE_DB:
        print(f"bench: PSNR {min(finite):.1f} dB below the "
              f"{PSNR_GATE_DB} dB gate", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
