"""
Fidelity-sweep CI gate: the intensity x stripe-
amplitude sweep from ROADMAP.md, promoted to a test so kernel optimizations
cannot silently erode the bright-plane PSNR margin.

The production destripe graph (the same XLA graph the device runs, at the
configured matmul precision) plus the flat-field epilogue is compared per
plane against the float64 numpy oracle of the reference pipeline
(tests/golden/numpy_ref.py).

Floors (calibrated on the 640x768 sweep):
- every plane >= 70 dB (the bright 45000-level planes are the binding case:
  absolute f32 rounding scales with signal),
- median >= 85 dB.
The project-wide acceptance gate is 60 dB; these floors keep >=10 dB of
margin in CI so a regression is caught before it threatens the gate.
"""

import numpy as np
import pytest

from aind_smartspim_destripe_tpu.ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
)
from tests.golden import numpy_ref as G

H, W = 640, 768

INTENSITIES = (100.0, 1000.0, 8000.0, 45000.0)
AMPLITUDES = (10.0, 120.0)

CELLS = {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3}
NO_CELLS = {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12}


def _sweep_planes():
    rng = np.random.default_rng(7)
    planes = []
    for level in INTENSITIES:
        for amp in AMPLITUDES:
            noise = max(2.0, level * 0.02)
            img = (
                level
                + (rng.normal(size=(H, 1)) * amp) * np.ones((1, W))
                + rng.normal(size=(H, W)) * noise
            )
            planes.append(np.clip(img, 0, 65535))
    return np.stack(planes).astype(np.uint16)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)


def test_fidelity_sweep_floor():
    plan = build_plan(
        H, W,
        FilterConfig.from_dict(CELLS),
        FilterConfig.from_dict(NO_CELLS),
    )
    consts = plan.constants()

    x = _sweep_planes()
    flat = 1.0 + 0.3 * np.hanning(W)[None, :] * np.ones((H, 1))
    flat = flat.astype(np.float32)
    dark = np.full((H, W), 4.0, np.float32)

    got = np.asarray(
        destripe_batch(plan, x, 2500.0, consts, flat=flat, dark=dark)
    )
    assert got.dtype == np.uint16

    psnrs = []
    for i in range(x.shape[0]):
        filt = G.filter_stripes_ref(
            x[i].astype(np.float64),
            cells_config=CELLS,
            no_cells_config=NO_CELLS,
            microscope_high_int=2500.0,
        )
        want = G.flatfield_correction_ref(
            filt, flat.astype(np.float64), dark.astype(np.float64)
        )
        psnrs.append(_psnr(got[i], want))

    psnrs = np.array(psnrs)
    labels = [
        f"lvl={lv:.0f} amp={am:.0f}: {p:.1f} dB"
        for (lv, am), p in zip(
            [(lv, am) for lv in INTENSITIES for am in AMPLITUDES], psnrs
        )
    ]
    assert psnrs.min() >= 70.0, f"fidelity floor breached: {labels}"
    assert np.median(psnrs) >= 85.0, f"median fidelity eroded: {labels}"
