"""
Full destripe_batch against the float64 oracle of the reference pipeline
(tests/golden/numpy_ref.py) at a 640 x 768 geometry, with each epilogue
(float, flat-field, wrap), an odd geometry, and dual mode; plus per-plane
semantics (a batch filters like its planes one by one) and the deep-level
Otsu thresholds at the production ladder's coarse shapes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from aind_smartspim_destripe_tpu.ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
    wrap_cast,
)
from aind_smartspim_destripe_tpu.ops.otsu import threshold_otsu_batch
from tests.golden import numpy_ref as G

H, W, B = 640, 768, 3
CELLS = {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3}
NO_CELLS = {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12}


def _planes(h=H, w=W, levels=(300.0, 3200.0, 500.0), seed=0):
    rng = np.random.default_rng(seed)
    level = np.asarray(levels)[:, None, None]
    n = len(levels)
    return np.clip(
        level
        + (rng.normal(size=(n, h, 1)) * 60) * np.ones((1, 1, w))
        + rng.normal(size=(n, h, w)) * 10,
        0, 65535,
    ).astype(np.uint16)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)


def _oracle(x, h, w):
    return np.stack([
        G.filter_stripes_ref(
            p.astype(np.float64), cells_config=CELLS,
            no_cells_config=NO_CELLS, microscope_high_int=2500.0,
        )[:h, :w]
        for p in x
    ])


@pytest.fixture(scope="module")
def plan():
    return build_plan(
        H, W, FilterConfig.from_dict(CELLS), FilterConfig.from_dict(NO_CELLS)
    )


@pytest.fixture(scope="module")
def oracle():
    return _oracle(_planes(), H, W)


def test_graph_matches_oracle(plan, oracle):
    got = np.asarray(destripe_batch(plan, _planes(), 2500.0))
    assert got.shape == (B, H, W) and got.dtype == np.float32
    for b in range(B):
        assert _psnr(got[b], oracle[b]) >= 60.0


def test_flat_epilogue_matches_oracle(plan, oracle):
    flat = np.full((H, W), 1.2, np.float32)
    dark = np.full((H, W), 4.0, np.float32)
    got = np.asarray(destripe_batch(plan, _planes(), 2500.0, flat=flat,
                                    dark=dark))
    assert got.dtype == np.uint16
    for b in range(B):
        want = G.flatfield_correction_ref(oracle[b], flat.astype(np.float64),
                                          dark.astype(np.float64))
        assert _psnr(got[b], want) >= 60.0


def test_wrap_epilogue_matches_oracle(plan, oracle):
    got = np.asarray(destripe_batch(plan, _planes(), 2500.0, wrap=True))
    want = np.mod(np.trunc(oracle).astype(np.int64), 65536).astype(np.uint16)
    assert got.dtype == np.uint16
    for b in range(B):
        assert _psnr(got[b], want[b]) >= 60.0


def test_odd_geometry_matches_oracle():
    """Odd height and width: every crop rule of the operator ladder."""
    h, w = 801, 701
    plan2 = build_plan(
        h, w, FilterConfig.from_dict(CELLS), FilterConfig.from_dict(NO_CELLS)
    )
    x = _planes(h, w, levels=(400.0, 3200.0), seed=3)
    got = np.asarray(destripe_batch(plan2, x, 2500.0))
    want = _oracle(x, h, w)
    for b in range(2):
        assert _psnr(got[b], want[b]) >= 60.0


def test_dual_mode_matches_oracle():
    """dual=True: both configs on every plane from one decomposition,
    each band against the single-config oracle."""
    fore = {"wavelet": "db3", "level": None, "sigma": 256, "max_threshold": 12}
    back = {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12}
    plan_d = build_plan(
        H, W, FilterConfig.from_dict(fore), FilterConfig.from_dict(back)
    )
    x = _planes()
    got = np.asarray(destripe_batch(plan_d, x, -np.inf, dual=True))
    assert got.shape == (2 * B, H, W)
    for half, cfg in ((got[:B], fore), (got[B:], back)):
        for b in range(B):
            want = G.log_space_fft_filtering_ref(
                x[b].astype(np.float64), wavelet_name="db3", level=None,
                sigma=cfg["sigma"], max_threshold=cfg["max_threshold"],
            )[:H, :W]
            assert _psnr(half[b], want) >= 60.0
    assert np.abs(got[:B] - got[B:]).max() > 0.1  # the bands differ


def test_deep_level_otsu_matches_oracle():
    """Per-plane Otsu of the squared cH bands at the coarse shapes of the
    production 1600 x 2000 ladder (levels 3..7)."""
    rng = np.random.default_rng(23)
    shapes = [(102, 127), (52, 65), (27, 34), (15, 18), (9, 11)]
    for i, s in enumerate(shapes):
        ch = (rng.normal(size=(3,) + s) * (i + 1)).astype(np.float32)
        got = np.asarray(jnp.sqrt(threshold_otsu_batch(jnp.asarray(ch * ch))))
        for b in range(3):
            sq = ch[b] * ch[b]
            want = np.sqrt(G.threshold_otsu_ref(sq))
            # within one histogram bin of the float64 binning
            bin_w = (sq.max() - sq.min()) / 256
            assert abs(got[b] ** 2 - want ** 2) <= bin_w * 1.01


@pytest.mark.parametrize("dual", [False, True])
def test_batch_equals_per_plane(plan, dual):
    """Planes are independent: filtering a batch equals filtering each
    plane alone (the classifier, Otsu and medians are per plane)."""
    x = _planes()
    both = np.asarray(destripe_batch(plan, x, 2500.0, dual=dual))
    for b in range(B):
        one = np.asarray(destripe_batch(plan, x[b:b + 1], 2500.0, dual=dual))
        # up to a few f32 ulps: XLA vectorizes the per-plane reductions
        # differently at another batch extent
        np.testing.assert_allclose(both[b], one[0], rtol=4e-6, atol=2e-3)
        if dual:
            np.testing.assert_allclose(both[B + b], one[1], rtol=4e-6,
                                       atol=2e-3)


def test_wrap_cast_is_modular():
    y = jnp.asarray([-1.5, 0.0, 65535.9, 65536.0, 70000.2])
    np.testing.assert_array_equal(
        np.asarray(wrap_cast(y)), [65535, 0, 65535, 0, 4464]
    )
