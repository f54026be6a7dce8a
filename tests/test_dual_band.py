"""Dual-band wavelet-FFT variant tests (BASELINE config 2)."""

import numpy as np

from aind_smartspim_destripe_tpu.ops.dual_band import dual_band_filtering
from tests.test_filter_golden import synthetic_plane


def test_dual_band_removes_stripes_preserves_bright():
    rng = np.random.default_rng(0)
    h, w = 96, 128
    base = 300 + 2.0 * np.arange(w)[None, :] * np.ones((h, 1))
    img = base + (rng.normal(size=(h, 1)) * 100.0) * np.ones((1, w))
    # bright blob that the foreground band should protect
    yy, xx = np.mgrid[0:h, 0:w]
    img = img + 20000 * np.exp(-((yy - 40) ** 2 + (xx - 60) ** 2) / 16.0)
    img = np.clip(img, 0, 65535).astype(np.float32)

    out = dual_band_filtering(
        img, sigma=(256.0, 64.0), wavelet="db3", level=None,
        max_threshold=12.0, crossover=100.0,
    )
    assert out.shape == img.shape
    # background stripes attenuated
    bg_rows_before = np.var(img[:, :30].mean(axis=1))
    bg_rows_after = np.var(out[:, :30].mean(axis=1))
    assert bg_rows_after < bg_rows_before / 2
    # bright peak survives within 10%
    assert out[40, 60] > 0.9 * img[40, 60]


def test_dual_band_batch_and_fixed_threshold():
    imgs = np.stack([synthetic_plane(64, 80, seed=s) for s in range(2)])
    out = dual_band_filtering(imgs, sigma=(128.0, 32.0), threshold=500.0)
    assert out.shape == imgs.shape
    assert np.isfinite(out).all()


import pytest


@pytest.mark.parametrize(
    "h,w",
    [
        (96, 128),  # lane-aligned
        (130, 258),  # odd extents, non-multiple-of-8 rows
        (67, 310),  # tall-narrow wavelet ladder, ragged last level
    ],
)
def test_dual_shared_decomposition_matches_two_single_runs(h, w):
    """destripe_batch(dual=True) — one analysis, two notch/synthesis bands —
    must reproduce two independent single-band runs (up to f32 batch-extent
    vectorization jitter; the algorithms are identical per plane). Odd
    geometries exercise the wrapped dual block indexing at ragged ladders."""
    import jax.numpy as jnp

    from aind_smartspim_destripe_tpu.ops.filter import (
        FilterConfig,
        build_plan,
        destripe_batch,
    )

    imgs = np.stack(
        [synthetic_plane(h, w, seed=s) for s in range(3)]
    ).astype(np.float32)
    cfg_f = FilterConfig("db3", None, 256.0, 12.0)
    cfg_b = FilterConfig("db3", None, 128.0, 12.0)
    plan_dual = build_plan(h, w, cfg_f, cfg_b)
    both = np.asarray(
        destripe_batch(plan_dual, jnp.asarray(imgs), -np.inf, dual=True)
    )
    assert both.shape == (6, h, w)
    for cfg, half in ((cfg_f, both[:3]), (cfg_b, both[3:])):
        plan = build_plan(h, w, cfg, cfg)
        single = np.asarray(destripe_batch(plan, jnp.asarray(imgs), -np.inf))
        np.testing.assert_allclose(half, single, rtol=0, atol=2e-3)
    # the two bands genuinely differ (different sigmas)
    assert np.abs(both[:3] - both[3:]).max() > 0.1


def test_dual_band_matches_independent_float64_oracle():
    """Independent end-to-end oracle for config 2: compose the dual output
    in float64 numpy from the golden single-band filter
    (G.log_space_fft_filtering_ref per config), the golden per-plane Otsu
    center on the raw plane, a scipy uniform_filter(17, mode='nearest')
    box smooth (verified == ops.dual_band._smooth to f32 eps), and the
    sigmoid band mix (G.dual_band_ref) — this pins the blend SEMANTICS
    (center choice, sigmoid orientation, smoothing) externally."""
    import jax.numpy as jnp

    from tests.golden import numpy_ref as G
    from aind_smartspim_destripe_tpu.ops.dual_band import (
        _dual_plan, dual_band_destripe_batch,
    )

    h, w = 96, 128
    imgs = np.stack([synthetic_plane(h, w, seed=s) for s in (3, 4)])
    sig_fore, sig_back, thr, crossover = 256.0, 64.0, 12.0, 100.0

    want = np.stack([
        G.dual_band_ref(
            img,
            {"wavelet": "db3", "level": None, "sigma": sig_fore,
             "max_threshold": thr},
            {"wavelet": "db3", "level": None, "sigma": sig_back,
             "max_threshold": thr},
            crossover=crossover,
        )
        for img in imgs.astype(np.float64)
    ])

    plan = _dual_plan(h, w, "db3", None, sig_fore, sig_back, thr)
    got = np.asarray(dual_band_destripe_batch(
        plan, jnp.asarray(imgs.astype(np.float32)), crossover, -1.0,
        consts=plan.constants(),
    ))

    u16g = np.clip(got, 0, 65535).astype(np.uint16)
    u16w = np.clip(want, 0, 65535).astype(np.uint16)
    mse = np.mean((u16g.astype(np.float64) - u16w.astype(np.float64)) ** 2)
    p = 10 * np.log10(65535.0**2 / max(mse, 1e-12))
    assert p > 80, f"dual-band PSNR vs float64 oracle too low: {p:.1f} dB"


@pytest.mark.parametrize("fixed_threshold", [False, True])
def test_dual_band_uint16_input_bitexact(fixed_threshold):
    """The full dual step fed raw uint16 (the production pipeline's dtype)
    must reproduce the f32-fed output bit-for-bit, with the per-plane Otsu
    blend center and with a fixed one (every 16-bit value is exactly
    representable in float32, so the cast inside the graph is lossless)."""
    import jax.numpy as jnp

    from aind_smartspim_destripe_tpu.ops.dual_band import (
        _dual_plan, dual_band_destripe_batch,
    )

    threshold = 420.0 if fixed_threshold else -1.0
    h, w = 560, 720
    rng = np.random.default_rng(17)
    x16 = np.clip(
        400 + (rng.normal(size=(1, h, 1)) * 60) * np.ones((1, 1, w))
        + rng.normal(size=(1, h, w)) * 10, 0, 65535,
    ).astype(np.uint16)
    plan = _dual_plan(h, w, "db3", None, 256.0, 128.0, 12.0)
    consts = plan.constants()
    got16 = np.asarray(dual_band_destripe_batch(
        plan, jnp.asarray(x16), 100.0, threshold, consts=consts))
    got32 = np.asarray(dual_band_destripe_batch(
        plan, jnp.asarray(x16.astype(np.float32)), 100.0, threshold,
        consts=consts))
    np.testing.assert_array_equal(got16, got32)


@pytest.mark.parametrize(
    "shape,crossover",
    [
        ((2, 200, 260), 100.0),  # ragged rows and lanes
        ((1, 64, 128), 100.0),  # aligned
        ((3, 17, 40), 25.0),  # smaller than the 17-wide window
        ((2, 131, 67), 400.0),  # odd extents, wide sigmoid
    ],
)
def test_blend_bands_xla_matches_float64_blend(shape, crossover):
    """blend_bands_xla (sigmoid foreground fraction -> 17x17 edge-replicated
    box smooth -> band mix) against the same blend composed in float64
    with scipy's uniform_filter(mode='nearest')."""
    import jax.numpy as jnp
    from scipy import ndimage

    from aind_smartspim_destripe_tpu.ops.dual_band import blend_bands_xla

    rng = np.random.default_rng(sum(shape))
    x = rng.uniform(0.0, 4000.0, shape).astype(np.float32)
    fore = (x * 0.9 + rng.normal(size=shape) * 5).astype(np.float32)
    back = (x * 1.1 + rng.normal(size=shape) * 5).astype(np.float32)
    centers = rng.uniform(100.0, 4000.0, (shape[0],)).astype(np.float32)

    got = np.asarray(blend_bands_xla(
        jnp.asarray(x), jnp.asarray(fore), jnp.asarray(back),
        jnp.asarray(centers), crossover, 8,
    ))
    want = np.empty(shape)
    for b in range(shape[0]):
        xb = x[b].astype(np.float64)
        frac = 1.0 / (1.0 + np.exp(-(xb - centers[b]) / crossover))
        frac = ndimage.uniform_filter(frac, size=17, mode="nearest")
        want[b] = fore[b] * frac + back[b] * (1.0 - frac)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-2)
