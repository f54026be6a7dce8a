"""
BaSiC shading-model tests: recover known synthetic flatfield/darkfield and
exercise the flatfield_estimation surface (reference flatfield_estimation.py).
"""

import numpy as np
import pytest

from aind_smartspim_destripe_tpu.flatfield_estimation import (
    shading_correction,
    unify_fields,
)
from aind_smartspim_destripe_tpu.models.basic import BaSiC


def synthetic_stack(n=24, h=64, w=64, dark=False, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    flat = 1.0 + 0.4 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (2 * (h / 3) ** 2))
    flat = flat / flat.mean()
    darkfield = 80.0 * (xx / w) if dark else np.zeros((h, w))
    imgs = []
    for i in range(n):
        base = rng.uniform(400, 1200)
        content = rng.normal(0, 15, size=(h, w))
        # sparse bright blobs (cells) that the sparse residual should absorb
        for _ in range(4):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            content += 3000 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
        imgs.append(base * flat + darkfield + content)
    return np.stack(imgs).astype(np.float32), flat, darkfield


def test_basic_recovers_flatfield():
    imgs, flat_true, _ = synthetic_stack()
    model = BaSiC(
        get_darkfield=False,
        smoothness_flatfield=1.0,
        sort_intensity=True,
        max_reweight_iterations=5,
        working_size=64,
    )
    model.fit(imgs)
    assert model.flatfield.shape == imgs.shape[1:]
    assert model.baseline.shape == (imgs.shape[0],)
    corr = np.corrcoef(model.flatfield.ravel(), flat_true.ravel())[0, 1]
    assert corr > 0.95, f"flatfield correlation too low: {corr:.3f}"
    rel_err = np.mean(np.abs(model.flatfield - flat_true) / flat_true)
    assert rel_err < 0.05, f"flatfield mean relative error {rel_err:.3f}"


def test_basic_transform_flattens():
    imgs, flat_true, _ = synthetic_stack(seed=3)
    model = BaSiC(sort_intensity=True, max_reweight_iterations=3, working_size=64)
    model.fit(imgs)
    corrected = model.transform(imgs)
    # After correction the column means should be much flatter
    profile_before = imgs.mean(axis=0)
    profile_after = corrected.mean(axis=0)
    cv_before = profile_before.std() / profile_before.mean()
    cv_after = profile_after.std() / profile_after.mean()
    # Residual blob content keeps a floor; shading contribution must shrink.
    assert cv_after < cv_before * 0.75, (cv_before, cv_after)


def test_basic_fit_rejects_bad_shape():
    with pytest.raises(ValueError):
        BaSiC().fit(np.zeros((8, 8)))


def test_shading_correction_surface():
    imgs, *_ = synthetic_stack(n=8, h=32, w=32)
    res = shading_correction(
        list(imgs),
        shading_parameters=dict(
            get_darkfield=False,
            smoothness_flatfield=1.0,
            sort_intensity=True,
            max_reweight_iterations=2,
            working_size=32,
        ),
    )
    assert set(res) == {"flatfield", "darkfield", "baseline"}
    assert res["flatfield"].shape == (32, 32)


def test_unify_fields_modes():
    flats = [np.full((4, 4), v) for v in (1.0, 2.0, 3.0)]
    darks = [np.full((4, 4), v) for v in (10.0, 20.0, 30.0)]
    bases = [np.full((3,), v) for v in (1.0, 2.0, 3.0)]

    f, d, b = unify_fields(flats, darks, bases, mode="median")
    assert f.dtype == np.float16 and float(f[0, 0]) == 2.0 and float(d[0, 0]) == 20.0
    f, d, b = unify_fields(flats, darks, bases, mode="mean")
    assert float(f[0, 0]) == 2.0
    f, d, b = unify_fields(flats, darks, bases, mode="mip")
    assert float(f[0, 0]) == 3.0 and float(d[0, 0]) == 10.0 and float(b[0]) == 3.0
    with pytest.raises(NotImplementedError):
        unify_fields(flats, darks, bases, mode="bogus")


def test_basic_production_parameters_full_reweights():
    """The production parameter set (reference zarr_destriper_orig.py:1092-
    1099: smoothness 1.0/20, sort_intensity, 35 reweight iterations,
    working_size 128) with darkfield estimation ON, against synthetic fields
    with known ground truth. BaSiCPy itself is not installable here (no
    fixtures can be generated offline); this quantifies field-level recovery
    error at the exact production knobs instead."""
    imgs, flat_true, dark_true = synthetic_stack(n=24, h=128, w=128, dark=True, seed=7)
    model = BaSiC(
        get_darkfield=True,
        smoothness_flatfield=1.0,
        smoothness_darkfield=20.0,
        sort_intensity=True,
        max_reweight_iterations=35,
        working_size=128,
    )
    model.fit(imgs)
    rel_err = np.mean(np.abs(model.flatfield - flat_true) / flat_true)
    assert rel_err < 0.05, f"flatfield mean relative error {rel_err:.4f}"
    # darkfield recovery incl. its DC (true field: 0..80 gradient, mean ~40;
    # measured err ~4 via the regression + dark-floor anchor)
    dark_err = np.mean(np.abs(model.darkfield - dark_true))
    assert dark_err < 10.0, f"darkfield mean abs error {dark_err:.2f}"
    dark_corr = np.corrcoef(model.darkfield.ravel(), dark_true.ravel())[0, 1]
    assert dark_corr > 0.95, f"darkfield correlation {dark_corr:.3f}"
    # residual blobs must have been absorbed by R, not the fields
    assert model.flatfield.max() < 2.5


def test_basic_cross_implementation_parity():
    """Cross-implementation evidence: BaSiCPy cannot
    be installed in this runtime, so the independent float64 numpy oracle
    (tests/golden/basic_ref.py — same published model/update equations,
    separately implemented: explicit loops + scipy DCT vs float32
    jax.lax.while_loop + jax DCT) must agree field-level with
    models/basic.py at the production knobs, and BOTH must recover the
    synthetic ground truth."""
    from tests.golden.basic_ref import basic_fit_ref

    h = w = 64  # working-resolution stack: the oracle skips the resample
    imgs, flat_true, dark_true = synthetic_stack(
        n=24, h=h, w=w, dark=True, seed=11
    )
    knobs = dict(
        get_darkfield=True,
        smoothness_flatfield=1.0,
        smoothness_darkfield=20.0,
        sort_intensity=True,
        max_reweight_iterations=35,
    )
    model = BaSiC(working_size=h, **knobs)
    model.fit(imgs)
    S_ref, D_ref, b_ref = basic_fit_ref(imgs, **knobs)

    # both implementations recover the ground truth...
    for name, S in (("jax", model.flatfield), ("numpy-ref", S_ref)):
        rel = np.mean(np.abs(S - flat_true) / flat_true)
        assert rel < 0.05, f"{name} flatfield GT error {rel:.4f}"
    # ...and agree with each other much more tightly than the GT bound
    # (same equations; float32-vs-float64 + DCT backends decorrelate)
    flat_gap = np.mean(
        np.abs(model.flatfield - S_ref) / np.maximum(S_ref, 1e-3)
    )
    assert flat_gap < 0.02, f"cross-implementation flatfield gap {flat_gap:.4f}"
    dark_gap = np.mean(np.abs(model.darkfield - D_ref))
    assert dark_gap < 5.0, f"cross-implementation darkfield gap {dark_gap:.2f}"
    # baselines: identical ordering and scale
    b_corr = np.corrcoef(model.baseline, b_ref)[0, 1]
    assert b_corr > 0.999, f"baseline correlation {b_corr:.4f}"


def test_transform_timelapse_subtracts_baseline():
    # sort_intensity=False: timelapse baselines must PAIR with the input
    # frames, which a sorted fit cannot guarantee (that combination now
    # raises — see test_timelapse_rejected_after_sorted_fit)
    imgs, *_ = synthetic_stack(n=8, h=32, w=32, seed=5)
    model = BaSiC(sort_intensity=False, max_reweight_iterations=2, working_size=32)
    model.fit(imgs)
    plain = model.transform(imgs)
    tl = model.transform(imgs, timelapse=True)
    np.testing.assert_allclose(
        plain - tl, np.broadcast_to(model.baseline[:, None, None], imgs.shape),
        rtol=1e-5,
    )
    with pytest.raises(ValueError):
        model.transform(imgs[:3], timelapse=True)


def test_matches_basicpy_golden_fixture():
    """Field-level gate against REAL BaSiCPy output.

    The fixture is generated by tests/golden/make_basicpy_fixture.py on a
    machine where BaSiCPy installs (it cannot in this image: no network) and
    committed as tests/fixtures/basicpy_golden.npz; until it lands this test
    SKIPS, and the moment it lands the gate arms with no code change.

    Tolerance: flatfields are compared after mean-normalization at 2% max
    absolute deviation (the LADMAP solver and BaSiCPy differ in working-size
    resampling and stopping rules; a systematic model-level deviation shows
    up far above 2%), darkfield at 5% of the dark dynamic range, baseline
    as Pearson r > 0.99 against BaSiCPy's (its absolute scale is coupled to
    the flat normalization)."""
    import os

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "fixtures",
        "basicpy_golden.npz",
    )
    if not os.path.exists(path):
        pytest.skip(
            "basicpy_golden.npz not generated yet "
            "(see tests/golden/make_basicpy_fixture.py)"
        )
    fx = np.load(path)
    images = fx["images"]
    for tag, get_dark in (("nodark", False), ("dark", True)):
        model = BaSiC(
            get_darkfield=get_dark,
            smoothness_flatfield=1.0,
            smoothness_darkfield=20,
            sort_intensity=True,
            max_reweight_iterations=35,
        ).fit(images)
        want_flat = fx[f"flatfield_{tag}"]
        got_flat = model.flatfield / model.flatfield.mean()
        want_flat = want_flat / want_flat.mean()
        assert np.abs(got_flat - want_flat).max() < 0.02, tag
        if get_dark:
            want_dark = fx[f"darkfield_{tag}"]
            scale = max(want_dark.max() - want_dark.min(), 1.0)
            assert np.abs(model.darkfield - want_dark).max() < 0.05 * scale
        b_got, b_want = model.baseline, fx[f"baseline_{tag}"]
        r = np.corrcoef(b_got, b_want)[0, 1]
        assert r > 0.99, (tag, r)


def test_timelapse_rejected_after_sorted_fit():
    """Review-derived: sort_intensity fits baselines on the SORTED stack;
    pairing with the input frames is destroyed, so the timelapse transform
    must refuse instead of silently misaligning."""
    rng = np.random.default_rng(0)
    imgs = (400 + rng.random((6, 24, 24)) * 100).astype(np.float32)
    m = BaSiC(sort_intensity=True, max_reweight_iterations=3)
    m.fit(imgs)
    with pytest.raises(ValueError, match="sort_intensity"):
        m.transform(imgs, timelapse=True)
