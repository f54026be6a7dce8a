"""The notch stage of the per-band filter (ops/filter._filter_level: stripe
mask -> row-median inpainting -> per-plane notch product -> re-insert the
stripe pixels) against a float64 re-derivation of its contract."""

import numpy as np
import pytest

import jax.numpy as jnp

from aind_smartspim_destripe_tpu.ops import fft_notch
from aind_smartspim_destripe_tpu.ops.filter import _filter_level


def _case(B=3, h=96, w=250, seed=0):
    rng = np.random.default_rng(seed)
    ch = (rng.normal(size=(B, h, w)) * 2.0).astype(np.float32)
    bc = fft_notch.packed_notch_matrix(w, 12.0).astype(np.float32)
    bn = fft_notch.packed_notch_matrix(w, 40.0).astype(np.float32)
    cells = np.array([True, False, True][:B])
    return ch, bc, bn, cells


def _ref_delta(ch, bc, bn, thr, cells):
    """filter(ch) - ch in float64 for given per-plane thresholds."""
    out = np.empty(ch.shape, np.float64)
    for b in range(ch.shape[0]):
        x = ch[b].astype(np.float64)
        stripes = np.sqrt((ch[b] * ch[b]).astype(np.float32)) > thr[b]
        bg = np.where(stripes, 0.0, x)
        med = np.median(bg, axis=-1, keepdims=True)
        inp = np.where(stripes, med, x)
        op = (bc if cells[b] else bn).astype(np.float64)
        out[b] = np.where(stripes, 0.0, inp @ op.T - x)
    return out


def _delta(ch, bc, bn, cells, thr_cells, thr_no, otsu=None):
    cat = np.concatenate([bc.T, bn.T], axis=1)
    out = _filter_level(
        jnp.asarray(ch), jnp.asarray(cells), jnp.asarray(cat),
        thr_cells, thr_no,
        otsu_sqrt=None if otsu is None else jnp.asarray(otsu),
    )
    return np.asarray(out) - ch


def test_delta_matches_float64_contract():
    ch, bc, bn, cells = _case()
    otsu = np.array([1.5, 0.8, 2.5], np.float32)
    got = _delta(ch, bc, bn, cells, 100.0, 100.0, otsu=otsu)
    want = _ref_delta(ch, bc, bn, otsu, cells)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_stripe_pixels_keep_their_value():
    """Pixels above the threshold are foreground: filter(ch) == ch there
    exactly (reference filtering.py:215)."""
    ch, bc, bn, cells = _case()
    otsu = np.array([1.5, 0.8, 2.5], np.float32)
    got = _delta(ch, bc, bn, cells, 100.0, 100.0, otsu=otsu)
    stripes = np.abs(ch) > otsu[:, None, None]
    assert np.all(got[stripes] == 0.0)


def test_max_threshold_caps_otsu():
    """threshold = min(max_threshold of the plane's config, sqrt(otsu))."""
    ch, bc, bn, cells = _case()
    otsu = np.array([5.0, 5.0, 5.0], np.float32)
    got = _delta(ch, bc, bn, cells, 1.0, 2.0, otsu=otsu)
    thr = np.where(cells, 1.0, 2.0)
    want = _ref_delta(ch, bc, bn, thr, cells)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_per_plane_operator_selection():
    """Each plane is notched with its own config's operator only."""
    ch, bc, bn, _ = _case()
    otsu = np.full(3, 100.0, np.float32)  # no stripe pixels
    for cells in (np.array([True] * 3), np.array([False] * 3)):
        got = _delta(ch, bc, bn, cells, 100.0, 100.0, otsu=otsu) + ch
        op = bc if cells[0] else bn
        want = ch.astype(np.float64) @ op.astype(np.float64).T
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("w", [256, 250])
def test_otsu_threshold_in_graph(w):
    """Without a precomputed threshold the stage computes sqrt(otsu(ch^2))
    itself, aligned (256) and ragged (250) widths."""
    from tests.golden import numpy_ref as G

    ch, bc, bn, cells = _case(B=2, h=64, w=w, seed=3)
    cells = cells[:2]
    got = _delta(ch, bc, bn, cells, 100.0, 100.0)
    thr = np.array([np.sqrt(G.threshold_otsu_ref(c * c)) for c in ch])
    want = _ref_delta(ch, bc, bn, thr, cells)
    stripes = np.abs(ch) > thr[:, None, None]
    # a pixel within float rounding of the threshold may classify either
    # way; everything else matches the contract
    near = np.abs(np.abs(ch) - thr[:, None, None]) < 1e-3
    np.testing.assert_allclose(got[~near], want[~near], rtol=2e-4,
                               atol=2e-4)
    assert stripes.any() and (~stripes).any()
