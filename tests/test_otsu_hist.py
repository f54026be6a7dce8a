"""256-bin histograms and per-plane Otsu thresholds of ops/otsu.py against
numpy.histogram and the float64 Otsu oracle: shapes, position invariance,
constant planes, squared (filter) input, uint16 ingest and the narrow
production level-2 band."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aind_smartspim_destripe_tpu.ops.otsu import (
    histogram_fixed_bins,
    threshold_otsu,
    threshold_otsu_batch,
)
from tests.golden import numpy_ref as G


def _np_counts(plane):
    counts, _ = np.histogram(plane.ravel(), bins=256)
    return counts.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 128), (3, 13, 130), (1, 64, 100)])
def test_histogram_matches_numpy(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) ** 2).astype(np.float32)
    for b in range(shape[0]):
        got, _ = histogram_fixed_bins(jnp.asarray(x[b]))
        got = np.asarray(got)
        assert got.sum() == x[b].size
        # numpy bins in float64; a value within an ulp of an edge may fall
        # one bin over, so compare bin by bin with a 1-count allowance
        assert np.abs(got - _np_counts(x[b])).max() <= 1


@pytest.mark.parametrize("rows", [8, 24, 64, 1024])
def test_histogram_position_invariant(rows):
    """Binning depends only on the values: any reshaping of a plane's
    pixels (rows larger than the plane included) gives identical counts."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(52, 130)) ** 2).astype(np.float32)
    flat = x.reshape(-1)
    pad = (-flat.size) % rows
    # pad with copies of the first value: the counts of that bin grow by
    # exactly `pad`, nothing else moves
    shaped = np.concatenate([flat, np.full(pad, flat[0])]).reshape(rows, -1)
    want, _ = histogram_fixed_bins(jnp.asarray(x))
    got, _ = histogram_fixed_bins(jnp.asarray(shaped))
    want = np.array(want)
    got = np.array(got)
    b0 = int(np.argmax(got - want)) if pad else 0
    want[b0] += pad
    np.testing.assert_array_equal(got, want)


def test_histogram_narrow_production_level2():
    """The production level-2 detail band (204 x 254, ragged rows and
    lanes) bins like numpy."""
    rng = np.random.default_rng(5)
    x = rng.normal(scale=3.0, size=(3, 204, 254)).astype(np.float32)
    for b in range(3):
        got, _ = histogram_fixed_bins(jnp.asarray(x[b]))
        assert np.abs(np.asarray(got) - _np_counts(x[b])).max() <= 1
        assert np.asarray(got).sum() == x[b].size


def test_threshold_otsu_batch_matches_single():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 32, 40)) ** 2).astype(np.float32)
    got = np.asarray(threshold_otsu_batch(jnp.asarray(x)))
    want = np.asarray(jax.vmap(threshold_otsu)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_constant_plane():
    x = jnp.full((2, 8, 128), 5.0)
    th = np.asarray(threshold_otsu_batch(x))
    np.testing.assert_allclose(th, [5.0, 5.0])


def test_squared_input_matches_float64_oracle():
    """The filter's Otsu input is ch**2 (reference filtering.py:191)."""
    rng = np.random.default_rng(11)
    x = rng.normal(scale=4.0, size=(3, 21, 203)).astype(np.float32)
    got = np.asarray(threshold_otsu_batch(jnp.asarray(x * x)))
    for b in range(3):
        want = G.threshold_otsu_ref(x[b] * x[b])
        span = float((x[b] * x[b]).max() - (x[b] * x[b]).min())
        assert abs(got[b] - want) <= span / 256 * 1.01  # within one bin


def test_histogram_uint16_ingest_bitexact():
    """Raw uint16 planes bin exactly like their float32 cast (every 16-bit
    value is exactly representable)."""
    rng = np.random.default_rng(12)
    for shape in ((37, 301), (50, 200)):
        x16 = rng.integers(0, 65536, size=shape, dtype=np.uint16)
        a, ca = histogram_fixed_bins(jnp.asarray(x16.astype(np.float32)))
        b_, cb = histogram_fixed_bins(
            jnp.asarray(x16).astype(jnp.float32)
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
        assert np.asarray(a).sum() == x16.size


def test_threshold_otsu_batch_uint16_matches_f32():
    rng = np.random.default_rng(13)
    x16 = rng.integers(0, 5000, size=(3, 40, 260), dtype=np.uint16)
    got = np.asarray(threshold_otsu_batch(jnp.asarray(x16)))
    want = np.asarray(
        threshold_otsu_batch(jnp.asarray(x16.astype(np.float32)))
    )
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        ref = G.threshold_otsu_ref(x16[b].astype(np.float32))
        assert abs(got[b] - ref) <= (x16[b].max() - x16[b].min()) / 256
