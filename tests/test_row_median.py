"""Row medians of the inpainting stage (ops/filter._row_median): exact
against numpy at every scale and shape, with zeros, ties, the masked
background formulation of the filter, and even/ragged row lengths."""

import numpy as np
import pytest

import jax.numpy as jnp

from aind_smartspim_destripe_tpu.ops.filter import _row_median


@pytest.mark.parametrize(
    "shape", [(3, 10, 1002), (2, 7, 13), (5, 101), (4, 8, 16), (1, 1, 2)]
)
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_exact_vs_numpy(shape, scale):
    rng = np.random.default_rng(hash((shape, scale)) % 2**31)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x[..., 0] *= -1  # mixed signs
    got = np.asarray(_row_median(jnp.asarray(x)))
    want = np.median(x, axis=-1, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_with_zeros_and_duplicates():
    x = np.array(
        [[0.0, -0.0, 1.0, 1.0, -2.0], [3.0, 3.0, 3.0, 3.0, 3.0]], np.float32
    )
    got = np.asarray(_row_median(jnp.asarray(x)))
    want = np.median(x, axis=-1, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_masked_background_matches_reference_formulation():
    """The filter takes the median of ``ch * (1 - mask)`` (stripe pixels
    zeroed, reference filtering.py:195-201)."""
    rng = np.random.default_rng(9)
    x = rng.normal(scale=3.0, size=(4, 37, 203)).astype(np.float32)
    thr = np.array([0.5, 2.0, 0.0, 100.0], np.float32)
    mask = (np.sqrt(x * x) > thr[:, None, None]).astype(np.float32)
    background = x * (1 - mask)
    got = np.asarray(_row_median(jnp.asarray(background)))
    want = np.median(background, axis=-1, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_masked_even_and_ragged():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 9, 130)).astype(np.float32)  # even n
    thr = np.array([0.7, 0.1], np.float32)
    background = x * (1 - (np.sqrt(x * x) > thr[:, None, None]))
    got = np.asarray(_row_median(jnp.asarray(background)))
    want = np.median(background, axis=-1, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)
