"""
Otsu threshold matching skimage.filters.threshold_otsu semantics
(reference use: code/aind_smartspim_destripe/filtering.py:191, 256-bin default).

Implemented as a fused broadcast-compare histogram: XLA reduces the (N, 256)
comparison on the fly without materializing it, then the inter-class
variance argmax runs over the tiny 256-bin arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "histogram_fixed_bins",
    "threshold_otsu",
    "threshold_otsu_batch",
]


def histogram_fixed_bins(x: jnp.ndarray, nbins: int = 256):
    """Histogram of ``x`` (flattened) over [min(x), max(x)] with ``nbins``
    equal bins, matching numpy.histogram's closed right-most bin. Returns
    (counts float32 (nbins,), bin_centers (nbins,))."""
    flat = x.reshape(-1)
    lo = jnp.min(flat)
    hi = jnp.max(flat)
    span = hi - lo
    # Guard degenerate constant input; caller decides what to do with it.
    safe_span = jnp.where(span > 0, span, 1.0)
    idx = jnp.floor((flat - lo) / safe_span * nbins).astype(jnp.int32)
    idx = jnp.clip(idx, 0, nbins - 1)  # x == max falls in the last bin
    # Fused broadcast-compare-reduce: XLA streams this without materializing
    # the (N, nbins) intermediate (nbins <= 256, so the uint8 cast is
    # lossless and the compare operands stay narrow).
    idx8 = idx.astype(jnp.uint8)
    bins = jnp.arange(nbins, dtype=jnp.uint8)
    counts = jnp.sum(
        (idx8[:, None] == bins[None, :]).astype(jnp.float32), axis=0
    )
    edges = lo + span * jnp.arange(nbins + 1, dtype=x.dtype) / nbins
    centers = (edges[:-1] + edges[1:]) / 2.0
    return counts, centers


def threshold_otsu(x: jnp.ndarray, nbins: int = 256) -> jnp.ndarray:
    """Scalar Otsu threshold (bin center maximizing inter-class variance),
    numerically following skimage's implementation."""
    counts, centers = histogram_fixed_bins(x, nbins)
    weight1 = jnp.cumsum(counts)
    weight2 = jnp.cumsum(counts[::-1])[::-1]
    mean1 = jnp.cumsum(counts * centers) / jnp.maximum(weight1, 1e-30)
    mean2 = (jnp.cumsum((counts * centers)[::-1]) / jnp.maximum(weight2[::-1], 1e-30))[
        ::-1
    ]
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    idx = jnp.argmax(variance12)
    th = centers[idx]
    # Degenerate constant input: return the constant itself.
    return jnp.where(jnp.max(x) > jnp.min(x), th, jnp.min(x))


def threshold_otsu_batch(x: jnp.ndarray, nbins: int = 256) -> jnp.ndarray:
    """Per-plane Otsu thresholds for a (B, H, W) batch: :func:`threshold_otsu`
    vmapped over the leading axis. Integer planes (raw uint16) are binned in
    float32, which represents every 16-bit value exactly."""
    xv = (
        x if jnp.issubdtype(x.dtype, jnp.floating)
        else x.astype(jnp.float32)
    )
    return jax.vmap(lambda p: threshold_otsu(p, nbins))(xv)
