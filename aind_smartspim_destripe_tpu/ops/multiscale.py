"""
Multiscale pyramid reduction: 2x2x2 windowed mean on device.

Equivalent of the reference's xarray_multiscale.reducers.windowed_mean with
``preserve_dtype=True`` (zarr_destriper.py:399-405): the input is cropped to
dimensions divisible by the scale factors, averaged over non-overlapping
windows, and cast back to the input dtype (truncation for integers).

On device this is a single fused reduce — no Dask cluster required; the
runtime pipeline applies it slab-by-slab while streaming.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["windowed_mean", "windowed_mean_np"]


@partial(jax.jit, static_argnames=("factors", "preserve_dtype"))
def windowed_mean(
    x: jax.Array,
    factors: Tuple[int, ...] = (2, 2, 2),
    preserve_dtype: bool = True,
) -> jax.Array:
    """Non-overlapping windowed mean over the trailing ``len(factors)`` axes
    (leading axes pass through). Crops to divisible extents.

    Implemented as a native ``lax.reduce_window`` (window == stride) rather
    than the split-every-axis 6-D reshape+mean: the reshape formulation's
    layout assignment blows up XLA's compiler memory on production-size
    slabs ((64,1600,2000) crashed an earlier backend's compiler), while the
    reduce-window graph compiles in seconds with identical f32-mean
    numerics."""
    nf = len(factors)
    lead = x.ndim - nf
    cropped = tuple(
        (s // f) * f for s, f in zip(x.shape[lead:], factors)
    )
    sl = (slice(None),) * lead + tuple(slice(0, c) for c in cropped)
    xf = x[sl].astype(jnp.float32)
    win = (1,) * lead + tuple(factors)
    s = jax.lax.reduce_window(xf, 0.0, jax.lax.add, win, win, "VALID")
    y = s / np.float32(np.prod(factors))
    if preserve_dtype:
        y = y.astype(x.dtype)
    return y


def windowed_mean_np(x: np.ndarray, factors=(2, 2, 2), preserve_dtype=True):
    """numpy twin (host-side fallback / test oracle)."""
    nf = len(factors)
    lead = x.shape[: x.ndim - nf]
    tail = x.shape[x.ndim - nf :]
    cropped = tuple((s // f) * f for s, f in zip(tail, factors))
    sl = (slice(None),) * len(lead) + tuple(slice(0, c) for c in cropped)
    x = x[sl]
    new_shape = list(lead)
    red_axes = []
    for i, (c, f) in enumerate(zip(cropped, factors)):
        new_shape.extend([c // f, f])
        red_axes.append(len(lead) + 2 * i + 1)
    y = x.reshape(new_shape).astype(np.float64).mean(axis=tuple(red_axes))
    return y.astype(x.dtype) if preserve_dtype else y
