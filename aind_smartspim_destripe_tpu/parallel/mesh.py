"""
Multi-chip scaling of the destripe pipeline via jax.sharding.

The reference's only parallelism is a single-node process pool over Z-blocks
(SURVEY.md section 2.4). The equivalent here: a device mesh where

- the ``z`` axis shards independent planes (data parallelism — the filter is
  per-plane, so the compute needs no cross-device communication),
- the ``y`` axis (optional) shards rows of each plane for the flat-field and
  statistics stages (sequence-parallel analog); global reductions
  (normalize_image min/max, classifier means, BaSiC norms) ride the
  device interconnect (NVLink on a multi-GPU host) via psum/pmin/pmax
  inside shard_map.

Plane geometry stays whole per device for the wavelet/FFT stages (a
1600x2000 fp32 plane is ~12.8 MB — far under device memory): batch the
embarrassingly-parallel axis, keep the transform axes local.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.filter import DestripePlan, destripe_batch
from ..ops.flatfield import flatfield_correction

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_planes",
    "sharded_destripe_step",
    "sharded_destripe_step_2d",
    "global_minmax",
    "sharded_normalize_image",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "z") -> Mesh:
    """1-D mesh over the plane axis (the scaling axis of this workload)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh_2d(
    n_devices: Optional[int] = None,
    tile_parallel: int = 2,
    axes: Tuple[str, str] = ("tile", "z"),
) -> Mesh:
    """2-D mesh (tile, z): outer axis shards independent tiles/channels (the
    axis that may span hosts), inner axis shards planes within a tile
    (host-local). Both are data axes — the filter needs no cross-device
    math — but the 2-D layout is what a multi-host run uses: tiles across
    hosts, planes across the devices of each host."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % tile_parallel:
        raise ValueError(f"{n} devices not divisible by tile_parallel={tile_parallel}")
    return Mesh(
        np.array(devices).reshape(tile_parallel, n // tile_parallel), axes
    )


def shard_planes(mesh: Mesh, batch: jax.Array, axis: str = "z") -> jax.Array:
    """Place a (B, H, W) batch with B sharded across the mesh."""
    return jax.device_put(batch, NamedSharding(mesh, P(axis, None, None)))


def sharded_destripe_step(
    mesh: Mesh,
    plan: DestripePlan,
    microscope_high_int: float = 2500.0,
    with_flatfield: bool = True,
    axis: str = "z",
):
    """Build the jitted multi-device step: (B, H, W) uint16 planes sharded over
    ``axis`` -> destripe -> shadow-correct -> uint16, plus a psum'd global
    min/max (the cross-device reduction used for normalization statistics).

    Flat/dark are replicated (they are per-tile constants). XLA partitions
    the per-plane compute with zero collectives; only the stats reduce
    across devices.
    """
    in_spec = NamedSharding(mesh, P(axis, None, None))
    rep = NamedSharding(mesh, P())
    consts = jax.device_put(plan.constants(), rep)

    @partial(
        jax.jit,
        static_argnums=(0,),
        out_shardings=(in_spec, rep),
    )
    def step(plan, images, flat, dark, consts):
        filtered = destripe_batch(plan, images, microscope_high_int, consts)
        if with_flatfield:
            out = flatfield_correction(filtered, flat, dark)
        else:
            # zarr-store parity: the reference writes the unclipped float
            # into a uint16 store, which wraps via numpy astype — match the
            # streaming pipeline's explicit wrap, not XLA's saturating cast
            out = jnp.mod(
                jnp.trunc(filtered).astype(jnp.int32), 65536
            ).astype(jnp.uint16)
        stats = jnp.stack([jnp.min(filtered), jnp.max(filtered)])
        return out, stats

    def run(images, flat, dark):
        images = jax.device_put(images, in_spec)
        flat = jax.device_put(jnp.asarray(flat), rep)
        dark = jax.device_put(jnp.asarray(dark), rep)
        return step(plan, images, flat, dark, consts)

    return run


def sharded_destripe_step_2d(
    mesh: Mesh,
    plan: DestripePlan,
    microscope_high_int: float = 2500.0,
    axes: Tuple[str, str] = ("tile", "z"),
):
    """Multi-tile step on a 2-D mesh: input (T, B, H, W) with tiles sharded
    over ``axes[0]`` and planes over ``axes[1]``; per-tile flats (T, H, W)
    shard over the tile axis only. Global per-tile min/max stats reduce over
    the z axis, demonstrating the two-level collective layout."""
    in_spec = NamedSharding(mesh, P(axes[0], axes[1], None, None))
    flat_spec = NamedSharding(mesh, P(axes[0], None, None))
    rep = NamedSharding(mesh, P())
    consts = jax.device_put(plan.constants(), rep)

    stats_spec = NamedSharding(mesh, P(axes[0], None))

    @partial(jax.jit, static_argnums=(0,), out_shardings=(in_spec, stats_spec))
    def step(plan, images, flats, darks, consts):
        t, b, h, w = images.shape
        flat_b = jnp.repeat(flats[:, None], b, axis=1).reshape(t * b, h, w)
        dark_b = jnp.repeat(darks[:, None], b, axis=1).reshape(t * b, h, w)
        filtered = destripe_batch(
            plan, images.reshape(t * b, h, w), microscope_high_int, consts
        )
        out = flatfield_correction(filtered, flat_b, dark_b).reshape(t, b, h, w)
        stats = jnp.stack(
            [
                jnp.min(filtered.reshape(t, b, h, w), axis=(1, 2, 3)),
                jnp.max(filtered.reshape(t, b, h, w), axis=(1, 2, 3)),
            ],
            axis=-1,
        )
        return out, stats

    def run(images, flats, darks):
        images = jax.device_put(images, in_spec)
        flats = jax.device_put(jnp.asarray(flats), flat_spec)
        darks = jax.device_put(jnp.asarray(darks), flat_spec)
        return step(plan, images, flats, darks, consts)

    return run


def global_minmax(mesh: Mesh, x: jax.Array, axis: str = "z") -> Tuple[jax.Array, jax.Array]:
    """Explicit shard_map collective: per-shard min/max reduced across the
    mesh axis."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis, None, None),
        out_specs=P(),
    )
    def mm(block):
        lo = jax.lax.pmin(jnp.min(block), axis)
        hi = jax.lax.pmax(jnp.max(block), axis)
        return jnp.stack([lo, hi])

    res = mm(x)
    return res[0], res[1]


def sharded_normalize_image(mesh: Mesh, images: jax.Array, axis: str = "z"):
    """normalize_image (reference filtering.py:227-250) over a sharded stack:
    global min/max via mesh collectives, then the local [1,2] float16 map."""
    x = shard_planes(mesh, images, axis)
    xf = x.astype(jnp.float32)  # one cast: two would allocate the f32 stack twice
    lo, hi = global_minmax(mesh, xf, axis)
    ratio = (xf - lo) / (hi - lo)
    return 1 + ratio.astype(jnp.float16)
