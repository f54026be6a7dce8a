"""
Dual-band wavelet-FFT destripe (BASELINE config 2).

The reference README describes a "dual-band" mode (README.md:7-8) whose code
survives only as vestigial helpers (``foreground_fraction``,
filtering.py:25-51) — the shipped pipeline applies a single log-space filter.
This module builds the dual-band variant from those vestiges, following the
pystripe lineage the helpers come from: filter the plane with a foreground
sigma and a background sigma, then blend per pixel by a smoothed sigmoid
foreground fraction, so bright structure (cells) gets the gentler notch and
background gets the aggressive one.

Structure: both bands genuinely share ONE wavelet decomposition —
``destripe_batch(plan, images, dual=True)`` runs analysis, Otsu, and the
inpainting statistics once per plane and doubles only the per-plane notch
products and the delta synthesis (ops/filter.py). The blend
(:func:`blend_bands_xla`) is a sigmoid -> box smooth -> mix chain that XLA
fuses.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .filter import FilterConfig, build_plan, destripe_batch, device_constants
from .otsu import threshold_otsu_batch

__all__ = [
    "dual_band_destripe_batch",
    "dual_band_filtering",
    "dual_band_destripe_configs",
]


def _smooth(img: jax.Array, radius: int = 8) -> jax.Array:
    """Separable edge-replicated box smoothing of the blend mask: one
    stride-1 ``lax.reduce_window`` sum per axis."""
    if radius <= 0:
        return img
    k = 2 * radius + 1

    def blur_axis(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (radius, radius)
        xp = jnp.pad(x, pad, mode="edge")
        win = [1] * x.ndim
        win[axis] = k
        s = jax.lax.reduce_window(
            xp, 0.0, jax.lax.add, tuple(win), (1,) * x.ndim, "VALID"
        )
        return s / k

    return blur_axis(blur_axis(img, -1), -2)


def check_crossover(crossover) -> None:
    """crossover = 0 makes the sigmoid 0/0 = NaN at the center pixel and a
    negative width silently swaps the bands; fail loudly at every surface
    (configs dict, CLI, env, plane-batch AND row-sharded entries) that
    funnels here."""
    if not isinstance(crossover, jax.core.Tracer) and not crossover > 0:
        raise ValueError(f"dual-band crossover must be > 0, got {crossover}")


def dual_band_destripe_batch(
    plan,
    images: jax.Array,
    crossover: float = 100.0,
    threshold: float = -1.0,
    smooth_radius: int = 8,
    consts=None,
) -> jax.Array:
    """Blend two destripe bands per pixel from one shared decomposition.

    - ``plan``: a dual plan whose ``cells`` slot holds the gentle foreground
      config (e.g. sigma=256) and ``no_cells`` the aggressive background
      config (e.g. sigma=128) — build with :func:`_dual_plan`,
    - ``threshold``: sigmoid center; < 0 means per-plane Otsu,
    - ``crossover``: sigmoid width (reference foreground_fraction semantics).
    """
    check_crossover(crossover)
    b = images.shape[0]
    both = destripe_batch(plan, images, -jnp.inf, consts, dual=True)
    with jax.named_scope("blend"):
        otsu_centers = threshold_otsu_batch(images)
        centers = jnp.where(
            threshold < 0, otsu_centers, jnp.full_like(otsu_centers, threshold)
        )
        return blend_bands_xla(
            images, both[:b], both[b:], centers, crossover, smooth_radius
        )


def blend_bands_xla(
    x: jax.Array,
    fore: jax.Array,
    back: jax.Array,
    centers: jax.Array,
    crossover,
    smooth_radius: int = 8,
) -> jax.Array:
    """The dual-band blend: per-plane sigmoid foreground fraction ->
    edge-replicated box smooth -> band mix."""
    x = x.astype(jnp.float32)  # uint16 callers: sigmoid math is float
    frac = 1.0 / (1.0 + jnp.exp(-(x - centers[:, None, None]) / crossover))
    frac = _smooth(frac, smooth_radius)
    return fore * frac + back * (1.0 - frac)


@lru_cache(maxsize=8)
def _dual_plan(h, w, wavelet, level, sigma_fore, sigma_back, max_threshold):
    """One plan carrying both bands: cells slot = foreground (gentle sigma),
    no_cells slot = background (aggressive sigma). Sharing the plan is what
    lets destripe_batch(dual=True) share the decomposition — both configs
    must (and do) agree on wavelet and level."""
    return build_plan(
        h, w,
        FilterConfig(wavelet=wavelet, level=level, sigma=sigma_fore,
                     max_threshold=max_threshold),
        FilterConfig(wavelet=wavelet, level=level, sigma=sigma_back,
                     max_threshold=max_threshold),
    )


@partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=("crossover", "smooth_radius"),
)
def _jitted_dual(plan, images, threshold, consts, crossover=100.0,
                 smooth_radius=8):
    return dual_band_destripe_batch(
        plan, images, crossover, threshold, smooth_radius, consts
    )


@lru_cache(maxsize=8)
def _plan_from_config_items(h, w, cells_items, no_cells_items):
    return build_plan(
        h, w,
        FilterConfig.from_dict(dict(cells_items)),
        FilterConfig.from_dict(dict(no_cells_items)),
    )


def dual_band_destripe_configs(
    images: np.ndarray,
    cells_config: dict,
    no_cells_config: dict,
    crossover: float = 100.0,
    threshold: float = -1.0,
) -> np.ndarray:
    """Dual-band destripe from the orchestrators' config-dict pair.

    ``cells_config`` is the foreground band (gentle sigma, applied to bright
    structure), ``no_cells_config`` the background band — the same dicts the
    single-band classifier paths take (zarr_destriper/destriper parameters),
    so production configs switch modes without reshaping. Both must share
    wavelet and level (enforced by :func:`..ops.filter.build_plan`).
    One plane or a (B, H, W) batch; float32 out.
    """
    img = np.asarray(images)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    h, w = img.shape[-2:]
    plan = _plan_from_config_items(
        h, w,
        tuple(sorted((cells_config or {}).items())),
        tuple(sorted((no_cells_config or {}).items())),
    )
    out = np.asarray(
        _jitted_dual(
            plan,
            jnp.asarray(_as_device_dtype(img)),
            float(threshold),
            device_constants(plan),
            crossover=float(crossover),
        )
    )
    return out[0] if squeeze else out


def _as_device_dtype(img: np.ndarray) -> np.ndarray:
    """uint16 ships raw (half the host-to-device bytes; the graph casts on
    the fly); anything else goes to float32."""
    if img.dtype == np.uint16:
        return img
    return img.astype(np.float32, copy=False)


def dual_band_filtering(
    input_image: np.ndarray,
    sigma: Tuple[float, float] = (256.0, 128.0),
    wavelet: str = "db3",
    level: Optional[int] = None,
    max_threshold: float = 12.0,
    crossover: float = 100.0,
    threshold: float = -1.0,
) -> np.ndarray:
    """Host convenience wrapper: one plane or a (B, H, W) batch."""
    img = np.asarray(input_image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    h, w = img.shape[-2:]
    plan = _dual_plan(
        h, w, wavelet, level, float(sigma[0]), float(sigma[1]), float(max_threshold)
    )
    out = np.asarray(
        _jitted_dual(
            plan,
            jnp.asarray(_as_device_dtype(img)),
            float(threshold),
            device_constants(plan),
            crossover=float(crossover),
        )
    )
    return out[0] if squeeze else out
