"""
Flat-field / dark-field shadow correction in JAX.

Mirrors reference filtering.py:227-414 (`normalize_image`, `invert_image`,
`get_hemisphere_flatfield`, `flatfield_correction`) with the same numerics:
- darkfield subtraction clamped at zero (x <= dark -> 0),
- division by the flatfield, baseline subtraction,
- clip to [0, 65535] and cast to uint16,
- flat normalization to [1, 2] with a float16 rounding step (filtering.py:248).

The array math is pure jax.numpy (fusable behind the destripe kernel in one
jit); the hemisphere lookup is host-side string/dict logic.
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

__all__ = [
    "sigmoid",
    "foreground_fraction",
    "normalize_image",
    "invert_image",
    "get_hemisphere_flatfield",
    "flatfield_correction",
]


def sigmoid(data):
    """Reference filtering.py:13-22."""
    return 1 / (1 + jnp.exp(-data))


def foreground_fraction(img, center: float, crossover: float):
    """Reference filtering.py:25-51."""
    z = (img - center) / crossover
    return sigmoid(z)


def normalize_image(images) -> jnp.ndarray:
    """Normalize image(s) into [1, 2] with a float16 rounding step
    (reference filtering.py:227-250). Accepts an array or list of arrays."""
    images = jnp.asarray(np.asarray(images))
    min_val = jnp.min(images)
    max_val = jnp.max(images)
    ratio = (images - min_val) / (max_val - min_val)
    return 1 + ratio.astype(jnp.float16)


def invert_image(image) -> jnp.ndarray:
    """Reference filtering.py:253-270."""
    image = jnp.asarray(np.asarray(image))
    return image.max() - image


def get_hemisphere_flatfield(
    input_tile_path: str,
    tile_config: dict,
    flatfields: List,
    zarr: Optional[bool] = True,
):
    """Pick the per-hemisphere flatfield for a tile from its X_Y name
    (reference filtering.py:273-335). Host-side logic, raises KeyError with
    the reference's messages when the tile is missing from the config."""
    if zarr:
        xy_folders = str(input_tile_path).split("_")
    else:
        xy_folders = str(input_tile_path).split("/")[-2].split("_")

    x_folder = xy_folders[0]
    y_folder = xy_folders[1]

    x_config = tile_config.get(x_folder)
    if x_config is None:
        raise KeyError(
            f"Please, check the tile config while trying to reach: {x_folder}"
        )

    brain_side = tile_config[x_folder].get(y_folder)
    if brain_side is None:
        raise KeyError(
            f"Please, check the tile config while trying to reach: {y_folder}"
        )

    return flatfields[brain_side]


def flatfield_correction(
    image_tiles,
    flatfield,
    darkfield,
    baseline=None,
):
    """Shadow correction (reference filtering.py:338-414): darkfield subtract
    clamped at 0, flatfield divide, baseline subtract, clip -> uint16.

    ``image_tiles`` may be (H, W) or (B, H, W); flat/dark are (H, W) or
    broadcastable. The darkfield is cropped to the image extent like the
    reference (filtering.py:377).
    """
    img = jnp.asarray(image_tiles)
    flat = jnp.asarray(flatfield)
    dark = jnp.asarray(darkfield)

    h, w = img.shape[-2:]
    dark = dark[..., :h, :w]
    if dark.shape[-2:] != (h, w):
        raise ValueError(
            "Please, check the shape of the darkfield. "
            f"Image: {img.shape} - Darkfield: {dark.shape}"
        )
    if flat.shape[-2:] != (h, w):
        raise ValueError(
            "Please, check the shape of the flatfield."
            f"Image: {img.shape} - Flatfield: {flat.shape}"
        )

    img = img.astype(jnp.float32)
    img = jnp.where(img <= dark, 0.0, img - dark)
    corrected = img / flat.astype(jnp.float32)
    if baseline is not None:
        baseline = jnp.asarray(baseline).astype(jnp.float32)
        corrected = corrected - baseline.reshape(
            baseline.shape + (1,) * (corrected.ndim - baseline.ndim)
        )
    return jnp.clip(corrected, 0, 65535).astype(jnp.uint16)
