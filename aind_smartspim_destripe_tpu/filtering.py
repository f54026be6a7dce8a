"""
Drop-in filtering API (reference surface: code/aind_smartspim_destripe/
filtering.py). numpy in / numpy out; the heavy math runs on the device
graph in ``ops``.

A reference user can swap ``from aind_smartspim_destripe import filtering``
for ``from aind_smartspim_destripe_tpu import filtering`` and keep calling
``filter_stripes`` / ``log_space_fft_filtering`` / ``flatfield_correction``
with the same arguments.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .ops import fft_notch as _notch
from .ops import flatfield as _ff
from .ops.filter import log_space_fft_filtering as _log_space_fft_filtering

__all__ = [
    "sigmoid",
    "foreground_fraction",
    "get_foreground_background_mean",
    "notch",
    "gaussian_filter",
    "log_space_fft_filtering",
    "normalize_image",
    "invert_image",
    "get_hemisphere_flatfield",
    "flatfield_correction",
    "filter_stripes",
]


def sigmoid(data: np.ndarray):
    """1 / (1 + e^-x) (reference filtering.py:13-22)."""
    return 1 / (1 + np.exp(-data))


def foreground_fraction(img: np.ndarray, center: float, crossover: float):
    """Sigmoid foreground fraction (reference filtering.py:25-51)."""
    return sigmoid((img - center) / crossover)


def get_foreground_background_mean(
    img: np.ndarray, threshold_mask: Optional[float] = 0.3
) -> Tuple:
    """Foreground/background means + cell mask via the float16 sigmoid
    classifier (reference filtering.py:54-88)."""
    cell_for = foreground_fraction(img.astype(np.float16), 400, 20)
    cell_for = np.where(cell_for > threshold_mask, 1.0, 0.0)

    foreground = img[cell_for == 1]
    background = img[cell_for == 0]
    foreground_mean = foreground.mean() if foreground.size else 0.0
    background_mean = background.mean() if background.size else 0.0
    return foreground_mean, background_mean, cell_for


def notch(n: int, sigma: float) -> np.ndarray:
    """1-D Gaussian notch (reference filtering.py:91-115)."""
    return _notch.notch(n, sigma)


def gaussian_filter(shape: tuple, sigma: float) -> np.ndarray:
    """Broadcast notch (reference filtering.py:118-136)."""
    return _notch.gaussian_filter(shape, sigma)


def log_space_fft_filtering(
    input_image: np.ndarray,
    wavelet: Optional[str] = "db3",
    level: Optional[int] = 0,
    sigma: Optional[int] = 64,
    max_threshold: Optional[int] = 4,
) -> np.ndarray:
    """Log-space wavelet-FFT destripe of one plane (reference
    filtering.py:139-224), device-executed."""
    return _log_space_fft_filtering(
        input_image, wavelet=wavelet, level=level, sigma=sigma,
        max_threshold=max_threshold,
    )


def normalize_image(images: List[np.ndarray]) -> np.ndarray:
    """Normalize to [1, 2] with float16 rounding (reference filtering.py:227-250)."""
    return np.asarray(_ff.normalize_image(images))


def invert_image(image: np.ndarray) -> np.ndarray:
    """max - x (reference filtering.py:253-270)."""
    return np.asarray(_ff.invert_image(image))


def get_hemisphere_flatfield(
    input_tile_path: str,
    tile_config: dict,
    flatfields: List[np.ndarray],
    zarr: Optional[bool] = True,
) -> np.ndarray:
    """Hemisphere flat lookup by tile X_Y name (reference filtering.py:273-335)."""
    return _ff.get_hemisphere_flatfield(input_tile_path, tile_config, flatfields, zarr)


def flatfield_correction(
    image_tiles,
    flatfield: np.ndarray,
    darkfield: np.ndarray,
    baseline: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Shadow correction -> uint16 (reference filtering.py:338-414)."""
    return np.asarray(
        _ff.flatfield_correction(np.asarray(image_tiles), flatfield, darkfield, baseline)
    )


def filter_stripes(
    image: np.ndarray,
    input_tile_path: str = None,
    no_cells_config: dict = None,
    cells_config: dict = None,
    shadow_correction: Optional[dict] = None,
    microscope_high_int: Optional[int] = 2700,
    dual_band: Optional[dict] = None,
) -> np.ndarray:
    """Classify a plane (cells / no-cells), destripe with the matching
    config, optionally shadow-correct (reference filtering.py:417-491).

    ``dual_band``: pass a dict (``{}`` for defaults, optionally with
    ``crossover`` / ``threshold``) to skip the classifier and blend BOTH
    configs per pixel instead (the dual-band mode, ops/dual_band.py):
    cells_config filters the foreground, no_cells_config the background."""
    no_cells_config = no_cells_config or {}
    cells_config = cells_config or {}

    if dual_band is not None:
        from .ops.dual_band import dual_band_destripe_configs

        filtered_image = dual_band_destripe_configs(
            image,
            cells_config,
            no_cells_config,
            crossover=float(dual_band.get("crossover", 100.0)),
            threshold=float(dual_band.get("threshold", -1.0)),
        )
    else:
        fore_mean, back_mean, _ = get_foreground_background_mean(image)
        if fore_mean > back_mean and fore_mean > microscope_high_int:
            filtered_image = log_space_fft_filtering(input_image=image, **cells_config)
        else:
            filtered_image = log_space_fft_filtering(input_image=image, **no_cells_config)

    if shadow_correction is not None:
        retrospective = shadow_correction.get("retrospective")
        flatfield = shadow_correction.get("flatfield")
        darkfield = shadow_correction.get("darkfield")
        tile_config = shadow_correction.get("tile_config")

        if not retrospective:
            # The reference calls this with the zarr=True default even for
            # filesystem plane paths (filtering.py:478-482), where the
            # X_Y tile name lives in the PARENT directory and the default
            # parse reads garbage folders — a latent reference bug its
            # zarr pipeline never hits. Infer the shape instead: a bare
            # tile name has no separator, a plane file path does.
            p = str(input_tile_path)
            flatfield = get_hemisphere_flatfield(
                input_tile_path=input_tile_path,
                tile_config=tile_config,
                flatfields=flatfield,
                zarr=("/" not in p and os.sep not in p),
            )

        filtered_image = flatfield_correction(
            image_tiles=filtered_image,
            flatfield=flatfield,
            darkfield=darkfield,
            baseline=None,
        )

    return filtered_image
