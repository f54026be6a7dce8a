"""
Independent numpy/scipy re-derivation of the reference destripe math, used as
golden ground truth for the JAX device graph.

This is a test oracle only (not shipped). It mirrors the behavior of the
reference pipeline (code/aind_smartspim_destripe/filtering.py) but is written
from the underlying math with a deliberately different implementation style
(explicit folded-boundary analysis/synthesis matrices for the DWT instead of
convolutions) so that a systematic bug in the production kernels cannot hide.

Requires only numpy + scipy (scipy.fftpack provides the packed-format real FFT
the reference uses; PyWavelets/scikit-image are NOT available in this image,
so their semantics are re-derived here and cross-checked by construction).
"""

from __future__ import annotations

import numpy as np
from scipy import fftpack

from aind_smartspim_destripe_tpu.ops.wavelets import (
    dwt_coeff_len,
    dwt_max_level,
    idwt_len,
    wavelet,
)

# ---------------------------------------------------------------------------
# pywt-compatible DWT via explicit matrices
# ---------------------------------------------------------------------------


def _sym_index(i: int, n: int) -> int:
    """Fold an out-of-range index back into [0, n) using half-sample
    ("symmetric") reflection: ... x1 x0 | x0 x1 ... xn-1 | xn-1 xn-2 ..."""
    period = 2 * n
    i = i % period
    if i < 0:
        i += period
    return i if i < n else period - 1 - i


def analysis_matrix(n: int, filt: np.ndarray) -> np.ndarray:
    """(L, n) matrix computing one symmetric-mode analysis pass along an axis:
    out[k] = sum_i filt_rev[i] * x_ext[2k + 1 + i], with the extension folded
    into the matrix."""
    flen = len(filt)
    L = (n + flen - 1) // 2
    frev = filt[::-1]
    M = np.zeros((L, n))
    for k in range(L):
        for i in range(flen):
            src = 2 * k + 1 + i - (flen - 1)
            M[k, _sym_index(src, n)] += frev[i]
    return M


def synthesis_apply(coeff: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """One synthesis pass along the last axis: upsample by 2, full convolve
    with filt, crop [flen-2 : flen-2 + (2L - flen + 2)]."""
    flen = len(filt)
    L = coeff.shape[-1]
    up = np.zeros(coeff.shape[:-1] + (2 * L,), dtype=coeff.dtype)
    up[..., ::2] = coeff
    out = np.apply_along_axis(lambda r: np.convolve(r, filt, mode="full"), -1, up)
    lo = flen - 2
    return out[..., lo : lo + 2 * L - flen + 2]


def dwt2_ref(x: np.ndarray, name: str):
    wav = wavelet(name)
    dec_lo, dec_hi = wav.dec_lo, wav.dec_hi
    h, w = x.shape[-2:]
    My_lo = analysis_matrix(h, dec_lo)
    My_hi = analysis_matrix(h, dec_hi)
    Mx_lo = analysis_matrix(w, dec_lo)
    Mx_hi = analysis_matrix(w, dec_hi)
    a_y = np.einsum("ij,...jk->...ik", My_lo, x)
    d_y = np.einsum("ij,...jk->...ik", My_hi, x)
    aa = a_y @ Mx_lo.T
    ad = a_y @ Mx_hi.T
    da = d_y @ Mx_lo.T
    dd = d_y @ Mx_hi.T
    return aa, (da, ad, dd)  # (cA, (cH, cV, cD))


def idwt2_ref(ca: np.ndarray, details, name: str) -> np.ndarray:
    wav = wavelet(name)
    ch, cv, cd = details
    rec_lo, rec_hi = wav.rec_lo_arr, wav.rec_hi

    def syn_rows(arr, filt):  # synthesis along axis -2
        return np.swapaxes(synthesis_apply(np.swapaxes(arr, -1, -2), filt), -1, -2)

    # x-axis first then y-axis (order is immaterial for the separable product)
    lo_x = synthesis_apply(ca, rec_lo) + synthesis_apply(cv, rec_hi)
    hi_x = synthesis_apply(ch, rec_lo) + synthesis_apply(cd, rec_hi)
    return syn_rows(lo_x, rec_lo) + syn_rows(hi_x, rec_hi)


def wavedec2_ref(x: np.ndarray, name: str, level=None):
    wav = wavelet(name)
    h, w = x.shape[-2:]
    if level is None:
        level = min(dwt_max_level(h, wav.flen), dwt_max_level(w, wav.flen))
    coeffs = []
    approx = x
    for _ in range(level):
        approx, det = dwt2_ref(approx, name)
        coeffs.append(det)
    coeffs.append(approx)
    coeffs.reverse()
    return coeffs


def waverec2_ref(coeffs, name: str) -> np.ndarray:
    approx = coeffs[0]
    for det in coeffs[1:]:
        dh, dw = det[0].shape[-2:]
        approx = approx[..., :dh, :dw]
        approx = idwt2_ref(approx, det, name)
    return approx


# ---------------------------------------------------------------------------
# skimage-compatible Otsu threshold (256 bins)
# ---------------------------------------------------------------------------


def threshold_otsu_ref(image: np.ndarray, nbins: int = 256) -> float:
    counts, bin_edges = np.histogram(image.ravel(), bins=nbins)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2.0
    counts = counts.astype(float)
    weight1 = np.cumsum(counts)
    weight2 = np.cumsum(counts[::-1])[::-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean1 = np.cumsum(counts * bin_centers) / weight1
        mean2 = (np.cumsum((counts * bin_centers)[::-1]) / weight2[::-1])[::-1]
        variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    idx = np.nanargmax(variance12)
    return bin_centers[idx]


# ---------------------------------------------------------------------------
# The reference per-plane filter, end-to-end
# ---------------------------------------------------------------------------


def notch_ref(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n)
    return 1.0 - np.exp(-(x**2) / (2.0 * sigma**2))


def log_space_fft_filtering_ref(
    image: np.ndarray,
    wavelet_name: str = "db3",
    level=None,
    sigma: float = 64,
    max_threshold: float = 4,
) -> np.ndarray:
    """Mirror of reference filtering.py:log_space_fft_filtering (2-D path),
    including its quirks: packed-format rfft notch multiply, per-level sigma
    scaled by the level's row count over min(image.shape), and the
    exp(y) + 1.0 inverse (a +2 bias relative to a true round trip)."""
    img_log = np.log(1.0 + image)
    coeffs = wavedec2_ref(img_log, wavelet_name, level=level)
    approx, detail = coeffs[0], coeffs[1:]

    width_fraction = sigma / min(image.shape)

    filtered = [approx]
    for ch, cv, cd in detail:
        ch_sq = ch**2
        ch_power = np.sqrt(ch_sq)
        otsu_sqrt = np.sqrt(threshold_otsu_ref(ch_sq))
        threshold = min(max_threshold, otsu_sqrt)

        mask = ch_power > threshold
        foreground = ch * mask
        background = ch * (1 - mask)

        background_means = np.broadcast_to(
            np.median(background, axis=-1)[..., np.newaxis], ch.shape
        )
        background_inpainted = background + background_means * mask

        fft = fftpack.rfft(background_inpainted, axis=-1)
        s = fft.shape[0] * width_fraction
        g = np.broadcast_to(notch_ref(fft.shape[-1], s), fft.shape)
        background_filtered = fftpack.irfft(fft * g)

        ch_filtered = foreground + background_filtered * (1 - mask)
        filtered.append((ch_filtered, cv, cd))

    img_log_filtered = waverec2_ref(filtered, wavelet_name)
    return np.exp(img_log_filtered) + 1.0


def foreground_background_mean_ref(img: np.ndarray, threshold_mask: float = 0.3):
    """Mirror of filtering.py:get_foreground_background_mean (float16 sigmoid
    classifier, center=400, crossover=20)."""
    z = (img.astype(np.float16) - np.float16(400)) / np.float16(20)
    # float16 exp(-z) overflows to inf for z < ~-11 (pixels far below the
    # 400-count center); the sigmoid then saturates to exactly 0.0 — the
    # reference's own behavior (filtering.py:78 computes the same chain in
    # float16). Silence the benign RuntimeWarning so measured artifacts
    # (bench.py's driver-recorded tail) stay warning-free.
    with np.errstate(over="ignore"):
        f = 1 / (1 + np.exp(-z))
    cell_for = np.where(f > threshold_mask, 1.0, 0.0)
    fg = img[cell_for == 1]
    bg = img[cell_for == 0]
    fg_mean = fg.mean() if fg.size else 0.0
    bg_mean = bg.mean() if bg.size else 0.0
    return fg_mean, bg_mean, cell_for


def filter_stripes_ref(
    image: np.ndarray,
    no_cells_config: dict,
    cells_config: dict,
    microscope_high_int: float = 2700,
) -> np.ndarray:
    fg_mean, bg_mean, _ = foreground_background_mean_ref(image)
    cfg = (
        cells_config
        if (fg_mean > bg_mean and fg_mean > microscope_high_int)
        else no_cells_config
    )
    return log_space_fft_filtering_ref(
        image,
        wavelet_name=cfg.get("wavelet", "db3"),
        level=cfg.get("level"),
        sigma=cfg.get("sigma", 64),
        max_threshold=cfg.get("max_threshold", 4),
    )


def flatfield_correction_ref(
    image: np.ndarray,
    flatfield: np.ndarray,
    darkfield: np.ndarray,
    baseline=None,
) -> np.ndarray:
    """Mirror of filtering.py:flatfield_correction for a single 2-D plane."""
    img = np.array(image, dtype=np.float64)
    dark = darkfield[: img.shape[-2], : img.shape[-1]]
    img = np.where(img <= dark, 0.0, img - dark)
    if baseline is None:
        baseline = 0.0
    corrected = img / flatfield - baseline
    return np.clip(corrected, 0, 65535).astype(np.uint16)


def dual_band_ref(
    image: np.ndarray,
    fore_config: dict,
    back_config: dict,
    crossover: float = 100.0,
    threshold: float = -1.0,
    smooth_size: int = 17,
) -> np.ndarray:
    """Float64 dual-band destripe of one plane: the single-band filter per
    config, blended per pixel by the box-smoothed sigmoid foreground
    fraction centered on the plane's Otsu threshold (``threshold`` < 0) or
    on ``threshold``."""
    from scipy import ndimage

    img = np.asarray(image, dtype=np.float64)
    h, w = img.shape
    bands = [
        log_space_fft_filtering_ref(
            img,
            wavelet_name=cfg.get("wavelet", "db3"),
            level=cfg.get("level"),
            sigma=cfg.get("sigma", 64),
            max_threshold=cfg.get("max_threshold", 4),
        )[:h, :w]
        for cfg in (fore_config, back_config)
    ]
    center = (
        threshold_otsu_ref(img.astype(np.float32)) if threshold < 0
        else threshold
    )
    frac = 1.0 / (1.0 + np.exp(-(img - center) / crossover))
    frac = ndimage.uniform_filter(frac, size=smooth_size, mode="nearest")
    return bands[0] * frac + bands[1] * (1.0 - frac)
