"""
2-D discrete wavelet transform (DWT/IDWT) in JAX, pywt-compatible semantics.

The reference pipeline decomposes every image plane with
``pywt.wavedec2(img, wavelet="db3", level=None)`` using the default
"symmetric" (half-sample) signal extension, filters the horizontal-detail
bands, and reconstructs with ``pywt.waverec2`` (reference:
code/aind_smartspim_destripe/filtering.py:176,221). This module rebuilds that
contract as matmuls on the device:

- Daubechies filter banks are generated by spectral factorization (no PyWavelets
  dependency) and verified against the published db1..db4 coefficients in tests.
- One DWT level = a single strided 2-D convolution with 4 separable kernels
  (outer products of the 1-D lo/hi filters).
- One IDWT level = a single input-dilated ("transposed") 2-D convolution.
- All shapes are static: the per-level shape ladder is a pure function of the
  input geometry, so the whole multi-level transform jits cleanly.

pywt conventions replicated exactly:
- "symmetric" half-sample extension by (filter_len - 1) samples per side,
- analysis output length ``(n + filter_len - 1) // 2`` per axis,
- synthesis output length ``2*n - filter_len + 2`` per axis, with waverec2's
  crop-by-one rule when the approximation is one sample larger than the next
  level's detail bands,
- detail ordering ``(cH, cV, cD)`` where cH is highpass along y / lowpass
  along x (pywt key "da"), i.e. the band that captures horizontal streaks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Wavelet",
    "wavelet",
    "dwt_max_level",
    "dwt_coeff_len",
    "idwt_len",
    "wavedec2_shapes",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
]


# ---------------------------------------------------------------------------
# Filter-bank construction
# ---------------------------------------------------------------------------


def _daubechies_scaling(n_moments: int) -> np.ndarray:
    """Minimum-phase Daubechies scaling filter with ``n_moments`` vanishing
    moments (filter length ``2 * n_moments``), normalized so it sums to
    sqrt(2). Built by spectral factorization of the Daubechies half-band
    polynomial: keep the roots strictly inside the unit circle."""
    if n_moments == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)

    n = n_moments
    # P(y) = sum_k C(n-1+k, k) y^k ; |L(w)|^2 = P(sin^2(w/2)).
    # Factor in Y-SPACE: the degree-(n-1) P(y) with exact integer binomial
    # coefficients is far better conditioned than the degree-(2n-2)
    # z-space polynomial Q(z) = z^{n-1} P((2 - z - 1/z)/4), whose companion
    # matrix loses ~7 digits by order 16 and ~11 by order 20. Each y-root
    # is Newton-polished against the exact coefficients, then mapped to
    # the |z| < 1 branch of z^2 - (2 - 4y) z + 1 = 0 in closed form
    # (precision gated in test_db_high_orders_full_characterization).
    p_desc = np.array(
        [math.comb(n - 1 + k, k) for k in range(n)], np.complex128
    )[::-1]
    y_roots = np.roots(p_desc)
    dp = p_desc[:-1] * np.arange(len(p_desc) - 1, 0, -1)
    for _ in range(4):
        d = np.polyval(dp, y_roots)
        step = np.where(
            d != 0, np.polyval(p_desc, y_roots) / np.where(d == 0, 1, d), 0
        )
        y_roots = y_roots - step
    w = 1.0 - 2.0 * y_roots
    s = np.sqrt(w * w - 1.0)
    z_a, z_b = w + s, w - s
    inside = np.where(np.abs(z_a) < np.abs(z_b), z_a, z_b)  # |z| < 1 branch
    if inside.size != n - 1:  # pragma: no cover - numeric safety net
        raise RuntimeError(f"spectral factorization failed for db{n}")

    ell = np.array([1.0 + 0.0j])
    for r in inside:
        ell = np.convolve(ell, [1.0, -r])
    ell = np.real_if_close(ell, tol=1e6)
    if np.iscomplexobj(ell):  # pragma: no cover
        ell = ell.real

    h = np.array([1.0])
    for _ in range(n):
        h = np.convolve(h, [0.5, 0.5])
    h = np.convolve(h, ell)
    h = h * (np.sqrt(2.0) / h.sum())
    # Minimum phase: energy front-loaded (pywt ordering, e.g. db3 rec_lo
    # starts with 0.3327).
    if abs(h[0]) < abs(h[-1]):
        h = h[::-1]
    return np.ascontiguousarray(h, dtype=np.float64)


@dataclass(frozen=True)
class Wavelet:
    """Orthogonal wavelet filter bank (pywt layout).

    ``rec_lo`` is the scaling filter h; the other three follow pywt's
    quadrature-mirror relations:
      dec_lo[k] = rec_lo[flen-1-k]
      dec_hi[k] = (-1)^(k+1) rec_lo[k]
      rec_hi[k] = (-1)^k     dec_lo[k]
    """

    name: str
    rec_lo: Tuple[float, ...]

    @property
    def flen(self) -> int:
        return len(self.rec_lo)

    @property
    def _bank(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        rec_lo = np.asarray(self.rec_lo, dtype=np.float64)
        flen = rec_lo.size
        signs = np.where(np.arange(flen) % 2 == 0, -1.0, 1.0)
        dec_lo = rec_lo[::-1].copy()
        dec_hi = signs * rec_lo
        rec_hi = -signs * dec_lo
        return dec_lo, dec_hi, rec_lo, rec_hi

    @property
    def dec_lo(self) -> np.ndarray:
        return self._bank[0]

    @property
    def dec_hi(self) -> np.ndarray:
        return self._bank[1]

    @property
    def rec_lo_arr(self) -> np.ndarray:
        return self._bank[2]

    @property
    def rec_hi(self) -> np.ndarray:
        return self._bank[3]


@lru_cache(maxsize=None)
def wavelet(name: str) -> Wavelet:
    """Look up a wavelet by pywt-style name ('haar', 'db1'..'db20')."""
    key = name.lower()
    if key == "haar":
        key = "db1"
    if key.startswith("db"):
        try:
            order = int(key[2:])
        except ValueError:
            raise ValueError(f"Unknown wavelet: {name!r}") from None
        if not 1 <= order <= 20:
            raise ValueError(f"db order out of supported range: {name!r}")
        return Wavelet(name=key, rec_lo=tuple(_daubechies_scaling(order)))
    raise ValueError(f"Unknown wavelet: {name!r}")


# ---------------------------------------------------------------------------
# Shape bookkeeping (all static / trace-time)
# ---------------------------------------------------------------------------


def dwt_max_level(data_len: int, filter_len: int) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filter_len - 1)))."""
    if data_len < filter_len - 1 or data_len < 1:
        return 0
    return int(math.floor(math.log2(data_len / (filter_len - 1.0))))


def dwt_coeff_len(data_len: int, filter_len: int) -> int:
    """Per-axis analysis output length for symmetric extension."""
    return (data_len + filter_len - 1) // 2


def idwt_len(coeff_len: int, filter_len: int) -> int:
    """Per-axis synthesis output length."""
    return 2 * coeff_len - filter_len + 2


def wavedec2_shapes(
    shape: Tuple[int, int], wav: Wavelet, level: int | None
) -> Tuple[int, List[Tuple[int, int]]]:
    """Resolve the level count (pywt level=None -> max level over both axes)
    and the per-level detail shapes, coarsest first (matching the coefficient
    list layout ``[cA_L, (cH_L, cV_L, cD_L), ..., (cH_1, cV_1, cD_1)]``)."""
    h, w = shape
    flen = wav.flen
    if level is None:
        level = min(dwt_max_level(h, flen), dwt_max_level(w, flen))
    ladder = []
    ch, cw = h, w
    for _ in range(level):
        ch, cw = dwt_coeff_len(ch, flen), dwt_coeff_len(cw, flen)
        ladder.append((ch, cw))
    ladder.reverse()  # coarsest first
    return level, ladder


# ---------------------------------------------------------------------------
# Banded-matrix operators (the destripe graph's DWT form)
#
# A DWT level along one axis is a banded linear map, applied as a dense
# matmul against a per-geometry operator (the synthesis conv would lower to
# an input-dilated convolution instead). The operators are built once per
# (axis length, wavelet) in float64 and cached.
# ---------------------------------------------------------------------------


def _fold_symmetric(idx: np.ndarray, n: int) -> np.ndarray:
    """Fold arbitrary indices into [0, n) by half-sample reflection."""
    period = 2 * n
    idx = np.mod(idx, period)
    return np.where(idx < n, idx, period - 1 - idx)


@lru_cache(maxsize=None)
def analysis_operator(n: int, wavelet_name: str) -> np.ndarray:
    """(2L, n) float32 matrix computing one analysis pass along an axis:
    rows [0:L] are the lowpass outputs, rows [L:2L] the highpass outputs,
    with the symmetric extension folded in. L = (n + flen - 1) // 2."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    L = dwt_coeff_len(n, flen)
    k = np.arange(L)[:, None]
    i = np.arange(flen)[None, :]
    src = _fold_symmetric(2 * k + 1 + i - (flen - 1), n)  # (L, flen)
    A = np.zeros((2 * L, n))
    rows = np.repeat(np.arange(L), flen)
    np.add.at(A, (rows, src.ravel()), np.tile(wav.dec_lo[::-1], L))
    np.add.at(A, (L + rows, src.ravel()), np.tile(wav.dec_hi[::-1], L))
    return A.astype(np.float32)


@lru_cache(maxsize=None)
def synthesis_operator(coeff_len: int, wavelet_name: str) -> np.ndarray:
    """(2*coeff_len - flen + 2, 2*coeff_len) float32 matrix computing one
    synthesis pass along an axis from stacked [lowpass; highpass] coeffs:
    upsample-by-2, convolve with the reconstruction filters, crop flen-2."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    L = coeff_len
    out_len = idwt_len(L, flen)
    m = np.arange(out_len)[:, None]
    k = np.arange(L)[None, :]
    j = m + (flen - 2) - 2 * k  # filter tap index hitting up[2k]
    valid = (j >= 0) & (j < flen)
    jc = np.clip(j, 0, flen - 1)
    S = np.zeros((out_len, 2 * L))
    S[:, :L] = np.where(valid, wav.rec_lo_arr[jc], 0.0)
    S[:, L:] = np.where(valid, wav.rec_hi[jc], 0.0)
    return S.astype(np.float32)


# Precision of every operator matmul of the filter (DWT analysis/synthesis,
# notch): the one named constant each einsum/matmul site reads at trace
# time. bf16 x3 (f32 accumulation) is the cheapest setting that clears the
# 60 dB PSNR gate against the float64 oracle with a margin on every plane
# of an intensity sweep up to 45000 counts on the H100; Precision.HIGH
# lowers to TF32 there and keeps ~1 dB at the bright end (PERF.md, "Matmul
# precision").
MATMUL_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


# ---------------------------------------------------------------------------
# Blocked shift-invariant operators (the default path of dwt2/idwt2)
#
# Once the symmetric extension is materialized into the data, the banded
# analysis/synthesis maps are shift-invariant: every block of 64 (analysis)
# or 128 (synthesis) consecutive outputs is the SAME small matrix applied to
# a short overlapping window of the input. That turns each DWT axis pass
# into one huge batched (K x 2R) matmul with K ~= 132 — about n/K (~12-15x
# at production width) fewer FLOPs than the dense per-geometry operators.
# ---------------------------------------------------------------------------

_AN_R = 64  # analysis outputs per block (per filter)


@lru_cache(maxsize=None)
def _blocked_analysis_mat(wavelet_name: str) -> np.ndarray:
    """(K, 2R) matrix: window of 2R + flen - 2 extended samples ->
    [R lowpass outputs | R highpass outputs]."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    R = _AN_R
    K = 2 * R + flen - 2
    lo_rev = wav.dec_lo[::-1]
    hi_rev = wav.dec_hi[::-1]
    M = np.zeros((K, 2 * R))
    for r in range(R):
        for i in range(flen):
            M[2 * r + i, r] += lo_rev[i]
            M[2 * r + i, R + r] += hi_rev[i]
    return M.astype(np.float32)


@lru_cache(maxsize=None)
def _blocked_synthesis_mat(wavelet_name: str) -> Tuple[np.ndarray, int]:
    """((2T, R_out), T) matrix: windows of T lowpass + T highpass coefficients
    -> R_out = 2*AN_R reconstructed samples (upsample-convolve-crop)."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    R_out = 2 * _AN_R
    T = (R_out - 1 + flen - 2) // 2 + 1
    rec_lo = wav.rec_lo_arr
    rec_hi = wav.rec_hi
    M = np.zeros((2 * T, R_out))
    for s in range(R_out):
        for t in range(T):
            j = s + flen - 2 - 2 * t
            if 0 <= j < flen:
                M[t, s] += rec_lo[j]
                M[T + t, s] += rec_hi[j]
    return M.astype(np.float32), T


def _an_pass_last(x: jax.Array, wav: Wavelet) -> Tuple[jax.Array, jax.Array]:
    """One analysis pass along the last axis -> (lo, hi), each (..., L)."""
    flen = wav.flen
    n = x.shape[-1]
    L = dwt_coeff_len(n, flen)
    R = _AN_R
    K = 2 * R + flen - 2
    nq = -(-L // R)

    ext = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(flen - 1, flen - 1)], mode="symmetric")
    need = 1 + 2 * R * (nq + 1)  # halo slice extends one block past the base
    if ext.shape[-1] < need:
        ext = jnp.pad(ext, [(0, 0)] * (x.ndim - 1) + [(0, need - ext.shape[-1])])

    lead = x.shape[:-1]
    base = ext[..., 1 : 1 + 2 * R * nq].reshape(lead + (nq, 2 * R))
    halo = ext[..., 1 + 2 * R : 1 + 2 * R + 2 * R * nq].reshape(lead + (nq, 2 * R))[
        ..., : flen - 2
    ]
    win = jnp.concatenate([base, halo], axis=-1)  # (..., nq, K)

    M = jnp.asarray(_blocked_analysis_mat(wav.name))
    out = jnp.einsum("...qk,kr->...qr", win, M, precision=MATMUL_PRECISION)
    lo = out[..., :R].reshape(lead + (nq * R,))[..., :L]
    hi = out[..., R:].reshape(lead + (nq * R,))[..., :L]
    return lo, hi


def _syn_pass_last(lo: jax.Array, hi: jax.Array, wav: Wavelet) -> jax.Array:
    """One synthesis pass along the last axis from L lowpass + L highpass
    coefficients -> (..., 2L - flen + 2)."""
    flen = wav.flen
    L = lo.shape[-1]
    out_len = idwt_len(L, flen)
    M, T = _blocked_synthesis_mat(wav.name)
    R_out = M.shape[1]
    H = R_out // 2  # coefficient stride per block
    nq = -(-out_len // R_out)

    need = H * nq + T
    pad = [(0, 0)] * (lo.ndim - 1) + [(0, max(0, need - L))]
    lo_p = jnp.pad(lo, pad)
    hi_p = jnp.pad(hi, pad)
    lead = lo.shape[:-1]

    def windows(c):
        base = c[..., : H * nq].reshape(lead + (nq, H))
        halo = c[..., H : H + H * nq].reshape(lead + (nq, H))[..., : T - H]
        return jnp.concatenate([base, halo], axis=-1)  # (..., nq, T)

    win = jnp.concatenate([windows(lo_p), windows(hi_p)], axis=-1)  # (..., nq, 2T)
    out = jnp.einsum(
        "...qk,kr->...qr", win, jnp.asarray(M), precision=MATMUL_PRECISION
    )
    return out.reshape(lead + (nq * R_out,))[..., :out_len]


def _swap(x):
    return jnp.swapaxes(x, -1, -2)


# ---------------------------------------------------------------------------
# JAX kernels
# ---------------------------------------------------------------------------


def _dwt2_kernels(wav: Wavelet, dtype) -> np.ndarray:
    """(4, 1, flen, flen) strided-conv kernels for one analysis level.

    Output channels ordered (aa, da, ad, dd) == (cA, cH, cV, cD). The
    analysis correlates the symmetric-extended signal with the *reversed*
    decomposition filters at stride 2, offset 1 (derivation in module tests).
    Channel naming: first letter = y-axis filter, second = x-axis filter.
    """
    lo = wav.dec_lo[::-1]
    hi = wav.dec_hi[::-1]
    kernels = np.stack(
        [
            np.outer(lo, lo),  # aa -> cA
            np.outer(hi, lo),  # da -> cH  (highpass y, lowpass x)
            np.outer(lo, hi),  # ad -> cV
            np.outer(hi, hi),  # dd -> cD
        ]
    )[:, None]
    return kernels.astype(dtype)


def _idwt2_kernels(wav: Wavelet, dtype) -> np.ndarray:
    """(1, 4, flen, flen) kernels for one synthesis level (input channels
    ordered (aa, da, ad, dd)). Synthesis is a convolution of the 2x-dilated
    coefficients with the reconstruction filters; as an XLA cross-correlation
    that means the kernels are the *reversed* reconstruction filters."""
    lo = wav.rec_lo_arr[::-1]
    hi = wav.rec_hi[::-1]
    kernels = np.stack(
        [
            np.outer(lo, lo),
            np.outer(hi, lo),
            np.outer(lo, hi),
            np.outer(hi, hi),
        ]
    )[None]
    return kernels.astype(dtype)


_DN = jax.lax.conv_dimension_numbers((1, 1, 1, 1), (1, 1, 1, 1), ("NCHW", "OIHW", "NCHW"))


def dwt2(
    x: jax.Array, wav: Wavelet, ops: Optional[Tuple[jax.Array, jax.Array]] = None
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array, jax.Array]]:
    """One 2-D analysis level over the last two axes of ``x`` (leading axes
    are batch). Returns ``(cA, (cH, cV, cD))`` with pywt-compatible values.

    Default path: blocked shift-invariant batched matmuls (no per-geometry
    operators; see _blocked_analysis_mat). Passing ``ops`` (a dense
    (A_y, A_x) operator pair from :func:`analysis_operator`) selects the
    dense-matmul path instead — used for cross-checking."""
    if ops is None:
        lo_y, hi_y = _an_pass_last(_swap(x), wav)
        lo_y, hi_y = _swap(lo_y), _swap(hi_y)
        aa, ad = _an_pass_last(lo_y, wav)
        da, dd = _an_pass_last(hi_y, wav)
        return aa, (da, ad, dd)

    h, w = x.shape[-2:]
    A_y, A_x = ops
    t = jnp.einsum("ih,...hw->...iw", A_y, x, precision=MATMUL_PRECISION)
    y = jnp.einsum("...iw,jw->...ij", t, A_x, precision=MATMUL_PRECISION)
    L_h = A_y.shape[0] // 2
    L_w = A_x.shape[0] // 2
    aa = y[..., :L_h, :L_w]
    ad = y[..., :L_h, L_w:]
    da = y[..., L_h:, :L_w]
    dd = y[..., L_h:, L_w:]
    return aa, (da, ad, dd)


def idwt2(
    ca: jax.Array,
    details: Tuple[jax.Array, jax.Array, jax.Array],
    wav: Wavelet,
    ops: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> jax.Array:
    """One 2-D synthesis level (inverse of :func:`dwt2`). Default path:
    blocked shift-invariant batched matmuls; pass dense ``ops`` (from
    :func:`synthesis_operator`) for the dense cross-check path."""
    ch, cv, cd = details
    if ops is None:
        lo_row = _syn_pass_last(ca, cv, wav)  # lowpass-y channel
        hi_row = _syn_pass_last(ch, cd, wav)  # highpass-y channel
        y = _syn_pass_last(_swap(lo_row), _swap(hi_row), wav)
        return _swap(y)

    h, w = ca.shape[-2:]
    S_y, S_x = ops
    top = jnp.concatenate([ca, cv], axis=-1)  # lowpass-y: [aa | ad]
    bot = jnp.concatenate([ch, cd], axis=-1)  # highpass-y: [da | dd]
    c2 = jnp.concatenate([top, bot], axis=-2)
    t = jnp.einsum("ih,...hw->...iw", S_y, c2, precision=MATMUL_PRECISION)
    return jnp.einsum("...iw,jw->...ij", t, S_x, precision=MATMUL_PRECISION)


def dwt2_conv(
    x: jax.Array, wav: Wavelet
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array, jax.Array]]:
    """Strided-convolution analysis (reference implementation for
    cross-checking the matmul path)."""
    flen = wav.flen
    batch_shape = x.shape[:-2]
    h, w = x.shape[-2:]
    xb = x.reshape((-1, 1) + (h, w))

    pad = [(0, 0), (0, 0), (flen - 1, flen - 1), (flen - 1, flen - 1)]
    ext = jnp.pad(xb, pad, mode="symmetric")
    # Analysis phase: first output window starts at extended index 1.
    ext = ext[:, :, 1:, 1:]

    kernels = jnp.asarray(_dwt2_kernels(wav, x.dtype))
    out = jax.lax.conv_general_dilated(
        ext,
        kernels,
        window_strides=(2, 2),
        padding="VALID",
        dimension_numbers=_DN,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=x.dtype if x.dtype == jnp.float64 else jnp.float32,
    ).astype(x.dtype)

    oh, ow = dwt_coeff_len(h, flen), dwt_coeff_len(w, flen)
    out = out[:, :, :oh, :ow]
    out = out.reshape(batch_shape + (4, oh, ow))
    idx = len(batch_shape)
    take = lambda c: jnp.take(out, c, axis=idx)
    return take(0), (take(1), take(2), take(3))


def idwt2_conv(
    ca: jax.Array,
    details: Tuple[jax.Array, jax.Array, jax.Array],
    wav: Wavelet,
) -> jax.Array:
    """Input-dilated-convolution synthesis (reference implementation for
    cross-checking the matmul path)."""
    flen = wav.flen
    ch, cv, cd = details
    batch_shape = ca.shape[:-2]
    h, w = ca.shape[-2:]
    stacked = jnp.stack([ca, ch, cv, cd], axis=len(batch_shape))
    xb = stacked.reshape((-1, 4, h, w))

    kernels = jnp.asarray(_idwt2_kernels(wav, ca.dtype))
    out = jax.lax.conv_general_dilated(
        xb,
        kernels,
        window_strides=(1, 1),
        padding=((1, 1), (1, 1)),
        lhs_dilation=(2, 2),
        dimension_numbers=_DN,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=ca.dtype if ca.dtype == jnp.float64 else jnp.float32,
    ).astype(ca.dtype)

    oh, ow = idwt_len(h, flen), idwt_len(w, flen)
    return out[:, 0, :oh, :ow].reshape(batch_shape + (oh, ow))


def analysis_operators(
    shape: Tuple[int, int],
    wav: Wavelet,
    level: int | None = None,
):
    """Per-level (A_y, A_x) numpy operator pairs for :func:`wavedec2`,
    finest level first (application order)."""
    n_levels, _ = wavedec2_shapes(shape, wav, level)
    ops = []
    h, w = shape
    for _ in range(n_levels):
        ops.append(
            (analysis_operator(h, wav.name), analysis_operator(w, wav.name))
        )
        h, w = dwt_coeff_len(h, wav.flen), dwt_coeff_len(w, wav.flen)
    return ops


def synthesis_operators(
    shape: Tuple[int, int],
    wav: Wavelet,
    level: int | None = None,
):
    """Per-level (S_y, S_x) numpy operator pairs for :func:`waverec2`,
    coarsest level first (application order). Each level's operators act on
    the *detail* band geometry, and their output rows are pre-trimmed to the
    next level's detail shape (final level: the image shape) — folding
    waverec2's crop-by-one rule and the final crop into the matmul instead
    of emitting large slice copies."""
    _, ladder = wavedec2_shapes(shape, wav, level)
    targets = list(ladder[1:]) + [shape]
    ops = []
    for (h, w), (th, tw) in zip(ladder, targets):
        S_y = synthesis_operator(h, wav.name)[:th]
        ops.append((S_y, synthesis_operator(w, wav.name)[:tw]))
    return ops


def wavedec2(
    x: jax.Array, wav: Wavelet, level: int | None = None, operators=None
):
    """Multi-level 2-D analysis: ``[cA_L, (cH_L,cV_L,cD_L), ..., (cH_1,...)]``
    (coarsest detail first, like pywt.wavedec2). ``operators``: per-level
    (A_y, A_x) pairs, finest first (see :func:`analysis_operators`) — pass
    device-resident arrays to keep them out of the compiled graph."""
    n_levels, _ = wavedec2_shapes(x.shape[-2:], wav, level)
    coeffs: list = []
    approx = x
    for lvl in range(n_levels):
        ops = operators[lvl] if operators is not None else None
        approx, det = dwt2(approx, wav, ops)
        coeffs.append(det)
    coeffs.append(approx)
    coeffs.reverse()
    return coeffs


def waverec2(coeffs: Sequence, wav: Wavelet, operators=None) -> jax.Array:
    """Multi-level 2-D synthesis with pywt's crop-by-one rule: whenever the
    running approximation is one sample larger than the next detail band along
    an axis, it is truncated before the synthesis step. ``operators``:
    per-level (S_y, S_x) pairs, coarsest first (see
    :func:`synthesis_operators`)."""
    approx = coeffs[0]
    for i, det in enumerate(coeffs[1:]):
        dh, dw = det[0].shape[-2:]
        ah, aw = approx.shape[-2:]
        if not (0 <= ah - dh <= 1 and 0 <= aw - dw <= 1):
            raise ValueError(
                f"inconsistent coefficient shapes: approx {(ah, aw)} vs detail {(dh, dw)}"
            )
        approx = approx[..., :dh, :dw]
        ops = operators[i] if operators is not None else None
        approx = idwt2(approx, det, wav, ops)
    return approx
