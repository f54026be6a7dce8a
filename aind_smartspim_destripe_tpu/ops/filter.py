"""
The destripe kernel: batched, jittable, geometry-specialized.

Rebuilds reference filtering.py:139-224 (`log_space_fft_filtering`) and
:417-491 (`filter_stripes`) as one XLA graph per geometry:

- A *plan* is built once per image geometry (H, W, wavelet, level, sigmas):
  the static per-level shape ladder plus precomputed dense DWT and
  packed-FFT notch operators (see ops/wavelets.py, ops/fft_notch.py).
  Everything under jit has static shapes.
- Planes are processed as a batch (B, H, W). Analysis keeps only the
  lowpass x-half (only cA/cH are ever consumed) and synthesis propagates
  just the cH deltas onto log1p(x) via perfect reconstruction — see
  DestripePlan.constants. Every stage (classifier, analysis, Otsu,
  masked-median inpainting, notch, synthesis, epilogues) is plain
  jax.numpy / lax, one formulation per operation; every operator matmul
  runs at ``wavelets.MATMUL_PRECISION``.
- The per-plane cells/no-cells branch (reference filtering.py:462-467) only
  changes two scalars (sigma, max_threshold) when both configs share a
  wavelet/level — so instead of control flow the notch computes both
  notch products in one matmul and selects per plane.

Replicated reference quirks (they define the golden output):
- ``exp(y) + 1.0`` inverse instead of expm1 (filtering.py:222),
- float16 sigmoid classifier with center=400, crossover=20 (filtering.py:78),
- notch sigma scaled by the *level's row count* over min(H, W)
  (filtering.py:180,213),
- packed-format FFTPACK gain layout (see ops/fft_notch.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fft_notch
from . import wavelets
from .otsu import threshold_otsu_batch
from .wavelets import wavedec2_shapes, wavelet

__all__ = [
    "FilterConfig",
    "DestripePlan",
    "build_plan",
    "destripe_batch",
    "classify_planes",
    "log_space_fft_filtering",
    "wrap_cast",
]


def wrap_cast(y: jax.Array) -> jax.Array:
    """zarr-store modulo-2^16 uint16 cast (reference zarr_destriper.py:336
    assigns the unclipped float into a uint16 zarr, which wraps via numpy
    astype; a bare XLA astype would saturate instead). The ONE definition —
    the dual pipeline epilogue and the tests alias it so the wrap semantics
    can't drift between the classifier and dual paths."""
    return jnp.mod(jnp.trunc(y).astype(jnp.int32), 65536).astype(jnp.uint16)


@dataclass(frozen=True)
class FilterConfig:
    """Parameter surface of reference log_space_fft_filtering
    (filtering.py:139-145)."""

    wavelet: str = "db3"
    level: Optional[int] = None
    sigma: float = 64.0
    max_threshold: float = 4.0

    @staticmethod
    def from_dict(d: dict) -> "FilterConfig":
        return FilterConfig(
            wavelet=d.get("wavelet", "db3"),
            level=d.get("level", None),
            sigma=float(d.get("sigma", 64)),
            max_threshold=float(d.get("max_threshold", 4)),
        )


@dataclass(frozen=True)
class DestripePlan:
    """Static (trace-time) description of a destripe computation for one
    image geometry and a (cells, no-cells) config pair."""

    height: int
    width: int
    wavelet: str
    n_levels: int
    ladder: Tuple[Tuple[int, int], ...]  # coarsest-first detail shapes
    cells: FilterConfig
    no_cells: FilterConfig

    def notch_matrices(self, dtype=np.float32):
        """Per-level (cells, no_cells) notch operators, coarsest first.

        sigma_effective = rows(level) * sigma / min(H, W)
        (reference filtering.py:180,208-213: `s = fft.shape[0] * width_fraction`).
        """
        min_side = min(self.height, self.width)
        mats = []
        for h, w in self.ladder:
            pair = []
            for cfg in (self.cells, self.no_cells):
                s = h * cfg.sigma / min_side
                pair.append(
                    fft_notch.packed_notch_matrix(w, float(s)).astype(dtype)
                )
            mats.append(tuple(pair))
        return tuple(mats)

    def constants(self):
        """All large operator matrices as a pytree of numpy arrays, meant to
        be passed INTO a jitted kernel (device-resident) rather than baked
        into the graph — multi-MB HLO literal constants stall XLA's
        compiler.

        The operators are dense per-geometry matrices (mostly zeros: a DWT
        pass is banded). destripe_batch exploits the filter's structure:

        - only cA (to recurse) and cH (to filter) are ever consumed, so the
          analysis x-pass keeps just the lowpass rows (``an_x_lo``) — half
          the x-pass FLOPs;
        - by perfect reconstruction, waverec2 of the *unfiltered* pyramid is
          the input itself, so synthesis reduces to propagating the delta
          ``cH' - cH`` (plus the accumulated coarser correction) through the
          lowpass-x synthesis half (``syn_y``, ``syn_x_lo``) and adding it to
          log1p(x) — half the synthesis FLOPs.

        Keys (all finest-first for analysis, coarsest-first for synthesis):
        an_y (2L_h x h), an_x_lo (L_w x w), syn_y (h_t x 2L_h, output rows
        pre-trimmed to the crop-rule target), syn_x_lo (w_t x L_w), and
        notch_cat ((w, 2w): cells | no_cells notch operators fused so both
        bands come from a single matmul)."""
        wav = wavelets.wavelet(self.wavelet)
        an = wavelets.analysis_operators(
            (self.height, self.width), wav, self.n_levels
        )
        syn = wavelets.synthesis_operators(
            (self.height, self.width), wav, self.n_levels
        )
        out = {
            "an_y": tuple(p[0] for p in an),
            "an_x_lo": tuple(p[1][: p[1].shape[0] // 2] for p in an),
            "syn_y": tuple(p[0] for p in syn),
            "syn_x_lo": tuple(p[1][:, : p[1].shape[1] // 2] for p in syn),
            "notch_cat": tuple(
                np.concatenate([pair[0].T, pair[1].T], axis=1)
                for pair in self.notch_matrices()
            ),
        }
        return out


@lru_cache(maxsize=32)
def build_plan(
    height: int,
    width: int,
    cells: FilterConfig,
    no_cells: FilterConfig,
) -> DestripePlan:
    if (cells.wavelet, cells.level) != (no_cells.wavelet, no_cells.level):
        raise NotImplementedError(
            "cells/no_cells configs must share wavelet and level "
            "(they do in the reference pipeline, run_capsule.py:377-388); "
            "for disjoint configs run two plans and select on host."
        )
    wav = wavelet(cells.wavelet)
    n_levels, ladder = wavedec2_shapes((height, width), wav, cells.level)
    return DestripePlan(
        height=height,
        width=width,
        wavelet=cells.wavelet,
        n_levels=n_levels,
        ladder=tuple(ladder),
        cells=cells,
        no_cells=no_cells,
    )


# ---------------------------------------------------------------------------
# Classifier (reference filtering.py:54-88, 459-467)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _classifier_cut(
    center: float, crossover: float, threshold_mask: float
) -> Optional[float]:
    """Exact single-compare form of the float16 sigmoid classifier.

    The reference computes, entirely in float16, ``sigmoid((x - center) /
    crossover) > threshold_mask`` (filtering.py:54-88). Every step is weakly
    monotone in x, so over the finite float16 lattice the predicate is
    equivalent to ``x16 >= cut`` for one breakpoint — found here by
    evaluating the exact numpy float16 chain on all 65536 half-precision bit
    patterns. Returns the breakpoint, or None if monotonicity ever fails
    (callers then keep the transcendental formulation). Removes the exp from
    the per-plane classifier.
    """
    bits = np.arange(65536, dtype=np.uint16)
    v = bits.view(np.float16)
    sel = np.isfinite(v) | np.isinf(v)  # drop NaNs (compare False either way)
    v = v[sel]
    with np.errstate(over="ignore", invalid="ignore"):
        z = (v - np.float16(center)) / np.float16(crossover)
        frac = np.float16(1) / (np.float16(1) + np.exp(-z))
    m = frac > np.float16(threshold_mask)
    order = np.argsort(v.astype(np.float64), kind="stable")
    vs, ms = v[order], m[order]
    if not ms.any():
        return None  # never a cell: no compare-form breakpoint exists
    first = int(np.argmax(ms))
    if not bool(np.all(ms[first:])) or bool(np.any(ms[:first])):
        return None  # not monotone: keep the sigmoid path
    return float(vs[first])


def classify_planes(
    images: jax.Array,
    microscope_high_int: float,
    threshold_mask: float = 0.3,
) -> jax.Array:
    """Per-plane bool: does this plane contain cells? Mirrors the float16
    sigmoid foreground classifier and the fore/back mean comparison."""
    x16 = images.astype(jnp.float16)
    cut = _classifier_cut(400.0, 20.0, float(threshold_mask))
    if cut is not None:
        cell_mask = x16 >= jnp.float16(cut)
    else:  # pragma: no cover - production params are monotone
        z = (x16 - jnp.float16(400.0)) / jnp.float16(20.0)
        frac = 1 / (1 + jnp.exp(-z))
        cell_mask = frac > jnp.float16(threshold_mask)

    imgs = images.astype(jnp.float32)
    axes = tuple(range(1, images.ndim))
    # all four reductions in f32 so XLA emits ONE multi-output pass over the
    # (B,H,W) input instead of separate s32-count and f32-sum fusions
    # (f32 sums are exact for counts up to 2^24 >> plane size)
    fg_cnt = jnp.sum(cell_mask.astype(jnp.float32), axis=axes)
    bg_cnt = jnp.sum((~cell_mask).astype(jnp.float32), axis=axes)
    fg_sum = jnp.sum(jnp.where(cell_mask, imgs, 0.0), axis=axes)
    bg_sum = jnp.sum(jnp.where(cell_mask, 0.0, imgs), axis=axes)
    fg_mean = jnp.where(fg_cnt > 0, fg_sum / jnp.maximum(fg_cnt, 1.0), 0.0)
    bg_mean = jnp.where(bg_cnt > 0, bg_sum / jnp.maximum(bg_cnt, 1.0), 0.0)
    return (fg_mean > bg_mean) & (fg_mean > microscope_high_int)


def _row_median(x: jax.Array) -> jax.Array:
    """Exact median over the last axis, keepdims: a values-only lax.sort
    (about half the work of jnp.median's stable (f32, s32) tuple sort)."""
    n = x.shape[-1]
    s = jax.lax.sort(x, dimension=x.ndim - 1, is_stable=False)
    if n % 2:
        return s[..., n // 2 : n // 2 + 1]
    lo = s[..., n // 2 - 1 : n // 2]
    hi = s[..., n // 2 : n // 2 + 1]
    return (lo + hi) * 0.5


# ---------------------------------------------------------------------------
# Per-level horizontal-band filtering (reference filtering.py:186-219)
# ---------------------------------------------------------------------------


def _filter_level(
    ch: jax.Array,  # (B, h, w) horizontal-detail band
    is_cells: jax.Array,  # (B,) bool
    bmat_cat: jax.Array,  # (w, 2w): [cells | no_cells] notch operators fused
    thr_cells: float,
    thr_no_cells: float,
    otsu_sqrt: Optional[jax.Array] = None,  # precomputed sqrt(otsu(ch^2))
    notch_apply=None,  # (B,h,w)->(B,h,2w) spectral notch when bmat_cat=None
) -> jax.Array:
    """Reference per-band filter (filtering.py:186-219): Otsu stripe
    threshold on ch^2, row-median inpainting of the stripe pixels, then the
    per-plane notch. The ``jax.named_scope`` names are the stage names the
    trace reducer (benchmarks/step_profile.py) attributes device time to."""
    w = ch.shape[-1]
    max_thr = jnp.where(is_cells, thr_cells, thr_no_cells)

    ch_sq = ch * ch
    ch_power = jnp.sqrt(ch_sq)

    if otsu_sqrt is None:
        with jax.named_scope("otsu"):
            otsu_sqrt = jnp.sqrt(threshold_otsu_batch(ch_sq))  # (B,)
    threshold = jnp.minimum(max_thr, otsu_sqrt)[:, None, None]

    mask = (ch_power > threshold).astype(ch.dtype)
    foreground = ch * mask
    background = ch * (1.0 - mask)

    with jax.named_scope("median"):
        background_means = _row_median(background)
    background_inpainted = background + background_means * mask

    with jax.named_scope("notch"):
        if bmat_cat is None:
            both = notch_apply(background_inpainted)
        else:
            both = jnp.matmul(
                background_inpainted, bmat_cat,
                precision=wavelets.MATMUL_PRECISION,
            )
        background_filtered = jnp.where(
            is_cells[:, None, None], both[..., :w], both[..., w:]
        )

    return foreground + background_filtered * (1.0 - mask)


def normalize_flat_dark(height: int, width: int, flat, dark):
    """Validate and normalize a (flat, dark) pair to the plane extent:
    paired-or-absent check, reference darkfield crop (filtering.py:377),
    2-D broadcast to (H, W) with a clear error. Shared by every step that
    applies the flat-field epilogue."""
    if (flat is None) != (dark is None):
        raise ValueError(
            "flat and dark must be provided together "
            "(pass dark=jnp.zeros((1, 1)) for a zero darkfield)"
        )
    if flat is None:
        return None, None
    # Normalize both fields to the exact plane extent up front: the
    # darkfield is cropped like the reference (filtering.py:377), then
    # 2-D fields broadcast to (H, W); a shape that fits neither fails here
    # with a clear error instead of deep in the epilogue.
    hw = (height, width)
    flat = jnp.asarray(flat, jnp.float32)
    dark = jnp.asarray(dark, jnp.float32)
    if dark.ndim >= 2:
        # reference darkfield crop applies to 2-D fields; a scalar/1-D dark
        # (dark=0.0, a per-column row) goes straight to the broadcast below
        # instead of dying in a two-axis slice
        dark = dark[..., :height, :width]
    if flat.ndim <= 2 and dark.ndim <= 2:
        try:
            flat = jnp.broadcast_to(flat, hw)
            dark = jnp.broadcast_to(dark, hw)
        except ValueError:
            raise ValueError(
                f"flat {flat.shape} / dark {dark.shape} do not "
                f"broadcast to the plane extent {hw}"
            )
    return flat, dark


def analysis_bands(xlog: jax.Array, consts) -> list:
    """The cH band of every analysis level, finest first.

    Only cA (to recurse) and cH (to filter) are consumed, so the x-pass
    applies the lowpass half only — and it runs FIRST: the x-pass halves
    the width while the y-pass slightly expands it (lo+hi), so
    shrink-before-expand saves ~30% of the analysis FLOPs ((w+h)/(2h+w) of
    the y-first order)."""
    P = wavelets.MATMUL_PRECISION
    chs = []
    a = xlog
    for lvl, (an_y, an_x_lo) in enumerate(
        zip(consts["an_y"], consts["an_x_lo"])
    ):
        with jax.named_scope(f"analysis_l{lvl}"):
            lox_w = jnp.einsum(
                "...hw,jw->...hj", a, jnp.asarray(an_x_lo), precision=P
            )
            lox = jnp.einsum(
                "ih,...hw->...iw", jnp.asarray(an_y), lox_w, precision=P
            )
        L_h = lox.shape[-2] // 2
        a = lox[..., :L_h, :]  # aa: lowpass-y, lowpass-x
        chs.append(lox[..., L_h:, :])  # cH: highpass-y, lowpass-x
    return chs


def synthesis_correction(deltas, consts) -> jax.Array:
    """Log-space correction of the full plane from the per-level cH deltas
    (coarsest first). By perfect reconstruction the unfiltered pyramid
    reconstructs to log1p(x) exactly, so only the correction [accumulated
    coarser correction; cH delta] needs the synthesis operators — and only
    their lowpass-x half."""
    P = wavelets.MATMUL_PRECISION
    corr = None
    n_lvls = len(deltas)
    for i, (delta, syn_y, syn_x_lo) in enumerate(
        zip(deltas, consts["syn_y"], consts["syn_x_lo"])
    ):
        with jax.named_scope(f"synthesis_l{n_lvls - 1 - i}"):
            syn_y = jnp.asarray(syn_y)
            L_h = syn_y.shape[-1] // 2
            if corr is None:
                stacked_y = jnp.einsum(
                    "ih,...hw->...iw", syn_y[:, L_h:], delta, precision=P
                )
            else:
                up = jnp.concatenate([corr[..., :L_h, :], delta], axis=-2)
                stacked_y = jnp.einsum(
                    "ih,...hw->...iw", syn_y, up, precision=P
                )
            corr = jnp.einsum(
                "...iw,jw->...ij", stacked_y, jnp.asarray(syn_x_lo),
                precision=P,
            )
    return corr


# ---------------------------------------------------------------------------
# The full batched kernel
# ---------------------------------------------------------------------------


def destripe_batch(
    plan: DestripePlan,
    images: jax.Array,  # (B, H, W) float32 (or integer; cast internally)
    microscope_high_int: float = 2700.0,
    consts=None,
    flat: Optional[jax.Array] = None,
    dark: Optional[jax.Array] = None,
    wrap: bool = False,
    dual: bool = False,
) -> jax.Array:
    """log-space wavelet-FFT destripe of a batch of planes; returns float32
    of the same shape. Jit with ``plan`` static (it is hashable) and, for
    production geometries, pass ``consts=plan.constants()`` as a device
    argument so the operator matrices stay out of the compiled graph.

    Optional epilogues (uint16 output, fused by XLA into the last
    synthesis pass): ``flat``/``dark`` apply the flat-field correction
    (reference filtering.py:470-489); ``wrap=True`` applies the zarr-store
    modulo-2^16 cast (reference zarr_destriper.py:336 parity).

    ``dual=True`` runs BOTH of the plan's configs on every plane from ONE
    wavelet decomposition (the dual-band mode, BASELINE config 2): the
    classifier is skipped, the analysis/Otsu/inpainting run once per plane,
    and only the notch products and delta synthesis double. Returns
    (2B, H, W) float32 — ``out[:B]`` filtered with ``plan.cells`` (the
    foreground band), ``out[B:]`` with ``plan.no_cells`` (background);
    epilogues are disallowed (blend first, then correct)."""
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    if dual and (flat is not None or wrap):
        raise ValueError(
            "dual mode returns both float32 bands; blend them before "
            "applying a flat-field or wrap epilogue"
        )
    flat, dark = normalize_flat_dark(plan.height, plan.width, flat, dark)

    def epilogue(y):
        if flat is not None:
            from .flatfield import flatfield_correction

            return flatfield_correction(y, flat, dark)
        if wrap:
            return wrap_cast(y)
        return y

    x = images.astype(jnp.float32)
    with jax.named_scope("log1p"):
        xlog = jnp.log(1.0 + x)

    if plan.n_levels == 0:
        # Degenerate tiny-image case: wavedec2 returns [x] untouched.
        out0 = epilogue(jnp.exp(xlog) + 1.0)
        return jnp.concatenate([out0, out0], axis=0) if dual else out0

    if consts is None:
        consts = plan.constants()

    # Dual mode needs no classifier: every plane takes BOTH configs,
    # selected by batch half (first half = cells slot, second = no-cells).
    B0 = x.shape[0]
    if dual:
        is_cells = jnp.arange(2 * B0) < B0
    else:
        with jax.named_scope("classify"):
            is_cells = classify_planes(x, microscope_high_int)

    chs = analysis_bands(xlog, consts)

    # Filter each cH band (coarsest first, matching the notch operators);
    # each yields the synthesis delta filter(cH) - cH.
    deltas = []
    n_lvls = len(chs)
    for j, (ch, bm_cat) in enumerate(zip(reversed(chs), consts["notch_cat"])):
        with jax.named_scope(f"filter_l{n_lvls - 1 - j}"):
            otsu_sqrt = None
            if dual:
                # ONE Otsu per input plane, shared by both bands (the
                # stripe threshold depends only on the coefficients, not
                # the sigma), tiled to the doubled delta batch
                with jax.named_scope("otsu"):
                    otsu_sqrt = jnp.tile(
                        jnp.sqrt(threshold_otsu_batch(ch * ch)), 2
                    )
                ch = jnp.concatenate([ch, ch], axis=0)
            deltas.append(_filter_level(
                ch,
                is_cells,
                jnp.asarray(bm_cat),
                plan.cells.max_threshold,
                plan.no_cells.max_threshold,
                otsu_sqrt=otsu_sqrt,
            ) - ch)

    corr = synthesis_correction(deltas, consts)

    if dual:
        # both bands' corrections apply to the same log-space input
        xlog = jnp.concatenate([xlog, xlog], axis=0)
    with jax.named_scope("epilogue"):
        return epilogue(jnp.exp(xlog + corr) + 1.0)


# ---------------------------------------------------------------------------
# Single-config API parity (reference filtering.py:139-224)
# ---------------------------------------------------------------------------


def log_space_fft_filtering(
    input_image,
    wavelet: str = "db3",
    level: Optional[int] = 0,
    sigma: float = 64,
    max_threshold: float = 4,
):
    """Drop-in equivalent of the reference single-image entry point (host
    convenience wrapper; jit-compiled per geometry under the hood). Accepts a
    2-D plane or a (B, H, W) batch; note the reference treats a 3-D input as
    one batch for Otsu/median purposes, while production filters per-plane —
    this function follows the production per-plane semantics."""
    img = np.asarray(input_image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    cfg = FilterConfig(wavelet=wavelet, level=level, sigma=float(sigma),
                       max_threshold=float(max_threshold))
    plan = build_plan(img.shape[-2], img.shape[-1], cfg, cfg)
    out = _jitted_destripe(
        plan, jnp.asarray(img.astype(np.float32)), -np.inf, device_constants(plan)
    )
    out = np.asarray(out)
    return out[0] if squeeze else out


@lru_cache(maxsize=8)
def device_constants(plan: DestripePlan):
    """Device-resident operator matrices for a plan (cached)."""
    return jax.device_put(plan.constants())


@partial(jax.jit, static_argnums=(0,))
def _jitted_destripe(plan, images, microscope_high_int, consts):
    return destripe_batch(plan, images, microscope_high_int, consts)
