"""
BaSiC shading estimation (flatfield / darkfield / baseline) in JAX.

Replaces the BaSiCPy dependency of the reference flat-field estimation step
(flatfield_estimation.py:43-45: ``BaSiC(**params).fit(images,
fitting_weight=mask)`` -> flatfield/darkfield/baseline). Implements the BaSiC
model (Peng et al., Nat. Commun. 2017): images are modeled as

    I_i(x)  =  b_i * S(x)  +  D(x)  +  R_i(x)

with a smooth multiplicative flatfield S (sparse in DCT domain), an optional
additive darkfield D, per-image baselines b_i, and sparse residuals R_i. The
fit minimizes  ||W o R||_1 + lambda_s ||DCT(S)||_1 + lambda_d ||DCT(D)||_1
by an inexact augmented-Lagrangian (LADMAP-style) iteration with L1
reweighting — the same optimization family BaSiCPy uses — written as a
jit-compiled jax.lax.while_loop so the whole fit runs on device.

Parameter surface mirrors BaSiCPy's (the subset the reference exercises:
get_darkfield, smoothness_flatfield, smoothness_darkfield, sort_intensity,
max_reweight_iterations, fitting_weight mask; see
zarr_destriper_orig.py:1092-1099 for the production values).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BaSiC"]


def _dct2(x):
    return jax.scipy.fft.dctn(x, type=2, norm="ortho")


def _idct2(x):
    return jax.scipy.fft.idctn(x, type=2, norm="ortho")


def _shrink(x, thresh):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - thresh, 0.0)


@partial(jax.jit, static_argnames=("max_iterations",))
def _ladmap_fit(
    images,  # (n, h, w) float32, working resolution
    weight,  # (n, h, w) float32 fitting weights
    smoothness_flatfield: float,
    max_iterations: int,
    tol: float,
):
    """One inner LADMAP solve at fixed weights (multiplicative model
    ``I_i = b_i * S + R_i``; any darkfield is subtracted from ``images``
    beforehand — see :meth:`BaSiC.fit`). Returns (S, b, R)."""
    n, h, w = images.shape
    im_mean = jnp.mean(images, axis=0)
    norm = jnp.linalg.norm(images.ravel())
    mu0 = 12.5 / jnp.maximum(norm, 1e-6)
    rho = 1.5
    mu_max = mu0 * 1e7

    lam_s = smoothness_flatfield * jnp.maximum(norm, 1e-6) / 400.0

    S0 = im_mean / jnp.maximum(jnp.mean(im_mean), 1e-6)
    b0 = jnp.mean(images.reshape(n, -1), axis=1)

    def model(S, b):
        return b[:, None, None] * S[None]

    def cond(state):
        k, S, b, R, Y, mu, diff = state
        return (k < max_iterations) & (diff > tol)

    def body(state):
        k, S, b, R, Y, mu, _ = state
        fit = model(S, b)
        old = fit + R

        # S step: gradient of 0.5*mu*||I - fit - R + Y/mu||^2 wrt S, then
        # DCT-domain soft-threshold (sparse smooth surface).
        resid = images - fit - R + Y / mu
        b_sq = jnp.sum(b * b) + 1e-6
        gS = jnp.sum(b[:, None, None] * resid, axis=0) / b_sq
        S_new = _idct2(_shrink(_dct2(S + gS), lam_s / (mu * b_sq)))

        # b step: per-image least squares against S.
        S_sq = jnp.sum(S_new * S_new) + 1e-6
        b_new = jnp.sum(
            S_new[None] * (images - R + Y / mu), axis=(1, 2)
        ) / S_sq

        fit = model(S_new, b_new)
        # R step: pixelwise soft-threshold with the reweighting mask.
        resid = images - fit + Y / mu
        R_new = _shrink(resid, weight / mu)

        Y_new = Y + mu * (images - fit - R_new)
        mu_new = jnp.minimum(mu * rho, mu_max)

        diff = jnp.linalg.norm((fit + R_new - old).ravel()) / (
            jnp.linalg.norm(old.ravel()) + 1e-6
        )
        return (k + 1, S_new, b_new, R_new, Y_new, mu_new, diff)

    state0 = (
        0,
        S0,
        b0,
        jnp.zeros_like(images),
        jnp.zeros_like(images),
        mu0,
        jnp.asarray(jnp.inf, images.dtype),
    )
    _, S, b, R, *_ = jax.lax.while_loop(cond, body, state0)
    return S, b, R


@jax.jit
def _estimate_darkfield(images, S, b, smoothness_darkfield):
    """Darkfield from the per-pixel intercept of ``I_i(x)`` regressed
    against the per-image baselines ``b_i`` (the intensity extrapolated to
    zero illumination), content-masked, DCT-smoothed, and anchored with the
    dark-floor prior ``min(D) = 0``.

    Three pieces, each load-bearing (all failure modes observed while
    building this):
    - *Why a regression at all*: estimating D inside the LADMAP iteration
      provably fails — the sparse residual's threshold (weight/mu) crosses
      below the dark amplitude long before any DCT threshold (lam/mu) does,
      so R absorbs the dark and D never leaves zero (round 1 returned an
      all-zero darkfield because of this). It must also run on the UNSORTED
      stack: sort_intensity destroys the (b_i, I_i(x)) pairing.
    - *Content mask*: sparse bright cells wreck a plain per-pixel least
      squares; pairs > 5 MAD from the per-pixel median residual are dropped.
    - *Dark-floor anchor*: in ``I = b*S + D`` the component of D parallel
      to S trades freely against b (stage-1 b absorbs <D,S>/<S,S>), so the
      raw intercept is D - c*S with unknown c. The physical prior that the
      darkfield floor is ~0 identifies c as the 0.99-quantile of
      ``-(intercept_smooth / S)`` (BaSiCPy similarly pins its dark on
      low-intensity statistics rather than the ALM iteration)."""
    resid = images - b[:, None, None] * S[None]
    med = jnp.median(resid, axis=0)
    mad = jnp.median(jnp.abs(resid - med[None]), axis=0) + 1e-3
    w = (jnp.abs(resid - med[None]) < 5.0 * mad[None]).astype(images.dtype)
    wsum = w.sum(axis=0) + 1e-6
    b_w = (w * b[:, None, None]).sum(axis=0) / wsum
    i_w = (w * images).sum(axis=0) / wsum
    db = b[:, None, None] - b_w[None]
    cov = (w * db * (images - i_w[None])).sum(axis=0) / wsum
    var = (w * db * db).sum(axis=0) / wsum + 1e-6
    slope = cov / var  # per-pixel ~S(x)
    intercept = i_w - slope * b_w
    smooth = _idct2(_shrink(_dct2(intercept), smoothness_darkfield))
    c = jnp.quantile(-(smooth / jnp.maximum(S, 1e-3)), 0.99)
    return jnp.maximum(smooth + c * S, 0.0)


@dataclass
class BaSiC:
    """BaSiCPy-compatible facade.

    >>> model = BaSiC(get_darkfield=False, smoothness_flatfield=1.0)
    >>> model.fit(images, fitting_weight=mask)
    >>> model.flatfield, model.darkfield, model.baseline
    """

    get_darkfield: bool = False
    smoothness_flatfield: float = 1.0
    smoothness_darkfield: float = 20.0
    sort_intensity: bool = False
    max_reweight_iterations: int = 10
    max_iterations: int = 100
    working_size: int = 128
    epsilon: float = 0.1
    optimization_tol: float = 1e-4
    reweight_tol: float = 1e-3

    flatfield: Optional[np.ndarray] = field(default=None, init=False)
    darkfield: Optional[np.ndarray] = field(default=None, init=False)
    baseline: Optional[np.ndarray] = field(default=None, init=False)
    residual: Optional[np.ndarray] = field(default=None, init=False)

    def fit(self, images, fitting_weight: Optional[np.ndarray] = None) -> "BaSiC":
        images = np.asarray(images, dtype=np.float32)
        if images.ndim != 3:
            raise ValueError(f"expected (n, h, w) images, got {images.shape}")
        n, full_h, full_w = images.shape
        ws = self.working_size

        x = jnp.asarray(images)
        x_small = jax.image.resize(x, (n, ws, ws), method="linear")
        if fitting_weight is not None:
            wgt = jnp.asarray(np.asarray(fitting_weight, np.float32))
            if wgt.ndim == 2:
                wgt = jnp.broadcast_to(wgt[None], images.shape)
            w_small = jax.image.resize(wgt, (n, ws, ws), method="linear")
        else:
            w_small = jnp.ones((n, ws, ws), jnp.float32)

        # Darkfield (two-stage): a quick stage-1 solve on the UNSORTED stack
        # gives per-image baselines b, the dark follows by per-pixel
        # regression against b, then the main reweighted fit runs on the
        # dark-subtracted stack. Must happen before sort_intensity: per-pixel
        # sorting destroys the (b_i, I_i) pairing the regression needs (see
        # _estimate_darkfield for why D cannot be recovered inside the
        # LADMAP iteration either).
        if self.get_darkfield:
            S1, b1, _ = _ladmap_fit(
                x_small,
                w_small,
                float(self.smoothness_flatfield),
                int(self.max_iterations),
                float(self.optimization_tol),
            )
            D = _estimate_darkfield(x_small, S1, b1, float(self.smoothness_darkfield))
            x_work = x_small - D[None]
        else:
            D = jnp.zeros((ws, ws), jnp.float32)
            x_work = x_small

        if self.sort_intensity:
            # Sort each pixel's stack across images: shading structure stays,
            # content decorrelates (BaSiCPy sort_intensity semantics).
            x_work = jnp.sort(x_work, axis=0)

        weight = w_small
        S = b = R = None
        last_S = None
        for _ in range(max(1, int(self.max_reweight_iterations))):
            S, b, R = _ladmap_fit(
                x_work,
                weight,
                float(self.smoothness_flatfield),
                int(self.max_iterations),
                float(self.optimization_tol),
            )
            # L1 reweighting on the residual
            w_new = jnp.ones_like(R) / (jnp.abs(R) / (jnp.mean(jnp.abs(x_work)) + 1e-6) + self.epsilon)
            weight = w_new * w_small
            weight = weight * (weight.size / jnp.sum(weight))
            if last_S is not None:
                rel = float(
                    jnp.linalg.norm((S - last_S).ravel())
                    / (jnp.linalg.norm(last_S.ravel()) + 1e-6)
                )
                if rel < self.reweight_tol:
                    last_S = S
                    break
            last_S = S

        S_full = jax.image.resize(S, (full_h, full_w), method="linear")
        S_full = S_full / jnp.maximum(jnp.mean(S_full), 1e-6)
        D_full = jax.image.resize(D, (full_h, full_w), method="linear")

        self.flatfield = np.asarray(S_full)
        self.darkfield = np.asarray(D_full)
        self.baseline = np.asarray(b)
        self.residual = np.asarray(R)
        return self

    # BaSiCPy also exposes transform(); provide it for parity.
    def transform(self, images, timelapse: bool = False) -> np.ndarray:
        """Correct images with the fitted fields: ``(I - D) / S``; with
        ``timelapse=True`` additionally subtract the per-image baseline
        (BaSiCPy transform semantics — round-1 omission)."""
        if self.flatfield is None:
            raise RuntimeError("call fit() first")
        images = np.asarray(images, np.float32)
        out = (images - self.darkfield[None]) / np.maximum(
            self.flatfield[None], 1e-6
        )
        if timelapse:
            if self.sort_intensity:
                # the fit ran on the per-pixel-SORTED stack, so baseline[i]
                # belongs to rank i, not to images[i] (the docstring's
                # "destroys the (b_i, I_i(x)) pairing") — subtracting it
                # here would silently misalign every frame
                raise ValueError(
                    "timelapse transform is incompatible with "
                    "sort_intensity=True: the per-image baselines were fit "
                    "on the sorted stack and no longer pair with the inputs"
                )
            if images.shape[0] != self.baseline.shape[0]:
                raise ValueError(
                    f"timelapse transform needs one baseline per image: "
                    f"{images.shape[0]} images vs {self.baseline.shape[0]} baselines"
                )
            out = out - self.baseline[:, None, None]
        return out
