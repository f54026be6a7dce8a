"""
Gaussian-notch row filtering equivalent to the reference's packed-format
scipy.fftpack pipeline, recast as a matmul.

The reference multiplies the *packed* output of scipy.fftpack.rfft by a 1-D
Gaussian notch elementwise (filtering.py:206-215). FFTPACK's legacy packing is
``[r0, Re(y1), Im(y1), Re(y2), Im(y2), ..., (Re(y_{n/2}) if n even)]`` — so
frequency k's real part is scaled by g[2k-1] and its imaginary part by g[2k]:
two *different* gains per frequency. A naive ``irfft(rfft(x) * g)`` with the
modern complex layout changes the output.

Because rfft -> per-bin (real, imag) gains -> irfft is a fixed real linear map
of each row, we precompute the exact n x n operator B (float64 numpy at trace
time, applied as x @ B^T in float32) — this both reproduces the packed-format
semantics bit-faithfully and turns awkward odd-length FFTs (1002, 503, 129...)
into dense matmuls on the device's matrix units.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "notch",
    "gaussian_filter",
    "packed_notch_matrix",
    "apply_notch",
]


def notch(n: int, sigma: float) -> np.ndarray:
    """1-D Gaussian notch ``1 - exp(-x^2 / (2 sigma^2))`` of length n
    (reference filtering.py:91-115)."""
    if n <= 0:
        raise ValueError("n must be positive")
    n = int(n)
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    x = np.arange(n)
    return 1.0 - np.exp(-(x**2) / (2.0 * sigma**2))


def gaussian_filter(shape: tuple, sigma: float) -> np.ndarray:
    """Broadcast the notch over ``shape`` (reference filtering.py:118-136)."""
    g = notch(n=shape[-1], sigma=sigma)
    return np.broadcast_to(g, shape).copy()


def _packed_gains(n: int, g: np.ndarray):
    """Split the packed-layout gain vector into per-frequency (real, imag)
    gains for the modern complex rfft layout of length n//2 + 1."""
    nfreq = n // 2 + 1
    a = np.zeros(nfreq)  # real-part gains
    b = np.zeros(nfreq)  # imag-part gains
    a[0] = g[0]
    b[0] = g[0]  # DC has no imaginary part; gain irrelevant but keep symmetric
    for k in range(1, (n + 1) // 2):
        a[k] = g[2 * k - 1]
        b[k] = g[2 * k]
    if n % 2 == 0:
        a[n // 2] = g[n - 1]
        b[n // 2] = g[n - 1]  # Nyquist bin is real
    return a, b


@lru_cache(maxsize=None)
def packed_notch_matrix(n: int, sigma: float) -> np.ndarray:
    """The n x n real operator B with ``y = x @ B.T`` equal to
    ``fftpack.irfft(fftpack.rfft(x) * notch(n, sigma))`` on each length-n row.

    Built in float64 by pushing the identity through the (packed-gain) spectral
    map with numpy's FFT; cached per (length, sigma).
    """
    g = notch(n, float(sigma))
    a, b = _packed_gains(n, g)
    eye = np.eye(n)
    spec = np.fft.rfft(eye, axis=-1)
    spec = a * spec.real + 1j * (b * spec.imag)
    basis = np.fft.irfft(spec, n=n, axis=-1)
    # Row i of `basis` is the image of e_i, so y = x @ basis.
    return np.ascontiguousarray(basis.T)  # y = x @ B.T with B = basis.T


def apply_notch(rows: jax.Array, bmat: jax.Array) -> jax.Array:
    """Apply a precomputed notch operator to the last axis of ``rows``."""
    return jnp.matmul(rows, bmat.T, precision=jax.lax.Precision.HIGHEST)

