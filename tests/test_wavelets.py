"""
Wavelet transform fidelity tests.

The JAX conv-based DWT is validated three ways:
1. filter banks against published PyWavelets db1..db4 coefficients,
2. hand-derived haar vectors (anchoring the symmetric-extension phase),
3. cross-checked against an independently implemented matrix-based numpy
   oracle (tests/golden/numpy_ref.py) plus perfect-reconstruction round trips
   over a grid of odd/even geometries.
"""

import jax
import numpy as np
import pytest

from aind_smartspim_destripe_tpu.ops import wavelets as W
from tests.golden import numpy_ref as G

# Published pywt filter banks (dec_lo), exact to ~1e-10.
PYWT_DEC_LO = {
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [
        -0.12940952255092145,
        0.22414386804185735,
        0.836516303737469,
        0.48296291314469025,
    ],
    "db3": [
        0.035226291882100656,
        -0.08544127388224149,
        -0.13501102001039084,
        0.4598775021193313,
        0.8068915093133388,
        0.3326705529509569,
    ],
    "db4": [
        -0.010597401784997278,
        0.032883011666982945,
        0.030841381835986965,
        -0.18703481171888114,
        -0.02798376941698385,
        0.6308807679295904,
        0.7148465705525415,
        0.23037781330885523,
    ],
}


@pytest.mark.parametrize("name", sorted(PYWT_DEC_LO))
def test_filter_bank_matches_pywt(name):
    wav = W.wavelet(name)
    np.testing.assert_allclose(wav.dec_lo, PYWT_DEC_LO[name], atol=1e-9)
    # Orthonormality invariants
    assert abs(np.sum(wav.rec_lo_arr) - np.sqrt(2)) < 1e-10
    assert abs(np.sum(np.square(wav.dec_lo)) - 1.0) < 1e-10
    assert abs(np.sum(wav.dec_hi)) < 1e-10
    # Even-shift orthogonality of lo and hi
    for shift in range(2, wav.flen, 2):
        assert abs(np.dot(wav.dec_lo[:-shift], wav.dec_lo[shift:])) < 1e-10


def test_db_generic_orders():
    for order in (5, 6, 8, 10):
        wav = W.wavelet(f"db{order}")
        assert wav.flen == 2 * order
        assert abs(np.sum(wav.rec_lo_arr) - np.sqrt(2)) < 1e-8
        assert abs(np.sum(np.square(wav.dec_lo)) - 1.0) < 1e-8


def test_haar_hand_derived_vector():
    """pywt.dwt([1,2,3,4], 'haar') == cA [ (1+2)/sqrt2, (3+4)/sqrt2 ]: this
    pins the analysis phase (offset 1 into the symmetric extension)."""
    x = np.array([[1.0, 2.0, 3.0, 4.0]] * 4)  # constant rows
    ca, (ch, cv, cd) = map_np(W.dwt2)(x, W.wavelet("haar"))
    # After the y-pass on constant columns: lowpass row = sqrt(2)*[1,2,3,4]
    np.testing.assert_allclose(
        ca[0], np.array([3.0, 7.0]), atol=1e-6  # sqrt2 * (sqrt2*(1+2)/2 ...)
    )
    np.testing.assert_allclose(ch, 0.0, atol=1e-6)


def map_np(fn):
    def wrapped(x, *a, **k):
        out = fn(jax.numpy.asarray(x), *a, **k)
        return jax.tree_util.tree_map(np.asarray, out)

    return wrapped


def test_shape_ladder_production_geometry():
    wav = W.wavelet("db3")
    level, shapes = W.wavedec2_shapes((1600, 2000), wav, None)
    assert level == 8
    assert shapes[-1] == (802, 1002)  # finest
    assert shapes[0] == (11, 12)  # coarsest
    # ladder consistency
    h, w = 1600, 2000
    expect = []
    for _ in range(level):
        h, w = (h + 5) // 2, (w + 5) // 2
        expect.append((h, w))
    assert shapes == list(reversed(expect))


@pytest.mark.parametrize("name", ["db1", "db2", "db3", "db4"])
@pytest.mark.parametrize("shape", [(16, 16), (13, 17), (31, 9), (64, 100)])
def test_dwt2_matches_numpy_oracle(name, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    ca_j, (ch_j, cv_j, cd_j) = map_np(W.dwt2)(x, W.wavelet(name))
    ca_n, (ch_n, cv_n, cd_n) = G.dwt2_ref(x.astype(np.float64), name)
    np.testing.assert_allclose(ca_j, ca_n, atol=2e-5)
    np.testing.assert_allclose(ch_j, ch_n, atol=2e-5)
    np.testing.assert_allclose(cv_j, cv_n, atol=2e-5)
    np.testing.assert_allclose(cd_j, cd_n, atol=2e-5)


@pytest.mark.parametrize("name", ["db1", "db3"])
@pytest.mark.parametrize("shape", [(16, 16), (13, 17), (100, 64)])
def test_idwt2_matches_numpy_oracle(name, shape):
    rng = np.random.default_rng(1)
    wav = W.wavelet(name)
    ch_, cw_ = (
        W.dwt_coeff_len(shape[0], wav.flen),
        W.dwt_coeff_len(shape[1], wav.flen),
    )
    bands = [rng.normal(size=(ch_, cw_)).astype(np.float32) for _ in range(4)]
    y_j = map_np(W.idwt2)(bands[0], tuple(bands[1:]), wav)
    y_n = G.idwt2_ref(
        bands[0].astype(np.float64), [b.astype(np.float64) for b in bands[1:]], name
    )
    np.testing.assert_allclose(y_j, y_n, atol=2e-5)


@pytest.mark.parametrize("name", ["db1", "db2", "db3"])
@pytest.mark.parametrize("shape", [(32, 32), (37, 53), (64, 100), (100, 100)])
def test_perfect_reconstruction_multilevel(name, shape):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    wav = W.wavelet(name)
    coeffs = W.wavedec2(jax.numpy.asarray(x), wav, level=None)
    y = np.asarray(W.waverec2(coeffs, wav))
    assert y.shape[-2] >= shape[0] and y.shape[-1] >= shape[1]
    np.testing.assert_allclose(y[: shape[0], : shape[1]], x, atol=5e-5)


def test_multilevel_matches_oracle_and_batching():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 41, 57)).astype(np.float32)
    wav = W.wavelet("db3")
    coeffs_j = W.wavedec2(jax.numpy.asarray(x), wav, level=None)
    coeffs_n = G.wavedec2_ref(x.astype(np.float64), "db3", level=None)
    assert len(coeffs_j) == len(coeffs_n)
    np.testing.assert_allclose(np.asarray(coeffs_j[0]), coeffs_n[0], atol=1e-4)
    for (j_det, n_det) in zip(coeffs_j[1:], coeffs_n[1:]):
        for a, b in zip(j_det, n_det):
            np.testing.assert_allclose(np.asarray(a), b, atol=1e-4)
    # batched == per-plane
    single = W.wavedec2(jax.numpy.asarray(x[1]), wav, level=None)
    np.testing.assert_allclose(
        np.asarray(coeffs_j[0][1]), np.asarray(single[0]), atol=1e-6
    )


def test_waverec2_crop_rule_odd_shapes():
    """Odd geometries force the crop-by-one rule at several levels."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(45, 77)).astype(np.float32)
    wav = W.wavelet("db3")
    coeffs = W.wavedec2(jax.numpy.asarray(x), wav, level=2)
    y = np.asarray(W.waverec2(coeffs, wav))
    y_ref = G.waverec2_ref(G.wavedec2_ref(x.astype(np.float64), "db3", 2), "db3")
    np.testing.assert_allclose(y, y_ref, atol=1e-4)
    np.testing.assert_allclose(y[:45, :77], x, atol=5e-5)


def test_max_level_zero_small_image():
    wav = W.wavelet("db3")
    level, shapes = W.wavedec2_shapes((4, 4), wav, None)
    assert level == 0 and shapes == []


def test_matmul_path_matches_conv_path():
    """The banded-matmul DWT must agree with the strided-conv derivation."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 45, 77)).astype(np.float32)
    wav = W.wavelet("db3")
    ca_m, det_m = map_np(W.dwt2)(x, wav)
    ca_c, det_c = map_np(W.dwt2_conv)(x, wav)
    np.testing.assert_allclose(ca_m, ca_c, atol=2e-5)
    for a, b in zip(det_m, det_c):
        np.testing.assert_allclose(a, b, atol=2e-5)
    y_m = map_np(W.idwt2)(ca_m, det_m, wav)
    y_c = map_np(W.idwt2_conv)(ca_m, det_m, wav)
    np.testing.assert_allclose(y_m, y_c, atol=2e-5)


def test_blocked_path_matches_dense_operators():
    """The default blocked shift-invariant path must agree with the dense
    per-geometry operator path (same math, different blocking)."""
    rng = np.random.default_rng(11)
    for shape in [(45, 77), (64, 100), (16, 16), (13, 17), (130, 258)]:
        x = rng.normal(size=(2,) + shape).astype(np.float32)
        wav = W.wavelet("db3")
        h, w = shape
        dense_ops = (
            np.asarray(W.analysis_operator(h, "db3")),
            np.asarray(W.analysis_operator(w, "db3")),
        )
        ca_b, det_b = map_np(W.dwt2)(x, wav)
        ca_d, det_d = map_np(W.dwt2)(x, wav, tuple(map(jax.numpy.asarray, dense_ops)))
        np.testing.assert_allclose(ca_b, ca_d, atol=3e-5)
        for a, b in zip(det_b, det_d):
            np.testing.assert_allclose(a, b, atol=3e-5)

        syn_ops = (
            jax.numpy.asarray(W.synthesis_operator(ca_b.shape[-2], "db3")),
            jax.numpy.asarray(W.synthesis_operator(ca_b.shape[-1], "db3")),
        )
        y_b = map_np(W.idwt2)(ca_b, det_b, wav)
        y_d = map_np(W.idwt2)(ca_b, det_b, wav, syn_ops)
        np.testing.assert_allclose(y_b, y_d, atol=3e-5)


@pytest.mark.parametrize("shape", [(70, 64), (561, 600)])
@pytest.mark.parametrize("name", ["db1", "db2", "db4"])
def test_blocked_path_matches_dense_per_wavelet(name, shape):
    """The blocked analysis/synthesis windows depend on the filter length:
    the other Daubechies orders agree with the dense operators too, at a
    small and a >= 560 geometry."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(1,) + shape).astype(np.float32)
    wav = W.wavelet(name)
    h, w = shape
    dense = (jax.numpy.asarray(W.analysis_operator(h, name)),
             jax.numpy.asarray(W.analysis_operator(w, name)))
    ca_b, det_b = map_np(W.dwt2)(x, wav)
    ca_d, det_d = map_np(W.dwt2)(x, wav, dense)
    for a, b in zip((ca_b,) + tuple(det_b), (ca_d,) + tuple(det_d)):
        np.testing.assert_allclose(a, b, atol=5e-5)
    syn = (jax.numpy.asarray(W.synthesis_operator(ca_b.shape[-2], name)),
           jax.numpy.asarray(W.synthesis_operator(ca_b.shape[-1], name)))
    np.testing.assert_allclose(
        map_np(W.idwt2)(ca_b, det_b, wav),
        map_np(W.idwt2)(ca_b, det_b, wav, syn), atol=5e-5,
    )


# ---------------------------------------------------------------------------
# Brute-force from-the-definition oracle (third, independent expression)
# ---------------------------------------------------------------------------
# pywt itself is not installable in this environment, so true pywt-generated
# arrays cannot be vendored. Instead: the published filter literals above +
# the documented algorithm (symmetric half-sample extension, correlate,
# downsample at odd phases) re-expressed with np.convolve — no shared code
# with ops/wavelets.py or tests/golden/numpy_ref.py.


def _bf_dwt1d(x, dec):
    flen = len(dec)
    if flen > 1:
        x = np.concatenate([x[: flen - 1][::-1], x, x[-(flen - 1):][::-1]])
    conv = np.convolve(x, dec)  # pywt convolves the extension with dec
    L = (len(x) - 2 * (flen - 1) + flen - 1) // 2
    return conv[flen : flen + 2 * L - 1 : 2]


def _bf_dwt2(img, dec_lo, dec_hi):
    lo = np.stack([_bf_dwt1d(r, dec_lo) for r in img])
    hi = np.stack([_bf_dwt1d(r, dec_hi) for r in img])
    ca = np.stack([_bf_dwt1d(c, dec_lo) for c in lo.T], axis=1)
    ch = np.stack([_bf_dwt1d(c, dec_hi) for c in lo.T], axis=1)
    cv = np.stack([_bf_dwt1d(c, dec_lo) for c in hi.T], axis=1)
    cd = np.stack([_bf_dwt1d(c, dec_hi) for c in hi.T], axis=1)
    return ca, (ch, cv, cd)


def _qmf_hi(dec_lo):
    # pywt: rec_hi[k] = (-1)^k rec_lo[n-1-k] (qmf), dec_hi = rec_hi reversed
    # => dec_hi[k] = (-1)^(n-1-k) dec_lo[n-1-k]
    n = len(dec_lo)
    return [((-1) ** (n - 1 - k)) * dec_lo[n - 1 - k] for k in range(n)]


def test_pywt_doc_example_db1():
    """The official pywt docs example: dwt([1,2,3,4], 'db1') ->
    cA=[2.12132034, 4.94974747], cD=[-0.70710678, -0.70710678]."""
    dec_lo = np.array(PYWT_DEC_LO["db1"])
    dec_hi = np.array(_qmf_hi(PYWT_DEC_LO["db1"]))
    ca = _bf_dwt1d(np.array([1.0, 2, 3, 4]), dec_lo)
    cd = _bf_dwt1d(np.array([1.0, 2, 3, 4]), dec_hi)
    np.testing.assert_allclose(ca, [2.12132034, 4.94974747], atol=1e-8)
    np.testing.assert_allclose(cd, [-0.70710678, -0.70710678], atol=1e-8)


@pytest.mark.parametrize("name", ["db2", "db3"])
@pytest.mark.parametrize("shape", [(11, 13), (16, 16), (23, 9)])
def test_wavedec2_matches_bruteforce_literals(name, shape):
    """Full multi-level wavedec2 against the from-the-definition oracle built
    ONLY from published literals (de-circularizes the self-authored oracle)."""
    rng = np.random.default_rng(sum(shape))
    img = rng.normal(size=shape)
    wav = W.wavelet(name)
    dec_lo = np.array(PYWT_DEC_LO[name])
    dec_hi = np.array(_qmf_hi(PYWT_DEC_LO[name]))

    level, _ = W.wavedec2_shapes(shape, wav, None)
    got = [
        np.asarray(c) if not isinstance(c, tuple) else tuple(map(np.asarray, c))
        for c in W.wavedec2(jax.numpy.asarray(img), wav, None)
    ]

    approx = img
    want = []
    for _ in range(level):
        approx, det = _bf_dwt2(approx, dec_lo, dec_hi)
        want.append(det)
    want = [approx] + want[::-1]

    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        for gb, wb in zip(g, w):
            np.testing.assert_allclose(gb, wb, atol=1e-5)


def test_db_high_orders_full_characterization():
    """db5..db20 (beyond the vendored literals): the three properties that
    UNIQUELY characterize a Daubechies filter of order N up to reflection —
    (1) orthonormality of even shifts (sum_k h[k] h[k+2m] = delta_m),
    (2) N vanishing moments of the highpass (sum_k k^p g[k] = 0, p < N),
    (3) minimum phase (energy front-loaded, the pywt convention) — plus a
    multilevel perfect-reconstruction roundtrip at the highest order."""
    for order in (5, 7, 9, 12, 16, 20):
        wav = W.wavelet(f"db{order}")
        h = wav.rec_lo_arr
        g = wav.dec_hi
        # (1) orthonormal shifts
        for m in range(order):
            dot = float(np.dot(h[: len(h) - 2 * m], h[2 * m :]))
            assert abs(dot - (1.0 if m == 0 else 0.0)) < 1e-9, (order, m)
        # (2) vanishing moments (normalize k^p to the filter span so high
        # powers stay O(1); the zero must hold relative to |g|)
        k = np.arange(len(g), dtype=np.float64)
        for p in range(order):
            mom = float(np.sum(((k / len(g)) ** p) * g))
            assert abs(mom) < 1e-7, (order, p, mom)
        # (3) minimum phase: cumulative energy of the front half dominates
        half = len(h) // 2
        assert float(np.sum(h[:half] ** 2)) > float(np.sum(h[half:] ** 2)), order

    # perfect reconstruction through the production matmul path at db20
    import jax.numpy as jnp

    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 128, 160)).astype(np.float32) * 10
    wav = W.wavelet("db20")
    ca, det = W.dwt2(jnp.asarray(x), wav)
    rec = np.asarray(W.idwt2(ca, det, wav))[..., :128, :160]
    np.testing.assert_allclose(rec, x, atol=5e-4, rtol=1e-4)
