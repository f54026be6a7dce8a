"""
The analysis / synthesis / classifier stages of ops/filter.py at
>= 560 x 560 geometries, against the float64 numpy oracle
(tests/golden/numpy_ref.py) and against ops/wavelets.dwt2: the plan's dense
operators, the lowpass-x-first analysis of every level, the delta synthesis
of the lowpass-x half, and the float16 classifier decision.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from aind_smartspim_destripe_tpu.ops import wavelets as wv
from aind_smartspim_destripe_tpu.ops.filter import (
    FilterConfig,
    analysis_bands,
    build_plan,
    classify_planes,
    synthesis_correction,
)
from tests.golden import numpy_ref as G

H, W = 640, 768


def _plan(h=H, w=W, level=1):
    cfg = FilterConfig(wavelet="db3", level=level, sigma=64, max_threshold=3)
    return build_plan(h, w, cfg, cfg)


@pytest.fixture(scope="module")
def plan():
    return _plan()


@pytest.fixture(scope="module")
def consts(plan):
    return plan.constants()


def _dec(name="db3"):
    wav = wv.wavelet(name)
    return wav.dec_lo, wav.dec_hi


@pytest.mark.parametrize("h,w", [(61, 90), (96, 128), (561, 600),
                                 (1600, 2000)])
def test_constants_shapes_follow_the_ladder(h, w):
    """Every level carries dense float32 operators whose shapes chain:
    analysis finest first (an_y (2L_h, h), an_x_lo (L_w, w)), synthesis and
    notch coarsest first (syn_y trimmed to the next level's rows, syn_x_lo
    (w_t, L_w), notch_cat (w, 2w) on the detail width)."""
    cfg = FilterConfig(wavelet="db3", level=None, sigma=64, max_threshold=3)
    plan = build_plan(h, w, cfg, cfg)
    c = plan.constants()
    n = plan.n_levels
    assert all(len(c[k]) == n for k in c)
    assert all(a.dtype == np.float32 for k in c for a in c[k])
    flen = wv.wavelet("db3").flen
    rows, cols = h, w
    for lvl in range(n):
        L_h, L_w = wv.dwt_coeff_len(rows, flen), wv.dwt_coeff_len(cols, flen)
        assert c["an_y"][lvl].shape == (2 * L_h, rows)
        assert c["an_x_lo"][lvl].shape == (L_w, cols)
        # the same level seen from the coarsest-first side
        i = n - 1 - lvl
        assert plan.ladder[i] == (L_h, L_w)
        assert c["syn_y"][i].shape == (rows, 2 * L_h)
        assert c["syn_x_lo"][i].shape == (cols, L_w)
        assert c["notch_cat"][i].shape == (L_w, 2 * L_w)
        rows, cols = L_h, L_w


def test_analysis_operators_match_oracle(plan, consts):
    """an_x_lo is the lowpass analysis matrix of the width, an_y stacks the
    lowpass and highpass matrices of the height (float64 oracle)."""
    lo, hi = _dec()
    np.testing.assert_allclose(
        consts["an_x_lo"][0], G.analysis_matrix(W, lo), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        consts["an_y"][0],
        np.concatenate([G.analysis_matrix(H, lo), G.analysis_matrix(H, hi)]),
        rtol=0, atol=1e-6,
    )


def test_synthesis_operators_reconstruct(plan, consts):
    """syn_y @ an_y is the identity on the plane rows (perfect
    reconstruction of the folded symmetric DWT), likewise for x."""
    ident_y = consts["syn_y"][0].astype(np.float64) @ consts["an_y"][0]
    np.testing.assert_allclose(ident_y, np.eye(H), atol=1e-5)
    A_x = wv.analysis_operator(W, "db3").astype(np.float64)
    S_x = wv.synthesis_operator(A_x.shape[0] // 2, "db3")[:W]
    np.testing.assert_allclose(S_x @ A_x, np.eye(W), atol=1e-5)


def test_notch_operator_layout(plan, consts):
    """notch_cat is [cells^T | no_cells^T] of the packed-FFT notch."""
    (bc, bn), = plan.notch_matrices()
    cat = consts["notch_cat"][0]
    w = bc.shape[0]
    assert cat.shape == (w, 2 * w)
    np.testing.assert_array_equal(cat[:, :w], bc.T)
    np.testing.assert_array_equal(cat[:, w:], bn.T)


def test_level0_band_matches_oracle_log1p(plan, consts):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 4000, size=(2, H, W))
    (ch,) = analysis_bands(jnp.asarray(np.log1p(x), jnp.float32), consts)
    for b in range(2):
        _, (want, _, _) = G.dwt2_ref(np.log1p(x[b]), "db3")
        np.testing.assert_allclose(np.asarray(ch[b]), want, rtol=2e-5,
                                   atol=2e-4)


def test_level0_band_from_uint16_planes(plan, consts):
    """Raw uint16 planes through the graph's log1p cast."""
    rng = np.random.default_rng(5)
    x16 = rng.integers(0, 65535, size=(1, H, W), dtype=np.uint16)
    xlog = jnp.log(1.0 + jnp.asarray(x16).astype(jnp.float32))
    (ch,) = analysis_bands(xlog, consts)
    _, (want, _, _) = G.dwt2_ref(np.log1p(x16[0].astype(np.float64)), "db3")
    np.testing.assert_allclose(np.asarray(ch[0]), want, rtol=2e-5, atol=2e-3)


def test_band_matches_wavelets_dwt2(plan, consts):
    """The lowpass-x-first analysis equals the cH of the blocked dwt2."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, H, W)) * 3.0).astype(np.float32)
    (ch,) = analysis_bands(jnp.asarray(x), consts)
    _, (want, _, _) = wv.dwt2(jnp.asarray(x), wv.wavelet("db3"))
    np.testing.assert_allclose(np.asarray(ch), np.asarray(want), rtol=2e-5,
                               atol=2e-4)


def test_multilevel_bands_match_oracle():
    """Every level of a 3-level plan, finest first, against wavedec2."""
    plan3 = _plan(level=3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, H, W))
    chs = analysis_bands(jnp.asarray(x, jnp.float32), plan3.constants())
    ref = G.wavedec2_ref(x[0], "db3", level=3)  # coarsest first
    assert len(chs) == 3
    for lvl, ch in enumerate(chs):
        want = ref[len(ref) - 1 - lvl][0]
        assert ch.shape[1:] == want.shape
        np.testing.assert_allclose(np.asarray(ch[0]), want, rtol=3e-5,
                                   atol=6e-4)


def test_level1_chain_at_1280():
    """Level 1 of a 1280 x 1280 plan (643 x 643 input): analysis and the
    delta synthesis of that level against the oracle."""
    plan2 = _plan(1280, 1280, level=2)
    consts2 = plan2.constants()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 1280, 1280))
    chs = analysis_bands(jnp.asarray(x, jnp.float32), consts2)
    ca1, (ch1, _, _) = G.dwt2_ref(x[0], "db3")
    _, (ch2, _, _) = G.dwt2_ref(ca1, "db3")
    np.testing.assert_allclose(np.asarray(chs[0][0]), ch1, rtol=3e-5,
                               atol=6e-4)
    np.testing.assert_allclose(np.asarray(chs[1][0]), ch2, rtol=3e-5,
                               atol=6e-4)


def _synthesis_oracle(deltas, shape):
    """waverec2 of a zero pyramid with the cH deltas (coarsest first): the
    correction the delta synthesis must produce."""
    coeffs = [np.zeros_like(deltas[0])]
    for d in deltas:
        z = np.zeros_like(d)
        coeffs.append((d, z, z))
    return G.waverec2_ref(coeffs, "db3")[: shape[0], : shape[1]]


def test_synthesis_single_level_matches_oracle(plan, consts):
    rng = np.random.default_rng(4)
    L_h, L_w = plan.ladder[-1]
    delta = rng.normal(size=(1, L_h, L_w)) * 0.01
    got = synthesis_correction([jnp.asarray(delta, jnp.float32)], consts)
    want = _synthesis_oracle([delta[0]], (H, W))
    assert got.shape == (1, H, W)
    np.testing.assert_allclose(np.asarray(got[0]), want, rtol=2e-4,
                               atol=1e-5)


def test_synthesis_multilevel_matches_oracle():
    plan3 = _plan(level=3)
    rng = np.random.default_rng(8)
    deltas = [rng.normal(size=s) * 0.01 for s in plan3.ladder]
    got = synthesis_correction(
        [jnp.asarray(d[None], jnp.float32) for d in deltas],
        plan3.constants(),
    )
    want = _synthesis_oracle(deltas, (H, W))
    np.testing.assert_allclose(np.asarray(got[0]), want, rtol=2e-4,
                               atol=2e-5)


def test_zero_deltas_give_zero_correction(plan, consts):
    """Perfect reconstruction: an unfiltered pyramid corrects nothing."""
    L_h, L_w = plan.ladder[-1]
    got = synthesis_correction([jnp.zeros((2, L_h, L_w))], consts)
    assert float(jnp.abs(got).max()) == 0.0


@pytest.mark.parametrize("level", [300.0, 3200.0])
def test_classifier_matches_oracle(level):
    """The float16-sigmoid fore/background classifier (reference
    filtering.py:54-88, 459-467) decides like the oracle, on dim and bright
    planes and on a plane straddling the 400-count center."""
    rng = np.random.default_rng(int(level))
    planes = np.clip(
        np.stack([
            level + rng.normal(size=(H, W)) * 20,
            np.where(rng.random((H, W)) < 0.3, 3000.0, 200.0),
        ]),
        0, 65535,
    ).astype(np.uint16)
    got = np.asarray(classify_planes(jnp.asarray(planes), 2500.0))
    for b in range(2):
        fg, bg, _ = G.foreground_background_mean_ref(planes[b])
        assert bool(got[b]) == bool(fg > bg and fg > 2500.0)
