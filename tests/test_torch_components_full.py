"""The port's full-covariance component model and its statistics against the
JAX package at float64 (``segmentalist_tpu.models.components_full``,
``ops.stats`` with ``full_cov``, ``segmenters.common`` and the touched-slot
tables of ``segmenters.fullcov``), plus a closed-form check of the
predictive.  ``torch.linalg``'s Cholesky is not the JAX package's unrolled
one, so values agree to rounding (1e-10 relative), not bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.special import gammaln

from segmentalist_tpu.models import components_full as jcf
from segmentalist_tpu.ops import stats as jstats
from segmentalist_tpu.priors import NIW as JNIW
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters import fullcov as jfull

from segmentalist_torch.models import components_full as tcf
from segmentalist_torch.models import cov_module
from segmentalist_torch.ops import stats as tstats
from segmentalist_torch.priors import NIW
from segmentalist_torch.segmenters import common as tcommon
from segmentalist_torch.segmenters import fullcov as tfull

from touched_reference import all_slot_leave_out, all_slot_touched

RTOL = 1e-10


def _assignments(seed, N=24, K=6):
    return np.random.RandomState(seed + 100).randint(-1, K - 1, N)


def _state(seed, N=24, D=4, K=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    assign = _assignments(seed, N, K)  # slot K-1 stays empty
    A = rng.randn(D, D)
    m_0, S_0 = 0.3 * rng.randn(D), 0.3 * np.eye(D) + 0.05 * A @ A.T
    k_0, v_0 = 0.4, D + 2.0
    stats = tstats.suff_stats_from_assignments(
        torch.as_tensor(X), torch.as_tensor(assign), K, full_cov=True)
    js = jstats.suff_stats_from_assignments(
        jnp.asarray(X), jnp.asarray(assign, dtype=jnp.int32), K,
        full_cov=True)
    return (X, NIW.create(m_0, k_0, v_0, S_0), stats,
            JNIW.create(m_0, k_0, v_0, S_0), js)


def _close(got, want, rtol=RTOL):
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                        atol=rtol)


# -- statistics ---------------------------------------------------------------

def test_full_statistics_match_jax():
    X, tp, st, jp, js = _state(0)
    for got, want in zip(st, js):
        _close(got, want, 1e-12)
    assert st.sum_sq.shape == (6, 4, 4)
    e = tstats.empty_suff_stats(6, 4, torch.float64, full_cov=True)
    assert e.sum_sq.shape == (6, 4, 4) and float(e.sum_sq.abs().sum()) == 0
    x = torch.as_tensor(X[3])
    for weight in (1, -1):
        got = tstats.add_item(st, x, 2, full_cov=True, weight=weight)
        want = jstats.add_item(js, jnp.asarray(X[3]), 2, full_cov=True,
                               weight=weight)
        for g, w in zip(got, want):
            _close(g, w, 1e-12)
    got = tstats.del_item(st, x, 2, full_cov=True)
    _close(got.sum_sq, jstats.del_item(js, jnp.asarray(X[3]), 2,
                                       full_cov=True).sum_sq, 1e-12)


@pytest.mark.parametrize("D", [1, 3, 13])
def test_sym_pack_matches_jax_indices(D):
    iu0, iu1, unpack = jcommon.sym_pack_indices(D)
    pk = tstats.sym_pack(D, torch.device("cpu"))
    npt.assert_array_equal(pk.iu0.numpy(), iu0)
    npt.assert_array_equal(pk.iu1.numpy(), iu1)
    npt.assert_array_equal(pk.unpack.numpy(), unpack)
    il0, il1 = np.tril_indices(D)
    npt.assert_array_equal(pk.il0.numpy(), il0)
    npt.assert_array_equal(pk.il1.numpy(), il1)
    assert tstats.sym_pack(D, torch.device("cpu")) is pk  # built once
    x = torch.as_tensor(np.random.RandomState(D).randn(5, D))
    full = tstats.item_sq(x, full_cov=True)
    npt.assert_array_equal(
        tstats.unpack_sym(tstats.packed_outer(x), D).numpy(), full.numpy())


def test_flat_contrib_full_matches_jax():
    rng = np.random.RandomState(4)
    B, S, D, K = 3, 5, 4, 7
    X = rng.randn(30, D)
    embeds = rng.randint(-1, 30, (B, S)).astype(np.int32)
    ks = rng.randint(-1, K, (B, S)).astype(np.int32)
    valid = np.array([True, False, True])
    got = tcommon.flat_contrib(torch.as_tensor(X), torch.as_tensor(embeds),
                               torch.as_tensor(ks), K,
                               torch.as_tensor(valid), full_cov=True)
    want = jcommon.flat_contrib(jnp.asarray(X), jnp.asarray(embeds),
                                jnp.asarray(ks), K, True, jnp.asarray(valid))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


# -- the component model ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_predictive_params_match_jax(seed):
    X, tp, st, jp, js = _state(seed)
    params = tcf.predictive_params(tp, st)
    for got, want in zip(params, jcf.predictive_params(jp, js)):
        _close(got, want)
    # the scorer's whitening factor: lower triangular, L^T L = inv_covar
    L = params.chol_inv
    assert bool((L == L.tril()).all())
    _close(L.transpose(-1, -2) @ L, params.inv_covar)


def test_update_predictive_row_matches_jax():
    X, tp, st, jp, js = _state(3)
    params = tcf.predictive_params(tp, st)
    jparams = jcf.predictive_params(jp, js)
    for k in (0, 5):
        for got, want in zip(tcf.update_predictive_row(tp, st, params, k),
                             jcf.update_predictive_row(jp, js, jparams, k)):
            _close(got, want)


def test_scores_match_jax():
    X, tp, st, jp, js = _state(4)
    params = tcf.predictive_params(tp, st)
    jparams = jcf.predictive_params(jp, js)
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    _close(tcf.log_post_pred(params, Xt[3]), jcf.log_post_pred(jparams, Xj[3]))
    _close(tcf.log_post_pred_batch(params, Xt),
           jcf.log_post_pred_batch(jparams, Xj))
    _close(tcf.log_prior(tp, Xt[5]), jcf.log_prior(jp, Xj[5]))
    _close(tcf.log_prior_batch(tp, Xt), jcf.log_prior_batch(jp, Xj))


def test_log_marg_and_map_match_jax_and_mask_empty_slots():
    X, tp, st, jp, js = _state(5)
    got = tcf.log_marg_k_vec(tp, st)
    _close(got, jcf.log_marg_k_vec(jp, js))
    assert got[-1] == 0.0 and st.counts[-1] == 0
    _close(tcf.log_marg(tp, st), jcf.log_marg(jp, js))
    for got, want in zip(tcf.map_k(tp, st, 1), jcf.map_k(jp, js, 1)):
        _close(got, want)


def test_family_dispatch():
    assert cov_module("full") is tcf


def test_log_post_pred_against_closed_form():
    """One component's predictive is the multivariate Student's t with
    scale (k_N + 1) / (k_N (v_N - D + 1)) S_N (reference
    gaussian_components.py:228-251), computed here with numpy."""
    X, tp, st, jp, js = _state(6)
    D = X.shape[1]
    idx = 2
    members = X[_assignments(6) == idx]
    n = len(members)
    m_0, S_0 = tp.m_0.numpy(), tp.S_0.numpy()
    k_0, v_0 = float(tp.k_0), float(tp.v_0)
    k_n, v_n = k_0 + n, v_0 + n
    m_n = (k_0 * m_0 + members.sum(0)) / k_n
    S_n = (S_0 + members.T @ members + k_0 * np.outer(m_0, m_0)
           - k_n * np.outer(m_n, m_n))
    v = v_n - D + 1
    cov = (k_n + 1) / (k_n * v) * S_n
    x = X[0] + 0.3
    d = x - m_n
    want = (gammaln((v + D) / 2) - gammaln(v / 2) - D / 2 * math.log(v * np.pi)
            - 0.5 * np.linalg.slogdet(cov)[1]
            - (v + D) / 2 * math.log1p(d @ np.linalg.solve(cov, d) / v))
    params = tcf.predictive_params(tp, st)
    got = tcf.log_post_pred(params, torch.as_tensor(x))[idx]
    npt.assert_allclose(float(got), want, rtol=1e-10)


# -- the touched-slot tables of segmenters/fullcov.py -------------------------

def _touched_case(seed=7, D=4, K=6):
    X, tp, st, jp, js = _state(seed, D=D, K=K)
    assign = _assignments(seed, X.shape[0], K)
    e = np.nonzero(assign >= 0)[0]  # old segments are assigned members
    dup = e[(assign[e] == assign[e[3]]) & (e != e[3])][0]
    old_embeds = np.array([[e[0], e[1], e[2], -1], [e[3], dup, e[4], e[5]],
                           [-1, -1, -1, -1]], np.int32)
    old_ks = np.where(old_embeds >= 0, assign[np.maximum(old_embeds, 0)],
                      -1).astype(np.int32)
    assert old_ks[1, 0] == old_ks[1, 1]  # a duplicate component
    t = tfull.touched_leave_out(tp, st, torch.as_tensor(X),
                                torch.as_tensor(old_embeds),
                                torch.as_tensor(old_ks))
    j = jfull.touched_leave_out(jp, js, jnp.asarray(X),
                                jnp.asarray(old_embeds), jnp.asarray(old_ks))
    return X, tp, st, jp, js, t, j


def test_touched_leave_out_matches_jax():
    *_, t, j = _touched_case()
    npt.assert_array_equal(t.tk.numpy(), np.asarray(j.tk))
    npt.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    live = t.tk.numpy() >= 0
    for got, want in zip(t.params, j.params):
        _close(np.asarray(got)[live], np.asarray(want)[live])


def test_score_and_chain_tables_match_jax():
    X, tp, st, jp, js, t, j = _touched_case()
    pg, jpg = tcf.predictive_params(tp, st), jcf.predictive_params(jp, js)
    g, tt, tslot = tfull.fullcov_score_inputs(pg, t)
    jg, jt, oh, tmask = jfull.fullcov_score_inputs(jpg, j)
    D = X.shape[1]
    pk = tstats.sym_pack(D, torch.device("cpu"))

    def expanded(L, Lmu):
        """The JAX package's (A2, A1, a0) from the whitening tables: A =
        L^T L packed with doubled off-diagonals, A mu = L^T Lmu, mu . A mu =
        |Lmu|^2."""
        full = L.new_zeros(L.shape[:-1] + (D, D))
        full[..., pk.il0, pk.il1] = L
        A = full.transpose(-1, -2) @ full
        return (A[..., pk.iu0, pk.iu1] * pk.dbl,
                (full.transpose(-1, -2) @ Lmu[..., None])[..., 0],
                (Lmu * Lmu).sum(-1))

    for got, want in zip(expanded(g[0].T, g[1].T) + g[2:], jg):
        _close(got, want)
    live = t.tk.numpy() >= 0
    for got, want in zip(expanded(tt[0], tt[1]) + tt[2:], jt):
        _close(np.asarray(got)[live], np.asarray(want)[live])
    # the slot index picks what the slot one-hot matrix picks
    K = pg.mu.shape[0]
    picked = np.where(tslot.numpy() >= 0, tslot.numpy(), -1)
    oh = np.asarray(oh)
    for b in range(oh.shape[0]):
        for k in range(K):
            rows = np.nonzero(oh[b, :, k])[0]
            assert list(rows) == ([picked[b, k]] if picked[b, k] >= 0 else [])
    npt.assert_array_equal(np.asarray(tmask) > 0, picked >= 0)
    got = tfull.chain_inputs(tp, pg, st.counts, t)
    want = jfull.pallas_chain_inputs(jp, jpg, js.counts, j)
    # (m, invP, ldP, tk) of the live slots, then the global tables
    for g_, w_ in zip(got[:3], want[1:4]):
        _close(np.asarray(g_)[live], np.asarray(w_)[live])
    npt.assert_array_equal(got[3].numpy(), np.asarray(want[4]))
    for g_, w_ in zip(got[4:], want[5:]):
        _close(g_, w_)


def test_corrected_candidate_post_matches_jax():
    X, tp, st, jp, js, t, j = _touched_case()
    rng = np.random.RandomState(2)
    Xc = rng.randn(3, 5, X.shape[1])
    pg, jpg = tcf.predictive_params(tp, st), jcf.predictive_params(jp, js)
    post = tcf.log_post_pred_batch(pg, torch.as_tensor(
        Xc.reshape(15, -1))).reshape(3, 5, -1)
    jpost = jcf.log_post_pred_batch(jpg, jnp.asarray(
        Xc.reshape(15, -1))).reshape(3, 5, -1)
    K = pg.mu.shape[0]
    _close(tfull.corrected_candidate_post(post, torch.as_tensor(Xc), t, K),
           jfull.corrected_candidate_post(jpost, jnp.asarray(Xc), j, K))


def test_n_to_sv_and_params_to_P_match_jax():
    X, tp, st, jp, js = _state(8)
    pg, jpg = tcf.predictive_params(tp, st), jcf.predictive_params(jp, js)
    D = X.shape[1]
    for got, want in zip(
            tfull.n_to_sv(tp.k_0, tp.v_0, D, st.counts, torch.float64),
            jfull.n_to_sv(jp.k_0, jp.v_0, D, js.counts, jnp.float64)):
        _close(got, want, 1e-12)
    for got, want in zip(
            tfull.params_to_P(pg.inv_covar, pg.logdet_covar, st.counts,
                              tp.k_0, tp.v_0, D),
            jfull.params_to_P(jpg.inv_covar, jpg.logdet_covar, js.counts,
                              jp.k_0, jp.v_0, D)):
        _close(got, want)


# -- touched_leave_out derives the live slots alone ----------------------------

# the components of each block's old segments ([B, S], -1 pads)
LIVE_CASES = {
    "duplicate": [[0, 1, 2, -1, -1], [3, 3, 4, 5, -1], [1, 6, 0, 2, 3],
                  [4, -1, -1, -1, -1]],
    "all_pad_utterance": [[0, 1, -1, -1, -1], [-1] * 5, [2, 3, 4, 5, 6],
                          [6, -1, -1, -1, -1]],
    "no_live_slot": [[-1] * 5] * 4,
    "every_slot_live": [[0, 1, 2, 3, 4], [5, 6, 0, 1, 2], [3, 4, 5, 6, 0],
                        [1, 2, 3, 4, 5]],
}


def _live_case(case, D, K=8, N=64, seed=3):
    """A float32 state (7 occupied components, slot K-1 empty) and a block
    of old segments whose components ``LIVE_CASES[case]`` gives, each a
    distinct member of its component."""
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.randn(N, D), dtype=torch.float32)
    assign = rng.permutation(np.arange(N) % (K - 1))
    A = rng.randn(D, D)
    prior = NIW.create(*(torch.as_tensor(a, dtype=torch.float32) for a in (
        0.3 * rng.randn(D), 0.4, D + 2.0, 0.3 * np.eye(D) + 0.05 * A @ A.T)))
    stats = tstats.suff_stats_from_assignments(
        X, torch.as_tensor(assign), K, full_cov=True)
    old_ks = np.array(LIVE_CASES[case], np.int32)
    old_embeds = np.full_like(old_ks, -1)
    used = {k: iter(np.nonzero(assign == k)[0]) for k in range(K - 1)}
    for (b, s), k in np.ndenumerate(old_ks):
        if k >= 0:
            old_embeds[b, s] = next(used[k])
    return (X, prior, stats, torch.as_tensor(old_embeds),
            torch.as_tensor(old_ks))


@pytest.mark.parametrize("D", [4, 13])
@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_touched_live_slots_match_all_slot_derivation(case, D):
    """Each live slot's (m_n, inv_covar, logdet, v, chol_inv) is bitwise
    the all-slot derivation's; tk and counts are identical on every slot;
    the slot layout holds zeros in pads and duplicates."""
    X, prior, stats, old_embeds, old_ks = _live_case(case, D)
    t = tfull.touched_leave_out(prior, stats, X, old_embeds, old_ks)
    tk, counts, want = all_slot_leave_out(prior, stats, X, old_embeds,
                                          old_ks)
    assert torch.equal(t.tk, tk) and torch.equal(t.counts, counts)
    live = (tk >= 0).reshape(-1)
    assert torch.equal(t.slots, live.nonzero().squeeze(1))
    B, S = tk.shape
    for got, w, laid in zip(t.live, want, t.params):
        flat = (B * S,) + w.shape[2:]
        assert torch.equal(got, w.reshape(flat)[live])
        assert laid.shape == w.shape
        assert torch.equal(laid.reshape(flat)[live], got)
        assert not laid.reshape(flat)[~live].any()


@pytest.mark.parametrize("D", [4, 13])
@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_kernels_on_live_slot_tables_match_all_slot_tables(case, D):
    """The plain K8 and K9 (both weight modes, sampling and argmax) give
    exactly the scores and ks on the tables built from the live slots that
    they give on the all-slot tables; the tables agree on every live
    slot."""
    from segmentalist_torch.models.bigram_lm import transcript_pairs_batch
    from segmentalist_torch.ops import cuda_fullcov_score
    from segmentalist_torch.ops.random import gumbel

    X, prior, stats, old_embeds, old_ks = _live_case(case, D)
    K = stats.counts.shape[0]
    B, S = old_ks.shape
    t = tfull.touched_leave_out(prior, stats, X, old_embeds, old_ks)
    ref = all_slot_touched(prior, stats, X, old_embeds, old_ks)
    pg = tcf.predictive_params(prior, stats)
    lo = stats.counts[None] - tcommon.counts_contrib(old_ks, old_embeds >= 0,
                                                     K)
    live = (t.tk >= 0).reshape(-1)
    gen = torch.Generator().manual_seed(D)
    M = 6
    Xc = X[torch.randint(0, X.shape[0], (B, M), generator=gen)] + 0.1
    w = torch.log(0.5 / K + lo.to(X.dtype))
    (g, tt, tslot), (rg, rt, rslot) = (
        tfull.fullcov_score_inputs(pg, x) for x in (t, ref))
    assert torch.equal(tslot, rslot)
    for a, b in zip(tt, rt):
        assert torch.equal(a.reshape(B * S, -1)[live],
                           b.reshape(B * S, -1)[live])
    scores = [cuda_fullcov_score.fullcov_scores_plain(
        Xc, tcf.log_prior_batch(prior, Xc), g, x, tslot, w, lo)
        for x in (tt, rt)]
    assert torch.isfinite(scores[0]).all()
    assert torch.equal(*scores)

    tables = [tfull.chain_inputs(prior, pg, stats.counts, x) for x in (t, ref)]
    for a, b in zip(tables[0][:3], tables[1][:3]):
        assert torch.equal(a.reshape(B * S, -1)[live],
                           b.reshape(B * S, -1)[live])
    new = torch.randint(-1, X.shape[0], (B, S), generator=gen,
                        dtype=torch.int32)
    base = tcf.log_post_pred_batch(pg, X[new.clamp_min(0).long()].reshape(
        B * S, D)).reshape(B, S, K)
    noise = gumbel((B, S, K), gen, X.device, X.dtype)
    lpv = tcf.log_prior_batch(prior, X)
    pj, pi = transcript_pairs_batch(old_ks)
    lm = (lo + 1, torch.randint(0, 4, (K, K), generator=gen,
                                dtype=torch.int32), pj, pi, 1.0, 0.2, 1.5)
    for kw in (dict(), dict(use_argmax=True), dict(lm=lm)):
        ks = [tfull.fullcov_chain(prior, X, pg, stats.counts, lo, x, new,
                                  base, noise, lpv, 1.0, K, 1.2, 0.9, **kw)
              for x in (t, ref)]
        assert (ks[0][new >= 0] >= 0).all()
        assert torch.equal(*ks)
