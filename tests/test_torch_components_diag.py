"""The port's diagonal-covariance component model against the JAX package
(``segmentalist_tpu.models.components_diag``) at float64, and the analytic
checks of ``tests/test_components_diag.py`` (the reference's strategy:
univariate Student's t products, the closed-form log marginal)."""

import math

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.special import gammaln

from segmentalist_tpu.models import components_diag as jcd
from segmentalist_tpu.ops.stats import SuffStats as JStats
from segmentalist_tpu.priors import NIW as JNIW

from segmentalist_torch.models import components_diag as tcd
from segmentalist_torch.models import cov_module
from segmentalist_torch.ops.stats import SuffStats, suff_stats_from_assignments
from segmentalist_torch.priors import NIW

RTOL = 1e-12


def _state(seed, N=20, D=4, K=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    assign = rng.randint(-1, K - 1, N)  # slot K-1 stays empty
    m_0, S_0 = 0.3 * rng.randn(D), 0.2 + rng.rand(D)
    k_0, v_0 = 0.4, D + 2.0
    stats = suff_stats_from_assignments(torch.as_tensor(X),
                                        torch.as_tensor(assign), K)
    jstats = JStats(*(jnp.asarray(t.numpy()) for t in stats))
    return (X, NIW.create(m_0, k_0, v_0, S_0), stats,
            JNIW.create(m_0, k_0, v_0, S_0), jstats)


def _close(got, want, rtol=RTOL):
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                        atol=rtol)


@pytest.mark.parametrize("seed", [0, 1])
def test_predictive_params_match_jax(seed):
    X, tp, st, jp, js = _state(seed)
    for got, want in zip(tcd.predictive_params(tp, st),
                         jcd.predictive_params(jp, js)):
        _close(got, want)


def test_feature_major_params_match_jax():
    X, tp, st, jp, js = _state(2)
    B, K, D = 3, 6, 4
    rng = np.random.RandomState(9)
    counts = rng.randint(0, 5, (B, K)).astype(np.int32)
    sxT = rng.randn(B, D, K) * counts[:, None, :]
    sqT = (rng.rand(B, D, K) + 1.0) * counts[:, None, :] + sxT ** 2
    got = tcd.predictive_params_T(tp, torch.as_tensor(counts),
                                  torch.as_tensor(sxT), torch.as_tensor(sqT))
    want = jcd.predictive_params_T(jp, jnp.asarray(counts), jnp.asarray(sxT),
                                   jnp.asarray(sqT))
    for g, w in zip(got, want):
        _close(g, w)
    # log_prod_var is summed from var itself: equal to the [K, D] form's
    for b in range(B):
        p = tcd.predictive_params(tp, SuffStats(
            torch.as_tensor(counts[b]), torch.as_tensor(sxT[b].T),
            torch.as_tensor(sqT[b].T)))
        npt.assert_array_equal(got[2][b].numpy(), p.log_prod_var.numpy())


def test_update_predictive_row_matches_jax():
    X, tp, st, jp, js = _state(3)
    params = tcd.predictive_params(tp, st)
    jparams = jcd.predictive_params(jp, js)
    for k in (0, 5):
        for got, want in zip(tcd.update_predictive_row(tp, st, params, k),
                             jcd.update_predictive_row(jp, js, jparams, k)):
            _close(got, want)


def test_scores_match_jax():
    X, tp, st, jp, js = _state(4)
    params = tcd.predictive_params(tp, st)
    jparams = jcd.predictive_params(jp, js)
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    _close(tcd.log_post_pred(params, Xt[3]), jcd.log_post_pred(jparams, Xj[3]))
    _close(tcd.log_post_pred_batch(params, Xt),
           jcd.log_post_pred_batch(jparams, Xj))
    _close(tcd.log_prior(tp, Xt[5]), jcd.log_prior(jp, Xj[5]))
    _close(tcd.log_prior_batch(tp, Xt), jcd.log_prior_batch(jp, Xj))


def test_log_marg_matches_jax_and_masks_empty_slots():
    X, tp, st, jp, js = _state(5)
    got = tcd.log_marg_k_vec(tp, st)
    _close(got, jcd.log_marg_k_vec(jp, js))
    assert got[-1] == 0.0 and st.counts[-1] == 0
    _close(tcd.log_marg(tp, st), jcd.log_marg(jp, js))


def test_family_dispatch():
    from segmentalist_torch.models import components_full

    assert cov_module("diag") is tcd
    assert cov_module("full") is components_full
    with pytest.raises(ValueError):
        cov_module("spherical")


# -- analytic checks (tests/test_components_diag.py) ----------------------

def students_t(x, mu, var, v):
    c = (gammaln((v + 1) / 2.0) - gammaln(v / 2.0)
         - 0.5 * (math.log(v) + math.log(np.pi) + math.log(var)))
    return c - (v + 1) / 2.0 * math.log(1 + 1.0 / v * (x - mu) ** 2 / var)


def _hand_pred(X_members, x, m_0, k_0, v_0, S_0):
    N, D = X_members.shape
    k_N, v_N = k_0 + N, v_0 + N
    m_N = (k_0 * m_0 + X_members.sum(0)) / k_N
    S_N = S_0 + np.square(X_members).sum(0) + k_0 * np.square(m_0) \
        - k_N * np.square(m_N)
    var = S_N * (k_N + 1) / (k_N * v_N)
    return sum(students_t(x[i], m_N[i], var[i], v_N) for i in range(D))


def test_log_post_pred_against_hand_derivation():
    D = 3
    m_0, k_0, v_0, S_0 = np.array([0.5, -0.1, 0.1]), 2.0, 5.0, 5.0 * np.ones(D)
    X = np.array([[0.5, 0.4, 0.3], [1.2, 0.9, 0.2], [-0.1, 0.8, -0.2],
                  [0.0, 0.5, -1.0]])
    stats = suff_stats_from_assignments(torch.as_tensor(X),
                                        torch.zeros(4, dtype=torch.int32), 4)
    params = tcd.predictive_params(NIW.create(m_0, k_0, v_0, S_0), stats)
    got = float(tcd.log_post_pred(params, torch.as_tensor(X[0]))[0])
    npt.assert_almost_equal(got, _hand_pred(X, X[0], m_0, k_0, v_0, S_0))


def test_log_post_pred_after_deletion():
    rng = np.random.RandomState(1)
    D, N_1, N_2 = 5, 8, 4
    X = 5 * rng.rand(N_1 + N_2, D) - 1
    m_0, k_0, v_0, S_0 = rng.rand(D), 0.4, D + 2.0, 0.5 * rng.rand(D) + 0.1
    assign = np.concatenate([np.zeros(N_1), -np.ones(N_2)]).astype(np.int64)
    stats = suff_stats_from_assignments(torch.as_tensor(X),
                                        torch.as_tensor(assign), 3)
    params = tcd.predictive_params(NIW.create(m_0, k_0, v_0, S_0), stats)
    got = float(tcd.log_post_pred(params, torch.as_tensor(X[N_1]))[0])
    npt.assert_almost_equal(got, _hand_pred(X[:N_1], X[N_1], m_0, k_0, v_0,
                                            S_0))


def test_log_prior_against_hand_derivation():
    rng = np.random.RandomState(3)
    D = 4
    m_0, k_0, v_0, S_0 = rng.rand(D), 1.5, D + 1.0, rng.rand(D) + 0.5
    x = rng.rand(D)
    var = (k_0 + 1.0) / (k_0 * v_0) * S_0
    want = sum(students_t(x[i], m_0[i], var[i], v_0) for i in range(D))
    got = float(tcd.log_prior(NIW.create(m_0, k_0, v_0, S_0),
                              torch.as_tensor(x)))
    npt.assert_almost_equal(got, want)


def test_log_marg_k_closed_form():
    rng = np.random.RandomState(1)
    D, N = 6, 9
    X = 2 * rng.rand(N, D) - 1
    m_0, k_0, v_0, S_0 = rng.rand(D), 0.3, D + 3.0, rng.rand(D) + 0.2
    stats = suff_stats_from_assignments(torch.as_tensor(X),
                                        torch.zeros(N, dtype=torch.int32), 3)
    k_N, v_N = k_0 + N, v_0 + N
    m_N = (k_0 * m_0 + X.sum(0)) / k_N
    S_N = S_0 + np.square(X).sum(0) + k_0 * np.square(m_0) \
        - k_N * np.square(m_N)
    want = (-N * D / 2.0 * math.log(np.pi) + D / 2.0 * math.log(k_0)
            - D / 2.0 * math.log(k_N) + v_0 / 2.0 * np.log(S_0).sum()
            - v_N / 2.0 * np.log(S_N).sum()
            + D * (gammaln(v_N / 2.0) - gammaln(v_0 / 2.0)))
    lm = tcd.log_marg_k_vec(NIW.create(m_0, k_0, v_0, S_0), stats).numpy()
    npt.assert_allclose(lm[0], want, rtol=1e-10)
    npt.assert_array_equal(lm[1:], 0.0)
