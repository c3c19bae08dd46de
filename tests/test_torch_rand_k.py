"""The port's posterior parameter draws (``rand_k`` of the three families)
and its Wishart samplers against their analytic posterior moments, on the
port's own ``torch.Generator`` noise (tests/test_rand_k.py's checks, with
the JAX package's draw orders)."""

import numpy as np
import numpy.testing as npt
import torch

import segmentalist_torch as pt
from segmentalist_torch.models import (components_diag, components_fixedvar,
                                       components_full)
from segmentalist_torch.ops.stats import suff_stats_from_assignments


def _stats(X, full_cov):
    X = torch.as_tensor(X)
    return suff_stats_from_assignments(
        X, torch.zeros(X.shape[0], dtype=torch.int32), 2, full_cov=full_cov)


def test_rand_k_full_matches_posterior_moments():
    rng = np.random.RandomState(0)
    D, N = 3, 40
    X = rng.randn(N, D)
    prior = pt.NIW.create(np.zeros(D), 2.0, D + 6.0, np.eye(D))
    stats = _stats(X, True)
    n = float(stats.counts[0])
    k_n, v_n = 2.0 + n, D + 6.0 + n
    m_n = stats.sum_x[0].numpy() / k_n
    S_n = np.eye(D) + stats.sum_sq[0].numpy() - k_n * np.outer(m_n, m_n)

    gen = torch.Generator().manual_seed(1)
    draws = [components_full.rand_k(gen, prior, stats, 0)
             for _ in range(4000)]
    mus = np.stack([m.numpy() for m, _ in draws])
    sigmas = np.stack([s.numpy() for _, s in draws])
    exp_sigma = S_n / (v_n - D - 1)
    npt.assert_allclose(sigmas.mean(axis=0), exp_sigma, rtol=0.12)
    npt.assert_allclose(mus.mean(axis=0), m_n, atol=4 * np.sqrt(
        np.diag(exp_sigma) / k_n / len(draws)).max() + 1e-3)
    npt.assert_allclose(np.cov(mus.T), exp_sigma / k_n, rtol=0.25, atol=0.02)


def test_rand_k_diag_matches_posterior_moments():
    rng = np.random.RandomState(3)
    D, N = 4, 50
    X = rng.randn(N, D) * 1.5
    prior = pt.NIW.create(np.zeros(D), 1.5, 5.0, np.ones(D))
    stats = _stats(X, False)
    n = float(stats.counts[0])
    k_n, v_n = 1.5 + n, 5.0 + n
    m_n = stats.sum_x[0].numpy() / k_n
    s_n = 1.0 + stats.sum_sq[0].numpy() - k_n * np.square(m_n)

    gen = torch.Generator().manual_seed(4)
    draws = [components_diag.rand_k(gen, prior, stats, 0)
             for _ in range(6000)]
    means = np.stack([m.numpy() for m, _ in draws])
    variances = np.stack([v.numpy() for _, v in draws])
    npt.assert_allclose(variances.mean(axis=0), s_n / (v_n - 2), rtol=0.1)
    npt.assert_allclose(means.mean(axis=0), m_n, atol=0.05)
    npt.assert_allclose(means.var(axis=0), (s_n / (v_n - 2)) / k_n,
                        rtol=0.2)


def test_rand_k_fixedvar_matches_posterior_moments():
    """The fixed-variance draw is N(mu_n, 1 / prec_n) per dimension."""
    rng = np.random.RandomState(5)
    D, N = 3, 20
    X = rng.randn(N, D) + 2.0
    var, var_0 = 0.5 * np.ones(D), 2.0 * np.ones(D)
    prior = pt.FixedVarPrior.create(var, np.zeros(D), var_0)
    stats = _stats(X, False)
    prec_n = 1.0 / var_0 + N / var
    mu_n = (stats.sum_x[0].numpy() / var) / prec_n

    gen = torch.Generator().manual_seed(6)
    draws = np.stack([components_fixedvar.rand_k(gen, prior, stats, 0)
                      .numpy() for _ in range(6000)])
    npt.assert_allclose(draws.mean(axis=0), mu_n,
                        atol=4 * np.sqrt(1.0 / prec_n / 6000).max())
    npt.assert_allclose(draws.var(axis=0), 1.0 / prec_n, rtol=0.1)


def test_wishrnd_iwishrnd_moments():
    """Wishart mean v Sigma; iwishrnd inverts the draw, so it is
    IW(Sigma^-1, v) with mean Sigma^-1 / (v - D - 1); a precomputed
    Cholesky factor gives the same draw."""
    D, v = 3, 12.0
    A = np.array([[2.0, 0.3, 0.0], [0.3, 1.5, 0.2], [0.0, 0.2, 1.0]])
    sigma = torch.as_tensor(A @ A.T)
    n_draws = 8000
    gen = torch.Generator().manual_seed(7)
    ws = np.stack([pt.wishart.wishrnd(gen, sigma, v).numpy()
                   for _ in range(n_draws)])
    s = sigma.numpy()
    elem_var = v * (s ** 2 + np.outer(np.diag(s), np.diag(s)))
    npt.assert_allclose(ws.mean(axis=0), v * s,
                        atol=4 * np.sqrt(elem_var / n_draws).max())
    iws = np.stack([pt.wishart.iwishrnd(gen, sigma, v).numpy()
                    for _ in range(n_draws)])
    npt.assert_allclose(iws.mean(axis=0), np.linalg.inv(s) / (v - D - 1),
                        rtol=0.12, atol=0.01)
    C = torch.linalg.cholesky(sigma)
    w1 = pt.wishart.wishrnd(torch.Generator().manual_seed(9), sigma, v)
    w2 = pt.wishart.wishrnd(torch.Generator().manual_seed(9), sigma, v, C=C)
    npt.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-12)


def test_rand_k_draws_follow_the_models_generator():
    """The component view draws from the model's generator: the same seed
    gives the same draw, another seed another one."""
    X = np.random.RandomState(0).randn(12, 3)
    prior = pt.NIW.create(np.zeros(3), 1.0, 6.0, np.eye(3))

    def draw(seed):
        am = pt.FBGMM(X, prior, 1.0, 3, np.arange(12) % 3,
                      covariance_type="full", seed=seed, device="cpu")
        return am.components.rand_k(1)[1].numpy()

    npt.assert_array_equal(draw(3), draw(3))
    assert not np.allclose(draw(3), draw(4))
