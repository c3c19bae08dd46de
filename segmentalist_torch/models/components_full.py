"""Full-covariance Gaussian component model (pure functions on tensors).

Counterpart of ``segmentalist_tpu/models/components_full.py`` (reference
``GaussianComponents``, ``gaussian_components.py``): a normal-inverse-Wishart
prior (:class:`~segmentalist_torch.priors.NIW` with a [D, D] ``S_0``) and a
multivariate Student's t posterior predictive.  Every quantity is derived
from the sufficient statistics (``sum_sq`` [K, D, D]) with one batched
Cholesky factorisation (``torch.linalg.cholesky_ex``, which leaves the
factorisation's status on the device instead of syncing the host to check
it; the matrices here are SPD by construction: they dominate ``S_0``).
``gammaln`` is the exact ``torch.lgamma``; only the assignment chain uses
the Stirling series.

Math references: posterior statistics ``gaussian_components.py:161-167``;
predictive covariance / dof ``:319-331`` and ``:216-226``; vectorised
predictive ``:228-251``; log marginal ``:253-276``; MAP ``:305-316``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.stats import SuffStats, packed_outer, sym_pack
from ..priors import NIW
from ..wishart import bartlett

_LOG_PI = math.log(math.pi)


class PredParams(NamedTuple):
    """Posterior-predictive parameters for all K slots.

    mu           [K, D]     predictive location (posterior mean m_N)
    inv_covar    [K, D, D]  inverse predictive scale matrix
    logdet_covar [K]        log-determinant of the predictive scale matrix
    v            [K]        Student's t degrees of freedom (v_N - D + 1)
    chol_inv     [K, D, D]  L^-1 for the scale matrix's Cholesky factor L
                            (lower triangular; inv_covar = L^-T L^-1), the
                            whitening factor of the candidate scorer
    """

    mu: torch.Tensor
    inv_covar: torch.Tensor
    logdet_covar: torch.Tensor
    v: torch.Tensor
    chol_inv: torch.Tensor


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _derive_covar(prior: NIW, counts, sum_x, sum_sq):
    """(m_n, predictive scale matrix, dof) of statistics with leading
    batch axes."""
    n = counts.to(sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + sum_x) / k_n[..., None]
    s_n_partial = prior.S_0 + prior.k_0 * _outer(prior.m_0, prior.m_0) \
        + sum_sq
    D = sum_x.shape[-1]
    v = v_n - D + 1.0
    scale = (k_n + 1.0) / (k_n * v)
    covar = scale[..., None, None] * (
        s_n_partial - k_n[..., None, None] * _outer(m_n, m_n))
    return m_n, covar, v


def _chol_logdet(a):
    """log det of SPD matrices [..., D, D] from their Cholesky factors."""
    L = torch.linalg.cholesky_ex(a)[0]
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def _chol_inv_logdet(covar):
    """Batched inverse, log-determinant and inverse Cholesky factor of
    SPD matrices: ``inv = L^-T L^-1``."""
    L = torch.linalg.cholesky_ex(covar)[0]
    eye = torch.eye(covar.shape[-1], dtype=covar.dtype,
                    device=covar.device).expand_as(covar)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return L_inv.transpose(-1, -2) @ L_inv, logdet, L_inv


def predictive_params(prior: NIW, stats: SuffStats) -> PredParams:
    m_n, covar, v = _derive_covar(prior, stats.counts, stats.sum_x,
                                  stats.sum_sq)
    inv, logdet, L_inv = _chol_inv_logdet(covar)
    return PredParams(m_n, inv, logdet, v, L_inv)


def update_predictive_row(prior: NIW, stats: SuffStats, params: PredParams,
                          k: int) -> PredParams:
    """Predictive parameters with slot ``k`` re-derived."""
    m_n, covar, v = _derive_covar(prior, stats.counts[k], stats.sum_x[k],
                                  stats.sum_sq[k])
    inv, logdet, L_inv = _chol_inv_logdet(covar)
    out = PredParams(*(t.clone() for t in params))
    out.mu[k], out.inv_covar[k] = m_n, inv
    out.logdet_covar[k], out.v[k], out.chol_inv[k] = logdet, v, L_inv
    return out


def _student_t_from_maha(maha, logdet_covar, v, D: int):
    """Multivariate Student's t log-density from its Mahalanobis form."""
    return (torch.lgamma((v + D) / 2.0) - torch.lgamma(v / 2.0)
            - D / 2.0 * torch.log(v) - D / 2.0 * _LOG_PI
            - 0.5 * logdet_covar
            - (v + D) / 2.0 * torch.log1p(maha / v))


def _mvt_logpdf(x, mu, inv_covar, logdet_covar, v):
    """Multivariate Student's t log-density (reference
    ``_multivariate_students_t``, ``gaussian_components.py:334-344``)."""
    delta = x - mu
    maha = torch.einsum("...d,...de,...e->...", delta, inv_covar, delta)
    return _student_t_from_maha(maha, logdet_covar, v, x.shape[-1])


def log_post_pred(params: PredParams, x: torch.Tensor) -> torch.Tensor:
    """[K] log posterior predictive of ``x`` under every slot (reference
    ``log_post_pred``, ``gaussian_components.py:228-251``)."""
    return _mvt_logpdf(x, params.mu, params.inv_covar, params.logdet_covar,
                       params.v)


def log_post_pred_batch(params: PredParams, X: torch.Tensor) -> torch.Tensor:
    """[M, K] scores of a batch of query vectors, the Mahalanobis form
    expanded into matrix products over the packed lanes, ``x^T A x - 2 x .
    A mu + mu . A mu`` with ``x^T A x = packed_outer(x) . A2`` (A2 the
    packed inverse scale, off-diagonal lanes doubled; float32 matmuls run
    in full precision: the port keeps TF32 off)."""
    inv = params.inv_covar
    pk = sym_pack(inv.shape[-1], inv.device)
    A2 = inv[..., pk.iu0, pk.iu1] * pk.dbl.to(inv.dtype)
    A1 = torch.einsum("...de,...e->...d", inv, params.mu)
    a0 = (params.mu * A1).sum(-1)
    maha = packed_outer(X) @ A2.T - 2.0 * (X @ A1.T) + a0[None, :]
    return _student_t_from_maha(maha, params.logdet_covar[None, :],
                                params.v[None, :], X.shape[-1])


def log_prior(prior: NIW, x: torch.Tensor) -> torch.Tensor:
    """Log density under the prior predictive (reference ``log_prior``,
    ``gaussian_components.py:207-214``)."""
    D = prior.m_0.shape[-1]
    v = prior.v_0 - D + 1.0
    covar = (prior.k_0 + 1.0) / (prior.k_0 * v) * prior.S_0
    inv, logdet, _ = _chol_inv_logdet(covar)
    return _mvt_logpdf(x, prior.m_0, inv, logdet, v)


def log_prior_batch(prior: NIW, X: torch.Tensor) -> torch.Tensor:
    return log_prior(prior, X)


def log_marg_k_vec(prior: NIW, stats: SuffStats) -> torch.Tensor:
    """[K] log marginal of each slot's members; 0 for empty slots
    (reference ``log_marg_k``, ``gaussian_components.py:253-276``)."""
    D = stats.sum_x.shape[-1]
    n = stats.counts.to(stats.sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + stats.sum_x) / k_n[:, None]
    s_n = (prior.S_0 + prior.k_0 * _outer(prior.m_0, prior.m_0)
           + stats.sum_sq - k_n[:, None, None] * _outer(m_n, m_n))
    eye = torch.eye(D, dtype=s_n.dtype, device=s_n.device)
    s_n_safe = torch.where((stats.counts > 0)[:, None, None], s_n, eye)
    i = torch.arange(1, D + 1, dtype=s_n.dtype, device=s_n.device)
    gam = (torch.lgamma((v_n[:, None] + 1.0 - i[None, :]) / 2.0)
           - torch.lgamma((prior.v_0 + 1.0 - i[None, :]) / 2.0)).sum(-1)
    out = (-n * D / 2.0 * _LOG_PI
           + D / 2.0 * torch.log(prior.k_0)
           - D / 2.0 * torch.log(k_n)
           + prior.v_0 / 2.0 * _chol_logdet(prior.S_0)
           - v_n / 2.0 * _chol_logdet(s_n_safe)
           + gam)
    return torch.where(stats.counts > 0, out, 0.0)


def log_marg(prior: NIW, stats: SuffStats) -> torch.Tensor:
    """Scalar p(X | z)."""
    return log_marg_k_vec(prior, stats).sum()


def map_k(prior: NIW, stats: SuffStats, k):
    """MAP estimate of (mean, covariance) of slot ``k`` (reference ``map``,
    ``gaussian_components.py:305-316``)."""
    n = stats.counts[k].to(stats.sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + stats.sum_x[k]) / k_n
    D = stats.sum_x.shape[-1]
    s_n = (prior.S_0 + prior.k_0 * _outer(prior.m_0, prior.m_0)
           + stats.sum_sq[k] - k_n * _outer(m_n, m_n))
    return m_n, s_n / (v_n + D + 2.0)


def rand_k(generator: torch.Generator, prior: NIW, stats: SuffStats, k):
    """Posterior NIW draw of slot ``k``'s (mean, covariance) (reference
    ``rand_k``, ``gaussian_components.py:291-303`` with ``wishart.py``):
    Sigma = L A^-T A^-1 L^T with L = chol(S_n) and A the Bartlett factor of
    v_n degrees of freedom, then mu ~ N(m_n, Sigma / k_n); the chi-square
    draws [D], the normals [D, D] and the mean's normals [D], in the JAX
    package's order."""
    n = stats.counts[k].to(stats.sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + stats.sum_x[k]) / k_n
    D = stats.sum_x.shape[-1]
    s_n = (prior.S_0 + prior.k_0 * _outer(prior.m_0, prior.m_0)
           + stats.sum_sq[k] - k_n * _outer(m_n, m_n))
    A = bartlett(generator, D, v_n, s_n.dtype, s_n.device)
    L = torch.linalg.cholesky(s_n)
    eye = torch.eye(D, dtype=s_n.dtype, device=s_n.device)
    inv_A = torch.linalg.solve_triangular(A, eye, upper=False)
    factor = L @ inv_A.T
    sigma = factor @ factor.T
    mean_chol = torch.linalg.cholesky(sigma / k_n)
    mu = m_n + mean_chol @ torch.randn(D, generator=generator,
                                        dtype=s_n.dtype, device=s_n.device)
    return mu, sigma


if __name__ == "__main__":  # smoke demo (reference gaussian_components.py:370-465)
    from segmentalist_torch.demos import run_demo

    run_demo("components_full")
