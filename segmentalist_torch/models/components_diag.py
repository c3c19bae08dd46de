"""Diagonal-covariance Gaussian component model (pure functions on tensors).

Counterpart of ``segmentalist_tpu/models/components_diag.py``: a Bayesian
GMM component store with a per-dimension normal-inverse-chi-squared prior
(an :class:`~segmentalist_torch.priors.NIW` whose ``S_0`` is a D-vector)
and a posterior predictive that is a product of univariate Student's t
densities (reference ``gaussian_components_diag.py``).  Every quantity is a
function of the sufficient statistics
(:class:`segmentalist_torch.ops.stats.SuffStats`).  ``gammaln`` is the exact
``torch.lgamma``; only the chain kernels use the Stirling series.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.stats import SuffStats
from ..priors import NIW

_LOG_PI = math.log(math.pi)


class PredParams(NamedTuple):
    """Posterior-predictive parameters for all K slots: ``mu`` and
    ``inv_var`` [K, D], ``log_prod_var`` [K] = sum_d log var, ``v`` [K] the
    Student's t degrees of freedom."""

    mu: torch.Tensor
    inv_var: torch.Tensor
    log_prod_var: torch.Tensor
    v: torch.Tensor


def _derive(prior: NIW, counts, sum_x, sum_sq):
    """(m_n, var, v_n) of the posterior (reference
    ``gaussian_components_diag.py:169-176, :332-345``)."""
    n = counts.to(sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + sum_x) / k_n[..., None]
    s_n_partial = prior.S_0 + prior.k_0 * torch.square(prior.m_0) + sum_sq
    var = ((k_n[..., None] + 1.0) / (k_n[..., None] * v_n[..., None])
           * (s_n_partial - k_n[..., None] * torch.square(m_n)))
    return m_n, var, v_n


def predictive_params(prior: NIW, stats: SuffStats) -> PredParams:
    m_n, var, v_n = _derive(prior, stats.counts, stats.sum_x, stats.sum_sq)
    return PredParams(m_n, 1.0 / var, torch.log(var).sum(-1), v_n)


def predictive_params_T(prior: NIW, counts, sum_xT, sum_sqT):
    """Feature-major predictive parameters: ``counts`` [..., K] and
    ``sum_xT`` / ``sum_sqT`` [..., D, K] -> ``(muT, inv_varT [..., D, K],
    log_prod_var [..., K], v [..., K])``.  ``log_prod_var`` is summed from
    ``var`` itself, not from the rounded reciprocal, so it equals
    :func:`predictive_params`'s."""
    n = counts.to(sum_xT.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    kn_d = k_n[..., None, :]
    m_nT = ((prior.k_0 * prior.m_0)[:, None] + sum_xT) / kn_d
    s_n_partial = (prior.S_0 + prior.k_0 * torch.square(prior.m_0))[:, None] \
        + sum_sqT
    varT = ((kn_d + 1.0) / (kn_d * v_n[..., None, :])
            * (s_n_partial - kn_d * torch.square(m_nT)))
    return m_nT, 1.0 / varT, torch.log(varT).sum(-2), v_n


def update_predictive_row(prior: NIW, stats: SuffStats, params: PredParams,
                          k: int) -> PredParams:
    """Predictive parameters with slot ``k`` re-derived (O(D))."""
    m_n, var, v_n = _derive(prior, stats.counts[k], stats.sum_x[k],
                            stats.sum_sq[k])
    mu, inv_var = params.mu.clone(), params.inv_var.clone()
    lpv, v = params.log_prod_var.clone(), params.v.clone()
    mu[k], inv_var[k] = m_n, 1.0 / var
    lpv[k], v[k] = torch.log(var).sum(), v_n
    return PredParams(mu, inv_var, lpv, v)


def _log_prod_students_t(x, mu, inv_var, log_prod_var, v):
    """Product of D univariate Student's t log-densities (reference
    ``_log_prod_students_t``, ``gaussian_components_diag.py:347-360``)."""
    D = x.shape[-1]
    delta = x - mu
    return (D * (torch.lgamma((v + 1.0) / 2.0) - torch.lgamma(v / 2.0)
                 - 0.5 * torch.log(v) - 0.5 * _LOG_PI)
            - 0.5 * log_prod_var
            - (v + 1.0) / 2.0
            * torch.log1p(delta * delta * inv_var / v[..., None]).sum(-1))


def log_post_pred(params: PredParams, x: torch.Tensor) -> torch.Tensor:
    """[K] log posterior predictive of ``x`` under every slot (reference
    ``log_post_pred``, ``gaussian_components_diag.py:237-259``)."""
    return _log_prod_students_t(x, params.mu, params.inv_var,
                                params.log_prod_var, params.v)


def log_post_pred_batch(params: PredParams, X: torch.Tensor) -> torch.Tensor:
    """[M, K] scores of a batch of query vectors: the log1p couples the
    dimensions non-linearly, so this is an elementwise [M, K, D]
    contraction, not a matmul."""
    return _log_prod_students_t(X[:, None, :], params.mu[None],
                                params.inv_var[None],
                                params.log_prod_var[None], params.v[None])


def log_prior(prior: NIW, x: torch.Tensor) -> torch.Tensor:
    """Log density under the prior predictive (reference ``log_prior``,
    ``gaussian_components_diag.py:215-222``)."""
    var = (prior.k_0 + 1.0) / (prior.k_0 * prior.v_0) * prior.S_0
    return _log_prod_students_t(x, prior.m_0, 1.0 / var,
                                torch.log(var).sum(), prior.v_0)


def log_prior_batch(prior: NIW, X: torch.Tensor) -> torch.Tensor:
    return log_prior(prior, X)


def log_marg_k_vec(prior: NIW, stats: SuffStats) -> torch.Tensor:
    """[K] log marginal of each slot's members; 0 for empty slots
    (reference ``log_marg_k``, ``gaussian_components_diag.py:271-290``)."""
    D = stats.sum_x.shape[-1]
    n = stats.counts.to(stats.sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + stats.sum_x) / k_n[:, None]
    s_n = (prior.S_0 + prior.k_0 * torch.square(prior.m_0) + stats.sum_sq
           - k_n[:, None] * torch.square(m_n))
    # log(s_n) is NaN-prone for empty slots (s_n can be ~0): mask first.
    s_n_safe = torch.where(stats.counts[:, None] > 0, s_n, 1.0)
    out = (-n * D / 2.0 * _LOG_PI
           + D / 2.0 * torch.log(prior.k_0)
           - D / 2.0 * torch.log(k_n)
           + prior.v_0 / 2.0 * torch.log(prior.S_0).sum()
           - v_n / 2.0 * torch.log(s_n_safe).sum(-1)
           + D * (torch.lgamma(v_n / 2.0) - torch.lgamma(prior.v_0 / 2.0)))
    return torch.where(stats.counts > 0, out, 0.0)


def log_marg(prior: NIW, stats: SuffStats) -> torch.Tensor:
    """Scalar p(X | z)."""
    return log_marg_k_vec(prior, stats).sum()


def rand_k(generator: torch.Generator, prior: NIW, stats: SuffStats, k):
    """Posterior (mean, var) draw of slot ``k`` (reference ``rand_k``,
    ``gaussian_components_diag.py:305-323``): var from the scaled
    inverse-chi-squared ``1 / Gamma(v_n/2, rate s_n/2)``, then the mean
    from N(m_n, var / k_n); the gamma draws [D] first, then the normals
    [D], the JAX package's order."""
    n = stats.counts[k].to(stats.sum_x.dtype)
    k_n = prior.k_0 + n
    v_n = prior.v_0 + n
    m_n = (prior.k_0 * prior.m_0 + stats.sum_x[k]) / k_n
    s_n = (prior.S_0 + prior.k_0 * torch.square(prior.m_0) + stats.sum_sq[k]
           - k_n * torch.square(m_n))
    shape = torch.broadcast_to(v_n / 2.0, m_n.shape).contiguous()
    gamma_draw = torch._standard_gamma(shape, generator=generator)
    var = (s_n / 2.0) / gamma_draw
    mean = m_n + torch.sqrt(var / k_n) * torch.randn(
        m_n.shape, generator=generator, dtype=m_n.dtype, device=m_n.device)
    return mean, var


if __name__ == "__main__":  # smoke demo (reference gaussian_components_diag.py:410-494)
    from segmentalist_torch.demos import run_demo

    run_demo("components_diag")
