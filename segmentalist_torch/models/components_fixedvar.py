"""Fixed-variance Gaussian component model (pure functions on tensors).

Counterpart of ``segmentalist_tpu/models/components_fixedvar.py``: a
Bayesian GMM component store with known diagonal covariance and a conjugate
normal prior on the mean (reference ``gaussian_components_fixedvar.py``).
Every quantity is a function of the sufficient statistics
(:class:`segmentalist_torch.ops.stats.SuffStats`).

The prior density reproduces the reference's quirk of using ``precision_0``
as the predictive precision (``gaussian_components_fixedvar.py:224-231``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.stats import SuffStats
from ..priors import FixedVarPrior

_LOG_2PI = math.log(2.0 * math.pi)


class PredParams(NamedTuple):
    """Posterior-predictive parameters for all K slots: ``mu_pred`` and
    ``prec_pred`` [K, D], ``log_prod_prec`` [K] = sum_d log prec_pred."""

    mu_pred: torch.Tensor
    prec_pred: torch.Tensor
    log_prod_prec: torch.Tensor


def _derive(prior: FixedVarPrior, counts, sum_x):
    precision = 1.0 / prior.var
    precision_0 = 1.0 / prior.var_0
    mu_n_num = precision_0 * prior.mu_0 + precision * sum_x
    prec_n = precision_0 + counts[..., None].to(sum_x.dtype) * precision
    mu_pred = mu_n_num / prec_n
    prec_pred = prec_n * precision / (prec_n + precision)
    return mu_pred, prec_pred


def predictive_params(prior: FixedVarPrior, stats: SuffStats) -> PredParams:
    mu_pred, prec_pred = _derive(prior, stats.counts, stats.sum_x)
    return PredParams(mu_pred, prec_pred, torch.log(prec_pred).sum(-1))


def predictive_params_T(prior: FixedVarPrior, counts, sum_xT):
    """Feature-major predictive parameters: ``counts`` [..., K] and
    ``sum_xT`` [..., D, K] -> ``(mu_predT, prec_predT)`` [..., D, K]."""
    precision = 1.0 / prior.var
    precision_0 = 1.0 / prior.var_0
    mu_n_num = (precision_0 * prior.mu_0)[:, None] \
        + precision[:, None] * sum_xT
    prec_n = precision_0[:, None] \
        + counts[..., None, :].to(sum_xT.dtype) * precision[:, None]
    mu_predT = mu_n_num / prec_n
    prec_predT = prec_n * precision[:, None] / (prec_n + precision[:, None])
    return mu_predT, prec_predT


def update_predictive_row(prior: FixedVarPrior, stats: SuffStats,
                          params: PredParams, k: int) -> PredParams:
    """Predictive parameters with slot ``k`` re-derived (O(D))."""
    mu_k, prec_k = _derive(prior, stats.counts[k], stats.sum_x[k])
    mu_pred, prec_pred = params.mu_pred.clone(), params.prec_pred.clone()
    lpp = params.log_prod_prec.clone()
    mu_pred[k], prec_pred[k] = mu_k, prec_k
    lpp[k] = torch.log(prec_k).sum()
    return PredParams(mu_pred, prec_pred, lpp)


def log_post_pred(params: PredParams, x: torch.Tensor) -> torch.Tensor:
    """[K] log posterior predictive of ``x`` under every slot (reference
    ``log_post_pred``, ``gaussian_components_fixedvar.py:242-253``)."""
    D = x.shape[-1]
    delta = params.mu_pred - x
    maha = (delta * delta * params.prec_pred).sum(-1)
    return -0.5 * D * _LOG_2PI + 0.5 * params.log_prod_prec - 0.5 * maha


def log_post_pred_batch(params: PredParams, X: torch.Tensor) -> torch.Tensor:
    """[M, K] scores of a batch of query vectors, in matmul form:
    sum_d (x-mu)^2 p = (x^2) @ p^T - 2 x @ (mu p)^T + sum_d mu^2 p."""
    mp = params.mu_pred * params.prec_pred
    const_k = (params.mu_pred * mp).sum(-1)
    maha = (X * X) @ params.prec_pred.T - 2.0 * (X @ mp.T) + const_k[None, :]
    D = X.shape[-1]
    return (-0.5 * D * _LOG_2PI + 0.5 * params.log_prod_prec[None, :]
            - 0.5 * maha)


def log_prior(prior: FixedVarPrior, x: torch.Tensor) -> torch.Tensor:
    """Log density of ``x`` under the prior alone, with predictive precision
    ``precision_0`` (the reference's quirk, reproduced exactly)."""
    precision_0 = 1.0 / prior.var_0
    D = x.shape[-1]
    delta = x - prior.mu_0
    return (-0.5 * D * _LOG_2PI
            + 0.5 * torch.log(precision_0).sum()
            - 0.5 * (delta * delta * precision_0).sum(-1))


def log_prior_batch(prior: FixedVarPrior, X: torch.Tensor) -> torch.Tensor:
    return log_prior(prior, X)


def log_marg_k_vec(prior: FixedVarPrior, stats: SuffStats) -> torch.Tensor:
    """[K] log marginal probability of each slot's members; 0 for empty slots
    (reference ``gaussian_components_fixedvar.py:261-283``)."""
    precision = 1.0 / prior.var
    precision_0 = 1.0 / prior.var_0
    n = stats.counts[:, None].to(stats.sum_x.dtype)
    sx = stats.sum_x
    ssq = stats.sum_sq
    denom = n / precision_0 + 1.0 / precision
    per_dim = (
        (n - 1.0) / 2.0 * torch.log(precision)
        - 0.5 * n * _LOG_2PI
        - 0.5 * torch.log(denom)
        - 0.5 * precision * ssq
        - 0.5 * precision_0 * torch.square(prior.mu_0)
        + 0.5
        * (
            torch.square(sx) * precision / precision_0
            + torch.square(prior.mu_0) * precision_0 / precision
            + 2.0 * sx * prior.mu_0
        )
        / denom
    )
    return torch.where(stats.counts > 0, per_dim.sum(-1), 0.0)


def log_marg(prior: FixedVarPrior, stats: SuffStats) -> torch.Tensor:
    """Scalar p(X | z) (reference ``log_marg``,
    ``gaussian_components_fixedvar.py:285-296``)."""
    return log_marg_k_vec(prior, stats).sum()


def rand_k(generator: torch.Generator, prior: FixedVarPrior,
           stats: SuffStats, k) -> torch.Tensor:
    """Posterior draw of slot ``k``'s mean (reference ``rand_k``,
    ``gaussian_components_fixedvar.py:298-308``): one normal draw [D]."""
    mu_pred, _ = _derive(prior, stats.counts[k], stats.sum_x[k])
    precision = 1.0 / prior.var
    precision_0 = 1.0 / prior.var_0
    prec_n = (precision_0
              + stats.counts[k].to(stats.sum_x.dtype) * precision)
    std = torch.sqrt(1.0 / prec_n)
    return mu_pred + std * torch.randn(mu_pred.shape, generator=generator,
                                       dtype=mu_pred.dtype,
                                       device=mu_pred.device)


if __name__ == "__main__":  # smoke demo (reference gaussian_components_fixedvar.py:359-388)
    from segmentalist_torch.demos import run_demo

    run_demo("components_fixed")
