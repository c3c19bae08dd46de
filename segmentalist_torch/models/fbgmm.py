"""Finite Bayesian GMM container (counterpart of
``segmentalist_tpu/models/fbgmm.py``).

Holds the acoustic model state the segmenter composes: data ``X``, the
sufficient statistics, the ``[N]`` assignment vector and the per-item prior
log densities, all on one device, plus the record metrics of the
reference's ``FBGMM`` (``fbgmm.py``).  The component family follows
``covariance_type``: "fixed", "diag" or "full" (whose ``sum_sq`` is
[K, D, D]); the FBGMM's own Gibbs sweeps are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.random import logsumexp
from ..ops.stats import SuffStats, num_active, suff_stats_from_assignments
from ..device import resolve_device
from ..priors import Prior
from . import cov_module


def log_weights(counts: torch.Tensor, alpha, K_max: int, lms=1.0,
                include_denominator: bool = False,
                dtype=torch.float32) -> torch.Tensor:
    """[..., K] collapsed mixture-weight term
    ``lms * (log(alpha/K + N_k) [- log(N + alpha)])`` (reference
    ``fbgmm.py:268-272``, ``:371-375``)."""
    c = counts.to(dtype)
    w = torch.log(alpha / K_max + c)
    if include_denominator:
        w = w - torch.log(c.sum(-1, keepdim=True) + alpha)
    return lms * w


def log_prob_z_dirichlet(counts: torch.Tensor, alpha,
                         K_max: int) -> torch.Tensor:
    """log P(z) under the symmetric Dirichlet prior, Murphy (24.24)
    (reference ``FBGMM.log_prob_z``, ``fbgmm.py:208-225``), in float64."""
    c = counts.to(torch.float64)
    a = torch.tensor(float(alpha), dtype=torch.float64, device=c.device)
    return (torch.lgamma(a) - torch.lgamma(a + c.sum())
            + (torch.lgamma(c + a / K_max) - torch.lgamma(a / K_max)).sum())


def component_logits_batch(cov, prior, stats: SuffStats, params, X_batch,
                           log_prior_vec, alpha, K_max: int, lms=1.0,
                           include_denominator: bool = True) -> torch.Tensor:
    """[M, K] log P(z_i = k) + log p(x_i | k): posterior predictive for
    active slots, prior density for empty ones (reference
    ``fbgmm.py:377-379``, ``:281-284``)."""
    w = log_weights(stats.counts, alpha, K_max, lms, include_denominator,
                    X_batch.dtype)
    post = cov.log_post_pred_batch(params, X_batch)
    active = (stats.counts > 0)[None, :]
    return w[None, :] + torch.where(active, post, log_prior_vec[:, None])


def _make_consecutive(assignments: np.ndarray) -> np.ndarray:
    """Relabel assignments to consecutive 0..K-1 (reference
    fbgmm.py:123-128)."""
    assignments = np.asarray(assignments, dtype=np.int64)
    used = np.unique(assignments[assignments >= 0])
    lut = np.full(int(used.max(initial=-1)) + 2, -1, dtype=np.int64)
    lut[used] = np.arange(used.size)
    return lut[assignments]  # -1 indexes the trailing -1 entry


class FBGMM:
    """Finite Bayesian Gaussian mixture model state (reference
    ``fbgmm.py:27-498``): ``alpha`` is the symmetric-Dirichlet
    concentration, ``K`` the number of component slots, ``assignments`` an
    int vector (-1 = unassigned), "rand" (a uniform draw from numpy's
    global state, as the reference) or "each-in-own"; ``lms`` scales the
    mixture weights.  ``decollide_new`` is kept for the FBGMM's own blocked
    sampler (reference ``fbgmm.py:578``), which is not ported yet.

    The ``[N]`` assignment vector is stored with one trailing sentinel slot
    (``_assign_pad``), so a block can write every row of a padded index
    tensor without a host sync; ``assignments`` is the ``[N]`` view.
    The state lives on ``device``: the CUDA card by default (raises when
    there is none), the CPU when the caller asks.
    """

    def __init__(self, X, prior: Prior, alpha, K, assignments="rand",
                 covariance_type="full", lms=1.0, decollide_new=True,
                 device="cuda"):
        self.cov = cov_module(covariance_type)
        self.covariance_type = covariance_type
        self.full_cov = covariance_type == "full"
        X = torch.as_tensor(X, device=resolve_device(device))
        self.device = X.device
        self.prior = prior.to(device=self.device, dtype=X.dtype)
        self.alpha = float(alpha)
        self.lms = float(lms)
        self.decollide_new = bool(decollide_new)
        self.setup_components(K, assignments, X)

    def setup_components(self, K, assignments="rand", X=None):
        """Reset the state from an assignment vector (reference
        ``setup_components``, fbgmm.py:93-137)."""
        if X is not None:
            self.X = X
            self.N, self.D = X.shape
        self.K_max = int(K)
        if isinstance(assignments, str) and assignments == "rand":
            assignments = np.random.randint(0, self.K_max, self.N)
        elif isinstance(assignments, str) and assignments == "each-in-own":
            assignments = np.arange(self.N)
        assignments = _make_consecutive(
            np.asarray(torch.as_tensor(assignments).cpu(), dtype=np.int64))
        if assignments.max(initial=-1) >= self.K_max:
            raise ValueError("more distinct assignments than K slots")
        self.assignments = torch.as_tensor(assignments, dtype=torch.int32,
                                           device=self.device)
        self.stats = suff_stats_from_assignments(self.X, self.assignments,
                                                 self.K_max, self.full_cov)
        self.log_prior_vec = self.cov.log_prior_batch(self.prior, self.X)

    @property
    def assignments(self) -> torch.Tensor:
        return self._assign_pad[:-1]

    @assignments.setter
    def assignments(self, value):
        value = torch.as_tensor(value, dtype=torch.int32, device=self.device)
        self._assign_pad = torch.cat(
            [value, value.new_full((1,), -1)])

    # -- scalar queries (reference API parity) --------------------------------

    def log_prob_z(self) -> float:
        return float(log_prob_z_dirichlet(self.stats.counts, self.alpha,
                                          self.K_max))

    def log_prob_X_given_z(self) -> float:
        return float(self.cov.log_marg(self.prior, self.stats))

    def log_marg(self) -> float:
        """log p(X, z) (reference ``log_marg``, fbgmm.py:231-253)."""
        return self.log_prob_z() + self.log_prob_X_given_z()

    def sweep_metrics_device(self):
        """The record quantities of one sweep as device scalars:
        (log_prob_z, log_prob_X_given_z, active K, n_assigned, n_tokens)."""
        stats = self.stats
        return (
            log_prob_z_dirichlet(stats.counts, self.alpha, self.K_max),
            self.cov.log_marg(self.prior, stats),
            num_active(stats),
            (self.assignments >= 0).sum(),
            stats.counts.sum(),
        )

    @staticmethod
    def metrics_to_dict(fetched) -> dict:
        lpz, lpx, k_act, n_assigned, n_tokens = (float(v) for v in fetched)
        return {
            "log_prob_z": lpz,
            "log_prob_X_given_z": lpx,
            "log_marg": lpz + lpx,
            "components": int(k_act),
            "n_assigned": int(n_assigned),
            "n_tokens": int(n_tokens),
        }

    def sweep_metrics(self) -> dict:
        """The record quantities of the current state, fetched."""
        return self.metrics_to_dict(self.sweep_metrics_device())

    def log_marg_batch(self, embed_ids) -> torch.Tensor:
        """Collapsed marginals of many held-out items (reference
        ``log_marg_i``, fbgmm.py:256-286, vectorised)."""
        params = self.cov.predictive_params(self.prior, self.stats)
        ids = torch.as_tensor(embed_ids, dtype=torch.long, device=self.device)
        logits = component_logits_batch(
            self.cov, self.prior, self.stats, params, self.X[ids],
            self.log_prior_vec[ids], self.alpha, self.K_max, self.lms,
            include_denominator=True,
        )
        return logsumexp(logits, dim=-1)
