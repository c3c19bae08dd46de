"""Finite Bayesian GMM with collapsed Gibbs sampling (counterpart of
``segmentalist_tpu/models/fbgmm.py``; reference ``fbgmm.py``).

Holds the model state: data ``X``, the sufficient statistics, the ``[N]``
assignment vector and the per-item prior log densities, all on one device.
The component family follows ``covariance_type``: "fixed", "diag" or
"full" (whose ``sum_sq`` is [K, D, D]).  Two sweep modes, as in the JAX
package:

* ``mode="sequential"``: exact collapsed Gibbs, each item removed from its
  component, scored against the running statistics, drawn and added back
  in item order (``fbgmm.py:517-570``).  The whole sweep is one launch of
  an item-chain kernel (``ops/cuda_item_chain.py``: K10 for the fixed and
  diag families, K11 for the full family); so are ``reassign_items`` (the
  chain with the delete off) and the single-item draws.
* ``mode="blocked"``: every item scored against leave-one-out statistics
  in one [N, K] pass and drawn at once, new components decollided, the
  statistics rebuilt (``fbgmm.py:572-650``).

Every draw is Gumbel-max with noise from the model's ``torch.Generator``
(seeded by ``seed``, the counterpart of the JAX package's ``key``), and
every sampling method also takes its noise as an argument.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.cuda_item_chain import item_chain
from ..ops.random import annealed_gumbel_max, gumbel, logsumexp
from ..ops.stats import (SuffStats, add_item, canonicalize_new_component,
                         decollide_new_items, del_item, item_sq, num_active,
                         suff_stats_from_assignments)
from ..device import resolve_device
from ..priors import Prior
from ..utils.annealing import anneal_temperatures
from . import cov_module

RECORD_KEYS = ("sample_time", "log_marg", "log_prob_z", "log_prob_X_given_z",
               "anneal_temp", "components")


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
    mixture weights.  ``decollide_new`` gives each simultaneous
    new-component draw of the blocked sweep its own empty slot (the JAX
    package's ``fbgmm.py:578``).  ``seed`` seeds ``generator``, the
    ``torch.Generator`` on the model's device that every draw takes its
    noise from.

    The ``[N]`` assignment vector is stored with one trailing sentinel slot
    (``_assign_pad``), so a block can write every row of a padded index
    tensor without a host sync; ``assignments`` is the ``[N]`` view.
    The state lives on ``device``: the CUDA card by default (raises when
    there is none), the CPU when the caller asks.
    """

    def __init__(self, X, prior: Prior, alpha, K, assignments="rand",
                 covariance_type="full", lms=1.0, decollide_new=True,
                 seed: int = 0, device="cuda"):
        self.cov = cov_module(covariance_type)
        self.covariance_type = covariance_type
        self.full_cov = covariance_type == "full"
        X = torch.as_tensor(X, device=resolve_device(device))
        self.device = X.device
        self.prior = prior.to(device=self.device, dtype=X.dtype)
        self.alpha = float(alpha)
        self.lms = float(lms)
        self.decollide_new = bool(decollide_new)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
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

    @property
    def K(self) -> int:
        """Number of active (non-empty) components."""
        return int(num_active(self.stats))

    def get_n_assigned(self) -> int:
        """Reference ``get_n_assigned`` (fbgmm.py:496-498)."""
        return int((self.assignments >= 0).sum())

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

    def log_marg_i(self, i: int) -> float:
        """Collapsed marginal of one held-out item (reference
        ``log_marg_i``, fbgmm.py:256-286): assumes x_i is not in the
        model."""
        return float(self.log_marg_batch([int(i)])[0])

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

    # -- noise ----------------------------------------------------------------

    def draw_noise(self, rows: int) -> torch.Tensor:
        """[rows, K] standard Gumbel noise from the model's generator: a
        row an item a draw."""
        return gumbel((rows, self.K_max), self.generator, self.device,
                      self.X.dtype)

    # -- single items (reference fbgmm.py:422-498) ----------------------------

    def gibbs_sample_inside_loop_i(self, i: int, anneal_temp: float = 1.0,
                                   noise=None):
        """Draw a component for (currently unassigned) item ``i`` from its
        collapsed conditional and add it (reference fbgmm.py:422-463);
        ``noise`` [K] (drawn when None)."""
        self.reassign_items([int(i)], anneal_temp,
                            None if noise is None else noise[None])

    def map_assign_i(self, i: int):
        """Add item ``i`` to its MAP component (reference ``map_assign_i``,
        fbgmm.py:465-494).  Like the reference, the mixture weights are not
        scaled by ``lms`` here."""
        ids = torch.tensor([int(i)], device=self.device)
        self._item_steps(ids, False, None, 1.0, use_argmax=True, lms=1.0)

    def _add(self, i, k):
        """Item ``i`` joins slot ``k`` (no check that it was unassigned)."""
        self.stats = add_item(self.stats, self.X[i], k, self.full_cov)
        self._assign_pad[int(i)] = int(k)

    def del_item(self, i: int):
        """Remove item ``i`` from its component (if any) and unassign it."""
        k = int(self.assignments[int(i)])
        if k >= 0:
            self.stats = del_item(self.stats, self.X[int(i)], k,
                                  self.full_cov)
        self._assign_pad[int(i)] = -1

    def set_K(self, K: int, reassign: bool = True):
        """Keep the ``K`` largest components (relabelled 0 .. K-1 by size,
        ascending) and, with ``reassign``, Gibbs-assign the items of the
        dropped ones one by one (reference fbgmm.py:139-180)."""
        if self.K <= K:
            self.K_max = int(K)
            self.stats = suff_stats_from_assignments(
                self.X, self.assignments, self.K_max, self.full_cov)
            return
        counts = self.stats.counts.cpu().numpy()
        old = self.assignments.cpu().numpy().astype(np.int64)
        keep = np.argsort(counts)[-K:]  # the JAX package's order
        lut = np.full(counts.shape[0] + 1, -1, dtype=np.int64)
        lut[keep] = np.arange(K)
        new = lut[old]  # -1 indexes the trailing -1 entry
        self.setup_components(K, new)
        if reassign:
            orphans = np.nonzero((old != -1) & (new == -1))[0]
            if len(orphans):
                self.reassign_items(orphans)

    def reassign_items(self, ids, anneal_temp: float = 1.0, noise=None):
        """Gibbs-assign the listed (unassigned) items in order, each against
        the statistics the items before it updated: the JAX package's
        ``reassign_items`` (fbgmm.py:323-387), one K10 / K11 launch with
        the delete off.  ``noise`` [len(ids), K] (drawn when None)."""
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                              device=self.device)
        if noise is None:
            noise = self.draw_noise(ids.shape[0])
        self._item_steps(ids, False, noise, anneal_temp)

    def _item_steps(self, ids, delete: bool, noise, temp, use_argmax=False,
                    lms=None):
        """The items ``ids`` in order: each (``delete``) leaves its
        component, is scored against the running statistics, drawn (row j
        of ``noise`` for the j-th item; ``use_argmax``: the MAP) and added.
        One launch of kernel K10 (fixed, diag) or K11 (full), their plain
        versions on the CPU."""
        lms = self.lms if lms is None else lms
        ids = ids.to(self.device)
        k_old = (self.assignments[ids] if delete else
                 torch.full(ids.shape, -1, dtype=torch.int32,
                            device=self.device))
        ks, self.stats = item_chain(
            self.covariance_type, self.X[ids], self.log_prior_vec[ids], noise,
            k_old, self.stats, self.prior, self.alpha, self.K_max, lms, temp,
            use_argmax)
        self._assign_pad[ids] = ks.to(torch.int32)

    # -- full sweeps ------------------------------------------------------------

    def sequential_sweep(self, anneal_temp: float = 1.0,
                         consider_unassigned: bool = True, noise=None):
        """One exact collapsed-Gibbs sweep over the items in order (the JAX
        package's ``_build_sequential_sweep``, fbgmm.py:517-570): each item
        leaves its component, is drawn against the running statistics and
        added.  With ``consider_unassigned`` False unassigned items are
        skipped (the JAX step's weight-0 update leaves the statistics'
        bits as they are).  ``noise`` [N, K], a row an item (when None, a
        row is drawn for each visited item only)."""
        if consider_unassigned:
            ids = torch.arange(self.N, device=self.device)
        else:
            ids = torch.nonzero(self.assignments >= 0)[:, 0]
        noise = (self.draw_noise(ids.shape[0]) if noise is None
                 else noise[ids])
        self._item_steps(ids, True, noise, anneal_temp)

    def blocked_sweep(self, anneal_temp: float = 1.0,
                      consider_unassigned: bool = True, noise=None):
        """One blocked sweep (the JAX package's ``_build_blocked_sweep``,
        fbgmm.py:572-650): every item scored against the frozen statistics
        in one [N, K] pass, column k_i of an assigned item corrected to its
        leave-one-out score, all items drawn at once, new components
        decollided (``decollide_new``) or sent to the first empty slot, and
        the statistics rebuilt.  ``noise`` [N, K] (drawn when None)."""
        cov, prior, X, stats = self.cov, self.prior, self.X, self.stats
        N, K = self.N, self.K_max
        if noise is None:
            noise = self.draw_noise(N)
        params = cov.predictive_params(prior, stats)
        w = log_weights(stats.counts, self.alpha, K, self.lms, dtype=X.dtype)
        active = stats.counts > 0
        logits = w[None, :] + torch.where(
            active[None, :], cov.log_post_pred_batch(params, X),
            self.log_prior_vec[:, None])
        # Leave-one-out: only column k_i of an assigned item i changes when
        # x_i leaves it (an unassigned item's row is left as it is).
        k_i = self.assignments.long()
        assigned = k_i >= 0
        k_safe = k_i.clamp_min(0)
        cnt_wo = stats.counts[k_safe] - assigned.to(stats.counts.dtype)
        a = assigned.to(X.dtype)
        a_sq = a.reshape((N,) + (1,) * (stats.sum_sq.dim() - 1))
        row = SuffStats(cnt_wo, stats.sum_x[k_safe] - a[:, None] * X,
                        stats.sum_sq[k_safe] - a_sq * item_sq(X,
                                                               self.full_cov))
        pred = cov.log_post_pred(cov.predictive_params(prior, row), X)
        corr = (self.lms * torch.log(self.alpha / K + cnt_wo.to(X.dtype))
                + torch.where(cnt_wo > 0, pred, self.log_prior_vec))
        own = assigned[:, None] & (torch.arange(K, device=self.device)[None]
                                   == k_safe[:, None])
        logits = torch.where(own, corr[:, None], logits)
        k_new = annealed_gumbel_max(logits, noise, anneal_temp)
        if self.decollide_new:
            k_new = decollide_new_items(stats.counts, k_new)
        else:
            k_new = canonicalize_new_component(
                stats.counts.expand(N, K), k_new)
        keep_old = ~assigned if not consider_unassigned else torch.zeros_like(
            assigned)
        self.assignments = torch.where(keep_old, k_i, k_new).to(torch.int32)
        self.stats = suff_stats_from_assignments(X, self.assignments, K,
                                                 self.full_cov)

    def gibbs_sample(self, n_iter: int, consider_unassigned: bool = True,
                     anneal_schedule=None, anneal_start_temp_inv: float = 0.1,
                     anneal_end_temp_inv: float = 1.0,
                     n_anneal_steps: int = -1,
                     mode: str = "sequential") -> dict:
        """``n_iter`` collapsed-Gibbs sweeps; returns the reference's record
        dict (reference ``gibbs_sample``, fbgmm.py:288-420): per sweep its
        wall time, log_marg, log_prob_z, log_prob_X_given_z, the annealing
        temperature and the active components.  The metrics stay on the
        device until the last sweep has run."""
        sweeps = {"sequential": self.sequential_sweep,
                  "blocked": self.blocked_sweep}
        if mode not in sweeps:
            raise ValueError("invalid mode: %r" % (mode,))
        temps = anneal_temperatures(n_iter, anneal_schedule,
                                    anneal_start_temp_inv,
                                    anneal_end_temp_inv, n_anneal_steps)
        record = {k: [] for k in RECORD_KEYS}
        pending = []
        start = prev = time.time()
        for temp in temps:
            sweeps[mode](float(temp), consider_unassigned)
            now = time.time()
            pending.append((now - prev, float(temp),
                            self.sweep_metrics_device()))
            prev = now
        for dt, temp, dev in pending:
            m = self.metrics_to_dict(dev)
            record["sample_time"].append(dt)
            record["log_marg"].append(m["log_marg"])
            record["log_prob_z"].append(m["log_prob_z"])
            record["log_prob_X_given_z"].append(m["log_prob_X_given_z"])
            record["anneal_temp"].append(temp)
            record["components"].append(m["components"])
        if record["sample_time"]:  # the fetch belongs to the last sweep
            record["sample_time"][-1] += (time.time() - start
                                          - sum(record["sample_time"]))
        return record

    # -- reference-style view ---------------------------------------------------

    @property
    def components(self):
        """Duck-typed view of the reference's component store
        (``fbgmm.components``)."""
        return ComponentsView(self)


class ComponentsView:
    """The reference component-store surface over an :class:`FBGMM` (the
    JAX package's ``_ComponentsView``, fbgmm.py:657-752)."""

    def __init__(self, owner: FBGMM):
        self._o = owner

    @property
    def X(self):
        return self._o.X

    @property
    def N(self):
        return self._o.N

    @property
    def D(self):
        return self._o.D

    @property
    def K(self):
        return self._o.K

    @property
    def K_max(self):
        return self._o.K_max

    @property
    def counts(self):
        return self._o.stats.counts

    @property
    def prior(self):
        return self._o.prior

    @property
    def assignments(self):
        return self._o.assignments

    def get_assignments(self, list_of_i):
        return self._o.assignments.cpu().numpy()[np.asarray(list_of_i)]

    def log_post_pred(self, i):
        o = self._o
        params = o.cov.predictive_params(o.prior, o.stats)
        return o.cov.log_post_pred(params, o.X[i])

    def log_post_pred_k(self, i, k):
        return self.log_post_pred(i)[k]

    def log_prior(self, i):
        return self._o.log_prior_vec[i]

    def log_marg_k(self, k):
        o = self._o
        return o.cov.log_marg_k_vec(o.prior, o.stats)[k]

    def log_marg(self):
        o = self._o
        return o.cov.log_marg(o.prior, o.stats)

    def rand_k(self, k):
        """Posterior parameter draw of component ``k`` from the model's
        generator (reference ``rand_k``, gaussian_components.py:291-303)."""
        o = self._o
        return o.cov.rand_k(o.generator, o.prior, o.stats, k)

    def map(self, k):
        """MAP parameters of component ``k`` (reference ``map``,
        gaussian_components.py:305-316); the fixed and diag families give
        the predictive mean."""
        o = self._o
        if hasattr(o.cov, "map_k"):
            return o.cov.map_k(o.prior, o.stats, k)
        params = o.cov.predictive_params(o.prior, o.stats)
        return params[0][k]

    def add_item(self, i, k):
        self._o._add(i, k)

    def del_item(self, i):
        self._o.del_item(i)

    def del_component(self, k):
        """Unassign component ``k``'s members and zero its statistics
        (reference ``del_component``, gaussian_components.py:188-205); no
        swap-with-last relabelling, slots stay stable."""
        o, k = self._o, int(k)
        counts, sum_x, sum_sq = (t.clone() for t in o.stats)
        counts[k], sum_x[k], sum_sq[k] = 0, 0.0, 0.0
        o.stats = SuffStats(counts, sum_x, sum_sq)
        o.assignments = torch.where(o.assignments == k, -1, o.assignments)


if __name__ == "__main__":  # smoke demo (reference fbgmm.py:505-546)
    from segmentalist_torch.demos import run_demo

    run_demo("fbgmm")
