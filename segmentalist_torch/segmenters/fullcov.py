"""Touched-component machinery of the full-covariance (NIW) block step.

Counterpart of ``segmentalist_tpu/segmenters/fullcov.py``.  A left-out
utterance's statistics differ from the block's global statistics only in
the <= S components its own old segments are assigned to (its "touched"
components).  So a block step

  1. derives predictive parameters once from the global statistics (one
     batched Cholesky of K matrices);
  2. scores every candidate against them, and overwrites each utterance's
     touched columns with exact leave-out scores (kernel K8,
     ``ops/cuda_fullcov_score.py``);
  3. runs the assignment chain over a per-utterance touched-slot table of
     (mean, inverse unscaled scale matrix, its log-determinant) that a
     rank-1 Sherman-Morrison update extends one segment at a time; every
     other component keeps its global score (kernel K9,
     ``ops/cuda_fullcov_chain.py``).

Every score is still the exact leave-one-utterance-out posterior predictive
(reference ``gaussian_components.py:228-251``; removal before scoring,
``unigram_acoustic_wordseg.py:270-273``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.components_full import (
    PredParams,
    _chol_inv_logdet,
    _derive_covar,
    _student_t_from_maha,
)
from ..ops import cuda_fullcov_chain
from ..ops.stats import SuffStats, packed_outer, sym_pack, unpack_sym

_LOG_PI = math.log(math.pi)


def n_to_sv(k_0, v_0, D: int, n, dtype):
    """Predictive scalars of a member count ``n``: ``s = (k_n + 1) / (k_n
    v)`` with ``k_n = k_0 + n`` and ``v = v_0 + n - D + 1`` (NIW predictive,
    reference ``gaussian_components.py:228-251``)."""
    n = n.to(dtype)
    k_n = k_0 + n
    v = v_0 + n - D + 1.0
    return (k_n + 1.0) / (k_n * v), v, k_n


def params_to_P(inv_covar, logdet_covar, n, k_0, v_0, D: int):
    """Predictive (inv_covar, logdet_covar) -> the UNSCALED scale-matrix
    factors (inv P, logdet P) the chain's rank-1 updates evolve
    (``P = S_0 + k_0 m_0 m_0^T + sum_sq - k_n m_n m_n^T``, covar = s P)."""
    s, _, _ = n_to_sv(k_0, v_0, D, n, inv_covar.dtype)
    return inv_covar * s[..., None, None], logdet_covar - D * torch.log(s)


class Touched(NamedTuple):
    """Per-utterance touched-component view (all [B, S, ...]).

    tk      [B, S]      touched component ids; -1 for pads and duplicates
    counts  [B, S]      leave-one-utterance-out member counts (int32)
    params  PredParams  leave-out predictive parameters, [B, S, ...]
    """

    tk: torch.Tensor
    counts: torch.Tensor
    params: PredParams


def touched_leave_out(prior, stats: SuffStats, X: torch.Tensor,
                      old_embeds: torch.Tensor, old_ks: torch.Tensor,
                      rows: torch.Tensor | None = None) -> Touched:
    """Leave-one-utterance-out statistics restricted to the components each
    utterance touches (its old segments' assignments).  Duplicate ids are
    collapsed to their first slot (later ones get tk = -1): each correction
    subtracts the utterance's whole contribution to its component.  The
    second moments are contracted in the packed lanes and unpacked once.
    ``rows`` [B, S, D] supplies the old segments' vectors directly."""
    B, S = old_ks.shape
    D = X.shape[-1]
    valid = (old_embeds >= 0) & (old_ks >= 0)
    ks_safe = old_ks.clamp_min(0).long()
    same = ((old_ks[:, :, None] == old_ks[:, None, :])
            & valid[:, :, None] & valid[:, None, :])
    earlier = torch.ones((S, S), dtype=torch.bool,
                         device=X.device).tril(-1)
    is_dup = (same & earlier).any(-1)
    tk = torch.where(valid & ~is_dup, old_ks, -1)

    x_old = X[old_embeds.clamp_min(0).long()] if rows is None else rows
    x_old = torch.where(valid[..., None], x_old, 0.0)
    same_f = same.to(X.dtype)
    pk = sym_pack(D, X.device)
    lo_counts = (stats.counts[ks_safe] - same.sum(-1)).to(torch.int32)
    lo_sum_x = stats.sum_x[ks_safe] - same_f @ x_old
    lo_sum_sq_p = (stats.sum_sq[:, pk.iu0, pk.iu1][ks_safe]
                   - same_f @ packed_outer(x_old))
    m_n, covar, v = _derive_covar(prior, lo_counts, lo_sum_x,
                                  unpack_sym(lo_sum_sq_p, D))
    inv, logdet, L_inv = _chol_inv_logdet(covar)
    return Touched(tk, lo_counts, PredParams(m_n, inv, logdet, v, L_inv))


def corrected_candidate_post(post: torch.Tensor, Xc: torch.Tensor,
                             touched: Touched, K_max: int) -> torch.Tensor:
    """The JAX package's XLA scoring composition: overwrite the touched
    columns of the [B, M, K] global-parameter scores with each utterance's
    exact leave-out scores (<= S columns a row)."""
    B, M, _ = post.shape
    D = Xc.shape[-1]
    p = touched.params
    S = p.mu.shape[1]
    xx = (Xc[..., :, None] * Xc[..., None, :]).reshape(B, M, D * D)
    A1 = torch.einsum("btde,bte->btd", p.inv_covar, p.mu)
    maha = (xx @ p.inv_covar.reshape(B, S, D * D).transpose(1, 2)
            - 2.0 * (Xc @ A1.transpose(1, 2))
            + (p.mu * A1).sum(-1)[:, None, :])
    c = _student_t_from_maha(maha, p.logdet_covar[:, None, :],
                             p.v[:, None, :], D)                 # [B, M, S]
    col = torch.where(touched.tk >= 0, touched.tk, K_max).long()
    out = torch.cat([post, post.new_zeros((B, M, 1))], dim=-1)
    out.scatter_(2, col[:, None, :].expand(B, M, S), c)
    return out[..., :K_max]


def _score_tables(p: PredParams):
    """(L, Lmu, ck, 1/v, (v + D)/2) of predictive parameters: the packed
    whitening factor ``L = chol_inv`` [..., F] (lower-triangular lanes of
    ``ops.stats.sym_pack``), ``Lmu = L mu`` [..., D], so that ``maha =
    |L x - Lmu|^2``, and the Student-t constants, exact lgamma."""
    D = p.mu.shape[-1]
    pk = sym_pack(D, p.mu.device)
    Lmu = torch.einsum("...de,...e->...d", p.chol_inv, p.mu)
    ck = (torch.lgamma((p.v + D) / 2.0) - torch.lgamma(p.v / 2.0)
          - 0.5 * D * (torch.log(p.v) + _LOG_PI)
          - 0.5 * p.logdet_covar)
    return (p.chol_inv[..., pk.il0, pk.il1], Lmu, ck, 1.0 / p.v,
            (p.v + D) / 2.0)


def fullcov_score_inputs(params_g: PredParams, touched: Touched):
    """K8's inputs (``ops.cuda_fullcov_score.fullcov_scores``): the global
    tables with the whitening ones feature-major (``LT`` [F, K], ``LmuT``
    [D, K]; F = D(D+1)/2), the touched-slot tables slot-major ([B, S, F],
    [B, S, D], [B, S]), and ``tslot`` [B, K] int32, the slot of each
    touched component (-1 elsewhere): the JAX package's slot one-hot
    matrix product picks exactly these values."""
    L, Lmu, *g_rest = _score_tables(params_g)
    g = (L.T.contiguous(), Lmu.T.contiguous(),
         *(t.contiguous() for t in g_rest))
    t = tuple(x.contiguous() for x in _score_tables(touched.params))
    B, S = touched.tk.shape
    K = params_g.mu.shape[0]
    col = torch.where(touched.tk >= 0, touched.tk, K).long()
    slots = torch.arange(S, dtype=torch.int32,
                         device=col.device).expand(B, S)
    tslot = torch.full((B, K + 1), -1, dtype=torch.int32,
                       device=col.device).scatter_(1, col, slots)
    return g, t, tslot[:, :K].contiguous()


def chain_inputs(prior, params_g: PredParams, global_counts: torch.Tensor,
                 touched: Touched):
    """K9's tables in P-form (``ops.cuda_fullcov_chain.fullcov_chain``):
    touched-slot (m, inv P, logdet P, tk), then the global (m, inv P,
    logdet P) that claimed slots pull (an untouched component's leave-out
    factors are the global ones)."""
    D = params_g.mu.shape[-1]
    k0, v0 = prior.k_0, prior.v_0
    t_invP, t_ldP = params_to_P(touched.params.inv_covar,
                                touched.params.logdet_covar, touched.counts,
                                k0, v0, D)
    g_invP, g_ldP = params_to_P(params_g.inv_covar, params_g.logdet_covar,
                                global_counts, k0, v0, D)
    return (touched.params.mu.contiguous(), t_invP.contiguous(),
            t_ldP.contiguous(), touched.tk.to(torch.int32).contiguous(),
            params_g.mu.contiguous(), g_invP.contiguous(),
            g_ldP.contiguous())


def fullcov_chain(prior, X, params_g: PredParams, global_counts, lo_counts,
                  touched: Touched, new_embeds, base_scores, gumbel,
                  log_prior_vec, alpha, K_max: int, lms, temp,
                  use_argmax: bool = False, lm=None,
                  k0_v0=None) -> torch.Tensor:
    """Sequential within-utterance assignment chains over the touched-slot
    tables (the JAX package's ``fullcov_chain``; reference conditioning
    ``fbgmm.py:422-463``), through kernel K9 on a CUDA tensor and its plain
    version on a CPU one.

    params_g / global_counts: the block's global predictive parameters and
    counts; lo_counts [B, K] the leave-out counts; touched from
    :func:`touched_leave_out`; new_embeds [B, S] (-1 pads); base_scores and
    gumbel [B, S, K].  ``lm`` = (uni_lo, big_table, corr_j, corr_i, a,
    intrp_lambda, b) selects the bigram mode (always Gumbel-max; ``alpha``
    unused), else the Dirichlet weights.  ``k0_v0``: the prior's k_0 and
    v_0 as host floats (read from ``prior`` when None, a device sync on a
    card).  Returns ks [B, S] int32.
    """
    rows = new_embeds.clamp_min(0).long()
    if k0_v0 is None:
        k0_v0 = (float(prior.k_0), float(prior.v_0))
    data = (new_embeds.to(torch.int32).contiguous(), X[rows],
            log_prior_vec[rows], gumbel.contiguous(),
            base_scores.contiguous(), lo_counts.to(torch.int32),
            *chain_inputs(prior, params_g, global_counts, touched),
            *k0_v0, temp)
    if lm is None:
        return cuda_fullcov_chain.fullcov_chain(
            *data, alpha=alpha, K=K_max, lms=lms, use_argmax=use_argmax)
    uni_lo, big_table, corr_j, corr_i, a, lam, b = lm
    return cuda_fullcov_chain.bigram_fullcov_chain(
        *data, uni_lo, big_table, corr_j, corr_i, alpha_a=a,
        intrp_lambda=lam, b_smooth=b, K=K_max, lms=lms)
