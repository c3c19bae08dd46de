"""Within-utterance diagonal-covariance assignment chains: kernels K6 and K7
and their plain versions.

Counterpart of the diag chains of ``segmentalist_tpu/ops/pallas_chain.py``
(``diag_chain`` and ``bigram_diag_chain`` with ``stats_T=True``, and their
XLA twins ``diag_chain_xla`` / ``bigram_diag_chain_xla``).  Each
utterance's new segments are assigned in order under the
normal-inverse-chi-squared predictive (reference
``gaussian_components_diag.py:237-259`` scoring inside the
``fbgmm.py:422-463`` chain, and ``bigram_acoustic_wordseg.py:332-384`` for
the bigram weights).  The per-column Student-t constant
``lgamma((v+1)/2) - lgamma(v/2)`` is the Stirling series of
:mod:`segmentalist_torch.ops.special`, and the per-dimension ``log1p`` is
taken as the logs of four stride-4 group products
(``pallas_chain.py:736-752``).  K6 weighs the components with the Dirichlet
term, K7 with the bigram LM of K4 (:func:`cuda_chain.bigram_lm_weights`).
The plain versions follow the kernels (``csrc/diag_chain.cu``) step for
step, with the same operation order, so on shared noise they sample the
same chains.  On the card :func:`launch_plan` picks the kernels' form:
the tables in one CTA's shared memory where they fit, else in device
memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_chain import bigram_constants, bigram_lm_weights
from .random import annealed_gumbel_max
from .special import lgamma_ratio
from .stats import canonicalize_new_component

_HALF_LOG_PI = 0.5 * math.log(math.pi)
_GROUPS = 4  # stride of the Student-t group products

launches = 0         # K6 launches since the last reset
bigram_launches = 0  # K7 launches since the last reset


def prior_terms(m_0, k_0, S_0):
    """(k0 m0, S0 + k0 m0 m0) [D] as the JAX kernel forms them
    (``pallas_chain.py:694-696``), and k0 as a float: the prior terms the
    plain versions take."""
    k0 = float(k_0)
    return k0 * m_0, S_0 + k0 * m_0 * m_0, k0


def diag_chain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT,
               m_0, k_0, v_0, S_0, temp, alpha: float, K: int,
               lms: float = 1.0, use_argmax: bool = False):
    """Sequential within-utterance diag assignment chains, batched over
    utterances (kernel K6).

    embeds [B, S] int32 segment embedding ids (-1 = pad); Xe [B, S, D] their
    vectors; log_prior_e [B, S] their prior log densities; gumbel [B, S, K]
    noise (ignored for ``use_argmax``); counts [B, K] int32, sum_xT and
    sum_sqT [B, D, K] the leave-one-utterance-out statistics; m_0 / S_0 [D]
    and the scalars k_0 / v_0 the normal-inverse-chi-squared prior; temp a
    Python float.

    Returns ks [B, S] int32, the sampled component of each segment (-1 pads).
    """
    k0m0, snp0, k0 = prior_terms(m_0, k_0, S_0)
    args = (embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0,
            snp0, k0, float(v_0), float(temp), float(alpha), int(K),
            float(lms), bool(use_argmax))
    if cuda_lib.use_kernel(Xe):
        return _launch(*args)
    return diag_chain_plain(*args)


def bigram_diag_chain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                      sum_sqT, m_0, k_0, v_0, S_0, temp, uni_lo, big_table,
                      corr_j, corr_i, alpha_a: float, intrp_lambda: float,
                      b_smooth: float, K: int, lms: float = 1.0):
    """Bigram-conditioned diag assignment chains (kernel K7): the inputs of
    :func:`diag_chain` (always Gumbel-max) plus the LM inputs of
    ``cuda_chain.bigram_fixedvar_chain``.  Every valid old pair must be
    counted in ``big_table`` or the weight goes NaN (the JAX kernel's
    caveat, ``pallas_chain.py:1053-1060``).

    Returns ks [B, S] int32 (-1 pads).
    """
    k0m0, snp0, k0 = prior_terms(m_0, k_0, S_0)
    args = (embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0,
            snp0, k0, float(v_0), float(temp), uni_lo, big_table, corr_j,
            corr_i, bigram_constants(alpha_a, b_smooth, intrp_lambda, K),
            int(K), float(lms))
    if cuda_lib.use_kernel(Xe):
        return _launch_bigram(*args)
    return bigram_diag_chain_plain(*args)


def _derive(k0m0, snp0, k0, v0, cnt, sx, ssq):
    """(m_n, var) of columns with counts ``cnt`` and sums ``sx`` / ``ssq``
    (``pallas_chain.py:711-718``)."""
    k_n = k0 + cnt
    v_n = v0 + cnt
    m_n = (k0m0 + sx) / k_n
    var = (k_n + 1.0) / (k_n * v_n) * ((snp0 + ssq) - k_n * m_n * m_n)
    return m_n, var


def _sum_log_d(var, positive_only: bool):
    """sum over axis 1 of log(var) in ascending d (the kernel's order);
    with ``positive_only`` non-positive entries count as log(1) = 0."""
    acc = torch.zeros_like(var[:, 0])
    for d in range(var.shape[1]):
        r = var[:, d]
        acc = acc + torch.log(torch.where(r > 0, r, 1.0) if positive_only
                              else r)
    return acc


def _student_t_groups(x, mu, var, v_n):
    """t1 [B, K]: the logs of the four stride-4 group products of
    ``1 + (x - mu)^2 / (var v_n)``, each product in ascending d, the logs
    summed in group order."""
    prods = [None] * _GROUPS
    for d in range(x.shape[1]):
        dl = x[:, d, None] - mu[:, d, :]
        r = 1.0 + (dl * dl) / (var[:, d, :] * v_n)
        j = d % _GROUPS
        prods[j] = r if prods[j] is None else prods[j] * r
    t1 = torch.zeros_like(v_n)
    for p in prods:
        if p is not None:
            t1 = t1 + torch.log(p)
    return t1


def _diag_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                      sum_sqT, k0m0, snp0, k0, v0, temp, use_argmax, weights):
    """The chain loop both plain versions share, all utterances advancing
    one segment per step; utterances past their last segment see
    ``embeds < 0`` and change nothing.  ``weights(cnt, j_prev)`` gives the
    [B, K] mixture-weight term of a step."""
    B, S = embeds.shape
    D = Xe.shape[-1]
    m0c, s0c = k0m0[:, None], snp0[:, None]                     # [D, 1]
    cnt = counts.to(Xe.dtype).clone()                           # [B, K]
    sx, ssq = sum_xT.clone(), sum_sqT.clone()                   # [B, D, K]
    mu, var = _derive(m0c, s0c, k0, v0, cnt[:, None, :], sx, ssq)
    lpv = _sum_log_d(var, positive_only=False)                  # [B, K]
    gr = lgamma_ratio(v0 + cnt)
    ks = torch.full((B, S), -1, dtype=torch.int32, device=Xe.device)
    j_prev = torch.full((B,), -1, dtype=torch.long, device=Xe.device)
    steps = torch.arange(1, S + 1, device=Xe.device)
    n_steps = int(torch.where(embeds >= 0, steps, 0).amax()) if S else 0
    rows = torch.arange(B, device=Xe.device)
    for s in range(n_steps):
        ok = embeds[:, s] >= 0
        x = Xe[:, s, :]
        v_n = v0 + cnt
        t1 = _student_t_groups(x, mu, var, v_n)
        post = ((D * ((gr - 0.5 * torch.log(v_n)) - _HALF_LOG_PI)
                 - 0.5 * lpv) - ((v_n + 1.0) / 2.0) * t1)
        logits = weights(cnt, j_prev) + torch.where(
            cnt > 0, post, log_prior_e[:, s, None])
        k_draw = (torch.argmax(logits, dim=-1) if use_argmax else
                  annealed_gumbel_max(logits, gumbel[:, s], temp))
        k_new = canonicalize_new_component(cnt, k_draw)
        ks[:, s] = torch.where(ok, k_new, -1).to(torch.int32)
        j_prev = torch.where(ok, k_new, j_prev)
        b, k = rows[ok], k_new[ok]
        xo = x[ok]
        cnt[b, k] += 1.0
        sx[b, :, k] += xo
        ssq[b, :, k] += xo * xo
        c_new = cnt[b, k]
        mu_k, var_k = _derive(k0m0, snp0, k0, v0, c_new[:, None],
                              sx[b, :, k], ssq[b, :, k])
        mu[b, :, k] = mu_k
        var[b, :, k] = var_k
        lpv[b, k] = _sum_log_d(var_k, positive_only=True)
        gr[b, k] = lgamma_ratio(v0 + c_new)
    return ks


def diag_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                     sum_sqT, k0m0, snp0, k0, v0, temp, alpha, K, lms,
                     use_argmax):
    """Plain PyTorch version of K6."""
    def weights(cnt, j_prev):
        return lms * torch.log(alpha / K + cnt)

    return _diag_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                             sum_sqT, k0m0, snp0, k0, v0, temp, use_argmax,
                             weights)


def bigram_diag_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                            sum_sqT, k0m0, snp0, k0, v0, temp, uni_lo,
                            big_table, corr_j, corr_i, consts, K, lms):
    """Plain PyTorch version of K7: K4's LM weights, the rest as K6."""
    weights = bigram_lm_weights(uni_lo, big_table, corr_j, corr_i, consts,
                                K, lms, Xe.dtype)
    return _diag_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                             sum_sqT, k0m0, snp0, k0, v0, temp, False,
                             weights)


class ChainPlan(NamedTuple):
    """How K6 / K7 launch: one CTA of ``threads`` an utterance, with
    ``smem`` bytes of dynamic shared memory; ``form`` "smem" keeps the
    tables and column arrays in shared memory, "global" in device memory."""

    form: str
    threads: int
    smem: int


N_COL_ARRAYS = 6  # the global form's [B, 6, K] column arrays


def smem_bytes(global_tables: bool, bigram: bool, D: int, S: int,
               K: int) -> int:
    """Dynamic shared memory of the CTA, as the kernel reserves it
    (``csrc/diag_chain.cu::smem_words``).  The smem form: per column mu
    and den [D], cnt, the two hoisted terms, the weight term and the
    touched slot (K7: and its old-pair range) and a double-buffered noise
    value.  Both forms: x and the log prior [3, D + 1]; k0 m0, snp0 and
    the updated column's log variances [3, D]; the valid steps [S]; K7:
    the old pairs [2, S]."""
    per_col = 2 * D + (6 if bigram else 5) + 2
    words = ((0 if global_tables else per_col * K) + 3 * (D + 1) + 3 * D
             + S + (2 * S if bigram else 0))
    return 4 * words


def launch_plan(D: int, K: int, S: int, bigram: bool,
                smem_limit: int) -> ChainPlan:
    """The form of K6 / K7 for D dims, K columns and S segments (pure
    Python): "smem" where the tables fit the ``smem_limit`` bytes of
    dynamic shared memory a CTA may take, else "global".  Raises if
    neither fits."""
    if S >= 1 << 15:
        raise ValueError("diag chains take fewer than 32768 segments")
    threads = min(1024, 32 * max(1, -(-K // 32)))
    for form in ("smem", "global"):
        smem = smem_bytes(form == "global", bigram, D, S, K)
        if smem <= smem_limit:
            return ChainPlan(form, threads, smem)
    raise ValueError("no diag chain form fits D=%d, K=%d, S=%d" % (D, K, S))


def card_plan(D: int, K: int, S: int, bigram: bool) -> ChainPlan:
    """:func:`launch_plan` under the current card's limit: its opt-in
    shared memory a block less the kernel's static shared memory, as the
    kernel library reads them."""
    limit = cuda_lib.library().diag_chain_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "diag_chain_smem_limit")
    return launch_plan(D, K, S, bigram, limit)


def _check(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0,
           snp0, K):
    """Validate the chain inputs; returns (B, S, D)."""
    B, S = embeds.shape
    D = Xe.shape[-1]
    dev, f32 = Xe.device, torch.float32
    req = cuda_lib.require
    req(embeds, "embeds", torch.int32, (B, S), dev)
    req(Xe, "Xe", f32, (B, S, D), dev)
    req(log_prior_e, "log_prior_e", f32, (B, S), dev)
    req(gumbel, "gumbel", f32, (B, S, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    req(sum_xT, "sum_xT", f32, (B, D, K), dev)
    req(sum_sqT, "sum_sqT", f32, (B, D, K), dev)
    req(k0m0, "k0m0", f32, (D,), dev)
    req(snp0, "snp0", f32, (D,), dev)
    return B, S, D


def _outputs(plan, B, S, D, K, dev):
    """ks and the kernel's device-memory scratch: the touched-column table
    [B, S, 2, D] (a slot a step) and, for the global form only, the mu and
    den tables [B, D, K] and the column arrays [B, 6, K]."""
    f32 = torch.float32
    ks = torch.empty((B, S), dtype=torch.int32, device=dev)
    touched = torch.empty((B, S, 2, D), dtype=f32, device=dev)
    glob = ((torch.empty((B, D, K), dtype=f32, device=dev),
             torch.empty((B, D, K), dtype=f32, device=dev),
             torch.empty((B, N_COL_ARRAYS, K), dtype=f32, device=dev))
            if plan.form == "global" else (None, None, None))
    return ks, touched, glob


def _plan_args(plan):
    """The form and threads the kernel takes; it sizes its own shared
    memory."""
    return int(plan.form == "global"), plan.threads


def _launch(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0,
            snp0, k0, v0, temp, alpha, K, lms, use_argmax):
    global launches
    B, S, D = _check(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                     sum_sqT, k0m0, snp0, K)
    plan = card_plan(D, K, S, False)
    ks, touched, glob = _outputs(plan, B, S, D, K, Xe.device)
    p = cuda_lib.ptr
    err = cuda_lib.library().diag_chain_launch(
        p(embeds), p(Xe), p(log_prior_e), p(gumbel), p(counts), p(sum_xT),
        p(sum_sqT), p(k0m0), p(snp0), k0, v0, p(touched),
        *(p(t) for t in glob), p(ks), B, S, D, K, *_plan_args(plan),
        alpha / K, lms, temp, _HALF_LOG_PI, int(use_argmax),
        cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "diag_chain")
    launches += 1
    return ks


def _launch_bigram(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT,
                   k0m0, snp0, k0, v0, temp, uni_lo, big_table, corr_j,
                   corr_i, consts, K, lms):
    global bigram_launches
    B, S, D = _check(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                     sum_sqT, k0m0, snp0, K)
    dev = Xe.device
    req = cuda_lib.require
    req(uni_lo, "uni_lo", torch.int32, (B, K), dev)
    req(big_table, "big_table", torch.int32, (K, K), dev)
    req(corr_j, "corr_j", torch.int32, (B, S), dev)
    req(corr_i, "corr_i", torch.int32, (B, S), dev)
    plan = card_plan(D, K, S, True)
    ks, touched, glob = _outputs(plan, B, S, D, K, dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().bigram_diag_chain_launch(
        p(embeds), p(Xe), p(log_prior_e), p(gumbel), p(counts), p(sum_xT),
        p(sum_sqT), p(k0m0), p(snp0), k0, v0, p(uni_lo), p(big_table),
        p(corr_j), p(corr_i), p(touched), *(p(t) for t in glob), p(ks), B,
        S, D, K, *_plan_args(plan), *consts, lms, temp, _HALF_LOG_PI,
        cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "bigram_diag_chain")
    bigram_launches += 1
    return ks
