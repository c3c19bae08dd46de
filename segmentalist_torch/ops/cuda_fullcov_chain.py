"""Within-utterance full-covariance assignment chains: kernel K9 (both
mixture-weight modes) and its plain versions.

Counterpart of ``segmentalist_tpu/ops/pallas_chain.py::fullcov_chain_pallas``
and its XLA twin ``segmentalist_tpu/segmenters/fullcov.py::fullcov_chain``
(reference conditioning ``fbgmm.py:422-463``; bigram weights
``bigram_acoustic_wordseg.py:332-384``).  Each utterance carries a table of
T = T0 + S touched slots: the components its old segments belonged to (T0
slots from ``segmenters.fullcov.chain_inputs``, -1 for pads and duplicates)
and up to S components it claims while its new segments are assigned.  A
slot holds (m, inv P, logdet P) of the leave-out posterior, P the unscaled
scale matrix, whose count is the running count of its component.  A step

  1. scores x against every live slot, the exact leave-out Student-t
       maha = max((x - m)^T invP (x - m), 0) / s,  s = (k_n + 1) / (k_n v)
       c    = glr(v) - D/2 (log v + log pi) - (ldP + D log s)/2
              - (v + D)/2 log1p(maha / v)
     with v = v0 + n - D + 1, k_n = k0 + n and glr(v) = lgamma((v + D)/2) -
     lgamma(v/2) the Stirling series (``ops/special.py``);
  2. takes every other component's score from ``base`` (the global
     predictive, which an untouched component's leave-out equals);
  3. draws k by Gumbel-max (or argmax) over ``w + (n > 0 ? score : prior)``,
     with the first-empty birth rule;
  4. updates k's slot (or claims the first free slot, which pulls k's global
     factors) by the rank-1 Sherman-Morrison step of adding x:
       beta = k_n / (k_n + 1),  u = invP (x - m),  denom = 1 + beta u.(x - m)
       invP -= (beta / denom) u u^T,  ldP += log denom,
       m = (k_n m + x) / (k_n + 1)
     (``denom`` <= 0 is taken as 1, the reference's pad-step guard).

The weights are the Dirichlet term ``lms log(alpha/K + n)`` or, in the
bigram mode, K4's LM weights (:func:`cuda_chain.bigram_lm_weights`).  The
plain versions follow the kernel (``csrc/fullcov_chain.cu``) operation for
operation -- the matrix-vector products and dot products summed in
ascending order -- so on shared noise they sample the same chains.
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

_LOG_PI = math.log(math.pi)

launches = 0         # K9 launches, Dirichlet weights
bigram_launches = 0  # K9 launches, bigram-LM weights


def fullcov_chain(embeds, Xe, log_prior_e, gumbel, base, counts, t_m0,
                  t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, k_0, v_0, temp,
                  alpha: float, K: int, lms: float = 1.0,
                  use_argmax: bool = False):
    """Sequential within-utterance full-covariance assignment chains,
    batched over utterances (kernel K9, Dirichlet weights).

    embeds [B, S] int32 segment embedding ids (-1 = pad); Xe [B, S, D]
    their vectors; log_prior_e [B, S] their prior log densities; gumbel and
    base [B, S, K] the noise (ignored for ``use_argmax``) and the global
    predictive scores; counts [B, K] int32 leave-out counts; t_m0 [B, T0,
    D], t_invP0 [B, T0, D, D], t_ldP0 [B, T0], tk0 [B, T0] int32 the
    touched slots; g_m [K, D], g_invP [K, D, D], g_ldP [K] the global
    P-form tables; k_0, v_0, temp Python floats.

    Returns ks [B, S] int32, the sampled component of each segment (-1 pads).
    """
    args = (embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0,
            t_ldP0, tk0, g_m, g_invP, g_ldP, float(k_0), float(v_0),
            float(temp), float(alpha), int(K), float(lms), bool(use_argmax))
    if cuda_lib.use_kernel(Xe):
        return _launch(*args)
    return fullcov_chain_plain(*args)


def bigram_fullcov_chain(embeds, Xe, log_prior_e, gumbel, base, counts,
                         t_m0, t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, k_0,
                         v_0, temp, uni_lo, big_table, corr_j, corr_i,
                         alpha_a: float, intrp_lambda: float,
                         b_smooth: float, K: int, lms: float = 1.0):
    """Bigram-conditioned full-covariance chains (kernel K9, bigram mode):
    the inputs of :func:`fullcov_chain` (always Gumbel-max) plus the LM
    inputs of ``cuda_chain.bigram_fixedvar_chain``.  Every valid old pair
    must be counted in ``big_table`` (``pallas_chain.py:1381-1383``).

    Returns ks [B, S] int32 (-1 pads).
    """
    args = (embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0,
            t_ldP0, tk0, g_m, g_invP, g_ldP, float(k_0), float(v_0),
            float(temp), uni_lo, big_table, corr_j, corr_i,
            bigram_constants(alpha_a, b_smooth, intrp_lambda, K), int(K),
            float(lms))
    if cuda_lib.use_kernel(Xe):
        return _launch_bigram(*args)
    return bigram_fullcov_chain_plain(*args)


def _matvec(A, v):
    """[..., D] rows of ``A`` [..., D, D] times ``v`` [..., D], each row
    summed in ascending column order (the kernel's)."""
    acc = torch.zeros_like(v)
    for e in range(v.shape[-1]):
        acc = acc + A[..., e] * v[..., e, None]
    return acc


def _dot(a, b):
    """Sum over the last axis of ``a * b`` in ascending order."""
    acc = torch.zeros_like(a[..., 0])
    for d in range(a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def _slot_scores(x, t_m, t_invP, t_ldP, n, k0, v0):
    """[B, T] leave-out Student-t log densities of x [B, D] under every
    slot (step 1 of the module docstring)."""
    D = x.shape[-1]
    delta = x[:, None, :] - t_m
    mahaP = _dot(_matvec(t_invP, delta), delta).clamp_min(0.0)
    k_n = k0 + n
    v_t = v0 + n - D + 1.0
    s_t = (k_n + 1.0) / (k_n * v_t)
    ld_t = t_ldP + D * torch.log(s_t)
    return (((lgamma_ratio(v_t, D) - (0.5 * D) * (torch.log(v_t) + _LOG_PI))
             - 0.5 * ld_t)
            - (0.5 * (v_t + D)) * torch.log1p((mahaP / s_t) / v_t))


def _first(mask):
    """Index of the first True along the last axis (its length if none)."""
    T = mask.shape[-1]
    lane = torch.arange(T, device=mask.device)
    return torch.where(mask, lane, T).amin(-1)


def _fullcov_chain_plain(embeds, Xe, log_prior_e, gumbel, base, counts,
                         t_m0, t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, k0,
                         v0, temp, use_argmax, weights):
    """The chain loop both plain versions share, all utterances advancing
    one segment per step; utterances past their last segment see
    ``embeds < 0`` and change nothing.  ``weights(cnt, j_prev)`` gives the
    [B, K] mixture-weight term of a step."""
    B, S = embeds.shape
    D = Xe.shape[-1]
    K = counts.shape[-1]
    dev = Xe.device
    cnt = counts.to(Xe.dtype).clone()                              # [B, K]
    tk = torch.cat([tk0.long(), tk0.new_full((B, S), -1).long()], 1)
    t_m = torch.cat([t_m0, t_m0.new_zeros((B, S, D))], 1)
    t_iP = torch.cat([t_invP0, t_invP0.new_zeros((B, S, D, D))], 1)
    t_ld = torch.cat([t_ldP0, t_ldP0.new_zeros((B, S))], 1)
    ks = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    j_prev = torch.full((B,), -1, dtype=torch.long, device=dev)
    steps = torch.arange(1, S + 1, device=dev)
    n_steps = int(torch.where(embeds >= 0, steps, 0).amax()) if S else 0
    rows = torch.arange(B, device=dev)
    for s in range(n_steps):
        ok = embeds[:, s] >= 0
        x = Xe[:, s, :]
        c = _slot_scores(x, t_m, t_iP, t_ld, cnt.gather(1, tk.clamp_min(0)),
                         k0, v0)
        post = torch.cat([base[:, s], base.new_zeros((B, 1))], 1).scatter(
            1, torch.where(tk >= 0, tk, K), c)[:, :K]
        logits = weights(cnt, j_prev) + torch.where(
            cnt > 0, post, log_prior_e[:, s, None])
        k_draw = (torch.argmax(logits, dim=-1) if use_argmax else
                  annealed_gumbel_max(logits, gumbel[:, s], temp))
        k_new = canonicalize_new_component(cnt, k_draw)
        ks[:, s] = torch.where(ok, k_new, -1).to(torch.int32)
        j_prev = torch.where(ok, k_new, j_prev)

        b, k, xo = rows[ok], k_new[ok], x[ok]
        tk_b = tk[b]
        match = tk_b == k[:, None]
        have = match.any(1)
        slot = torch.where(have, _first(match), _first(tk_b < 0))
        m = torch.where(have[:, None], t_m[b, slot], g_m[k])
        iP = torch.where(have[:, None, None], t_iP[b, slot], g_invP[k])
        ld = torch.where(have, t_ld[b, slot], g_ldP[k])
        k_n = k0 + cnt[b, k]
        beta = k_n / (k_n + 1.0)
        dv = xo - m
        u = _matvec(iP, dv)
        denom = 1.0 + beta * _dot(u, dv)
        denom = torch.where(denom > 0, denom, 1.0)
        t_iP[b, slot] = iP - (beta / denom)[:, None, None] * (
            u[:, :, None] * u[:, None, :])
        t_ld[b, slot] = ld + torch.log(denom)
        t_m[b, slot] = (k_n[:, None] * m + xo) / (k_n + 1.0)[:, None]
        tk[b, slot] = k
        cnt[b, k] += 1.0
    return ks


def fullcov_chain_plain(embeds, Xe, log_prior_e, gumbel, base, counts, t_m0,
                        t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, k0, v0,
                        temp, alpha, K, lms, use_argmax):
    """Plain PyTorch version of K9 with Dirichlet weights."""
    def weights(cnt, j_prev):
        return lms * torch.log(alpha / K + cnt)

    return _fullcov_chain_plain(embeds, Xe, log_prior_e, gumbel, base, counts,
                                t_m0, t_invP0, t_ldP0, tk0, g_m, g_invP,
                                g_ldP, k0, v0, temp, use_argmax, weights)


def bigram_fullcov_chain_plain(embeds, Xe, log_prior_e, gumbel, base,
                               counts, t_m0, t_invP0, t_ldP0, tk0, g_m,
                               g_invP, g_ldP, k0, v0, temp, uni_lo,
                               big_table, corr_j, corr_i, consts, K, lms):
    """Plain PyTorch version of K9's bigram mode: K4's LM weights, the rest
    as the Dirichlet mode."""
    weights = bigram_lm_weights(uni_lo, big_table, corr_j, corr_i, consts,
                                K, lms, Xe.dtype)
    return _fullcov_chain_plain(embeds, Xe, log_prior_e, gumbel, base, counts,
                                t_m0, t_invP0, t_ldP0, tk0, g_m, g_invP,
                                g_ldP, k0, v0, temp, False, weights)


class ChainPlan(NamedTuple):
    """How K9 launches: one block of ``threads`` an utterance, with
    ``smem`` bytes of dynamic shared memory; ``form`` "smem" keeps the
    slot tables in shared memory, "stream" keeps them in device memory and
    streams each live slot's record through a ring of ``ring`` record
    buffers in shared memory (0 in the smem form)."""

    form: str
    threads: int
    ring: int
    smem: int


MAX_RING = 3        # csrc/fullcov_chain.cu kMaxRing
MAX_THREADS = 512   # csrc/fullcov_chain.cu kMaxThreads


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def rec_words(D: int) -> int:
    """Words of a streamed slot record: m, then inv P (transposed), each
    padded to a multiple of 4 (bulk copies move multiples of 16 bytes)."""
    return _round4(D) + _round4(D * D)


def smem_bytes(form: str, bigram: bool, D: int, S: int, T0: int, K: int,
               ring: int = 0) -> int:
    """Dynamic shared memory of the block, as the kernel reserves it
    (``csrc/fullcov_chain.cu::smem_words``).  Smem form: inv P [T, D, D],
    m and U [T, D]; stream form: the ring [ring, rec_words] and U delta
    [2, D].  Both: a claim's u [D]; cnt, w, slot_of (bigram: the pair
    range) [K]; noise and base double buffers [4, K]; ten slot arrays and
    lists [T]; x and the log prior [3, D + 1]; the valid steps [S]; bigram:
    the old pairs [2, S]."""
    T = T0 + S
    tables = (ring * rec_words(D) + 2 * D if form == "stream"
              else T * (D * D + 2 * D))
    words = (tables + D + (4 if bigram else 3) * K + 4 * K + 10 * T
             + 3 * (D + 1) + S + (2 * S if bigram else 0))
    return 4 * words


def _threads(n: int) -> int:
    return min(MAX_THREADS, 32 * max(2, -(-n // 32)))


def launch_plan(D: int, K: int, S: int, T0: int, bigram: bool,
                smem_limit: int) -> ChainPlan:
    """The form of K9 for D dims, K components, S segments and T0 input
    slots (pure Python): "smem" where every table fits the ``smem_limit``
    bytes of dynamic shared memory a block may take, else "stream" with as
    many record buffers (2 or 3) as fit.  Raises if neither fits."""
    if S >= 1 << 15:
        raise ValueError("fullcov chains take fewer than 32768 segments")
    smem = smem_bytes("smem", bigram, D, S, T0, K)
    if smem <= smem_limit:
        return ChainPlan("smem", _threads(max(K, (T0 + S) * D)), 0, smem)
    consumers = 32 * -(-D // 32)
    if consumers + 32 <= MAX_THREADS:
        for ring in range(MAX_RING, 1, -1):
            smem = smem_bytes("stream", bigram, D, S, T0, K, ring)
            if smem <= smem_limit:
                return ChainPlan("stream", _threads(max(K, consumers + 32)),
                                 ring, smem)
    raise ValueError("no fullcov chain form fits D=%d, K=%d, S=%d, T0=%d"
                     % (D, K, S, T0))


def card_plan(D: int, K: int, S: int, T0: int, bigram: bool) -> ChainPlan:
    """:func:`launch_plan` under the current card's limit: its opt-in
    shared memory a block less the kernel's static shared memory, as the
    kernel library reads them."""
    limit = cuda_lib.library().fullcov_chain_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "fullcov_chain_smem_limit")
    return launch_plan(D, K, S, T0, bigram, limit)


def _check_and_scratch(embeds, Xe, log_prior_e, gumbel, base, counts, t_m0,
                       t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, K, bigram):
    """Validate the chain inputs; pick the plan; allocate the stream
    form's slot records [B, T, rec_words] and U [B, T, D] in device memory
    (empty in the smem form) and ks.  Returns the C launch's dimensions,
    the scratch and the plan's form ("smem", or "stream ring R")."""
    B, S = embeds.shape
    D = Xe.shape[-1]
    T0 = tk0.shape[1]
    T = T0 + S
    dev, f32, i32 = Xe.device, torch.float32, torch.int32
    req = cuda_lib.require
    req(embeds, "embeds", i32, (B, S), dev)
    req(Xe, "Xe", f32, (B, S, D), dev)
    req(log_prior_e, "log_prior_e", f32, (B, S), dev)
    req(gumbel, "gumbel", f32, (B, S, K), dev)
    req(base, "base", f32, (B, S, K), dev)
    req(counts, "counts", i32, (B, K), dev)
    req(t_m0, "t_m0", f32, (B, T0, D), dev)
    req(t_invP0, "t_invP0", f32, (B, T0, D, D), dev)
    req(t_ldP0, "t_ldP0", f32, (B, T0), dev)
    req(tk0, "tk0", i32, (B, T0), dev)
    req(g_m, "g_m", f32, (K, D), dev)
    req(g_invP, "g_invP", f32, (K, D, D), dev)
    req(g_ldP, "g_ldP", f32, (K,), dev)
    plan = card_plan(D, K, S, T0, bigram)
    n = B * T if plan.form == "stream" else 0
    scratch = [torch.empty((n, rec_words(D)), dtype=f32, device=dev),
               torch.empty((n, D), dtype=f32, device=dev),
               torch.empty((B, S), dtype=i32, device=dev)]
    # C order: recs, Ug, ks, then B, S, D, K, T0, form, threads, ring
    form = ("stream ring %d" % plan.ring if plan.form == "stream"
            else plan.form)
    return (B, S, D, K, T0, int(plan.form == "stream"), plan.threads,
            plan.ring), scratch, form


def _launch(embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0,
            t_ldP0, tk0, g_m, g_invP, g_ldP, k0, v0, temp, alpha, K, lms,
            use_argmax):
    global launches
    tables = (embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0,
              t_ldP0, tk0, g_m, g_invP, g_ldP)
    dims, scratch, form = _check_and_scratch(*tables, K, False)
    p = cuda_lib.ptr
    err = cuda_lib.library().fullcov_chain_launch(
        *(p(a) for a in tables), k0, v0, 0.5 * dims[2], _LOG_PI,
        *(p(a) for a in scratch), *dims, alpha / K, lms, temp,
        int(use_argmax), cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "fullcov_chain")
    launches += 1
    cuda_lib.count_form("K9", form)
    return scratch[-1]


def _launch_bigram(embeds, Xe, log_prior_e, gumbel, base, counts, t_m0,
                   t_invP0, t_ldP0, tk0, g_m, g_invP, g_ldP, k0, v0, temp,
                   uni_lo, big_table, corr_j, corr_i, consts, K, lms):
    global bigram_launches
    tables = (embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0,
              t_ldP0, tk0, g_m, g_invP, g_ldP)
    dims, scratch, form = _check_and_scratch(*tables, K, True)
    B, S = dims[:2]
    dev = Xe.device
    req = cuda_lib.require
    req(uni_lo, "uni_lo", torch.int32, (B, K), dev)
    req(big_table, "big_table", torch.int32, (K, K), dev)
    req(corr_j, "corr_j", torch.int32, (B, S), dev)
    req(corr_i, "corr_i", torch.int32, (B, S), dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().bigram_fullcov_chain_launch(
        *(p(a) for a in tables), k0, v0, 0.5 * dims[2], _LOG_PI, p(uni_lo),
        p(big_table), p(corr_j), p(corr_i), *(p(a) for a in scratch), *dims,
        *consts, lms, temp, cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "bigram_fullcov_chain")
    bigram_launches += 1
    cuda_lib.count_form("K9", form + " bigram")
    return scratch[-1]
