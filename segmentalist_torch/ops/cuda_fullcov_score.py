"""Fused full-covariance candidate scoring: kernel K8 and its plain version.

Counterpart of ``segmentalist_tpu/ops/pallas_score.py::fullcov_log_margs``.
With the inputs of ``segmenters.fullcov.fullcov_score_inputs`` it computes

    maha_g[b, m, k] = |L[k] x[b, m] - Lmu[k]|^2
    post_g          = ck[k] - vh[k] log1p(maha_g vinv[k])
    c_t[b, m, s]    = the same against utterance b's touched-slot tables
    post            = c_t[b, m, tslot[b, k]] where tslot[b, k] >= 0, else post_g
    log_margs[b, m] = logsumexp_k( w[b, k] + where(counts[b, k] > 0, post,
                                                   prior_c[b, m]) )

where ``L`` is the inverse Cholesky factor of the predictive scale matrix
(``PredParams.chol_inv``, packed lower triangle), so ``maha = (x -
mu)^T A (x - mu)``.  The JAX package expands the same form into ``x^T A x
- 2 x . A mu + mu . A mu``, whose terms cancel: in float32 two summation
orders of it differed by 1.3e-4 relative at D = 130.  The whitened form
cancels only in ``L x - L mu``, a difference of vectors the size of the
whitened candidate, and stays in float32.  The kernel
(``csrc/fullcov_score.cu``) and this plain version evaluate the same form
and differ only in summation order.  A CPU tensor takes the plain version,
a CUDA tensor the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .random import NEG_INF, logsumexp
from .stats import sym_pack

_PLAIN_ELEMS = 1 << 28  # elements of the plain version's [.., C, D] slab

launches = 0  # K8 launches since the last reset


def fullcov_log_margs(Xc, prior_c, g, t, tslot, wvec, counts, valid_m=None):
    """[B, M] collapsed candidate log marginals under the full-covariance
    predictive, touched columns corrected.

    Xc [B, M, D] candidate vectors; prior_c [B, M] their prior log
    densities; ``g`` = (LT [F, K], LmuT [D, K], ck, vinv, vh [K]) the
    global tables and ``t`` = (L [B, S, F], Lmu [B, S, D], ck, vinv, vh
    [B, S]) the touched-slot tables (F = D(D+1)/2); tslot [B, K] int32 the
    slot of each touched component (-1 elsewhere); wvec [B, K] mixture
    weights incl. the denominator; counts [B, K] int32 leave-out counts;
    valid_m optional [B] int32 valid-candidate prefix lengths (rows past it
    come back -inf).
    """
    if cuda_lib.use_kernel(Xc):
        return _launch(Xc, prior_c, g, t, tslot, wvec, counts, valid_m)
    return fullcov_scores_plain(Xc, prior_c, g, t, tslot, wvec, counts,
                                valid_m)


def _maha(Xc, L, Lmu):
    """[B, M, C] ``|L x - Lmu|^2`` of Xc [B, M, D] against packed factors
    L [Bt, C, F] and Lmu [Bt, C, D] (Bt 1 or B), C in slabs."""
    B, M, D = Xc.shape
    pk = sym_pack(D, Xc.device)
    Bt, C, _ = L.shape
    if C == 0:
        return Xc.new_zeros((B, M, 0))
    step = max(1, _PLAIN_ELEMS // (B * M * D))
    out = []
    for c0 in range(0, C, step):
        c1 = min(C, c0 + step)
        full = L.new_zeros((Bt, c1 - c0, D, D))
        full[..., pk.il0, pk.il1] = L[:, c0:c1]
        y = (Xc @ full.reshape(Bt, -1, D).transpose(1, 2)).unflatten(
            -1, (c1 - c0, D)) - Lmu[:, None, c0:c1]
        out.append((y * y).sum(-1))
    return torch.cat(out, dim=-1)


def _student_t(maha, ck, vh, vinv):
    return ck - vh * torch.log1p(maha * vinv)


def fullcov_scores_plain(Xc, prior_c, g, t, tslot, wvec, counts,
                         valid_m=None):
    """Plain PyTorch version of K8: the whitened form as matrix products
    over slabs of components, then select and -inf-safe logsumexp."""
    B, M, _ = Xc.shape
    gLT, gLmuT, gck, gvinv, gvh = g
    tL, tLmu, tck, tvinv, tvh = t
    post = _student_t(_maha(Xc, gLT.T[None], gLmuT.T[None]), gck, gvh,
                      gvinv)                                 # [B, M, K]
    c_t = _student_t(_maha(Xc, tL, tLmu), tck[:, None, :], tvh[:, None, :],
                     tvinv[:, None, :])                      # [B, M, S]
    K = tslot.shape[-1]
    if c_t.shape[-1]:  # S > 0 touched slots
        corr = c_t.gather(2, tslot.clamp_min(0).long()[:, None, :].expand(
            B, M, K))
        post = torch.where((tslot >= 0)[:, None, :], corr, post)
    logits = wvec[:, None, :] + torch.where(
        (counts > 0)[:, None, :], post, prior_c[..., None])
    out = logsumexp(logits, dim=-1)
    if valid_m is not None:
        live = torch.arange(M, device=Xc.device)[None, :] < valid_m[:, None]
        out = torch.where(live, out, NEG_INF)
    return out


class ScorePlan(NamedTuple):
    """How K8 launches: a grid of ``tiles`` x B blocks of ``rows``
    candidate rows (8 a warp), with ``smem`` bytes of dynamic shared
    memory."""

    rows: int
    tiles: int
    smem: int


ROWS_PER_WARP = 8  # csrc/fullcov_score.cu kRowsPerWarp
RING_WORDS = 3 * 16 * 128  # the factor ring: stages x lanes x entries


def smem_bytes(D: int, K: int, rows: int) -> int:
    """Dynamic shared memory of a block, as the kernel reserves it
    (``csrc/fullcov_score.cu::smem_words``): the factor ring, the rows
    [D, rows], the global and touched column lists [K] each and the warps'
    partial logsumexps of the empty columns [2, warps]."""
    return 4 * (RING_WORDS + D * rows + 2 * K + 2 * (rows // ROWS_PER_WARP))


def launch_plan(D: int, K: int, M: int, smem_limit: int) -> ScorePlan:
    """K8's tiling for D dims, K components and M candidate rows an
    utterance (pure Python): 64 rows a block (8 warps; each staged factor
    value feeds 64 rows), or 32 if 64 would exceed the ``smem_limit`` bytes
    of dynamic shared memory.  Raises if neither fits."""
    for rows in (64, 32):
        smem = smem_bytes(D, K, rows)
        if smem <= smem_limit:
            return ScorePlan(rows, -(-M // rows), smem)
    raise ValueError("no fullcov scores tile fits D=%d, K=%d" % (D, K))


def card_plan(D: int, K: int, M: int) -> ScorePlan:
    """:func:`launch_plan` under the current card's limit: its opt-in
    shared memory a block less the kernel's static shared memory."""
    limit = cuda_lib.library().fullcov_scores_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "fullcov_scores_smem_limit")
    return launch_plan(D, K, M, limit)


def _launch(Xc, prior_c, g, t, tslot, wvec, counts, valid_m):
    global launches
    B, M, D = Xc.shape
    K = tslot.shape[-1]
    S = t[1].shape[1]
    F = D * (D + 1) // 2
    dev, f32 = Xc.device, torch.float32
    req = cuda_lib.require
    req(Xc, "Xc", f32, (B, M, D), dev)
    req(prior_c, "prior_c", f32, (B, M), dev)
    for name, a, shape in zip(("LT", "LmuT", "ck", "vinv", "vh"), g,
                              ((F, K), (D, K)) + ((K,),) * 3):
        req(a, "g_" + name, f32, shape, dev)
    for name, a, shape in zip(("L", "Lmu", "ck", "vinv", "vh"), t,
                              ((B, S, F), (B, S, D)) + ((B, S),) * 3):
        req(a, "t_" + name, f32, shape, dev)
    req(tslot, "tslot", torch.int32, (B, K), dev)
    req(wvec, "wvec", f32, (B, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    if valid_m is not None:
        req(valid_m, "valid_m", torch.int32, (B,), dev)
    plan = card_plan(D, K, M)
    out = torch.empty((B, M), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fullcov_scores_launch(
        p(Xc), p(prior_c), *(p(a) for a in g), *(p(a) for a in t), p(tslot),
        p(wvec), p(counts), p(valid_m), p(out), B, M, D, K, S, plan.rows,
        cuda_lib.stream_of(Xc))
    cuda_lib.check(err, "fullcov_scores")
    launches += 1
    cuda_lib.count_form("K8", "%d rows" % plan.rows)
    return out
