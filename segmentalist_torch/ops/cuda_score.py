"""Fused candidate scoring: kernels K1 (fixed variance) and K5 (diagonal
covariance) and their plain versions.

Counterpart of the fixed-variance and diag parts of
``segmentalist_tpu/ops/pallas_score.py`` (``fixedvar_log_margs_T`` /
``_fixedvar_dispatch`` and ``diag_log_margs_T`` / ``_diag_dispatch``).
Each computes

    log_margs[b, m] = logsumexp_k( w[b, k] + where(counts[b, k] > 0,
                          log_post_pred[b, m, k], prior_c[b, m]) )

without materialising the [B, M, K] logits on the card.  Both kernels are
one scorer (``csrc/diag_family_score.cuh``) with a per-family policy
(``csrc/fixedvar_score.cu``, ``csrc/diag_score.cu``) and launch by one
pure-Python plan (:func:`launch_plan`).  A CPU tensor takes the plain
PyTorch version, a CUDA tensor the kernel.

K1 and its plain version sum the Mahalanobis form ``sum_d (x - mu)^2 prec``
directly, in ascending d (the Pallas kernel's expanded ``x^2 prec - 2 x mu
prec + const`` form cancels badly in float32), and K5 and its plain version
fold ``r_d`` in ascending d in the same operations, so each kernel differs
from its plain version only in the order of the logsumexp over K and in its
per-component constants (K1's ``sum_d log prec``, K5's Student-t terms):
they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import cuda_lib
from .random import NEG_INF, logsumexp

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_PI = math.log(math.pi)
_MAX_D = 512  # the widest rows tested (the plan fits them in 64-row tiles)
_GROUP = 4    # dims per log in K5's grouped composition

launches = 0             # K1 launches since the last reset
diag_launches = 0        # K5 launches, grouped composition
diag_exact_launches = 0  # K5 launches, exact composition


def fixedvar_log_margs_T(Xc, prior_c, mu_predT, prec_predT, wvec, counts,
                         valid_m=None):
    """[B, M] collapsed candidate log marginals.

    Xc [B, M, D] candidate vectors; prior_c [B, M] their prior log
    densities; mu_predT / prec_predT [B, D, K] feature-major predictive
    parameters (``components_fixedvar.predictive_params_T``); wvec [B, K]
    mixture-weight terms incl. the denominator; counts [B, K] int32
    leave-out counts; valid_m optional [B] int32 valid-candidate prefix
    lengths (rows past it come back -inf).  Kernel on a CUDA tensor, plain
    version on a CPU tensor.
    """
    if cuda_lib.use_kernel(Xc):
        return _launch(Xc, prior_c, mu_predT, prec_predT, wvec, counts,
                       valid_m)
    return fixedvar_scores_plain(Xc, prior_c, mu_predT, prec_predT, wvec,
                                 counts, valid_m)


def fixedvar_scores_plain(Xc, prior_c, muT, precT, wvec, counts,
                          valid_m=None):
    """Plain PyTorch version of K1: the [B, M, K] Mahalanobis table summed
    over d in ascending order, then select and -inf-safe logsumexp."""
    B, M, D = Xc.shape
    maha = torch.zeros((B, M, muT.shape[-1]), dtype=Xc.dtype,
                       device=Xc.device)
    for d in range(D):
        dl = Xc[:, :, d, None] - muT[:, None, d, :]
        maha = maha + dl * dl * precT[:, None, d, :]
    log_prod = torch.log(precT).sum(-2)
    post = -0.5 * D * _LOG_2PI + 0.5 * log_prod[:, None, :] - 0.5 * maha
    return _select_logsumexp(post, wvec, counts, prior_c, valid_m)


def _select_logsumexp(post, wvec, counts, prior_c, valid_m):
    """logsumexp_k(w + where(counts > 0, post, prior_c)), rows past valid_m
    -inf."""
    logits = wvec[:, None, :] + torch.where(
        (counts > 0)[:, None, :], post, prior_c[..., None])
    out = logsumexp(logits, dim=-1)
    if valid_m is not None:
        M = out.shape[1]
        live = torch.arange(M, device=out.device)[None, :] < valid_m[:, None]
        out = torch.where(live, out, NEG_INF)
    return out


class ScorePlan(NamedTuple):
    """How K1 / K5 launch: a grid of ``tiles`` x B blocks of ``rows``
    candidate rows (8 a warp), with ``smem`` bytes of dynamic shared
    memory."""

    rows: int
    tiles: int
    smem: int


ROWS = 64      # csrc/diag_family_score.cuh kRows: 8 warps of 8 rows
WINDOW = 2048  # kWin: columns compacted at a time, 8 a thread
RING_WORDS = 2 * 2 * 16 * 128  # table ring: buffers x tables x features x entries
CONST_WORDS = 2 * 3 * 128      # per-column constants: passes x slots x entries


def smem_bytes(D: int, K: int) -> int:
    """Dynamic shared memory of a block, as the kernels reserve it
    (``csrc/diag_family_score.cuh::smem_words``): the table ring, the
    per-column constants, the rows [D, 64], the active-column list (a
    window of 8 columns a thread, at most K) and the warps' partial
    logsumexps of the empty columns [2, 8]."""
    return 4 * (RING_WORDS + CONST_WORDS + D * ROWS + min(K, WINDOW) + 2 * 8)


def launch_plan(D: int, K: int, M: int, smem_limit: int) -> ScorePlan:
    """K1 / K5's tiling for D dims, K components and M candidate rows an
    utterance (pure Python): 64 rows a block (8 warps; each staged table
    value feeds 64 rows).  Raises if its shared memory would exceed the
    ``smem_limit`` bytes (on the H100 it fits up to D 512)."""
    smem = smem_bytes(D, K)
    if smem > smem_limit:
        raise ValueError("no candidate-score tile fits D=%d, K=%d" % (D, K))
    return ScorePlan(ROWS, -(-M // ROWS), smem)


def card_plan(D: int, K: int, M: int) -> ScorePlan:
    """:func:`launch_plan` under the current card's limit: its opt-in
    shared memory a block less the kernel's static shared memory."""
    return launch_plan(D, K, M, _smem_limit(torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _smem_limit(device: int) -> int:
    """The kernels' shared-memory limit on ``device``, asked once (the
    query costs the host more than a launch)."""
    limit = cuda_lib.library().diag_family_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "diag_family_smem_limit")
    return limit


def _launch(Xc, prior_c, muT, precT, wvec, counts, valid_m):
    global launches
    B, M, D = Xc.shape
    K = precT.shape[-1]
    if D > _MAX_D:
        raise ValueError("fixedvar_scores kernel supports D <= %d" % _MAX_D)
    dev, f32 = Xc.device, torch.float32
    req = cuda_lib.require
    req(Xc, "Xc", f32, (B, M, D), dev)
    req(prior_c, "prior_c", f32, (B, M), dev)
    req(muT, "muT", f32, (B, D, K), dev)
    req(precT, "precT", f32, (B, D, K), dev)
    req(wvec, "wvec", f32, (B, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    if valid_m is not None:
        req(valid_m, "valid_m", torch.int32, (B,), dev)
    plan = card_plan(D, K, M)  # raises where a block would not fit
    out = torch.empty((B, M), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fixedvar_scores_launch(
        p(Xc), p(prior_c), p(muT), p(precT), p(wvec), p(counts), p(valid_m),
        p(out), B, M, D, K, -0.5 * D * _LOG_2PI, cuda_lib.stream_of(Xc))
    cuda_lib.check(err, "fixedvar_scores")
    launches += 1
    cuda_lib.count_form("K1", "%d rows" % plan.rows)
    return out


# ------------------------------------------------------------------- K5

def diag_log_margs_T(Xc, prior_c, muT, inv_varT, log_prod_var, v, wvec,
                     counts, valid_m=None, exact: bool = False):
    """[B, M] collapsed candidate log marginals under the diag
    (product-of-Student-t) predictive.

    muT / inv_varT [B, D, K], log_prod_var / v [B, K] from
    ``components_diag.predictive_params_T``; the rest as
    :func:`fixedvar_log_margs_T`.  ``exact`` sums ``log1p`` per dimension
    (the deterministic Viterbi path); otherwise the TPU kernel's grouped
    composition (logs of contiguous 4-dim products) is used.  Kernel on a
    CUDA tensor (which forms its Student-t tables itself), plain version on
    a CPU tensor.
    """
    if cuda_lib.use_kernel(Xc):
        return _launch_diag(Xc, prior_c, muT.contiguous(),
                            inv_varT.contiguous(), log_prod_var, v, wvec,
                            counts, valid_m, exact)
    return diag_scores_plain(Xc, prior_c, muT, inv_varT, log_prod_var, v,
                             wvec, counts, valid_m, exact)


def diag_scores_plain(Xc, prior_c, muT, inv_varT, log_prod_var, v, wvec,
                      counts, valid_m=None, exact: bool = False):
    """Plain PyTorch version of K5 in either composition: the Student-t
    tables ``ivvT`` = inv_var / v, ``const`` = D (lgamma((v + 1)/2) -
    lgamma(v/2) - log(v)/2 - log(pi)/2) - log_prod_var / 2 and ``vh`` = (v
    + 1)/2 (``pallas_score.py:293-299``), the [B, M, K] accumulator built
    over d in ascending order, then select and -inf-safe logsumexp."""
    B, M, D = Xc.shape
    ivvT = inv_varT / v[:, None, :]
    const = (D * (torch.lgamma((v + 1.0) / 2.0) - torch.lgamma(v / 2.0)
                  - 0.5 * torch.log(v) - 0.5 * _LOG_PI)
             - 0.5 * log_prod_var)
    vh = (v + 1.0) / 2.0
    acc = torch.zeros((B, M, muT.shape[-1]), dtype=Xc.dtype,
                      device=Xc.device)
    prod = None
    for d in range(D):
        dl = Xc[:, :, d, None] - muT[:, None, d, :]
        r = dl * dl * ivvT[:, None, d, :]
        if exact:
            acc = acc + torch.log1p(r)
            continue
        prod = 1.0 + r if prod is None else prod * (1.0 + r)
        if d % _GROUP == _GROUP - 1 or d == D - 1:
            acc = acc + torch.log(prod)
            prod = None
    post = const[:, None, :] - vh[:, None, :] * acc
    return _select_logsumexp(post, wvec, counts, prior_c, valid_m)


def _launch_diag(Xc, prior_c, muT, inv_varT, log_prod_var, v, wvec, counts,
                 valid_m, exact):
    global diag_launches, diag_exact_launches
    B, M, D = Xc.shape
    K = inv_varT.shape[-1]
    if D > _MAX_D:
        raise ValueError("diag_scores kernel supports D <= %d" % _MAX_D)
    dev, f32 = Xc.device, torch.float32
    req = cuda_lib.require
    req(Xc, "Xc", f32, (B, M, D), dev)
    req(prior_c, "prior_c", f32, (B, M), dev)
    req(muT, "muT", f32, (B, D, K), dev)
    req(inv_varT, "inv_varT", f32, (B, D, K), dev)
    req(log_prod_var, "log_prod_var", f32, (B, K), dev)
    req(v, "v", f32, (B, K), dev)
    req(wvec, "wvec", f32, (B, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    if valid_m is not None:
        req(valid_m, "valid_m", torch.int32, (B,), dev)
    plan = card_plan(D, K, M)  # raises where a block would not fit
    out = torch.empty((B, M), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().diag_scores_launch(
        p(Xc), p(prior_c), p(muT), p(inv_varT), p(log_prod_var), p(v),
        p(wvec), p(counts), p(valid_m), p(out), B, M, D, K, int(exact),
        cuda_lib.stream_of(Xc))
    cuda_lib.check(err, "diag_scores")
    cuda_lib.count_form("K5", "%d rows %s" % (
        plan.rows, "exact" if exact else "grouped"))
    if exact:
        diag_exact_launches += 1
    else:
        diag_launches += 1
    return out
