"""Fused candidate scoring: kernels K1 (fixed variance) and K5 (diagonal
covariance) and their plain versions.

Counterpart of the fixed-variance and diag parts of
``segmentalist_tpu/ops/pallas_score.py`` (``fixedvar_log_margs_T`` /
``_fixedvar_dispatch`` and ``diag_log_margs_T`` / ``_diag_dispatch``).
Each computes

    log_margs[b, m] = logsumexp_k( w[b, k] + where(counts[b, k] > 0,
                          log_post_pred[b, m, k], prior_c[b, m]) )

without materialising the [B, M, K] logits on the card
(``csrc/fixedvar_score.cu``, ``csrc/diag_score.cu``).  A CPU tensor takes
the plain PyTorch version, a CUDA tensor the kernel.

K1 and its plain version sum the Mahalanobis form ``sum_d (x - mu)^2 prec`` directly, in
ascending d (the Pallas kernel's expanded ``x^2 prec - 2 x mu prec +
const`` form cancels badly in float32), so they differ only in the order
of the logsumexp over K: they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .random import NEG_INF, logsumexp

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_PI = math.log(math.pi)
_MAX_D = 512  # the kernels keep [16, D] candidate rows in shared memory
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
    lengths (rows past it come back -inf).
    """
    return fixedvar_scores(Xc, prior_c, mu_predT, prec_predT,
                           torch.log(prec_predT).sum(-2), wvec, counts,
                           valid_m)


def fixedvar_scores(Xc, prior_c, muT, precT, log_prod, wvec, counts,
                    valid_m=None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor
    (``log_prod`` [B, K] = sum_d log precT)."""
    if cuda_lib.use_kernel(Xc):
        return _launch(Xc, prior_c, muT, precT, log_prod, wvec, counts,
                       valid_m)
    return fixedvar_scores_plain(Xc, prior_c, muT, precT, log_prod, wvec,
                                 counts, valid_m)


def fixedvar_scores_plain(Xc, prior_c, muT, precT, log_prod, wvec, counts,
                          valid_m=None):
    """Plain PyTorch version of K1: the [B, M, K] Mahalanobis table summed
    over d in ascending order, then select and -inf-safe logsumexp."""
    B, M, D = Xc.shape
    maha = torch.zeros((B, M, muT.shape[-1]), dtype=Xc.dtype,
                       device=Xc.device)
    for d in range(D):
        dl = Xc[:, :, d, None] - muT[:, None, d, :]
        maha = maha + dl * dl * precT[:, None, d, :]
    post = -0.5 * D * _LOG_2PI + 0.5 * log_prod[:, None, :] - 0.5 * maha
    logits = wvec[:, None, :] + torch.where(
        (counts > 0)[:, None, :], post, prior_c[..., None])
    out = logsumexp(logits, dim=-1)
    if valid_m is not None:
        live = torch.arange(M, device=Xc.device)[None, :] < valid_m[:, None]
        out = torch.where(live, out, NEG_INF)
    return out


def _launch(Xc, prior_c, muT, precT, log_prod, wvec, counts, valid_m):
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
    req(log_prod, "log_prod", f32, (B, K), dev)
    req(wvec, "wvec", f32, (B, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    if valid_m is not None:
        req(valid_m, "valid_m", torch.int32, (B,), dev)
    out = torch.empty((B, M), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fixedvar_scores_launch(
        p(Xc), p(prior_c), p(muT), p(precT), p(log_prod), p(wvec),
        p(counts), p(valid_m), p(out), B, M, D, K, -0.5 * D * _LOG_2PI,
        cuda_lib.stream_of(Xc))
    cuda_lib.check(err, "fixedvar_scores")
    launches += 1
    return out


# ------------------------------------------------------------------- K5

def diag_log_margs_T(Xc, prior_c, muT, inv_varT, log_prod_var, v, wvec,
                     counts, valid_m=None, exact: bool = False):
    """[B, M] collapsed candidate log marginals under the diag
    (product-of-Student-t) predictive.

    muT / inv_varT [B, D, K], log_prod_var / v [B, K] from
    ``components_diag.predictive_params_T``; the rest as
    :func:`fixedvar_log_margs_T`.  The count-dependent constants are formed
    here, outside the kernel, with the exact ``lgamma``
    (``pallas_score.py:293-299``).  ``exact`` sums ``log1p`` per dimension
    (the deterministic Viterbi path); otherwise the TPU kernel's grouped
    composition (logs of contiguous 4-dim products) is used.
    """
    return diag_scores(Xc, prior_c, muT.contiguous(),
                       *diag_score_tables(inv_varT, log_prod_var, v,
                                          Xc.shape[-1]),
                       wvec, counts, valid_m, exact)


def diag_score_tables(inv_varT, log_prod_var, v, D: int):
    """K5's own tables from the predictive parameters: ``ivvT`` = inv_var /
    v [B, D, K], and the count-dependent constants ``const`` = D (lgamma((v
    + 1)/2) - lgamma(v/2) - log(v)/2 - log(pi)/2) - log_prod_var / 2 and
    ``vh`` = (v + 1)/2 [B, K] (``pallas_score.py:293-299``)."""
    const = (D * (torch.lgamma((v + 1.0) / 2.0) - torch.lgamma(v / 2.0)
                  - 0.5 * torch.log(v) - 0.5 * _LOG_PI)
             - 0.5 * log_prod_var)
    return ((inv_varT / v[:, None, :]).contiguous(), const,
            (v + 1.0) / 2.0)


def diag_scores(Xc, prior_c, muT, ivvT, const, vh, wvec, counts,
                valid_m=None, exact: bool = False):
    """Kernel on a CUDA tensor, plain version on a CPU tensor (``ivvT``
    [B, D, K] = inv_var / v; ``const`` / ``vh`` [B, K] the Student-t
    constants)."""
    if cuda_lib.use_kernel(Xc):
        return _launch_diag(Xc, prior_c, muT, ivvT, const, vh, wvec, counts,
                            valid_m, exact)
    return diag_scores_plain(Xc, prior_c, muT, ivvT, const, vh, wvec,
                             counts, valid_m, exact)


def diag_scores_plain(Xc, prior_c, muT, ivvT, const, vh, wvec, counts,
                      valid_m=None, exact: bool = False):
    """Plain PyTorch version of K5 in either composition: the [B, M, K]
    accumulator built over d in ascending order, then select and -inf-safe
    logsumexp."""
    B, M, D = Xc.shape
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
    logits = wvec[:, None, :] + torch.where(
        (counts > 0)[:, None, :], post, prior_c[..., None])
    out = logsumexp(logits, dim=-1)
    if valid_m is not None:
        live = torch.arange(M, device=Xc.device)[None, :] < valid_m[:, None]
        out = torch.where(live, out, NEG_INF)
    return out


def _launch_diag(Xc, prior_c, muT, ivvT, const, vh, wvec, counts, valid_m,
                 exact):
    global diag_launches, diag_exact_launches
    B, M, D = Xc.shape
    K = ivvT.shape[-1]
    if D > _MAX_D:
        raise ValueError("diag_scores kernel supports D <= %d" % _MAX_D)
    dev, f32 = Xc.device, torch.float32
    req = cuda_lib.require
    req(Xc, "Xc", f32, (B, M, D), dev)
    req(prior_c, "prior_c", f32, (B, M), dev)
    req(muT, "muT", f32, (B, D, K), dev)
    req(ivvT, "ivvT", f32, (B, D, K), dev)
    req(const, "const", f32, (B, K), dev)
    req(vh, "vh", f32, (B, K), dev)
    req(wvec, "wvec", f32, (B, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    if valid_m is not None:
        req(valid_m, "valid_m", torch.int32, (B,), dev)
    out = torch.empty((B, M), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().diag_scores_launch(
        p(Xc), p(prior_c), p(muT), p(ivvT), p(const), p(vh), p(wvec),
        p(counts), p(valid_m), p(out), B, M, D, K, int(exact),
        cuda_lib.stream_of(Xc))
    cuda_lib.check(err, "diag_scores")
    if exact:
        diag_exact_launches += 1
    else:
        diag_launches += 1
    return out
