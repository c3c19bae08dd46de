"""Fused fixed-variance candidate scoring: kernel K1 and its plain version.

Counterpart of the fixed-variance part of
``segmentalist_tpu/ops/pallas_score.py`` (``fixedvar_log_margs_T`` and
``_fixedvar_dispatch``).  It computes

    log_margs[b, m] = logsumexp_k( w[b, k] + where(counts[b, k] > 0,
                          log_post_pred[b, m, k], prior_c[b, m]) )

without materialising the [B, M, K] logits on the card
(``csrc/fixedvar_score.cu``).  A CPU tensor takes the plain PyTorch
version, a CUDA tensor the kernel.

Both sum the Mahalanobis form ``sum_d (x - mu)^2 prec`` directly, in
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
_MAX_D = 512  # the kernel keeps [16, D] candidate rows in shared memory

launches = 0  # kernel launches since the last reset


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
