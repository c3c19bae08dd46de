"""Segmentation-DP forward filter: kernel K2 and its plain version.

Counterpart of ``segmentalist_tpu/ops/pallas_dp.py`` (``forward_alphas``).

    alpha[t] = logsumexp_j( rev[t-1, j] + alpha[t - W + j] ) + lpc

(max and no ``lpc`` for Viterbi), rows at ``t >= length`` are -inf.  The
kernel (``csrc/forward_dp.cu``) and the plain version below sum each window
in the same ascending order.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .random import NEG_INF

launches = 0  # kernel launches since the last reset


def forward_alphas(rev_scores, lengths, log_p_continue, use_max: bool = False):
    """Batched forward filter.

    rev_scores [B, N, W] reversed, ``n_slices_min``-masked scores
    (``dp._rev_mask_scores``); lengths [B] int32; log_p_continue a scalar
    (float or 0-d/1-element tensor; ignored for ``use_max``).
    Returns alphas_pad [B, W + N] with ``alphas_pad[:, W + t] = log alpha_t``.
    """
    if cuda_lib.use_kernel(rev_scores):
        return _launch(rev_scores, lengths, log_p_continue, use_max)
    return forward_alphas_plain(rev_scores, lengths, log_p_continue, use_max)


def forward_alphas_plain(rev_scores, lengths, log_p_continue,
                         use_max: bool = False):
    """Plain PyTorch version of K2: a loop over t, the window summed in
    ascending j."""
    B, N, W = rev_scores.shape
    ap = torch.full((B, W + N), NEG_INF, dtype=rev_scores.dtype,
                    device=rev_scores.device)
    ap[:, W] = 0.0
    for t in range(1, N):
        logits = rev_scores[:, t - 1] + ap[:, t:t + W]
        m = logits.amax(-1)
        if use_max:
            val = m
        else:
            m_safe = torch.where(torch.isneginf(m), 0.0, m)
            s = torch.exp(logits[:, 0] - m_safe)
            for j in range(1, W):
                s = s + torch.exp(logits[:, j] - m_safe)
            val = torch.where(torch.isneginf(m), NEG_INF,
                              torch.log(s) + m_safe) + log_p_continue
        ap[:, W + t] = torch.where(t < lengths, val, NEG_INF)
    return ap


def _launch(rev_scores, lengths, log_p_continue, use_max):
    global launches
    B, N, W = rev_scores.shape
    dev, f32 = rev_scores.device, torch.float32
    cuda_lib.require(rev_scores, "rev_scores", f32, (B, N, W), dev)
    cuda_lib.require(lengths, "lengths", torch.int32, (B,), dev)
    if torch.is_tensor(log_p_continue):
        lpc = log_p_continue.reshape(1)
    else:  # a fill kernel, not a host-to-device copy
        lpc = torch.full((1,), float(log_p_continue), dtype=f32, device=dev)
    cuda_lib.require(lpc, "log_p_continue", f32, (1,), dev)
    out = torch.empty((B, W + N), dtype=f32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().forward_alphas_launch(
        p(rev_scores), p(lengths), p(lpc), p(out), B, N, W, int(use_max),
        cuda_lib.stream_of(rev_scores))
    cuda_lib.check(err, "forward_alphas")
    launches += 1
    return out
