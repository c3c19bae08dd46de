"""Segmentation DP: kernel K2 (``csrc/forward_dp.cu``), the whole DP in one
launch, and the forward filter's plain version.

Counterpart of ``segmentalist_tpu/ops/pallas_dp.py`` (``forward_alphas``)
and, for the fused entry, of ``segmentalist_tpu/ops/dp.py::segment_dp``.

    alpha[t] = logsumexp_j( rev[t-1, j] + alpha[t - W + j] ) + lpc

(max and no ``lpc`` for Viterbi), rows at ``t >= length`` are -inf.  The
kernel and the plain version below sum each window in the same ascending
order.  :func:`segment_dp` runs the forward filter, the backward draws and
the chain walk of ``ops/dp.py`` in one launch; its plain version is
``dp.segment_dp_plain``.  It launches by a pure-Python plan
(:func:`launch_plan`): a warp an utterance, the rows staged on chip where
they fit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_lib
from .random import NEG_INF

launches = 0  # K2 launches (segment_dp) since the last reset

MAX_WARPS = 4  # utterances (a warp each) a CTA, csrc/forward_dp.cu kMaxWarps
SERIAL_W = 8   # the widest window run on every lane, kSerialW


class DpPlan(NamedTuple):
    form: str   # "smem": rows staged on chip; "global": read in place
    warps: int  # utterances a CTA
    smem: int   # dynamic shared memory a CTA, bytes


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(N: int, W: int, staged: bool, noise: bool) -> int:
    """A warp's shared memory, as the kernel reserves it
    (``csrc/forward_dp.cu::layout``): the score and noise rows [N W] when
    staged (the noise only where the kernel draws), the padded rows
    [N SERIAL_W] of a window up to SERIAL_W, the alpha row [W + N], the
    window's exps [W], and the pointers, picked scores, node flags and
    walk stack [N + 1]; each array rounded up to 4 words."""
    rows = _round4(N * W) * ((1 + bool(noise)) if staged else 0)
    padded = N * SERIAL_W if W <= SERIAL_W else 0
    return 4 * (rows + padded + _round4(W + N) + _round4(W)
                + 4 * _round4(N + 1))


def launch_plan(N: int, W: int, noise: bool, smem_limit: int) -> DpPlan:
    """The form and the warps a CTA for N nodes and a window of W (pure
    Python): "smem" where one warp's staged rows fit ``smem_limit`` bytes,
    else "global"; up to ``MAX_WARPS`` warps a CTA.  Raises where not even
    the global form's per-node arrays fit, or for an empty shape."""
    if N < 1 or W < 1:
        raise ValueError("the DP takes N >= 1 and W >= 1, got N=%d, W=%d"
                         % (N, W))
    for form in ("smem", "global"):
        per_warp = smem_bytes(N, W, form == "smem", noise)
        warps = min(MAX_WARPS, smem_limit // per_warp)
        if warps >= 1:
            return DpPlan(form, warps, warps * per_warp)
    raise ValueError("no DP form fits N=%d, W=%d in %d bytes"
                     % (N, W, smem_limit))


def card_plan(N: int, W: int, noise: bool) -> DpPlan:
    """:func:`launch_plan` under the current card's opt-in limit."""
    return launch_plan(N, W, noise, _smem_limit(torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _smem_limit(device: int) -> int:
    """The kernel's shared-memory limit on ``device``, asked once."""
    limit = cuda_lib.library().segment_dp_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "segment_dp_smem_limit")
    return limit


def forward_alphas_plain(rev_scores, lengths, log_p_continue,
                         use_max: bool = False):
    """Plain PyTorch version of K2's forward filter: a loop over t, the
    window summed in ascending j."""
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


def _lpc_tensor(log_p_continue, dev):
    if torch.is_tensor(log_p_continue):
        lpc = log_p_continue.reshape(1)
    else:  # a fill kernel, not a host-to-device copy
        lpc = torch.full((1,), float(log_p_continue), dtype=torch.float32,
                         device=dev)
    cuda_lib.require(lpc, "log_p_continue", torch.float32, (1,), dev)
    return lpc


def segment_dp(scores, lengths, log_p_continue, anneal_temp, n_slices_min,
               use_max: bool, noise, with_alphas: bool = False):
    """The whole segmentation DP in one launch of K2 (CUDA tensors only).

    scores [B, N, W] float32 as ``ops/dp.py::segment_dp`` takes them (the
    kernel reverses and masks them); lengths [B] int32; log_p_continue a
    scalar; noise [B, N, W] standard Gumbel noise (sample mode; None for
    Viterbi, which draws nothing).  Returns (log_prob [B], boundaries
    [B, N] bool), and alphas_pad [B, W + N] third with ``with_alphas``.
    The plain version is ``dp.segment_dp_plain``."""
    global launches
    B, N, W = scores.shape
    dev, f32 = scores.device, torch.float32
    if not scores.is_cuda:
        raise ValueError("the fused DP kernel takes CUDA tensors, got %s"
                         % dev)
    cuda_lib.require(scores, "scores", f32, (B, N, W), dev)
    cuda_lib.require(lengths, "lengths", torch.int32, (B,), dev)
    if use_max:
        noise = None
    elif noise is None:
        raise ValueError("sample mode needs the backward draws' noise")
    else:
        cuda_lib.require(noise, "noise", f32, (B, N, W), dev)
    lpc = _lpc_tensor(log_p_continue, dev)
    plan = card_plan(N, W, noise is not None)
    log_prob = torch.empty((B,), dtype=f32, device=dev)
    bounds = torch.empty((B, N), dtype=torch.bool, device=dev)
    alphas = (torch.empty((B, W + N), dtype=f32, device=dev)
              if with_alphas else None)
    p = cuda_lib.ptr
    err = cuda_lib.library().segment_dp_launch(
        p(scores), p(noise), p(lengths), p(lpc), p(alphas), p(log_prob),
        p(bounds), B, N, W, max(int(n_slices_min), 0), int(use_max),
        float(anneal_temp), int(plan.form == "smem"), plan.warps,
        cuda_lib.stream_of(scores))
    cuda_lib.check(err, "segment_dp")
    launches += 1
    cuda_lib.count_form("K2", "%s %d warps" % (plan.form, plan.warps))
    if with_alphas:
        return log_prob, bounds, alphas
    return log_prob, bounds
