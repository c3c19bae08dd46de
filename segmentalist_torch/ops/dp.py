"""Forward-filtering backward-sampling / Viterbi segmentation DP.

Counterpart of ``segmentalist_tpu/ops/dp.py`` (reference module-level DP,
``unigram_acoustic_wordseg.py:653-864``).  On the card the whole DP is one
launch of kernel K2 (``ops/cuda_dp.py::segment_dp``): the forward filter,
then at every node the draw of its predecessor pointer and the walk of the
visited chain, all on chip.  On the CPU it is the kernel's plain version,
:func:`segment_dp_plain`: the forward filter (``forward_alphas_plain``),
then

* every prefix node ``v`` draws its predecessor pointer at once (one
  batched Gumbel-max over the window, on injected noise [B, N, W]), and
* the visited chain ``length -> p(length) -> ... -> 0`` is extracted by
  integer pointer doubling (``torch.gather``), exact on every device.

Semantics match the JAX package: the asymmetric ``n_slices_min`` window
cut, annealed backward draws, the backtracking fallback that
force-inserts a boundary where every continuation is -inf, and Viterbi
ties broken toward shorter segments.

Score layout: ``scores[b, t, w]`` scores the segment that ends at landmark
``t`` and covers ``w + 1`` slices; -inf marks invalid candidates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import cuda_dp, cuda_lib
from .random import NEG_INF, annealed_gumbel_max, gumbel


def _rev_mask_scores(scores: torch.Tensor, n_slices_min: int) -> torch.Tensor:
    """Reverse the window axis and apply the ``n_slices_min`` cut:
    ``rev[b, t, j] = scores[b, t, W - 1 - j]`` scores length ``W - j``."""
    W = scores.shape[-1]
    rev = scores.flip(-1)
    if n_slices_min > 1:
        lens = W - torch.arange(W, device=scores.device)
        rev = torch.where(lens >= n_slices_min, rev, NEG_INF)
    return rev.contiguous()


def _mark(targets: torch.Tensor, on: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] mask of the values ``targets[b, z]`` over the entries where
    ``on[b, z]``: an integer scatter of one constant, exact and
    order-free."""
    B = targets.shape[0]
    idx = torch.where(on, targets, n)
    hit = torch.zeros((B, n + 1), dtype=torch.bool, device=targets.device)
    return hit.scatter_(1, idx, True)[:, :n]


def _visited_closure(p: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, N + 1] mask of the nodes on ``length -> p(length) -> ... -> 0``.

    Pointer doubling: after round i the mask holds the chain's first 2^i
    nodes and ``jump = p^(2^i)``; ``p`` strictly decreases for v >= 1 with
    p(0) = 0, so ceil(log2(N + 1)) rounds cover the chain."""
    B, N1 = p.shape
    m = torch.arange(N1, device=p.device)[None, :] == lengths[:, None]
    jump = p
    for _ in range(max(1, math.ceil(math.log2(N1)))):
        m = m | _mark(jump, m, N1)
        jump = jump.gather(1, jump)
    return m


def segment_dp(scores: torch.Tensor, lengths: torch.Tensor,
               log_p_continue=0.0, anneal_temp=1.0, n_slices_min: int = 0,
               n_slices_max: int = 0, mode: str = "sample",
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched segmentation DP.

    scores [B, N_max, W] candidate scores (W = ``n_slices_max``, or N_max
    when 0); lengths [B] int32 (0 allowed).  ``mode`` is "sample" (FFBS) or
    "viterbi".  ``noise`` is the standard Gumbel noise [B, N_max, W] of the
    backward draws -- what the JAX package draws at ``dp.py:196``; when
    None it is drawn from ``generator``.  A CUDA tensor takes kernel K2 (one
    launch), a CPU tensor :func:`segment_dp_plain`.

    Returns (log_prob [B], boundaries [B, N_max] bool).
    """
    if mode not in ("sample", "viterbi"):
        raise ValueError(mode)
    B, N, W = scores.shape
    use_max = mode == "viterbi"
    lengths = lengths.to(torch.int32)
    if not use_max and noise is None:
        noise = gumbel((B, N, W), generator, scores.device, scores.dtype)
    if cuda_lib.use_kernel(scores):
        return cuda_dp.segment_dp(scores.contiguous(), lengths,
                                  log_p_continue, anneal_temp, n_slices_min,
                                  use_max, noise)
    return segment_dp_plain(scores, lengths, log_p_continue, anneal_temp,
                            n_slices_min, use_max, noise)


def segment_dp_plain(scores: torch.Tensor, lengths: torch.Tensor,
                     log_p_continue, anneal_temp, n_slices_min: int,
                     use_max: bool, noise: Optional[torch.Tensor],
                     with_alphas: bool = False):
    """Plain PyTorch version of the fused K2 (``cuda_dp.segment_dp``), on
    any device: reverse and mask the scores, the forward filter
    (``forward_alphas_plain``), then :func:`backward_sample`.  Returns
    (log_prob [B], boundaries [B, N]), and alphas_pad [B, W + N] third with
    ``with_alphas``."""
    rev = _rev_mask_scores(scores, max(int(n_slices_min), 0))
    alphas_pad = cuda_dp.forward_alphas_plain(rev, lengths, log_p_continue,
                                              use_max)
    out = backward_sample(rev, alphas_pad, lengths, anneal_temp, use_max,
                          noise)
    return (*out, alphas_pad) if with_alphas else out


def backward_sample(rev: torch.Tensor, alphas_pad: torch.Tensor,
                    lengths: torch.Tensor, anneal_temp=1.0,
                    use_max: bool = False,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass of :func:`segment_dp` given the forward table
    ``alphas_pad`` [B, W + N]: per-node draws (Gumbel-max on ``noise``, or
    argmax for ``use_max``), then chain extraction.  Returns (log_prob [B],
    boundaries [B, N])."""
    B, N, W = rev.shape
    dev = rev.device
    # window_alphas[b, v - 1, j] = alphas_pad[b, v + j]
    window_alphas = alphas_pad.unfold(1, W, 1)[:, 1:N + 1]
    node_logits = rev + window_alphas
    samplable = torch.isfinite(node_logits).any(-1)
    if use_max:  # ties toward shorter segments: argmax over ascending w
        pick = W - 1 - torch.argmax(node_logits.flip(-1), dim=-1)
    else:
        pick = annealed_gumbel_max(node_logits, noise, anneal_temp)
    contrib = rev.gather(-1, pick[..., None])[..., 0]

    v_idx = torch.arange(1, N + 1, device=dev)[None, :]
    p_nodes = torch.where(samplable, v_idx - (W - pick), v_idx - 1)
    p = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                   p_nodes.long()], dim=1)  # [B, N + 1]

    lengths_l = lengths.long()
    visited = _visited_closure(p, lengths_l)
    samp0 = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                       samplable], dim=1)
    seg_start = _mark(p, visited & samp0, N + 1)
    is_end = torch.arange(N + 1, device=dev)[None, :] == lengths_l[:, None]
    bounded = visited & (samp0 | is_end | seg_start)
    log_prob = torch.where(visited[:, 1:] & samplable, contrib, 0.0).sum(-1)
    return log_prob, bounded[:, 1:]
