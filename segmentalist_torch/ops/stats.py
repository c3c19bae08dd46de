"""Sufficient statistics as tensor reductions (counterpart of
``segmentalist_tpu/ops/stats.py``).

    counts [K]     int32 -- items assigned to each slot
    sum_x  [K, D]        -- sum of the member vectors
    sum_sq [K, D]        -- per-dimension sum of squares (fixed / diag)

Statistics are built with one-hot matrix products, never with float
``index_add_``/``scatter_add_``: CUDA atomics add in a run-dependent order,
and these sums feed argmax-sensitive leave-out scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SuffStats(NamedTuple):
    counts: torch.Tensor  # [K] int32
    sum_x: torch.Tensor   # [K, D]
    sum_sq: torch.Tensor  # [K, D]


def item_sq(x: torch.Tensor) -> torch.Tensor:
    """Per-item second-moment contribution of the diagonal families: x**2."""
    return x * x


def one_hot_rows(labels: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """[..., K] one-hot rows of ``labels``; labels outside ``[0, K)`` (the
    ``-1`` "unassigned" convention) give all-zero rows."""
    return (labels[..., None] == torch.arange(K, device=labels.device)
            ).to(dtype)


def suff_stats_from_assignments(X: torch.Tensor, assignments: torch.Tensor,
                                K_max: int) -> SuffStats:
    """All component statistics from the assignment vector at once
    (unassigned items are ``-1`` and contribute nothing)."""
    oh = one_hot_rows(assignments, K_max, X.dtype)  # [N, K]
    return SuffStats(
        counts=oh.sum(0).to(torch.int32),
        sum_x=oh.T @ X,
        sum_sq=oh.T @ item_sq(X),
    )


def empty_suff_stats(K_max: int, D: int, dtype=torch.float32,
                     device=None) -> SuffStats:
    return SuffStats(
        counts=torch.zeros(K_max, dtype=torch.int32, device=device),
        sum_x=torch.zeros(K_max, D, dtype=dtype, device=device),
        sum_sq=torch.zeros(K_max, D, dtype=dtype, device=device),
    )


def add_item(stats: SuffStats, x: torch.Tensor, k, weight=1) -> SuffStats:
    """New statistics with data vector ``x`` [D] added to slot ``k``;
    ``weight`` 0 makes it a no-op, -1 a removal (the reference's
    ``del_item``).  One addend per element, so the result is exact."""
    k = torch.as_tensor(k, device=x.device).long()
    w = torch.as_tensor(weight, device=x.device)
    counts, sum_x, sum_sq = (t.clone() for t in stats)
    counts[k] += w.to(counts.dtype)
    sum_x[k] += w.to(x.dtype) * x
    sum_sq[k] += w.to(x.dtype) * item_sq(x)
    return SuffStats(counts, sum_x, sum_sq)


def del_item(stats: SuffStats, x: torch.Tensor, k, weight=1) -> SuffStats:
    return add_item(stats, x, k, weight=-torch.as_tensor(weight))


def num_active(stats: SuffStats) -> torch.Tensor:
    """Number of non-empty components -- the reference's dynamic ``K``."""
    return (stats.counts > 0).sum()


def first_empty_slot(counts: torch.Tensor) -> torch.Tensor:
    """Index of the lowest empty slot along the last axis, or ``K - 1`` when
    none is empty (the reference's clamp rule, ``fbgmm.py:391-393``)."""
    K = counts.shape[-1]
    lane = torch.arange(K, device=counts.device)
    return torch.where(counts <= 0, lane, K).amin(-1).clamp_max(K - 1)


def canonicalize_new_component(counts: torch.Tensor,
                               k: torch.Tensor) -> torch.Tensor:
    """Map a draw that landed on an empty slot to the first empty slot
    (``counts`` [..., K], ``k`` [...])."""
    at_k = counts.gather(-1, k[..., None].long())[..., 0]
    return torch.where(at_k > 0, k, first_empty_slot(counts).to(k.dtype))
