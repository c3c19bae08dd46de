"""Sufficient statistics as tensor reductions (counterpart of
``segmentalist_tpu/ops/stats.py``).

    counts [K]     int32 -- items assigned to each slot
    sum_x  [K, D]        -- sum of the member vectors
    sum_sq [K, D]        -- per-dimension sum of squares (fixed / diag), or
           [K, D, D]        sum of outer products (full covariance)

Statistics are built with one-hot matrix products, never with float
``index_add_``/``scatter_add_``: CUDA atomics add in a run-dependent order,
and these sums feed argmax-sensitive leave-out scores.  Full second moments
are contracted in the symmetric-packed layout of :func:`sym_pack` and
unpacked by a mirror copy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class SuffStats(NamedTuple):
    counts: torch.Tensor  # [K] int32
    sum_x: torch.Tensor   # [K, D]
    sum_sq: torch.Tensor  # [K, D] or [K, D, D]


class SymPack(NamedTuple):
    """Index maps between a symmetric [D, D] matrix and its packed
    D(D+1)/2 upper triangle (row-major, ``np.triu_indices`` order), and the
    lanes of a packed lower-triangular factor (row-major,
    ``np.tril_indices`` order)."""

    iu0: torch.Tensor     # [F] long, row of each packed lane
    iu1: torch.Tensor     # [F] long, column of each packed lane (>= row)
    unpack: torch.Tensor  # [D*D] long, packed lane of each (d, e), mirrored
    dbl: torch.Tensor     # [F] float64, 1 on the diagonal, 2 off it
    il0: torch.Tensor     # [F] long, row of each lower-triangular lane
    il1: torch.Tensor     # [F] long, its column (<= row)


@functools.lru_cache(maxsize=None)
def sym_pack(D: int, device) -> SymPack:
    """The symmetric-packed layout of [D, D] second moments and quadratic
    forms, built once per (D, device) (the JAX package's
    ``segmenters.common.sym_pack_indices``): every full-covariance table
    (flat and leave-out statistics, scorer tables, the component scorer)
    takes its lanes from here.  Second-moment sums contract identical
    commuted products in one order, so their triangles are bitwise equal
    and packing loses nothing; a quadratic form ``x^T A x`` of a symmetric
    A is ``(x_iu0 x_iu1) . (A_packed * dbl)``.  The scorer's whitening
    factors are lower triangular and take the ``il0, il1`` lanes."""
    iu0, iu1 = torch.triu_indices(D, D)
    lane = torch.arange(iu0.numel())
    unpack = torch.zeros((D, D), dtype=torch.long)
    unpack[iu0, iu1] = lane
    unpack[iu1, iu0] = lane
    dbl = torch.where(iu0 == iu1, 1.0, 2.0).to(torch.float64)
    il0, il1 = torch.tril_indices(D, D)
    return SymPack(*(t.to(device) for t in (
        iu0, iu1, unpack.reshape(-1), dbl, il0, il1)))


def packed_outer(x: torch.Tensor) -> torch.Tensor:
    """[..., D(D+1)/2] packed outer products ``x_d x_e`` (e >= d)."""
    pk = sym_pack(x.shape[-1], x.device)
    return x[..., pk.iu0] * x[..., pk.iu1]


def unpack_sym(packed: torch.Tensor, D: int) -> torch.Tensor:
    """[..., D, D] symmetric matrices from their packed [..., F] lanes (a
    pure copy)."""
    pk = sym_pack(D, packed.device)
    return packed[..., pk.unpack].reshape(packed.shape[:-1] + (D, D))


def item_sq(x: torch.Tensor, full_cov: bool = False) -> torch.Tensor:
    """Per-item second-moment contribution: x**2 (fixed / diag) or the outer
    product x x^T (full)."""
    if full_cov:
        return x[..., :, None] * x[..., None, :]
    return x * x


def moment_sums(oh_T: torch.Tensor, x: torch.Tensor,
                full_cov: bool) -> torch.Tensor:
    """``sum_sq`` of one-hot sums ``oh_T @ item_sq(x)`` ([K, N] @ [N, ...]),
    full second moments through the packed lanes."""
    if full_cov:
        return unpack_sym(oh_T @ packed_outer(x), x.shape[-1])
    return oh_T @ item_sq(x)


def one_hot_rows(labels: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """[..., K] one-hot rows of ``labels``; labels outside ``[0, K)`` (the
    ``-1`` "unassigned" convention) give all-zero rows."""
    return (labels[..., None] == torch.arange(K, device=labels.device)
            ).to(dtype)


def suff_stats_from_assignments(X: torch.Tensor, assignments: torch.Tensor,
                                K_max: int, full_cov: bool = False
                                ) -> SuffStats:
    """All component statistics from the assignment vector at once
    (unassigned items are ``-1`` and contribute nothing)."""
    oh = one_hot_rows(assignments, K_max, X.dtype)  # [N, K]
    return SuffStats(
        counts=oh.sum(0).to(torch.int32),
        sum_x=oh.T @ X,
        sum_sq=moment_sums(oh.T, X, full_cov),
    )


def empty_suff_stats(K_max: int, D: int, dtype=torch.float32,
                     device=None, full_cov: bool = False) -> SuffStats:
    sq_shape = (K_max, D, D) if full_cov else (K_max, D)
    return SuffStats(
        counts=torch.zeros(K_max, dtype=torch.int32, device=device),
        sum_x=torch.zeros(K_max, D, dtype=dtype, device=device),
        sum_sq=torch.zeros(sq_shape, dtype=dtype, device=device),
    )


def add_item(stats: SuffStats, x: torch.Tensor, k, full_cov: bool = False,
             weight=1) -> SuffStats:
    """New statistics with data vector ``x`` [D] added to slot ``k``;
    ``weight`` 0 makes it a no-op, -1 a removal (the reference's
    ``del_item``).  One addend per element, so the result is exact."""
    k = torch.as_tensor(k, device=x.device).long()
    w = torch.as_tensor(weight, device=x.device)
    counts, sum_x, sum_sq = (t.clone() for t in stats)
    counts[k] += w.to(counts.dtype)
    sum_x[k] += w.to(x.dtype) * x
    sum_sq[k] += w.to(x.dtype) * item_sq(x, full_cov)
    return SuffStats(counts, sum_x, sum_sq)


def del_item(stats: SuffStats, x: torch.Tensor, k, full_cov: bool = False,
             weight=1) -> SuffStats:
    return add_item(stats, x, k, full_cov, weight=-torch.as_tensor(weight))


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


def decollide_new_items(counts: torch.Tensor,
                        k_new: torch.Tensor) -> torch.Tensor:
    """Give every item that drew an EMPTY slot its own empty slot, by rank
    in item order onto the empty slots in index order (the JAX package's
    ``ops.stats.decollide_new_items``).  A blocked per-item sweep draws all
    items against frozen counts, and the first-empty birth rule would fuse
    every simultaneous new-component draw into one component; empty slots
    are exchangeable (equal weight alpha/K), so the relabelling leaves each
    item's conditional as it was.  Creators beyond the empty slots keep
    their drawn slot (saturation).  ``counts`` [K], ``k_new`` [N]."""
    K = counts.shape[0]
    lane = torch.arange(K, device=counts.device)
    empty = counts <= 0
    is_new = empty[k_new.long()]
    new_i = is_new.to(torch.int64)
    rank = torch.cumsum(new_i, 0) - new_i
    empty_order = torch.argsort(torch.where(empty, lane, K), stable=True)
    tgt = empty_order[rank.clamp_max(K - 1)]
    return torch.where(is_new & (rank < empty.sum()), tgt.to(k_new.dtype),
                       k_new)
