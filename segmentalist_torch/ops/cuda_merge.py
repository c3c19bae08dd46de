"""The merge of a block's statistics into the global ones: the merge kernel
(``csrc/merge_stats.cu``) and its plain version.

Counterpart of ``segmentalist_tpu/segmenters/common.py`` ``flat_contrib``
twice (the block's old and new segments) and ``merge_flat``: for every
component k that a member of either side belongs to (an item (b, s) with
``embeds >= 0``, ``0 <= ks < K`` and ``valid[b]``)

    counts[k] += n_cnt - o_cnt
    sum_x[k]   = sum_x[k]  + (n - o)
    sum_sq[k]  = sum_sq[k] + (n2 - o2)

where each side's members are summed in increasing flat item order
``b S + s``, from 0, each square or outer-product lane rounded before it
is added: the order of the one-hot product ``one_hot(ks).T @ x``'s
non-zero terms, with no one-hot matrix and no float atomics (cuBLAS sums
that product in another order, so the two agree to rounding).  ``sum_sq`` [K, D] (fixed, diag)
takes D lanes of squares, [K, D, D] (full) the packed upper-triangle
lanes of ``sym_pack``, each position added to its own old value.  Rows of
untouched components are left as they are.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .stats import SuffStats, packed_outer, unpack_sym

launches = 0  # merge kernel launches since the last reset


def _keys(embeds, ks, valid, K):
    """[B S] long component of each item, -1 where it is no member."""
    ok = (embeds >= 0) & (ks >= 0) & (ks < K) & valid[:, None]
    return torch.where(ok, ks, -1).reshape(-1).long()


def merge_stats_plain(stats: SuffStats, valid: torch.Tensor, old: tuple,
                      new: tuple) -> SuffStats:
    """Plain PyTorch version of the merge kernel (any device and float
    dtype): ``old`` and ``new`` are (rows [B, S, D], embeds [B, S], ks
    [B, S]).  Members are stably sorted by component, then added rank by
    rank (one member of each component a step), so every component's sum
    runs in item order.  Returns new tensors."""
    counts, sum_x, sum_sq = stats
    K, D = sum_x.shape
    full = sum_sq.dim() == 3
    keys = [_keys(e, k, valid, K) for _, e, k in (old, new)]
    hist = [torch.bincount(k[k >= 0], minlength=K) for k in keys]
    touched = torch.nonzero((hist[0] + hist[1]) > 0).reshape(-1)
    slot = torch.full((K,), -1, dtype=torch.long, device=counts.device)
    slot[touched] = torch.arange(touched.numel(), device=counts.device)
    n_lanes = D + (D * (D + 1) // 2 if full else D)
    acc = []
    for (rows, _, _), key, h in zip((old, new), keys, hist):
        items = torch.nonzero(key >= 0).reshape(-1)
        comp, order = torch.sort(key[items], stable=True)
        items = items[order]
        first = torch.cumsum(h, 0) - h
        rank = torch.arange(items.numel(), device=items.device) - first[comp]
        x = rows.reshape(-1, D)[items]
        lanes = torch.cat([x, packed_outer(x) if full else x * x], dim=1)
        a = torch.zeros((touched.numel(), n_lanes), dtype=sum_x.dtype,
                        device=sum_x.device)
        for r in range(int(h.max()) if h.numel() else 0):
            at = rank == r
            s = slot[comp[at]]
            a[s] = a[s] + lanes[at]
        acc.append(a)
    delta = acc[1] - acc[0]
    out_x, out_sq = sum_x.clone(), sum_sq.clone()
    out_x[touched] = sum_x[touched] + delta[:, :D]
    sq = unpack_sym(delta[:, D:], D) if full else delta[:, D:]
    out_sq[touched] = sum_sq[touched] + sq
    return SuffStats(counts + (hist[1] - hist[0]).to(counts.dtype), out_x,
                     out_sq)


def merge_stats(stats: SuffStats, valid: torch.Tensor, old: tuple,
                new: tuple, in_place: bool = False) -> SuffStats:
    """The block's merge (see the module): ``old`` and ``new`` are (rows
    [B, S, D] float32, embeds [B, S] int32, ks [B, S] int32), ``valid``
    [B] bool.  On a CUDA tensor one launch of the merge kernel, into
    ``stats``'s own tensors with ``in_place`` (a graph's capture), else
    into a copy of them; on a CPU tensor :func:`merge_stats_plain`."""
    global launches
    if not cuda_lib.use_kernel(stats.sum_x):
        out = merge_stats_plain(stats, valid, old, new)
        if not in_place:
            return out
        for t, o in zip(stats, out):
            t.copy_(o)
        return stats
    counts, sum_x, sum_sq = stats
    K, D = sum_x.shape
    B, S = old[1].shape
    dev, req = sum_x.device, cuda_lib.require
    full = sum_sq.dim() == 3
    req(counts, "counts", torch.int32, (K,), dev)
    req(sum_x, "sum_x", torch.float32, (K, D), dev)
    req(sum_sq, "sum_sq", torch.float32, (K, D, D) if full else (K, D), dev)
    req(valid, "valid", torch.bool, (B,), dev)
    for side, (rows, embeds, ks) in (("old", old), ("new", new)):
        req(rows, side + " rows", torch.float32, (B, S, D), dev)
        req(embeds, side + " embeds", torch.int32, (B, S), dev)
        req(ks, side + " ks", torch.int32, (B, S), dev)
    if not in_place:
        counts, sum_x, sum_sq = (t.clone() for t in stats)
    keys = torch.empty((2, (B * S + 3) // 4 * 4), dtype=torch.int32,
                       device=dev)
    hist = torch.empty((2, K), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().merge_stats_launch(
        p(old[1]), p(old[2]), p(old[0]), p(new[1]), p(new[2]), p(new[0]),
        p(valid), B, S, D, K, int(full), p(keys), p(hist), p(counts),
        p(sum_x), p(sum_sq), cuda_lib.stream_of(sum_x))
    cuda_lib.check(err, "merge_stats")
    launches += 1
    return SuffStats(counts, sum_x, sum_sq)
