"""Shared machinery of the blocked-Gibbs segmentation sweeps (every
covariance family).

Counterpart of ``segmentalist_tpu/segmenters/common.py``.  A block of B
utterances is resampled against the block-start state:

  1. leave-one-utterance-out statistics for every utterance of the block;
  2. one fused scoring kernel for all their candidate segments;
  3. the batched segmentation DP;
  4. per-utterance sequential assignment chains;
  5. decollision of new components, then the merge
     ``global += new - old``.

The JAX package pulled rows and ids with one-hot matrix products because
element gathers are slow on a TPU; here rows come from direct gathers
(``X[embeds]``), which copy exactly the same values.  The statistic sums
keep one-hot matrix products: they fix one addition order, where float
scatter-add atomics would add in a run-dependent order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.random import NEG_INF
from ..ops.stats import SuffStats, item_sq, moment_sums, one_hot_rows


class Segments(NamedTuple):
    """Compacted per-utterance segment lists: ``ends`` [B, S] landmark of
    each segment's end (-1 pad), ``ws`` [B, S] length - 1, ``n`` [B]."""

    ends: torch.Tensor
    ws: torch.Tensor
    n: torch.Tensor


def segments_from_boundaries(boundaries: torch.Tensor,
                             lengths: torch.Tensor) -> Segments:
    """Decode boundary rows into ordered (end, length) pairs (reference
    ``get_segmented_landmark_indices``, ``utterances.py:206-216``): the
    (s+1)-th boundary sits at ``#{t : csum[t] <= s}``."""
    B, N_max = boundaries.shape
    dev = boundaries.device
    t_grid = torch.arange(N_max, device=dev)[None, :]
    is_b = boundaries & (t_grid < lengths[:, None])
    csum = torch.cumsum(is_b.to(torch.int32), dim=1)
    n = csum[:, -1]
    s_grid = torch.arange(N_max, device=dev)
    p = (csum[:, None, :] <= s_grid[None, :, None]).sum(2)
    ends = torch.where(s_grid[None, :] < n[:, None], p, -1)
    prev = torch.cat([torch.full((B, 1), -1, dtype=ends.dtype, device=dev),
                      ends[:, :-1]], dim=1)
    ws = torch.where(ends >= 0, ends - prev - 1, 0)
    return Segments(ends=ends, ws=ws, n=n)


def gather_segment_embeds(segs: Segments,
                          seg_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] embedding ids of the segments; -1 for pads and for spans
    longer than the stored window."""
    B, T, W = seg_ids.shape
    ends = segs.ends.clamp_min(0)
    ws = segs.ws.clamp(0, W - 1)
    ids = seg_ids.reshape(B, T * W).gather(1, ends * W + ws)
    valid = (segs.ends >= 0) & (segs.ws < W)
    return torch.where(valid, ids, -1).to(torch.int32)


def gather_block_segments(boundaries_blk, lengths_blk, seg_ids_blk):
    """Current segmentation of a block: (embed ids [B, S], segments)."""
    segs = segments_from_boundaries(boundaries_blk, lengths_blk)
    return gather_segment_embeds(segs, seg_ids_blk), segs


def counts_contrib(ks: torch.Tensor, valid_mask: torch.Tensor,
                   K_max: int) -> torch.Tensor:
    """[B, K] int32 per-utterance component counts of the segments with
    ``ks >= 0`` and ``valid_mask`` (an exact integer scatter)."""
    B = ks.shape[0]
    seg = torch.where((ks >= 0) & valid_mask, ks, K_max).long()
    out = torch.zeros((B, K_max + 1), dtype=torch.int32, device=ks.device)
    out.scatter_add_(1, seg, torch.ones_like(seg, dtype=torch.int32))
    return out[:, :K_max]


def leave_out_moments_T(stats: SuffStats, X: torch.Tensor,
                        embeds: torch.Tensor, ks: torch.Tensor, K_max: int,
                        rows: torch.Tensor | None = None,
                        with_sq: bool = False):
    """Leave-one-utterance-out ``sum_x`` in feature-major layout [B, D, K]:
    ``stats.sum_x.T - x^T @ one_hot(ks)`` per utterance, one batched matrix
    product (one fixed addition order).  With ``with_sq`` (the diag family)
    returns ``(sum_xT, sum_sqT)``, ``sum_sqT = stats.sum_sq.T - (x x)^T @
    one_hot(ks)`` the same way."""
    valid = (embeds >= 0) & (ks >= 0)
    x = X[embeds.clamp_min(0).long()] if rows is None else rows
    x = torch.where(valid[..., None], x, 0.0)
    oh = one_hot_rows(torch.where(valid, ks, -1), K_max, x.dtype)  # [B, S, K]
    sum_xT = (stats.sum_x.T[None] - x.transpose(1, 2) @ oh).contiguous()
    if not with_sq:
        return sum_xT
    sum_sqT = stats.sum_sq.T[None] - item_sq(x).transpose(1, 2) @ oh
    return sum_xT, sum_sqT.contiguous()


def flat_contrib(X: torch.Tensor, embeds: torch.Tensor, ks: torch.Tensor,
                 K_max: int, valid: torch.Tensor,
                 rows: torch.Tensor | None = None,
                 full_cov: bool = False,
                 second_moments: bool = True) -> SuffStats:
    """Summed statistics of all (utterance, segment) pairs of a block, as
    one-hot matrix products [K, B*S] @ [B*S, D]; full second moments
    through the packed lanes, unpacked by the mirror map.  Without
    ``second_moments`` (k-means) ``sum_sq`` is None."""
    ok = (embeds >= 0) & (ks >= 0) & valid[:, None]
    D = X.shape[-1]
    x = X[embeds.clamp_min(0).long()] if rows is None else rows
    x = torch.where(ok[..., None], x, 0.0).reshape(-1, D)
    oh = one_hot_rows(torch.where(ok, ks, -1).reshape(-1), K_max, x.dtype)
    return SuffStats(
        counts=oh.sum(0).to(torch.int32),
        sum_x=oh.T @ x,
        sum_sq=moment_sums(oh.T, x, full_cov) if second_moments else None,
    )


def put_assignments(pad: torch.Tensor, valid: torch.Tensor,
                    old_embeds: torch.Tensor, new_embeds: torch.Tensor,
                    new_ks: torch.Tensor):
    """In ``pad``, an [N + 1] assignment vector whose last slot is a sink,
    clear a block's old segments and set its new ones (rows of padding
    write to the sink, so no host sync picks the live rows)."""
    N = pad.shape[0] - 1
    vm = valid[:, None]
    clear = torch.where(vm & (old_embeds >= 0), old_embeds,
                        N).reshape(-1).long()
    pad.index_put_((clear,), pad.new_full(clear.shape, -1))
    put = torch.where(vm & (new_embeds >= 0), new_embeds, N)
    pad.index_put_((put.reshape(-1).long(),),
                   new_ks.reshape(-1).to(pad.dtype))
    pad[N] = -1


def merge_flat(global_stats: SuffStats, old_flat: SuffStats,
               new_flat: SuffStats) -> SuffStats:
    """``global + (new - old)`` for every statistic, in that order (the
    JAX package's ``tree.map(n - o)`` then ``g + d``)."""
    return SuffStats(*(g + (n - o) for g, n, o in
                       zip(global_stats, new_flat, old_flat)))


def merge_sweep_assignments(assignments: torch.Tensor, updates,
                            all_reduce) -> torch.Tensor:
    """The per-shard sweep's assignment merge, once a sweep (the JAX
    package's ``merge_sweep_assignments`` / ``merge_assignments``,
    ``segmenters/common.py:347-471``): ``updates`` lists a rank's
    (valid [B], old_embeds, new_embeds, new_ks [B, S]) of every block of
    the sweep.  A mask / value pair over the ``[N]`` rows, summed over the
    ranks by ``all_reduce``, is exact: every embedding row belongs to one
    utterance, and a sweep visits each utterance once, on one rank.  Old
    segments clear to -1 first and new ones then overwrite them."""
    N = assignments.shape[0]
    valid, old_e, new_e, ks = (torch.cat(u) for u in zip(*updates))
    vm = valid[:, None]
    mask = torch.zeros((2, N + 1), dtype=torch.int32,
                       device=assignments.device)
    clear = torch.where(vm & (old_e >= 0), old_e, N).reshape(-1).long()
    mask[0, clear] = 1
    mask[1, clear] = -1
    put = torch.where(vm & (new_e >= 0), new_e, N).reshape(-1).long()
    mask[0, put] = 1
    mask[1].index_put_((put,), ks.reshape(-1).to(torch.int32))
    hit, val = all_reduce(mask[:, :N])
    return torch.where(hit > 0, val, assignments)


def decollide_new_components(new_ks: torch.Tensor, new_mask: torch.Tensor,
                             lo_counts: torch.Tensor, counts0: torch.Tensor,
                             comm=None) -> torch.Tensor:
    """Relabel cross-utterance collisions on newly created components onto
    fresh empty slots (the JAX package's round-5 merge-trap fix,
    ``segmentalist_tpu/segmenters/common.py:472``).

    Every chain of a block treats a slot with leave-out count 0 as "a new
    component", so independent new-component choices of different
    utterances can land on one slot and fuse at merge time.  Per slot at
    most one creator keeps it (none if some row joined the slot's old
    members); every other creator's group moves to its own fresh slot
    (empty at block start and untouched by the block), in slot-major,
    row-minor order.  Empty slots are exchangeable, so each utterance's
    conditional is unchanged.  When fresh slots run out the remaining
    groups stay merged.

    ``comm`` (a ``parallel.mesh.Shard``): the rows are one rank's of a
    block split over the mesh.  The ranks' int8 code matrices [B, K] (1 a
    touched slot, 2 a created one) are all-gathered in rank order, every
    rank computes the same remap of all rows, and keeps its own (the JAX
    package's ``axis_name`` form).  The creator ranks are a cumulative sum
    over rows, so the gathered rows must be in the block's own order: rank
    r holds the r-th B rows.
    """
    B, K = lo_counts.shape
    mask = new_mask & (new_ks >= 0)
    ks = new_ks.clamp_min(0).long()
    touch = (ks[..., None] == torch.arange(K, device=ks.device)) \
        & mask[..., None]                                    # [B, S, K]
    touched = touch.any(1)                                   # [B, K]
    creator = touched & (lo_counts == 0)
    row0 = 0
    if comm is not None:
        code = comm.all_gather(touched.to(torch.int8) + creator.to(torch.int8))
        code = code.reshape(-1, K)                           # [n B, K]
        touched, creator = code >= 1, code == 2
        row0 = comm.rank * B
    joiner_any = (touched & ~creator).any(0)                 # [K]
    c_int = creator.to(torch.int64)
    crank = torch.cumsum(c_int, 0) - c_int                   # creator rank
    keep = creator & (crank == 0) & ~joiner_any[None, :]
    need = creator & ~keep
    fresh = (counts0 == 0) & ~touched.any(0)                 # [K]
    need_cnt = need.to(torch.int64).sum(0)
    offs = torch.cumsum(need_cnt, 0) - need_cnt
    nrank = crank - keep.any(0).to(torch.int64)[None, :]
    need_idx = offs[None, :] + nrank                         # [B, K]
    lane = torch.arange(K, device=ks.device)
    fresh_order = torch.sort(torch.where(fresh, lane, K)).values
    need, need_idx = need[row0:row0 + B], need_idx[row0:row0 + B]
    need_bs = need.gather(1, ks) & mask
    idx_bs = need_idx.gather(1, ks)
    ok = need_bs & (idx_bs < fresh.sum())
    tgt = fresh_order[idx_bs.clamp(0, K - 1)]
    return torch.where(ok, tgt.to(new_ks.dtype), new_ks)


def masked_candidate_scores(log_margs: torch.Tensor, seg_ids_blk: torch.Tensor,
                            seg_durs_blk: torch.Tensor, time_power_term,
                            wip) -> torch.Tensor:
    """``log_marg * duration ** time_power_term + wip``, -inf for missing
    embeddings and masked (NaN) durations (reference
    ``get_vec_embed_log_probs``, ``unigram_acoustic_wordseg.py:474-511``)."""
    durs = seg_durs_blk.to(log_margs.dtype)
    scale = torch.where(torch.isnan(durs), 0.0, durs) ** time_power_term
    scores = log_margs * scale + wip
    invalid = (seg_ids_blk < 0) | torch.isnan(durs)
    return torch.where(invalid, NEG_INF, scores)


def dp_window(a: torch.Tensor, W_dp: int) -> torch.Tensor:
    """Clamp (or -1 / NaN pad) the last axis of a dense [.., N_max, W_store]
    corpus tensor to the DP window ``W_dp``."""
    W_store = a.shape[-1]
    if W_store >= W_dp:
        return a[..., :W_dp]
    fill = float("nan") if a.is_floating_point() else -1
    pad = a.new_full(a.shape[:-1] + (W_dp - W_store,), fill)
    return torch.cat([a, pad], dim=-1)


def cand_tables(seg_ids_dp: torch.Tensor, X: torch.Tensor,
                log_prior_vec: torch.Tensor | None = None):
    """Sweep-static candidate tensors ``X[seg_ids]`` [U, N_max * W_dp, D] and
    ``log_prior_vec[seg_ids]`` [U, N_max * W_dp] (None without
    ``log_prior_vec``) from the DP-windowed ``seg_ids_dp`` [U, N_max, W_dp],
    in the flat layout the scoring kernel reads (rows at ``seg_ids == -1``
    hold row 0; every consumer masks on the id sign)."""
    U, N_max, W_dp = seg_ids_dp.shape
    ids = seg_ids_dp.clamp_min(0).long()
    return (X[ids].reshape(U, N_max * W_dp, -1),
            None if log_prior_vec is None
            else log_prior_vec[ids].reshape(U, N_max * W_dp))


def pad_utterance_order(order, batch_size: int) -> np.ndarray:
    """Pad a [U] permutation to a multiple of ``batch_size`` with -1 and
    reshape it to [n_blocks, batch_size]."""
    order = np.asarray(order)
    U = order.shape[0]
    n_blocks = -(-U // batch_size)
    order = np.concatenate(
        [order, np.full((n_blocks * batch_size - U,), -1, order.dtype)])
    return order.reshape(n_blocks, batch_size)


def seed_assignments_to_vector(utterances, ids_to_utterance_labels,
                               seed_assignments_dict, assignments, am_K):
    """Map per-utterance seed labels onto the global assignment vector
    (reference ``unigram_acoustic_wordseg.py:176-204``): integer labels keep
    their value, other labels are numbered by first appearance.  Mutates
    ``assignments``; returns ``(seed_to_cluster, am_K)``."""
    seed_to_cluster = {}
    i_cluster = 0
    for i_utt, utt in enumerate(ids_to_utterance_labels):
        embeds = np.array(utterances.get_segmented_embeds_i(i_utt), dtype=int)
        labels = np.array(seed_assignments_dict[utt][:])[embeds != -1]
        embeds = embeds[embeds != -1]
        for s in labels:
            if s not in seed_to_cluster:
                if isinstance(s, (int, np.integer)):
                    seed_to_cluster[s] = int(s)
                else:
                    seed_to_cluster[s] = i_cluster
                    i_cluster += 1
        assignments[embeds] = [seed_to_cluster[s] for s in labels]
    if am_K is None:
        am_K = max(seed_to_cluster.values()) + 1
    elif am_K < max(seed_to_cluster.values()) + 1:
        raise ValueError("am_K is smaller than the number of seed clusters")
    return seed_to_cluster, am_K
