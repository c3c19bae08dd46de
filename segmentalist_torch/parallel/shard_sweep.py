"""The per-shard collective sweep for every driver (the JAX package's
``shard_map`` mode, ``segmentalist_tpu/parallel/shard_sweep.py``).

After ``mesh.shard_segmenter``, :func:`use_shard_map_sweep` switches a
segmenter to sweeps in which each rank owns U/n utterances, keeps only
their rows of the corpus tensors (``shard_map``'s ``P(axis)`` inputs: this
is the memory scale-out), and resamples them in blocks of B/n with the
single-device block step and its kernels on its own card.  The ranks meet
in a few collectives a block (``BlockedWordseg._merge``,
``SegmentalKMeansWordseg.block_step``):

* unigram: the flat statistic deltas [K(, D(, D))] and the block's log
  probability;
* bigram: the same and the LM count deltas ([K] and [K, K]);
* k-means: the count and sum deltas and the objective;
* all: decollision's all-gathered int8 code matrix [n, B/n, K], and one
  [N] assignment mask / value pair a sweep
  (``common.merge_sweep_assignments``).

A rank's blocks come from the global permutation (:func:`shard_blocks`);
every rank runs the same number of blocks, a rank whose utterances have
run out its -1 blocks with zero deltas, so that every rank calls every
collective.

Each rank draws its DP and chain noise from a generator of its own, the
counterpart of ``fold_in(key, axis_index)`` (``shard_sweep.py:104``):
seeded from ``numpy.random.SeedSequence((seed, rank))``, the segmenter's
seed and the rank.  On one rank it is the segmenter's own generator, so a
one-rank mesh samples what one device does.  The replicated generator is
left to what updates the replicated state on every rank (``am_n_iter``'s
sweeps of the acoustic model).

As in the JAX package, utterances of one block step condition on one
statistics snapshot whichever rank holds them: the chain differs from the
single-device one by block composition only.  Decollision is skipped where
B/n is 1, as the JAX package's ``decollide and B > 1`` does with the
per-shard B (``unigram.py:1020``, ``bigram.py:1236``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..segmenters.common import merge_sweep_assignments
from .mesh import rebuild_tables


def shard_blocks(order: np.ndarray, n_shards: int, u_local: int,
                 batch_local: int) -> np.ndarray:
    """Per-shard block layout [n_blocks, n_shards, B/n] of LOCAL utterance
    indices (-1 pads) from a global permutation (-1 pads dropped): each
    shard takes its own utterances in the permutation's order.  A stable
    sort by shard groups them, and one scatter places them (the JAX
    package's ``shard_blocks``, ``shard_sweep.py:47-69``)."""
    order = np.asarray(order, dtype=np.int64).reshape(-1)
    order = order[order >= 0]
    shard = order // u_local
    local = order % u_local
    sort = np.argsort(shard, kind="stable")
    shard, local = shard[sort], local[sort]
    first = np.r_[True, shard[1:] != shard[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(shard)), 0))
    rank = np.arange(len(shard)) - start  # position within its shard
    n_blocks = max(int(rank.max(initial=-1)) // batch_local + 1, 1)
    out = np.full((n_blocks, n_shards, batch_local), -1, dtype=np.int64)
    out[rank // batch_local, shard, rank % batch_local] = local
    return out


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The per-shard mode's noise generator of ``rank``: seeded with the
    first 64 bits of ``SeedSequence((seed, rank))``."""
    state = np.random.SeedSequence((int(seed), int(rank))).generate_state(
        2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 32) | int(state[1]))


def _prep(seg, mesh) -> int:
    """The mesh size, once ``shard_segmenter`` has put ``seg`` on it."""
    n = mesh.size()
    if getattr(seg, "_shard", None) is None or seg.batch_size % n:
        raise ValueError("call parallel.mesh.shard_segmenter(seg, mesh) "
                         "first")
    return n


def _localize(seg, n: int, u_local: int):
    """Keep this rank's U/n rows of the corpus tensors (copies, so the
    whole corpus is freed) and re-derive the corpus tables from them."""
    utt, r = seg.utterances, seg._shard.rank
    rows = slice(r * u_local, (r + 1) * u_local)
    for name in ("seg_ids", "seg_durations", "lengths_dev",
                 "boundaries_dev"):
        setattr(utt, name, getattr(utt, name)[rows].clone())
    rebuild_tables(seg)


def _gibbs_sweep(seg, **fixed):
    """A sweep of the unigram or bigram segmenter over this rank's blocks,
    ``fixed`` going to every block step."""
    sh = seg._shard

    def sweep(blocks_l, anneal_temp, assign_temp, noise=None, **kwargs):
        """One sweep of this rank's blocks [n_blocks, B/n] (local ids, -1
        pads) at the given temperatures, then the sweep's assignment
        merge; returns the summed log probability (the same on every
        rank).  ``noise``: a (dp_noise, chain_noise) pair a block, this
        rank's (drawn from the rank's generator when None)."""
        sh.updates = []
        lp = 0.0
        for b, idx in enumerate(blocks_l):
            dp, chain = (None, None) if noise is None else noise[b]
            lp = lp + seg.block_step(idx, anneal_temp, assign_temp,
                                     dp_noise=dp, chain_noise=chain,
                                     **fixed, **kwargs)
        am = seg.acoustic_model
        am.assignments = merge_sweep_assignments(am.assignments, sh.updates,
                                                 sh.all_reduce)
        sh.updates = []
        return lp

    return sweep


def build_unigram_shard_sweep(seg, mesh):
    """``(sweep, n)``: the unigram segmenter's per-shard sweep
    ``sweep(blocks_l, anneal_temp, assign_temp, noise=None)``."""
    return _gibbs_sweep(seg), _prep(seg, mesh)


def build_bigram_shard_sweep(seg, mesh, assignments_only: bool):
    """``(sweep, n)``: the bigram segmenter's per-shard sweep, with
    ``assignments_only`` fixed."""
    return (_gibbs_sweep(seg, assignments_only=bool(assignments_only)),
            _prep(seg, mesh))


def build_kmeans_shard_sweep(seg, mesh):
    """``(sweep, n)``: the k-means segmenter's per-shard sweep
    ``sweep(blocks_l)``, which returns the summed objective."""
    n = _prep(seg, mesh)
    sh = seg._shard

    def sweep(blocks_l):
        sh.updates = []
        obj = sum(seg.block_step(idx) for idx in blocks_l)
        am = seg.acoustic_model
        am.state = am.state._replace(assignments=merge_sweep_assignments(
            am.state.assignments, sh.updates, sh.all_reduce))
        sh.updates = []
        return obj

    return sweep, n


def use_shard_map_sweep(seg, mesh):
    """Switch a segmenter (unigram / bigram / k-means, any covariance
    type) to the per-shard collective sweep; ``shard_segmenter`` must have
    put it on ``mesh`` first.  Mutates the segmenter and returns it.

    The rank keeps its own rows of the corpus only (rank r the global
    utterances r U/n .. (r + 1) U/n - 1, ``Shard.owner``); the statistics
    and assignments stay replicated.  What reads the corpus reads it on
    the rank that owns the rows, as collectives that every rank calls:
    ``monitor_i`` (the owner traces the utterance and broadcasts the
    trace, so every rank logs the same record), ``validate`` (each rank
    checks its rows, a violation on any rank raises on every rank), the
    debug-only sweeps (the monitored utterance in its owner's block, the
    others' blocks empty), and the batch scorers
    (``get_vec_embed_log_probs_all``,
    ``get_vec_embed_log_probs_unigram_all``: each owner scores its rows,
    gathered in the caller's order).  ``gather_boundaries`` gives the whole
    boundary matrix."""
    from ..segmenters.bigram import BigramAcousticWordseg
    from ..segmenters.kmeans_seg import SegmentalKMeansWordseg
    from ..segmenters.unigram import UnigramAcousticWordseg

    n = _prep(seg, mesh)
    sh = seg._shard
    if sh.per_shard:
        raise ValueError("the segmenter is in the per-shard mode already")
    # shard_segmenter padded the corpus and rounded the batch to the mesh
    u_local = seg.utterances.seg_ids.shape[0] // n
    b_local = seg.batch_size // n
    if isinstance(seg, SegmentalKMeansWordseg):
        sweep = build_kmeans_shard_sweep(seg, mesh)[0]
    elif isinstance(seg, (UnigramAcousticWordseg, BigramAcousticWordseg)):
        sweep = _gibbs_sweep(seg)  # the bigram's assignments_only passes on
    else:
        raise TypeError("unsupported segmenter type: %r" % type(seg))

    def run_blocks(blocks, *args, **kwargs):
        # the driver's padded [n_blocks, B] blocks, re-laid out per shard
        return sweep(shard_blocks(np.asarray(blocks).reshape(-1), n, u_local,
                                  b_local)[:, sh.rank], *args, **kwargs)

    _localize(seg, n, u_local)
    sh.per_shard = True
    sh.u_local = u_local
    if hasattr(seg, "_gen"):
        sh.gen = (seg._gen if n == 1
                  else rank_generator(seg._seed, sh.rank, seg.device))
    seg._run_blocks = run_blocks
    return seg


def gather_boundaries(seg) -> np.ndarray:
    """The whole host boundary matrix [U, N_max] of a segmenter in the
    per-shard mode, gathered from the ranks' rows (a collective: every
    rank calls it)."""
    utt = seg.utterances
    rows = seg._shard.all_gather(utt.boundaries_dev.to(torch.int32))
    return rows.reshape(-1, utt.N_max)[:utt.D].bool().cpu().numpy()
