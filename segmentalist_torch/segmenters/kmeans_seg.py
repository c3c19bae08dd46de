"""Segmental k-means word segmentation.

Counterpart of ``segmentalist_tpu/segmenters/kmeans_seg.py`` (reference
``SegmentalKMeansWordseg``, ``kmeans_acoustic_wordseg.py:27-443``): each
utterance is segmented by a Viterbi DP over duration-scaled best-component
distances, then every new segment goes to its nearest mean.

One block step (:meth:`SegmentalKMeansWordseg.block_step`) follows the JAX
package's ``_make_block_step`` (``kmeans_seg.py:525-634``):

  1. the means from the global statistics: the block's old segments leave
     the model only after the DP (the reference does not remove the
     utterance before scoring, ``kmeans_acoustic_wordseg.py:252-267``);
  2. candidate scores: the best component's negative squared distance
     times the duration, plus ``wip`` (no ``time_power_term``, ``:349``);
  3. the Viterbi DP, ``ops/dp.segment_dp(mode="viterbi")``: one launch of
     kernel K2 on the card, no noise drawn;
  4. every new segment to its nearest mean, the means frozen (the
     reference's ``get_max_unsup_transcript_i``, ``:436-442``);
  5. the count and sum deltas of the old and new segments, added to the
     global statistics.

Distances take the JAX package's expanded form and operation order
(``models/kmeans.py``), so float64 runs reproduce its trajectories.  The
statistics are rebuilt exactly from the assignment vector every
``_RESYNC_EVERY`` sweeps, which bounds the drift of the additive deltas.

Every sweep visits the utterances in a host ``RandomState(seed)``
permutation, as the JAX package does for runs of fewer than 8 sweeps; from
8 sweeps on (without in-between k-means iterations) the JAX package fuses
8 sweeps into one dispatch whose orders come from device permutations, so
its trajectory there cannot be reproduced.  Within a sweep each utterance
reads only its own assignments, so the ``[N]`` assignment vector is
updated after every block (the JAX package defers that merge to the end
of the sweep; the result is the same).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.kmeans import (KMeans, KMeansState,
                             kmeans_state_from_assignments, means_from_state,
                             neg_sqrd_norms, sum_neg_sqrd_norm)
from ..ops.dp import segment_dp
from ..ops.random import NEG_INF
from ..utils import debug as dbg
from .blocked import _to_device, build_corpus
from .common import (cand_tables, dp_window, flat_contrib,
                     gather_block_segments, pad_utterance_order,
                     put_assignments)
from .unigram import utterance_dp

logger = logging.getLogger(__name__)

RECORD_KEYS = ("sum_neg_sqrd_norm", "sum_neg_len_sqrd_norm", "components",
               "sample_time", "n_tokens")
# sweeps between exact rebuilds of the statistics (the JAX package's
# kmeans_seg.py:57)
_RESYNC_EVERY = 128


def forward_backward_kmeans_viterbi(vec_embed_neg_len_sqrd_norms, N,
                                    n_slices_min=0, n_slices_max=0,
                                    i_utt=None, device="cuda",
                                    dtype=torch.float32):
    """Module-level segmental k-means Viterbi over one utterance's packed
    triangular score vector (reference ``forward_backward_kmeans_viterbi``,
    kmeans_acoustic_wordseg.py:449-555): ``(sum_neg_len_sqrd_norm,
    boundaries)``.  Runs on the card (kernel K2, float32) unless
    ``device`` is "cpu"."""
    return utterance_dp(vec_embed_neg_len_sqrd_norms, 0.0, N, n_slices_min,
                        n_slices_max, 1.0, "viterbi", device=device,
                        dtype=dtype)


def duration_scaled_scores(best: torch.Tensor, seg_ids_blk: torch.Tensor,
                           seg_durs_blk: torch.Tensor, wip) -> torch.Tensor:
    """``best * duration + wip``, -inf for missing embeddings and masked
    (NaN) durations (reference kmeans_acoustic_wordseg.py:334-351)."""
    durs = seg_durs_blk.to(best.dtype)
    scores = best * torch.where(torch.isnan(durs), 0.0, durs) + wip
    invalid = (seg_ids_blk < 0) | torch.isnan(durs)
    return torch.where(invalid, NEG_INF, scores)


def direct_neg_sqrd_norms(X: torch.Tensor,
                          means: torch.Tensor) -> torch.Tensor:
    """[M, K] negative squared distances summed directly, ``-sum_d (x_d -
    mu_d)^2``: no cancellation, unlike ``models.kmeans.neg_sqrd_norms``."""
    diff = X[:, None, :] - means[None, :, :]
    return -(diff * diff).sum(-1)


class SegmentalKMeansWordseg:
    """Segmental k-means word segmentation using acoustic word embeddings
    (constructor parity with ``kmeans_acoustic_wordseg.py:101-223`` and the
    JAX package's ``kmeans_seg.py:84-148``).

    init_am_assignments : "rand" or "spread".
    batch_size : utterances segmented a block step (default
        ``min(64, U)``).
    seed : seeds the host RNG of the initial draws, in the JAX package's
        order (the boundaries, the "rand" draw or the "spread" shuffle,
        the random means: what the JAX package takes from numpy's global
        state after ``np.random.seed(seed)``), and the host RNG of the
        per-sweep utterance order.
    device : where the state lives and the DP runs: the CUDA card by
        default (raises when there is none); "cpu" when the caller asks
        for it, which runs K2's plain version.
    """

    _shard = None  # parallel.mesh.Shard on a mesh

    def __init__(self, am_K, embedding_mats, vec_ids_dict, durations_dict,
                 landmarks_dict, seed_boundaries_dict=None,
                 seed_assignments_dict=None, n_slices_min=0, n_slices_max=20,
                 min_duration=0, p_boundary_init=0.5,
                 init_am_assignments="rand", wip=0.0,
                 batch_size: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        if seed_assignments_dict is not None:
            raise NotImplementedError("seed assignments: the reference "
                                      "leaves them to do "
                                      "(kmeans_acoustic_wordseg.py:149)")
        self.device = resolve_device(device)
        self.n_slices_min = int(n_slices_min)
        self.n_slices_max = int(n_slices_max)
        self.wip = float(wip)
        init_rng = np.random.RandomState(seed)
        embeddings, self.ids_to_utterance_labels, self.utterances = \
            build_corpus(embedding_mats, vec_ids_dict, durations_dict,
                         landmarks_dict, seed_boundaries_dict, n_slices_min,
                         n_slices_max, min_duration, p_boundary_init,
                         init_rng, self.device)
        all_embeds = self.utterances.all_segmented_embeds()
        init_embeds = all_embeds[all_embeds >= 0]
        logger.info("No. initial embeddings: %d", init_embeds.shape[0])
        assignments = -1 * np.ones(embeddings.shape[0], dtype=np.int64)
        if init_am_assignments == "rand":
            assignments[init_embeds] = init_rng.randint(0, am_K,
                                                        len(init_embeds))
        elif init_am_assignments == "spread":
            n_init = len(init_embeds)
            lst = (list(range(am_K))
                   * int(np.ceil(float(n_init) / am_K)))[:n_init]
            init_rng.shuffle(lst)
            assignments[init_embeds] = np.array(lst)
        else:
            raise ValueError("invalid value for `init_am_assignments`: "
                             + str(init_am_assignments))
        self.acoustic_model = KMeans(embeddings, am_K, assignments,
                                     rng=init_rng, device=self.device)

        utt = self.utterances
        self.batch_size = (int(batch_size) if batch_size
                           else min(64, utt.D))
        self._rng = np.random.RandomState(seed)
        self.W_dp = (min(self.n_slices_max, utt.N_max)
                     if self.n_slices_max > 0 else utt.N_max)
        self._seg_ids_dp = dp_window(utt.seg_ids, self.W_dp)
        self._seg_durs_dp = dp_window(utt.seg_durations, self.W_dp)
        self.refresh_candidates()
        self._sweeps_since_resync = 0

    # ------------------------------------------------------------------ API

    def refresh_candidates(self):
        """Rebuild the sweep-static candidate table ``X[seg_ids]`` (after
        replacing ``acoustic_model.X``)."""
        self._cand_X = cand_tables(self._seg_ids_dp,
                                   self.acoustic_model.X)[0]

    def get_unsup_transcript_i(self, i: int) -> list:
        """Components of utterance ``i``'s current segments."""
        return list(self.acoustic_model.components.get_assignments(
            self.utterances.get_segmented_embeds_i(i)))

    def get_max_unsup_transcript_i(self, i: int) -> list:
        """Nearest components of utterance ``i``'s segments (reference
        kmeans_acoustic_wordseg.py:436-442)."""
        return self.acoustic_model.get_max_assignments(
            self.utterances.get_segmented_embeds_i(i))

    def get_vec_embed_neg_len_sqrd_norms(self, vec_ids,
                                         durations) -> np.ndarray:
        """Duration-scaled best-component distances in the packed
        triangular layout (reference kmeans_acoustic_wordseg.py:334-351)."""
        vec_ids = np.asarray(vec_ids)
        durations = np.asarray(durations, dtype=float)
        out = np.full(len(vec_ids), -np.inf)
        valid = vec_ids != -1
        if valid.any():
            am = self.acoustic_model
            ids = torch.as_tensor(vec_ids[valid].astype(np.int64),
                                  device=self.device)
            out[valid] = neg_sqrd_norms(am.X[ids], am.means()).amax(
                -1).cpu().numpy()
        nan_dur = np.isnan(durations)
        out[nan_dur & valid] = -np.inf
        ok = valid & ~nan_dur
        out[ok] = out[ok] * durations[ok]
        return out + self.wip

    def segment_i(self, i: int) -> float:
        """Segment utterance ``i`` alone: a block of one (reference
        ``segment_i``, kmeans_acoustic_wordseg.py:225-332).  Returns its
        DP objective."""
        return float(self.block_step(np.array([int(i)])))

    def segment(self, n_iter: int, n_iter_inbetween_kmeans: int = 0,
                monitor_i=None, validate: bool = False,
                segment_debug_only: bool = False) -> dict:
        """Segment all utterances ``n_iter`` times, each sweep followed by
        ``n_iter_inbetween_kmeans`` k-means iterations over the assigned
        items (reference ``segment``, kmeans_acoustic_wordseg.py:353-425).
        Returns the five-key record; its values are fetched once a
        sweep.

        ``monitor_i`` / ``validate``: a per-sweep trace of one utterance,
        logged at DEBUG level, and the invariant checks of
        ``utils.debug.KMEANS_CHECKS``, which raise ``ValidationError``
        after the last sweep (the reference's ``i_debug_monitor`` / NaN
        asserts; see ``utils/debug.py``).  ``segment_debug_only``: segment
        only the monitored utterance each sweep (the reference's standing
        flag, kmeans_acoustic_wordseg.py:20; requires ``monitor_i``)."""
        if segment_debug_only and monitor_i is None:
            raise AssertionError("segment_debug_only requires monitor_i")
        am = self.acoustic_model
        record = {k: [] for k in RECORD_KEYS}
        pending_monitor, pending_validate = [], []
        for _ in range(n_iter):
            t0 = time.time()
            order = (np.asarray([int(monitor_i)], dtype=np.int64)
                     if segment_debug_only else
                     self._rng.permutation(self.utterances.D))
            blocks = pad_utterance_order(order, self.batch_size)
            obj = self._run_blocks(blocks)
            self._sweeps_since_resync += 1
            if self._sweeps_since_resync >= _RESYNC_EVERY:
                self._resync_stats()
            st = am.state
            f64 = torch.float64
            obj, snn, k_act, n_tok = torch.stack([
                obj.to(f64),
                sum_neg_sqrd_norm(am.X, st, am.random_means).to(f64),
                (st.counts > 0).sum().to(f64),
                (st.assignments >= 0).sum().to(f64)]).tolist()
            if monitor_i is not None:
                pending_monitor.append(self._monitor(int(monitor_i)))
            if validate:
                pending_validate.append(self._validate())
            if n_iter_inbetween_kmeans > 0:
                am.fit(n_iter_inbetween_kmeans, consider_unassigned=False)
            record["sum_neg_sqrd_norm"].append(snn)
            record["sum_neg_len_sqrd_norm"].append(obj)
            record["components"].append(int(k_act))
            record["n_tokens"].append(int(n_tok))
            record["sample_time"].append(time.time() - t0)
            logger.info("iteration: %d, sum_neg_len_sqrd_norm: %s",
                        len(record["sample_time"]) - 1, obj)
        if monitor_i is not None:
            dbg.log_monitor(logger, int(monitor_i), pending_monitor)
        if validate:
            dbg.check_validation(pending_validate, dbg.KMEANS_CHECKS)
        return record

    def _run_blocks(self, blocks):
        """One sweep's blocks [n_blocks, B], a block step each; returns
        the summed objective.  The per-shard mode
        (``parallel/shard_sweep.py``) replaces it on the instance."""
        return sum(self.block_step(blk) for blk in blocks)

    def _candidate_scores(self, idx: torch.Tensor, means: torch.Tensor,
                          distances=neg_sqrd_norms) -> torch.Tensor:
        """[B, N_max, W_dp] candidate scores of the utterances ``idx``: the
        best component's negative squared distance to ``means`` (by
        ``distances``) times the duration, plus ``wip``; -inf where
        masked."""
        B, N_max, W_dp = idx.shape[0], self.utterances.N_max, self.W_dp
        Xc = self._cand_X[idx].reshape(B * N_max * W_dp, -1)
        best = distances(Xc, means).amax(-1).reshape(B, N_max, W_dp)
        return duration_scaled_scores(best, self._seg_ids_dp[idx],
                                      self._seg_durs_dp[idx], self.wip)

    def _monitor_device(self, i: int):
        """Utterance ``i``'s trace on the current state, as device tensors:
        ``(candidate scores [N_max, W_dp], -inf where masked; its boundary
        row [N_max]; its current segments' components [N_max], -1 pads)``
        (the JAX package's ``_monitor_device``, ``kmeans_seg.py:315-363``).
        The distances take the direct form: the block step's expanded form
        cancels in float32 (ROADMAP's reference caveats), which would show
        as rounding noise of up to ~2e-4 relative in the trace.
        """
        am, utt = self.acoustic_model, self.utterances
        idx = torch.tensor([int(i)], device=self.device)
        scores = self._candidate_scores(
            idx, means_from_state(am.state, am.random_means),
            direct_neg_sqrd_norms)
        embeds, _ = gather_block_segments(utt.boundaries_dev[idx],
                                          utt.lengths_dev[idx],
                                          utt.seg_ids[idx])
        ks = torch.where(embeds >= 0,
                         am.state.assignments[embeds.clamp_min(0).long()], -1)
        return scores[0], utt.boundaries_dev[int(i)].clone(), ks[0]

    def _monitor(self, i: int):
        """:meth:`_monitor_device` of utterance ``i``; in the per-shard mode
        a collective that gives every rank its owner's trace."""
        sh = self._shard
        if sh is not None and sh.per_shard:
            return sh.monitor(self, i)
        return self._monitor_device(i)

    def _validate(self) -> torch.Tensor:
        """:meth:`_validate_device`; in the per-shard mode each rank checks
        its own rows and a violation on any rank is one on every rank (a
        collective)."""
        flags = self._validate_device()
        sh = self._shard
        return sh.all_ok(flags) if sh is not None and sh.per_shard else flags

    def _validate_device(self) -> torch.Tensor:
        """The invariant flags of ``utils.debug.KMEANS_CHECKS`` on the
        current state, a bool tensor on the device."""
        return dbg.kmeans_validation_flags(self.acoustic_model.state,
                                           self.utterances.boundaries_dev,
                                           self.utterances.lengths_dev)

    def block_step(self, idx_blk) -> torch.Tensor:
        """Segment one block of utterances in place.  ``idx_blk`` [B] host
        ints: utterance ids, -1 for padding.  Returns the block's summed
        Viterbi objective (a device scalar).

        On a mesh, as ``BlockedWordseg._merge`` does: the exact mode
        segments this rank's rows of the block and gathers the whole block
        before step 5, which every rank then takes as one device would;
        the per-shard mode sums the ranks' count and sum deltas and
        objectives (the JAX package's ``kmeans_seg.py:610-627``) and leaves
        the assignments to the sweep's merge."""
        am, utt, sh = self.acoustic_model, self.utterances, self._shard
        X, K, st = am.X, am.K_max, am.state
        idx_np = np.asarray(idx_blk, dtype=np.int64)
        exact = sh is not None and not sh.per_shard
        if exact:
            idx_np, rows = sh.own_rows(idx_np)
        B = idx_np.shape[0]
        packed = _to_device(
            np.concatenate([idx_np, np.nonzero(idx_np >= 0)[0]]), self.device)
        valid = packed[:B] >= 0
        idx, live = packed[:B].clamp_min(0), packed[B:]
        if exact:
            full = (idx, valid, live)
            idx, valid = idx[rows], valid[rows]
        lengths = torch.where(valid, utt.lengths_dev[idx], 0)
        seg_ids = utt.seg_ids[idx]

        # 1. the means of the global statistics; the old segments
        means = means_from_state(st, am.random_means)
        old_embeds, _ = gather_block_segments(utt.boundaries_dev[idx],
                                              lengths, seg_ids)

        # 2. best-component distance x duration + wip for every candidate
        scores = self._candidate_scores(idx, means)

        # 3. the Viterbi DP (kernel K2)
        obj, new_bounds = segment_dp(
            scores, lengths, 0.0, 1.0, n_slices_min=self.n_slices_min,
            n_slices_max=self.W_dp, mode="viterbi")

        # 4. the new segments to their nearest (frozen) means
        new_embeds, _ = gather_block_segments(new_bounds, lengths, seg_ids)
        Xe_new = X[new_embeds.clamp_min(0).long()]
        new_ks = neg_sqrd_norms(Xe_new.reshape(-1, X.shape[-1]),
                                means).argmax(-1).reshape(new_embeds.shape)
        new_ks = torch.where(new_embeds >= 0, new_ks.to(torch.int32), -1)

        # 5. the statistics' deltas, the assignments and the boundaries
        if exact:
            idx, valid, live = full
            old_embeds, new_embeds, new_ks, new_bounds, obj = sh.gather_rows(
                old_embeds, new_embeds, new_ks, new_bounds, obj)
            Xe_new = X[new_embeds.clamp_min(0).long()]
        old_rows = old_embeds.clamp_min(0).long()
        old_ks = torch.where(old_embeds >= 0, st.assignments[old_rows], -1)
        old_c = flat_contrib(X, old_embeds, old_ks, K, valid,
                             rows=X[old_rows], second_moments=False)
        new_c = flat_contrib(X, new_embeds, new_ks, K, valid, rows=Xe_new,
                             second_moments=False)
        d_counts = new_c.counts - old_c.counts
        d_sum_x = new_c.sum_x - old_c.sum_x
        obj = torch.where(valid, obj, 0.0).sum()
        if sh is not None and sh.per_shard:
            d_counts, d_sum_x, obj = sh.sum_ranks([d_counts, d_sum_x, obj])
            sh.updates.append((valid, old_embeds, new_embeds, new_ks))
            assignments = st.assignments
        else:
            pad = torch.cat([st.assignments,
                             st.assignments.new_full((1,), -1)])
            put_assignments(pad, valid, old_embeds, new_embeds, new_ks)
            assignments = pad[:-1]
        am.state = KMeansState(assignments=assignments,
                               counts=st.counts + d_counts,
                               sum_x=st.sum_x + d_sum_x)
        utt.boundaries_dev[idx[live]] = new_bounds[live]
        return obj

    def _resync_stats(self):
        """Rebuild the statistics exactly from the assignment vector."""
        am = self.acoustic_model
        am.state = kmeans_state_from_assignments(am.X, am.state.assignments,
                                                 am.K_max)
        self._sweeps_since_resync = 0


if __name__ == "__main__":  # smoke demo (reference kmeans_acoustic_wordseg.py:558-658)
    from segmentalist_torch.demos import run_demo

    run_demo("kmeans_seg")
