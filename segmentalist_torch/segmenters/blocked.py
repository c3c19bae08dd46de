"""State and block-step stages shared by the blocked-Gibbs segmenters.

The unigram and bigram segmenters hold the same corpus and acoustic-model
state and resample a block of utterances through the same stages
(``segmentalist_tpu/segmenters/unigram.py:785-1057`` and
``bigram.py:953-1278``):

  1. the block's current segments and their leave-one-utterance-out
     statistics (:meth:`BlockedWordseg._leave_out`): feature-major moment
     sums for the fixed-variance and diagonal-covariance families; for the
     full-covariance one the global predictive parameters and each
     utterance's touched-component leave-outs (``segmenters/fullcov.py``);
  2. fused candidate scoring (kernel K1 for the fixed-variance family, K5
     for the diagonal-covariance one, K8 for the full-covariance one) and
     the boundary-resampling DP (kernel K2)
     (:meth:`BlockedWordseg._resample_boundaries`);
  3. the sequential assignment chain of the new segments -- the one stage
     the segmenters do differently (K3 / K6 / K9 with Dirichlet weights,
     K4 / K7 / K9's bigram mode with the bigram LM);
  4. cross-utterance decollision and the merge into the global state
     (:meth:`BlockedWordseg._merge`).

The segmenters differ only in the mixture weights they hand to stage 2, the
chain of stage 3 and the bookkeeping around it.

On a mesh (``parallel/``) the same stages run on a rank's rows: in the
exact mode :meth:`BlockedWordseg._leave_out` takes this rank's rows of the
block, :meth:`BlockedWordseg._own_noise` its rows of the block's noise, and
:meth:`BlockedWordseg._merge` gathers the whole block back; in the
per-shard mode the block is the rank's own and :meth:`BlockedWordseg._merge`
reduces its deltas over the ranks.  Without a mesh (``_shard`` None) every
hook is the identity.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..corpus import Utterances
from ..device import resolve_device
from ..models.components_full import PredParams
from ..ops.cuda_fullcov_score import fullcov_log_margs
from ..ops.cuda_score import diag_log_margs_T, fixedvar_log_margs_T
from ..ops.dp import segment_dp
from ..ops.random import gumbel, logsumexp
from ..ops.stats import SuffStats
from ..utils import debug as dbg
from .common import (
    cand_tables,
    counts_contrib,
    decollide_new_components,
    dp_window,
    flat_contrib,
    gather_block_segments,
    leave_out_moments_T,
    masked_candidate_scores,
    merge_flat,
    pad_utterance_order,
    put_assignments,
    seed_assignments_to_vector,
)
from .fullcov import (Touched, fullcov_chain, fullcov_score_inputs,
                      touched_leave_out)

logger = logging.getLogger(__name__)

RECORD_KEYS = ("sample_time", "log_marg", "log_marg*length", "log_prob_z",
               "log_prob_X_given_z", "anneal_temp", "components", "n_tokens")


def process_embeddings(embedding_mats, vec_ids_dict):
    """Flatten per-utterance embedding matrices into one [N, D] matrix and
    re-index the per-utterance ``vec_ids`` to global rows (reference
    ``process_embeddings``, unigram_acoustic_wordseg.py:571-646)."""
    embeddings, vec_ids, labels = [], [], []
    i_embed = 0
    for utt in sorted(embedding_mats):
        labels.append(utt)
        mat = np.asarray(embedding_mats[utt])
        local = np.asarray(vec_ids_dict[utt])
        vec_ids.append(np.where(local >= 0, local + i_embed, -1))
        embeddings.append(mat)
        i_embed += mat.shape[0]
    return np.concatenate(embeddings, axis=0), vec_ids, labels


def build_corpus(embedding_mats, vec_ids_dict, durations_dict,
                 landmarks_dict, seed_boundaries_dict, n_slices_min,
                 n_slices_max, min_duration, p_boundary_init,
                 rng: np.random.RandomState, device: torch.device):
    """The corpus of the per-utterance dicts: ``(embeddings [N, D],
    utterance labels in corpus order, Utterances)``, the boundaries drawn
    from ``rng`` unless ``seed_boundaries_dict`` gives them."""
    embeddings, vec_ids, labels = process_embeddings(embedding_mats,
                                                     vec_ids_dict)
    seed_boundaries = (None if seed_boundaries_dict is None else
                       [seed_boundaries_dict[i] for i in labels])
    utterances = Utterances(
        [len(landmarks_dict[i]) for i in labels], vec_ids,
        [durations_dict[i] for i in labels],
        [landmarks_dict[i] for i in labels],
        seed_boundaries=seed_boundaries, p_boundary_init=p_boundary_init,
        n_slices_min=n_slices_min, n_slices_max=n_slices_max,
        min_duration=min_duration, rng=rng, device=device,
    )
    return embeddings, labels, utterances


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on CUDA through pinned memory, so the
    copy is asynchronous and does not stall the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Block(NamedTuple):
    """One block of utterances at the start of its step."""

    idx: torch.Tensor         # [B] utterance ids (padding clamped to 0)
    valid: torch.Tensor       # [B] bool, False for padding
    live: torch.Tensor        # [n] positions of the real utterances
    lengths: torch.Tensor     # [B] landmarks (0 for padding)
    seg_ids: torch.Tensor     # [B, N_max, W_store] candidate embedding ids
    old_embeds: torch.Tensor  # [B, N_max] current segments' embedding ids
    old_ks: torch.Tensor      # [B, N_max] their components (-1 pads)
    Xe_old: torch.Tensor      # [B, N_max, D] their vectors
    own_counts: torch.Tensor  # [B, K] int32 per-utterance counts of old_ks
    lo_counts: torch.Tensor   # [B, K] int32 leave-one-utterance-out counts
    sum_xT: Optional[torch.Tensor]   # [B, D, K] leave-out sum_x (not full)
    sum_sqT: Optional[torch.Tensor]  # [B, D, K] ... sum_sq (diag only)
    params_g: Optional[PredParams]   # global predictive params (full only)
    touched: Optional[Touched]       # touched-slot leave-outs (full only)
    # exact mode on a mesh: (idx, valid, live) of the whole block and the
    # slice of this rank's rows; None elsewhere
    full: Optional[tuple] = None


class BlockedWordseg:
    """Corpus and acoustic-model state of a blocked-Gibbs segmenter, and
    the block-step stages its subclasses share.  A subclass calls
    :meth:`_init_corpus`, builds its acoustic model, then calls
    :meth:`_init_sampler`; it defines ``block_step``, ``sweep_metrics``
    and ``_candidate_weights`` (a block's [B, K] mixture-weight terms)."""

    _shard = None  # parallel.mesh.Shard on a mesh

    def _init_corpus(self, am_K, embedding_mats, vec_ids_dict,
                     durations_dict, landmarks_dict, seed_boundaries_dict,
                     seed_assignments_dict, n_slices_min, n_slices_max,
                     min_duration, p_boundary_init, beta_sent_boundary, wip,
                     time_power_term, init_am_assignments, seed,
                     decollide_new, device, one_by_one=False):
        """Build the corpus and the initial assignments; returns
        ``(embeddings [N, D], assignments [N], am_K)``.

        ``seed`` seeds the host RNG of the initialisation (the draws the JAX
        package takes from numpy's global RNG, in the same order).  With
        ``one_by_one`` (the unigram segmenter) ``init_am_assignments`` may be
        "one-by-one": every initial segment stays unassigned and its
        embedding id is kept in ``_init_embeds`` (in corpus order), for the
        segmenter to assign one by one once its model exists."""
        if seed_assignments_dict is not None and seed_boundaries_dict is None:
            raise ValueError(
                "seed_assignments_dict needs seed_boundaries_dict")
        self.device = resolve_device(device)
        self.n_slices_min = int(n_slices_min)
        self.n_slices_max = int(n_slices_max)
        self.beta_sent_boundary = float(beta_sent_boundary)
        self.wip = float(wip)
        self.time_power_term = float(time_power_term)
        self.decollide_new = bool(decollide_new)

        init_rng = np.random.RandomState(seed)
        embeddings, labels, self.utterances = build_corpus(
            embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
            seed_boundaries_dict, n_slices_min, n_slices_max, min_duration,
            p_boundary_init, init_rng, self.device)
        self.ids_to_utterance_labels = labels
        N = embeddings.shape[0]

        assignments = -1 * np.ones(N, dtype=np.int64)
        if seed_assignments_dict is not None:
            self.seed_to_cluster, am_K = seed_assignments_to_vector(
                self.utterances, labels, seed_assignments_dict, assignments,
                am_K)
        elif init_am_assignments == "rand":
            all_embeds = self.utterances.all_segmented_embeds()
            init_embeds = all_embeds[all_embeds >= 0]
            assignments[init_embeds] = init_rng.randint(0, am_K,
                                                        len(init_embeds))
        elif init_am_assignments == "one-by-one" and one_by_one:
            all_embeds = self.utterances.all_segmented_embeds()
            self._init_embeds = all_embeds[all_embeds >= 0]
        else:
            raise ValueError("invalid value for `init_am_assignments`: "
                             + str(init_am_assignments))
        return embeddings, assignments, am_K

    def _init_sampler(self, batch_size: Optional[int], seed: int):
        """Block size, the host RNG of the per-sweep utterance order, the
        device generator of the sampling noise (the acoustic model's, which
        its constructor seeded with ``seed``: one stream for the block
        steps and the model's own draws), and the DP-windowed candidate
        tables."""
        self.batch_size = (int(batch_size) if batch_size
                           else min(64, self.utterances.D))
        self._rng = np.random.RandomState(seed)
        self._seed = int(seed)
        self._gen = self.acoustic_model.generator
        utt = self.utterances
        self.W_dp = (min(self.n_slices_max, utt.N_max)
                     if self.n_slices_max > 0 else utt.N_max)
        self._seg_ids_dp = dp_window(utt.seg_ids, self.W_dp)
        self._seg_durs_dp = dp_window(utt.seg_durations, self.W_dp)
        self.refresh_candidates()

    # ------------------------------------------------------------------ API

    def refresh_candidates(self):
        """Rebuild the sweep-static candidate tensors ``X[seg_ids]`` and
        ``log_prior_vec[seg_ids]``, and the host copies of the NIW prior's
        scalars (after replacing ``acoustic_model.X`` or its prior)."""
        am = self.acoustic_model
        self._cand_X, self._cand_lp = cand_tables(
            self._seg_ids_dp, am.X, am.log_prior_vec)
        self._family = am.covariance_type
        # The chain kernels take k_0 and v_0 as host floats: fetched once
        # here, not in every block step.
        self._k0_v0 = ((float(am.prior.k_0), float(am.prior.v_0))
                       if self._family != "fixed" else None)

    def calc_p_continue(self) -> float:
        """Sentence-continue probability under the symmetric Beta prior
        (reference ``calc_p_continue``,
        unigram_acoustic_wordseg.py:513-531)."""
        return float(torch.exp(self._log_p_continue(
            self.acoustic_model.stats.counts)))

    def _log_p_continue(self, counts: torch.Tensor) -> torch.Tensor:
        """log of :meth:`calc_p_continue` as a device scalar (no host sync)."""
        dtype = self.acoustic_model.X.dtype
        if self.beta_sent_boundary == -1:
            return torch.zeros((), dtype=dtype, device=self.device)
        beta = self.beta_sent_boundary
        n_tokens = counts.sum().to(dtype)
        n_continue = n_tokens - (self.utterances.D - 1)
        return torch.log((n_continue + beta / 2.0) / (n_tokens + beta))

    def get_unsup_transcript_i(self, i: int):
        """Component assignments of utterance i's current segments
        (reference unigram_acoustic_wordseg.py:533-537)."""
        embeds = np.asarray(self.utterances.get_segmented_embeds_i(i),
                            dtype=np.int64)
        return list(self.acoustic_model.assignments.cpu().numpy()[embeds])

    def _dense_candidate_scores(self, utt_ids, wvec: torch.Tensor):
        """Duration-scaled candidate scores of the utterances ``utt_ids``
        (None: all, in corpus order) against the global statistics, with
        mixture-weight terms ``wvec`` [K]: ``(scores [n, N_max, W_store]
        as numpy, the n lengths)``, -inf where a span is missing or masked.

        The fixed-variance family scores through kernel K1 (its plain
        version on a CPU tensor), the block step's scorer, given one table
        of global statistics for every row.  The diag and full families
        score in plain tensor code (``cov.log_post_pred_batch``), as the
        JAX package does outside Pallas: K5 takes a Stirling lgamma and K8
        a float32 touched-slot form, so neither is that function."""
        am, utt = self.acoustic_model, self.utterances
        utt_ids = np.asarray(np.arange(utt.D) if utt_ids is None
                             else utt_ids, dtype=np.int64)
        sh = self._shard
        if sh is not None and sh.per_shard:
            dense = sh.gather_utterances(
                utt_ids, lambda rows: self._dense_rows(rows, wvec),
                lambda m: am.X.new_zeros((m,) + tuple(utt.seg_ids.shape[1:])))
        else:
            dense = self._dense_rows(utt_ids, wvec)
        return dense.cpu().numpy(), [utt.lengths[i] for i in utt_ids]

    def _dense_rows(self, rows_np, wvec: torch.Tensor) -> torch.Tensor:
        """:meth:`_dense_candidate_scores` of the corpus rows ``rows_np``
        this process holds, a device tensor [n, N_max, W_store]."""
        am, utt = self.acoustic_model, self.utterances
        rows = _to_device(rows_np, self.device)
        ids = utt.seg_ids[rows]  # [n, N_max, W_store]
        flat = ids.clamp_min(0).reshape(-1).long()
        x, lpv, counts = am.X[flat], am.log_prior_vec[flat], am.stats.counts
        if self._family == "fixed":
            muT, precT = am.cov.predictive_params_T(
                am.prior, counts[None], am.stats.sum_x.T[None])
            margs = fixedvar_log_margs_T(
                x[None], lpv[None], muT.contiguous(), precT.contiguous(),
                wvec[None].contiguous(), counts[None])[0]
        else:
            post = am.cov.log_post_pred_batch(
                am.cov.predictive_params(am.prior, am.stats), x)
            margs = logsumexp(wvec[None, :] + torch.where(
                (counts > 0)[None, :], post, lpv[:, None]), dim=-1)
        return masked_candidate_scores(
            margs.reshape(ids.shape), ids, utt.seg_durations[rows],
            self.time_power_term, self.wip)

    def _sample_sweeps(self, temps, anneal_gibbs_am: bool,
                       am_n_iter: int = 0, monitor_i=None,
                       validate: bool = False, debug_only: bool = False,
                       **step_kwargs) -> dict:
        """Blocked Gibbs sweeps at temperatures ``temps``: every sweep visits
        the utterances in a fresh host permutation, in blocks of
        ``batch_size``, after ``am_n_iter`` sweeps of the acoustic model
        alone over the assigned items (``FBGMM.gibbs_sample``, sequential).
        Returns the reference's 8-key record dict.

        After every sweep, ``monitor_i`` takes the utterance's trace
        (:meth:`_monitor_device`) and ``validate`` the invariant flags
        (:meth:`_validate_device`); after the last sweep the traces are
        logged and the flags checked (``utils/debug.py``), as the JAX
        package does (``unigram.py:469-474``).  ``debug_only`` visits only
        utterance ``monitor_i``, in one padded block, every sweep."""
        record = {k: [] for k in RECORD_KEYS}
        pending_monitor, pending_validate = [], []
        for temp in temps:
            t0 = time.time()
            if am_n_iter > 0:
                self.acoustic_model.gibbs_sample(am_n_iter,
                                                 consider_unassigned=False)
            temp = float(temp)
            assign_temp = temp if anneal_gibbs_am else 1.0
            order = (np.asarray([int(monitor_i)], dtype=np.int64)
                     if debug_only else
                     self._rng.permutation(self.utterances.D))
            blocks = pad_utterance_order(order, self.batch_size)
            log_prob = self._run_blocks(blocks, temp, assign_temp,
                                        **step_kwargs)
            m = self.sweep_metrics()
            record["log_marg"].append(m["log_marg"])
            record["log_marg*length"].append(float(log_prob))
            record["log_prob_z"].append(m["log_prob_z"])
            record["log_prob_X_given_z"].append(m["log_prob_X_given_z"])
            record["anneal_temp"].append(temp)
            record["components"].append(m["components"])
            record["n_tokens"].append(m["n_assigned"])
            record["sample_time"].append(time.time() - t0)
            logger.info("iteration: %d, log_marg: %s",
                        len(record["log_marg"]) - 1, record["log_marg"][-1])
            if monitor_i is not None:
                pending_monitor.append(self._monitor(int(monitor_i)))
            if validate:
                pending_validate.append(self._validate())
        if monitor_i is not None:
            dbg.log_monitor(logger, int(monitor_i), pending_monitor)
        if validate:
            dbg.check_validation(pending_validate, self.VALIDATION_CHECKS)
        return record

    def _run_blocks(self, blocks, *args, **kwargs):
        """One sweep's blocks [n_blocks, B], a block step each; returns
        the summed log probability.  The per-shard mode
        (``parallel/shard_sweep.py``) replaces it on the instance."""
        return sum(self.block_step(blk, *args, **kwargs) for blk in blocks)

    @property
    def _block_gen(self) -> torch.Generator:
        """The generator of the block steps' noise: the replicated one,
        or in the per-shard mode the rank's own."""
        sh = self._shard
        return self._gen if sh is None or sh.gen is None else sh.gen

    # ---------------------------------------------------------- debugging

    VALIDATION_CHECKS = dbg.FBGMM_CHECKS

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
        """The invariant flags of ``VALIDATION_CHECKS`` on the current
        state, a bool tensor on the device (the JAX package's
        ``_validate_device``, ``unigram.py:589-605``)."""
        am, utt = self.acoustic_model, self.utterances
        return dbg.fbgmm_validation_flags(am.stats, am.assignments,
                                          utt.boundaries_dev,
                                          utt.lengths_dev)

    def _monitor_device(self, i: int):
        """Utterance ``i``'s trace on the current state, as device tensors:
        ``(candidate scores [N_max, W_dp], -inf where masked; its boundary
        row [N_max]; its current segments' components [N_max], -1 pads)``
        (the JAX package's ``_monitor_device``, ``unigram.py:521-587``).

        The scores are the block step's, with the utterance held out (its
        segments and leave-out statistics from :meth:`_leave_out`) and the
        mixture weights of :meth:`_candidate_weights`.  The fixed-variance
        family scores through the block step's own scorer, kernel K1, which
        sums (x - mu)^2 prec directly (the expanded form of
        ``log_post_pred_batch`` cancels in float32); the diag and full
        families score in plain tensor code with ``cov.log_post_pred_batch``
        through a logsumexp, as the JAX monitor does (K5 takes a Stirling
        lgamma and K8 a float32 touched-slot form)."""
        am, utt = self.acoustic_model, self.utterances
        blk = self._leave_out(np.array([int(i)]))
        w = self._candidate_weights(blk)
        if self._family == "fixed":
            log_margs = self._candidate_log_margs(blk, w)
        else:
            own = flat_contrib(am.X, blk.old_embeds, blk.old_ks, am.K_max,
                               blk.valid, rows=blk.Xe_old,
                               full_cov=am.full_cov)
            lo = SuffStats(*(g - c for g, c in zip(am.stats, own)))
            post = am.cov.log_post_pred_batch(
                am.cov.predictive_params(am.prior, lo),
                self._cand_X[blk.idx][0])
            logits = w + torch.where((lo.counts > 0)[None, :], post,
                                     self._cand_lp[blk.idx][0][:, None])
            log_margs = logsumexp(logits, dim=-1).reshape(1, utt.N_max,
                                                          self.W_dp)
        scores = masked_candidate_scores(
            log_margs, self._seg_ids_dp[blk.idx], self._seg_durs_dp[blk.idx],
            self.time_power_term, self.wip)
        return scores[0], utt.boundaries_dev[int(i)].clone(), blk.old_ks[0]

    # ------------------------------------------------------- block stages

    def _leave_out(self, idx_blk, split: bool = False) -> Block:
        """Stage 1: the block's current segments and leave-one-utterance-out
        statistics (for the full family: the global predictive parameters
        and the touched-slot leave-outs, no moment tables; the JAX
        package's ``unigram.py:841-853``).  ``idx_blk`` [B] host ints, -1
        for padding.  With ``split`` (a block step) and the exact mode on a
        mesh: this rank's rows of the block, the whole block's in
        ``Block.full``."""
        am, utt, dev = self.acoustic_model, self.utterances, self.device
        X, K = am.X, am.K_max
        idx_np = np.asarray(idx_blk, dtype=np.int64)
        exact = (split and self._shard is not None
                 and not self._shard.per_shard)
        if exact:
            idx_np, rows = self._shard.own_rows(idx_np)
        B = idx_np.shape[0]
        live_np = np.nonzero(idx_np >= 0)[0]
        packed = _to_device(np.concatenate([idx_np, live_np]), dev)
        valid = packed[:B] >= 0
        idx, live = packed[:B].clamp_min(0), packed[B:]
        full = None
        if exact:
            full = (idx, valid, live, rows)
            idx, valid, live = idx[rows], valid[rows], None
        lengths = torch.where(valid, utt.lengths_dev[idx], 0)
        seg_ids = utt.seg_ids[idx]
        old_embeds, _ = gather_block_segments(utt.boundaries_dev[idx],
                                              lengths, seg_ids)
        old_ok = old_embeds >= 0
        old_rows = old_embeds.clamp_min(0).long()
        old_ks = torch.where(old_ok, am.assignments[old_rows], -1)
        Xe_old = X[old_rows]
        own_counts = counts_contrib(old_ks, old_ok, K)
        sum_xT = sum_sqT = params_g = touched = None
        if self._family == "full":
            params_g = am.cov.predictive_params(am.prior, am.stats)
            touched = touched_leave_out(am.prior, am.stats, X, old_embeds,
                                        old_ks, rows=Xe_old)
        elif self._family == "diag":
            sum_xT, sum_sqT = leave_out_moments_T(
                am.stats, X, old_embeds, old_ks, K, rows=Xe_old, with_sq=True)
        else:
            sum_xT = leave_out_moments_T(am.stats, X, old_embeds, old_ks, K,
                                         rows=Xe_old)
        return Block(idx, valid, live, lengths, seg_ids, old_embeds,
                     old_ks, Xe_old, own_counts,
                     am.stats.counts[None] - own_counts, sum_xT, sum_sqT,
                     params_g, touched, full)

    def _own_noise(self, blk: Block, dp_noise: Optional[torch.Tensor],
                   chain_noise: Optional[torch.Tensor], sample_dp: bool):
        """The block step's (DP, chain) noise.  In the exact mode: the
        whole block's, drawn where not given on the replicated generator in
        the single-device order (the DP's when ``sample_dp``, then the
        chain's), and this rank's rows of it; so every row sees the noise
        it would see on one device.  Elsewhere the noise as given (None is
        drawn later, by the stage that takes it)."""
        if blk.full is None:
            return dp_noise, chain_noise
        am, rows = self.acoustic_model, blk.full[3]
        B = blk.full[0].shape[0]
        if sample_dp and dp_noise is None:
            dp_noise = gumbel((B, self.utterances.N_max, self.W_dp),
                              self._gen, self.device, am.X.dtype)
        chain_noise = self._chain_noise(chain_noise, B)
        return (None if dp_noise is None else dp_noise[rows],
                chain_noise[rows])

    def _resample_boundaries(self, blk: Block, w_b: torch.Tensor,
                             anneal_temp: float, mode: str,
                             dp_noise: Optional[torch.Tensor]):
        """Stage 2: score every candidate span of the block with mixture
        weights ``w_b`` [B, K] (kernel K1, K5 for the diag family, K8 for
        the full one) and resample the boundaries (kernel K2).  Returns
        (log_prob [B], new boundaries [B, N_max]).

        The diag Viterbi DP takes K5's exact per-dimension composition: a
        deterministic argmax must not see the grouped form's rounding
        (the JAX driver's gate, ``unigram.py:863-871``).  The full family
        has one composition, K8, for both DP modes (``unigram.py:905-916``).
        """
        am = self.acoustic_model
        scores = masked_candidate_scores(
            self._candidate_log_margs(blk, w_b, exact=mode == "viterbi"),
            self._seg_ids_dp[blk.idx], self._seg_durs_dp[blk.idx],
            self.time_power_term, self.wip)
        return segment_dp(
            scores, blk.lengths, self._log_p_continue(am.stats.counts),
            anneal_temp, n_slices_min=self.n_slices_min,
            n_slices_max=self.W_dp, mode=mode, noise=dp_noise,
            generator=self._block_gen)

    def _candidate_log_margs(self, blk: Block, w_b: torch.Tensor,
                             exact: bool = False) -> torch.Tensor:
        """Stage 2's scorer: [B, N_max, W_dp] log marginals of every
        candidate span of the block under mixture weights ``w_b`` (kernel
        K1; K5, in its exact composition with ``exact``, for the diag
        family; K8 for the full one)."""
        am = self.acoustic_model
        B = blk.idx.shape[0]
        N_max, W_dp = self.utterances.N_max, self.W_dp
        Xc, prior_c = self._cand_X[blk.idx], self._cand_lp[blk.idx]
        valid_m = blk.lengths * W_dp
        if self._family == "full":
            log_margs = fullcov_log_margs(
                Xc, prior_c, *fullcov_score_inputs(blk.params_g, blk.touched),
                w_b, blk.lo_counts, valid_m=valid_m)
        elif self._family == "diag":
            muT, inv_varT, lpv, v = am.cov.predictive_params_T(
                am.prior, blk.lo_counts, blk.sum_xT, blk.sum_sqT)
            log_margs = diag_log_margs_T(
                Xc, prior_c, muT, inv_varT, lpv, v, w_b, blk.lo_counts,
                valid_m=valid_m, exact=exact)
        else:
            muT, precT = am.cov.predictive_params_T(am.prior, blk.lo_counts,
                                                    blk.sum_xT)
            log_margs = fixedvar_log_margs_T(
                Xc, prior_c, muT.contiguous(), precT.contiguous(), w_b,
                blk.lo_counts, valid_m=valid_m)
        return log_margs.reshape(B, N_max, W_dp)

    def _new_segments(self, blk: Block, new_bounds: torch.Tensor):
        """The segments of ``new_bounds``: (embedding ids [B, N_max], their
        vectors [B, N_max, D], their prior log densities [B, N_max])."""
        am = self.acoustic_model
        new_embeds, _ = gather_block_segments(new_bounds, blk.lengths,
                                              blk.seg_ids)
        rows = new_embeds.clamp_min(0).long()
        return new_embeds, am.X[rows], am.log_prior_vec[rows]

    def _chain_noise(self, chain_noise: Optional[torch.Tensor],
                     B: int) -> torch.Tensor:
        """The chain's [B, N_max, K] Gumbel noise, drawn when not given."""
        if chain_noise is not None:
            return chain_noise
        am = self.acoustic_model
        return gumbel((B, self.utterances.N_max, am.K_max),
                      self._block_gen, self.device, am.X.dtype)

    def _full_chain(self, blk: Block, new_embeds, Xe_new, noise, alpha,
                    lms, temp, use_argmax=False, lm=None) -> torch.Tensor:
        """Stage 3 for the full family: the global predictive scores of the
        new segments (a plain float32 matmul with TF32 off, as the JAX
        package leaves it to XLA), then kernel K9 (``lm``: its bigram mode,
        see ``fullcov.fullcov_chain``)."""
        am = self.acoustic_model
        base = am.cov.log_post_pred_batch(
            blk.params_g, Xe_new.reshape(-1, Xe_new.shape[-1])).reshape(
                noise.shape)
        return fullcov_chain(am.prior, am.X, blk.params_g, am.stats.counts,
                             blk.lo_counts, blk.touched, new_embeds, base,
                             noise, am.log_prior_vec, alpha, am.K_max, lms,
                             temp, use_argmax=use_argmax, lm=lm,
                             k0_v0=self._k0_v0)

    def _merge(self, blk: Block, new_bounds: torch.Tensor,
               new_embeds: torch.Tensor, Xe_new: torch.Tensor,
               new_ks: torch.Tensor, log_prob: torch.Tensor, lm_delta=None):
        """Stage 4: cross-utterance decollision of new components, then the
        merge of statistics, boundaries and assignments into the global
        state.  ``lm_delta(old_ks, new_ks, valid)`` (the bigram segmenter)
        gives further integer deltas of the merged rows, summed like the
        statistics.  Returns (the block's summed ``log_prob``, the list of
        ``lm_delta``'s tensors).

        On a mesh: the exact mode gathers the whole block's segments,
        components, boundary rows and log probabilities, and every rank
        merges the whole block as one device would (the JAX package's
        GSPMD mode).  The per-shard mode sums the ranks' deltas and log
        probabilities (``Shard.sum_ranks``, the JAX package's ``psum``,
        ``unigram.py:1037-1046``) and leaves the assignments to the
        sweep's merge (``parallel/shard_sweep.py``)."""
        am, utt, sh = self.acoustic_model, self.utterances, self._shard
        X, K, stats = am.X, am.K_max, am.stats
        exact = blk.full is not None
        # the JAX package's gate, ``decollide and B > 1``: B is the rows a
        # block step samples, so the per-shard mode's B/n; the exact mode
        # decollides the whole block
        if self.decollide_new and (blk.full[0] if exact
                                   else blk.valid).shape[0] > 1:
            new_ks = decollide_new_components(
                new_ks, (new_embeds >= 0) & blk.valid[:, None], blk.lo_counts,
                stats.counts, comm=sh)
        if exact:
            idx, valid, live, _ = blk.full
            old_embeds, new_embeds, new_ks, new_bounds, log_prob = \
                sh.gather_rows(blk.old_embeds, new_embeds, new_ks, new_bounds,
                               log_prob)
            old_rows = old_embeds.clamp_min(0).long()
            old_ks = torch.where(old_embeds >= 0, am.assignments[old_rows],
                                 -1)
            Xe_old, Xe_new = X[old_rows], X[new_embeds.clamp_min(0).long()]
        else:
            idx, valid, live = blk.idx, blk.valid, blk.live
            old_embeds, old_ks, Xe_old = (blk.old_embeds, blk.old_ks,
                                          blk.Xe_old)
        old_flat = flat_contrib(X, old_embeds, old_ks, K, valid, rows=Xe_old,
                                full_cov=am.full_cov)
        new_flat = flat_contrib(X, new_embeds, new_ks, K, valid, rows=Xe_new,
                                full_cov=am.full_cov)
        lp = torch.where(valid, log_prob, 0.0).sum()
        extra = list(lm_delta(old_ks, new_ks, valid)) if lm_delta else []
        per_shard = sh is not None and sh.per_shard
        if per_shard:  # one collective a dtype for the whole block
            summed = sh.sum_ranks([n - o for n, o in zip(new_flat, old_flat)]
                                  + [lp] + extra)
            lp, extra = summed[3], summed[4:]
            am.stats = SuffStats(*(g + d for g, d in zip(stats, summed[:3])))
        else:
            am.stats = merge_flat(stats, old_flat, new_flat)
        utt.boundaries_dev[idx[live]] = new_bounds[live]
        if per_shard:
            sh.updates.append((valid, old_embeds, new_embeds, new_ks))
        else:
            put_assignments(am._assign_pad, valid, old_embeds, new_embeds,
                            new_ks)
        return lp, extra
