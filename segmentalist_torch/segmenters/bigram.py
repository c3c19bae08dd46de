"""Bigram acoustic word segmentation, with fixed-variance, diagonal- or
full-covariance components.

Counterpart of ``segmentalist_tpu/segmenters/bigram.py`` (reference
``BigramAcousticWordseg``, ``bigram_acoustic_wordseg.py:32-722``): boundary
resampling uses unigram marginal scores and the unigram FFBS (the
reference's native bigram DP is an unimplemented stub,
``bigram_acoustic_wordseg.py:694-695, :728-758``; ``fb_type="bigram"`` is
accepted and raises at sampling), while component assignments are
resampled sequentially along each utterance, conditioning on the previous
segment's component through the smoothed bigram LM
(``gibbs_sample_inside_loop_i_embed``, ``:332-384``).

One block step (:meth:`BigramAcousticWordseg.block_step`) follows the JAX
package's ``_make_block_step`` (``bigram.py:953-1278``) stage by stage,
sharing every stage but the chain with the unigram segmenter
(``segmenters/blocked.py``): the scorer (K1; K5 for the diag family, K8 for
full) takes the LM's leave-out unigram weights, the chain is kernel K4 (K7
for diag, K9's bigram mode for full), and the LM count tables take the
block's signed count delta after the acoustic merge.  The LM is read
before the merge, so its tables count every old pair the chain removes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.bigram_fbgmm import BigramFBGMM
from ..models.bigram_lm import (
    BigramLMState,
    BigramSmoothLM,
    add_block_counts,
    apply_delta,
    block_count_delta,
    empty_lm_state,
    log_prob_vec_i,
    prob_vec_given_j,
    transcript_pairs_batch,
)
from ..models import cov_module
from ..models.fbgmm import log_weights
from ..ops.cuda_chain import bigram_fixedvar_chain
from ..ops.cuda_diag_chain import bigram_diag_chain
from ..ops.random import annealed_gumbel_max, gumbel, logsumexp
from ..ops.stats import add_item, canonicalize_new_component, num_active
from ..utils import debug as dbg
from ..utils.annealing import anneal_temperatures
from .blocked import BlockedWordseg
from .common import gather_block_segments
from .unigram import _dense_to_tri


def _self_ranks(keys: torch.Tensor) -> torch.Tensor:
    """rank[g, t] = #{s < t : keys[g, s] == keys[g, t]} for G independent
    key rows in one stable sort: within a run of equal keys the rank is the
    offset from the run's start, scattered back by position."""
    G, T = keys.shape
    iota = torch.arange(T, device=keys.device)[None, :].expand(G, T)
    sk, sp = torch.sort(keys, dim=1, stable=True)
    first = torch.cat([torch.ones((G, 1), dtype=torch.bool,
                                  device=keys.device),
                       sk[:, 1:] != sk[:, :-1]], dim=1)
    start = torch.cummax(torch.where(first, iota, 0), dim=1).values
    return torch.zeros_like(sp).scatter_(1, sp, iota - start)


def log_prob_z_replay(transcripts: torch.Tensor, intrp_lambda, a, b, K: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Corpus log P(z) under the bigram LM, replayed utterance by utterance
    in order (reference ``log_prob_z``, bigram_acoustic_wordseg.py:287-305),
    computed in parallel: the counts each token sees are ranks among equal
    keys in replay order (the JAX package's sort-based replay,
    ``segmenters/bigram.py:742-810``).  ``transcripts`` [U, S] (-1 pads)."""
    U, S = transcripts.shape
    pj, pi, prev_pos = transcript_pairs_batch(transcripts,
                                              return_prev_pos=True)
    flat_j = pj.reshape(-1).long()
    flat_i = pi.reshape(-1).long()
    valid = flat_i >= 0
    has_prev = flat_j >= 0
    v = valid.long()
    n_before = torch.cumsum(v, 0) - v
    i_s, j_s = flat_i.clamp_min(0), flat_j.clamp_min(0)
    # Token keys (unigram numerator) and pair keys (bigram numerator).  The
    # bigram denominator, #{tokens j before the pair}, is the previous
    # token's own unigram rank + 1: the pair directly follows it.
    tok_key = torch.where(valid, i_s, K)
    pair_key = torch.where(valid & has_prev, j_s * K + i_s, K * K)
    rank_uni, rank_big = _self_ranks(torch.stack([tok_key, pair_key]))
    r_u_prev = rank_uni.reshape(U, S).gather(
        1, prev_pos.clamp_min(0).long()).reshape(-1)
    p_uni = (rank_uni.to(dtype) + a / K) / (n_before.to(dtype) + a)
    p_big = (rank_big.to(dtype) + b / K) / ((r_u_prev + 1).to(dtype) + b)
    p = torch.where(has_prev,
                    intrp_lambda * p_uni + (1.0 - intrp_lambda) * p_big,
                    p_uni)
    return torch.where(valid, torch.log(p), 0.0).sum()


class BigramAcousticWordseg(BlockedWordseg):
    """Bigram word segmentation of speech using acoustic word embeddings
    (constructor parity with the JAX package and
    ``bigram_acoustic_wordseg.py:129-256``, plus ``device``).

    ``lm_params``: ``{"type": "smooth", "intrp_lambda", "a", "b"}``.
    ``covariance_type``: "fixed", "diag" or "full".
    ``seed`` seeds the initialisation, the per-sweep utterance order and
    the sampling noise, as in :class:`UnigramAcousticWordseg`.
    """

    def __init__(self, am_K, am_param_prior, lm_params, embedding_mats,
                 vec_ids_dict, durations_dict, landmarks_dict,
                 seed_boundaries_dict=None, seed_assignments_dict=None,
                 covariance_type="fixed", n_slices_min=0, n_slices_max=20,
                 min_duration=0, p_boundary_init=0.5, beta_sent_boundary=2.0,
                 lms=1.0, wip=0.0, fb_type="bigram",
                 init_am_assignments="rand", time_power_term=1.0,
                 batch_size: Optional[int] = None, seed: int = 0,
                 decollide_new: bool = True, device="cuda"):
        cov_module(covariance_type)  # an unknown family raises first
        if lm_params["type"] != "smooth":
            raise ValueError("invalid LM type: %r" % (lm_params["type"],))
        self.lms = float(lms)
        self.set_fb_type(fb_type)
        embeddings, assignments, am_K = self._init_corpus(
            am_K, embedding_mats, vec_ids_dict, durations_dict,
            landmarks_dict, seed_boundaries_dict, seed_assignments_dict,
            n_slices_min, n_slices_max, min_duration, p_boundary_init,
            beta_sent_boundary, wip, time_power_term, init_am_assignments,
            seed, decollide_new, device)
        self.lm = BigramSmoothLM(lm_params["intrp_lambda"], lm_params["a"],
                                 lm_params["b"], am_K, device=self.device)
        self.acoustic_model = BigramFBGMM(
            torch.as_tensor(embeddings, device=self.device), am_param_prior,
            am_K, assignments, covariance_type=covariance_type, lms=lms,
            lm=self.lm, seed=seed, device=self.device)
        self._init_sampler(batch_size, seed)
        self.set_lm_counts()

    # ------------------------------------------------------------------ API

    def set_fb_type(self, fb_type: str):
        # The reference's bigram forward-backward is a stub
        # (bigram_acoustic_wordseg.py:728-758); only the unigram DP works.
        # Both values are accepted; "bigram" raises at sampling time.
        if fb_type not in ("bigram", "unigram"):
            raise ValueError("invalid `fb_type`: " + fb_type)
        self.fb_type = fb_type

    def set_lm_counts(self):
        """LM counts of the current transcripts (reference
        ``set_lm_counts``, bigram_acoustic_wordseg.py:271-285)."""
        ts = self._all_transcripts()
        self.lm.state = add_block_counts(
            empty_lm_state(self.lm.K, self.device), ts,
            torch.ones(ts.shape[0], dtype=torch.bool, device=self.device))

    def _all_transcripts(self) -> torch.Tensor:
        """[U, N_max] padded component transcripts of every utterance (in
        the per-shard mode gathered from the ranks' own rows; a mesh's dead
        rows sliced off)."""
        utt, am, sh = self.utterances, self.acoustic_model, self._shard
        embeds, _ = gather_block_segments(utt.boundaries_dev, utt.lengths_dev,
                                          utt.seg_ids)
        ts = torch.where(embeds >= 0,
                         am.assignments[embeds.clamp_min(0).long()], -1)
        if sh is not None and sh.per_shard:
            ts = sh.all_gather(ts).reshape(-1, ts.shape[1])
        return ts[:utt.D]

    def _log_prob_z(self) -> torch.Tensor:
        lm = self.lm
        return log_prob_z_replay(self._all_transcripts(), lm.intrp_lambda,
                                 lm.a, lm.b, lm.K, self.acoustic_model.X.dtype)

    def log_prob_z(self) -> float:
        """Sequential-replay bigram assignment probability (reference
        ``log_prob_z``, bigram_acoustic_wordseg.py:287-305)."""
        return float(self._log_prob_z())

    def log_marg(self) -> float:
        return self.log_prob_z() + self.acoustic_model.log_prob_X_given_z()

    def sweep_metrics(self) -> dict:
        """The record quantities of the current state, in one fetch."""
        am = self.acoustic_model
        lpz, lpx, k_act, n_assigned = torch.stack([
            v.to(torch.float64) for v in (
                self._log_prob_z(), am.cov.log_marg(am.prior, am.stats),
                num_active(am.stats), (am.assignments >= 0).sum())
        ]).tolist()
        return {"log_prob_z": lpz, "log_prob_X_given_z": lpx,
                "log_marg": lpz + lpx, "components": int(k_act),
                "n_assigned": int(n_assigned)}

    def _lm_leave_out(self, blk) -> torch.Tensor:
        """[B, K] the LM's unigram counts without each utterance's own."""
        return self.lm.state.unigram_counts[None] - blk.own_counts

    def _candidate_weights(self, blk) -> torch.Tensor:
        """[B, K] mixture-weight terms of a block's candidate scores: the
        LM's leave-out unigram weights."""
        am = self.acoustic_model
        return log_weights(self._lm_leave_out(blk), self.lm.a, am.K_max,
                           self.lms, include_denominator=True,
                           dtype=am.X.dtype)

    VALIDATION_CHECKS = dbg.BIGRAM_CHECKS

    def _validate_device(self) -> torch.Tensor:
        """The invariant flags of ``BIGRAM_CHECKS``: the FBGMM's and the LM
        tables' (the JAX package's ``bigram.py:578-592``)."""
        am, utt = self.acoustic_model, self.utterances
        return dbg.bigram_validation_flags(am.stats, am.assignments,
                                           utt.boundaries_dev,
                                           utt.lengths_dev, self.lm.state)

    def _unigram_lm_weights(self) -> torch.Tensor:
        lm = self.lm
        return self.lms * log_prob_vec_i(lm.state, lm.a, lm.K,
                                         self.acoustic_model.X.dtype)

    def log_marg_i_embed_unigram(self, i_embed: int) -> float:
        """Unigram marginal of one held-out embedding under the LM's
        unigram weights (reference ``log_marg_i_embed_unigram``,
        bigram_acoustic_wordseg.py:314-329)."""
        am = self.acoustic_model
        params = am.cov.predictive_params(am.prior, am.stats)
        post = am.cov.log_post_pred(params, am.X[i_embed])
        logits = self._unigram_lm_weights() + torch.where(
            am.stats.counts > 0, post, am.log_prior_vec[i_embed])
        return float(logsumexp(logits))

    def get_vec_embed_log_probs_unigram(self, vec_ids,
                                        durations) -> np.ndarray:
        """Duration-scaled unigram-marginal candidate scores in the
        reference's packed triangular layout (reference
        ``get_vec_embed_log_probs_unigram``,
        bigram_acoustic_wordseg.py:673-692), against the current state."""
        vec_ids = np.asarray(vec_ids)
        durations = np.asarray(durations, dtype=float)
        out = np.full(len(vec_ids), -np.inf)
        valid = vec_ids != -1
        if valid.any():
            am = self.acoustic_model
            ids = torch.as_tensor(vec_ids[valid].astype(np.int64),
                                  device=self.device)
            params = am.cov.predictive_params(am.prior, am.stats)
            post = am.cov.log_post_pred_batch(params, am.X[ids])
            logits = self._unigram_lm_weights()[None, :] + torch.where(
                (am.stats.counts > 0)[None, :], post,
                am.log_prior_vec[ids][:, None])
            out[valid] = logsumexp(logits, dim=-1).cpu().numpy()
        nan_dur = np.isnan(durations)
        out[nan_dur & valid] = -np.inf
        ok = valid & ~nan_dur
        out[ok] = out[ok] * durations[ok] ** self.time_power_term
        return out + self.wip

    def get_vec_embed_log_probs_unigram_all(self, utt_ids=None) -> list:
        """:meth:`get_vec_embed_log_probs_unigram` for many utterances at
        once (the JAX package's ``bigram.py:296``), as
        ``UnigramAcousticWordseg.get_vec_embed_log_probs_all`` with the
        LM's unigram weights."""
        return _dense_to_tri(*self._dense_candidate_scores(
            utt_ids, self._unigram_lm_weights()))

    def get_vec_embed_log_probs_bigram(self, vec_ids, durations):
        """The reference's bigram candidate scorer is an unimplemented stub
        (``get_vec_embed_log_probs_bigram``,
        bigram_acoustic_wordseg.py:694-695, body ``pass``)."""
        raise NotImplementedError(
            "bigram candidate scoring is an unimplemented stub in the "
            "reference (bigram_acoustic_wordseg.py:694-695); use "
            "get_vec_embed_log_probs_unigram (fb_type='unigram')")

    def gibbs_sample_inside_loop_i_embed(
            self, i_embed: int, j_prev_assignment: int = -1,
            anneal_temp: float = 1.0,
            noise: Optional[torch.Tensor] = None) -> int:
        """Sample a component for one (unassigned) embedding conditioned on
        the previous segment's component through the bigram LM, and add it
        to the acoustic model (reference
        ``gibbs_sample_inside_loop_i_embed``,
        bigram_acoustic_wordseg.py:332-384).  ``noise`` [K] is the standard
        Gumbel noise of the draw (drawn from the segmenter's generator when
        None).  Returns the sampled component.

        The LM count tables are not updated here, like the reference, which
        re-adds an utterance's counts only after the whole utterance
        (``:496``)."""
        am, lm = self.acoustic_model, self.lm
        dtype = am.X.dtype
        if j_prev_assignment is not None and int(j_prev_assignment) >= 0:
            w = self.lms * torch.log(prob_vec_given_j(
                lm.state, int(j_prev_assignment), lm.intrp_lambda, lm.a,
                lm.b, lm.K, dtype))
        else:
            w = self._unigram_lm_weights()
        params = am.cov.predictive_params(am.prior, am.stats)
        post = am.cov.log_post_pred(params, am.X[i_embed])
        logits = w + torch.where(am.stats.counts > 0, post,
                                 am.log_prior_vec[i_embed])
        if noise is None:
            noise = gumbel((am.K_max,), self._gen, self.device, dtype)
        k = canonicalize_new_component(
            am.stats.counts, annealed_gumbel_max(logits, noise, anneal_temp))
        am.stats = add_item(am.stats, am.X[i_embed], k, am.full_cov)
        am.assignments[i_embed] = k.to(am.assignments.dtype)
        return int(k)

    # ------------------------------------------------------------- sampling

    def gibbs_sample_i(self, i: int, anneal_temp: float = 1.0,
                       anneal_gibbs_am: bool = False,
                       assignments_only: bool = False) -> float:
        """Resample utterance ``i`` alone (one padded block), through the
        sweep's block runner (in the per-shard mode: on the rank that owns
        it, with the sweep's assignment merge)."""
        order = np.full((1, self.batch_size), -1, dtype=np.int64)
        order[0, 0] = i
        return float(self._run_blocks(
            order, anneal_temp, anneal_temp if anneal_gibbs_am else 1.0,
            assignments_only=assignments_only))

    def gibbs_sample(self, n_iter: int, am_n_iter: int = 0,
                     anneal_schedule=None, anneal_start_temp_inv: float = 0.1,
                     anneal_end_temp_inv: float = 1.0,
                     n_anneal_steps: int = -1, anneal_gibbs_am: bool = False,
                     assignments_only: bool = False, monitor_i=None,
                     validate: bool = False) -> dict:
        """Blocked Gibbs sampling over all utterances (reference
        ``gibbs_sample``, bigram_acoustic_wordseg.py:553-670); returns the
        reference's 8-key record dict.  ``assignments_only`` keeps the
        boundaries and resamples the components only.

        ``monitor_i`` / ``validate``: a per-sweep trace of one utterance
        (its unigram-marginal candidate scores, boundaries and transcript)
        and the sampler-invariant checks, the LM tables' included (the
        reference's traces, bigram_acoustic_wordseg.py:24, :400-407, and
        NaN asserts, :368; see ``utils/debug.py``)."""
        if am_n_iter > 0:
            raise NotImplementedError(
                "am_n_iter > 0: the reference asserts to-do here "
                "(bigram_acoustic_wordseg.py:634-638)")
        if self.fb_type == "bigram" and not assignments_only:
            raise NotImplementedError(
                "fb_type='bigram' segmentation: the reference's bigram DP is "
                "an unimplemented stub (bigram_acoustic_wordseg.py:694-695, "
                ":728-758); use fb_type='unigram' as its recipes do")
        temps = anneal_temperatures(n_iter, anneal_schedule,
                                    anneal_start_temp_inv,
                                    anneal_end_temp_inv, n_anneal_steps)
        return self._sample_sweeps(temps, anneal_gibbs_am,
                                   monitor_i=monitor_i, validate=validate,
                                   assignments_only=assignments_only)

    def block_step(self, idx_blk, anneal_temp: float = 1.0,
                   assign_temp: float = 1.0,
                   dp_noise: Optional[torch.Tensor] = None,
                   chain_noise: Optional[torch.Tensor] = None,
                   assignments_only: bool = False) -> torch.Tensor:
        """Resample one block of utterances in place (the JAX package's
        bigram ``block_step``, ``bigram.py:953-1278``).

        ``idx_blk`` [B] host ints: utterance ids, -1 for padding.
        ``dp_noise`` [B, N_max, W_dp] and ``chain_noise`` [B, N_max, K] are
        the standard Gumbel noises of the DP's backward draws and of the
        assignment chain (drawn from the segmenter's generator when None).
        ``assignments_only`` keeps the boundaries.  Returns the block's
        summed DP log probability (a device scalar).
        """
        am, lm = self.acoustic_model, self.lm
        X, K, prior = am.X, am.K_max, am.prior

        # 1. old segments, their LM pairs and the leave-outs
        blk = self._leave_out(idx_blk, split=True)
        dp_noise, chain_noise = self._own_noise(
            blk, dp_noise, chain_noise, not assignments_only)
        pairs_old = transcript_pairs_batch(blk.old_ks)
        uni_lo = self._lm_leave_out(blk)

        # 2. scoring with the LM's unigram weights (K1 / K5 / K8),
        # boundaries (K2)
        if assignments_only:
            log_prob = torch.zeros(blk.idx.shape[0], dtype=X.dtype,
                                   device=self.device)
            new_bounds = self.utterances.boundaries_dev[blk.idx]
        else:
            log_prob, new_bounds = self._resample_boundaries(
                blk, self._candidate_weights(blk), anneal_temp, "sample",
                dp_noise)

        # 3. bigram-conditioned assignment chains (kernel K4 / K7 / K9)
        new_embeds, Xe_new, lpe_new = self._new_segments(blk, new_bounds)
        noise = self._chain_noise(chain_noise, blk.idx.shape[0])
        data = (new_embeds, Xe_new, lpe_new, noise, blk.lo_counts,
                blk.sum_xT)
        lm_args = (uni_lo, lm.state.bigram_counts, *pairs_old)
        opts = dict(alpha_a=lm.a, intrp_lambda=lm.intrp_lambda,
                    b_smooth=lm.b, K=K, lms=self.lms)
        if self._family == "full":
            new_ks = self._full_chain(
                blk, new_embeds, Xe_new, noise, 0.0, self.lms, assign_temp,
                lm=(*lm_args, lm.a, lm.intrp_lambda, lm.b))
        elif self._family == "diag":
            new_ks = bigram_diag_chain(
                *data, blk.sum_sqT, prior.m_0, *self._k0_v0, prior.S_0,
                assign_temp, *lm_args, **opts)
        else:
            new_ks = bigram_fixedvar_chain(
                *data, prior.var, prior.var_0, prior.mu_0, assign_temp,
                *lm_args, **opts)

        # 4. decollision, the acoustic merge, then the LM count delta
        def lm_delta(old_ks, new_ks, valid):
            # the exact mode merges the gathered block, whose old pairs are
            # not this step's
            pairs = pairs_old if old_ks is blk.old_ks else None
            return block_count_delta(old_ks, new_ks, valid, K,
                                     pairs_old=pairs)

        lp, delta = self._merge(blk, new_bounds, new_embeds, Xe_new, new_ks,
                                log_prob, lm_delta)
        lm.state = apply_delta(lm.state, BigramLMState(*delta))
        return lp


if __name__ == "__main__":  # smoke demo (reference bigram_acoustic_wordseg.py:765-857)
    from segmentalist_torch.demos import run_demo

    run_demo("bigram_seg")
