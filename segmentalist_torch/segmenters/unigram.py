"""Unigram acoustic word segmentation, fixed-variance components.

Counterpart of ``segmentalist_tpu/segmenters/unigram.py`` (reference
``UnigramAcousticWordseg``, ``unigram_acoustic_wordseg.py:27-564``):
blocked Gibbs sampling that alternates, per block of utterances,

  (a) boundary resampling by forward-filtering backward-sampling over
      duration-scaled candidate log marginals, and
  (b) sequential component reassignment of the new segments.

One block step (:meth:`UnigramAcousticWordseg.block_step`) follows the JAX
package's ``_make_block_step`` (``unigram.py:785-1057``) stage by stage and
runs the three hand-written kernels on a CUDA device: the fused scorer
(K1), the DP forward filter (K2) and the assignment chain (K3).  All state
lives on the segmenter's ``device``; sampling noise comes from a
``torch.Generator`` seeded from ``seed``, or is injected by the caller.

Within a sweep each utterance is visited once and reads only its own
assignments, so the ``[N]`` assignment vector is updated in place after
every block (the JAX package defers that merge to the end of the sweep;
the result is the same).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..corpus import Utterances
from ..device import resolve_device
from ..models import components_fixedvar as cfv
from ..models.fbgmm import FBGMM, log_weights
from ..ops.cuda_chain import fixedvar_chain
from ..ops.cuda_score import fixedvar_log_margs_T
from ..ops.dp import segment_dp
from ..ops.random import gumbel
from ..utils.annealing import anneal_temperatures
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
    seed_assignments_to_vector,
)

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


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on CUDA through pinned memory, so the
    copy is asynchronous and does not stall the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class UnigramAcousticWordseg:
    """Unigram word segmentation of speech using acoustic word embeddings.

    Constructor parameters mirror the JAX package (and the reference,
    ``unigram_acoustic_wordseg.py:118-125``); ``am_class`` is accepted for
    signature parity and the fixed-variance FBGMM is always used.

    batch_size : utterances resampled per blocked-Gibbs step (default
        ``min(64, U)``).
    seed : seeds the host RNG of the initialisation (the draws the JAX
        package takes from numpy's global RNG, in the same order), the host
        RNG of the per-sweep utterance order, and the device generator of
        the sampling noise.
    device : where the state lives and the kernels run ("cpu" runs the
        plain PyTorch versions of the kernels).
    """

    def __init__(self, am_class, am_alpha, am_K, am_param_prior,
                 embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
                 seed_boundaries_dict=None, seed_assignments_dict=None,
                 covariance_type="fixed", n_slices_min=0, n_slices_max=20,
                 min_duration=0, p_boundary_init=0.5, beta_sent_boundary=2.0,
                 lms=1.0, wip=0.0, fb_type="standard",
                 init_am_assignments="rand", time_power_term=1.0,
                 batch_size: Optional[int] = None, seed: int = 0,
                 decollide_new: bool = True, device="cpu"):
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
        self.set_fb_type(fb_type)

        embeddings, vec_ids, labels = process_embeddings(embedding_mats,
                                                         vec_ids_dict)
        self.ids_to_utterance_labels = labels
        N = embeddings.shape[0]
        init_rng = np.random.RandomState(seed)
        seed_boundaries = (None if seed_boundaries_dict is None else
                           [seed_boundaries_dict[i] for i in labels])
        self.utterances = Utterances(
            [len(landmarks_dict[i]) for i in labels], vec_ids,
            [durations_dict[i] for i in labels],
            [landmarks_dict[i] for i in labels],
            seed_boundaries=seed_boundaries, p_boundary_init=p_boundary_init,
            n_slices_min=n_slices_min, n_slices_max=n_slices_max,
            min_duration=min_duration, rng=init_rng, device=self.device,
        )

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
        elif init_am_assignments == "one-by-one":
            raise NotImplementedError(
                "init_am_assignments='one-by-one' needs FBGMM's sequential "
                "Gibbs step, which segmentalist_torch does not port yet")
        else:
            raise ValueError("invalid value for `init_am_assignments`: "
                             + str(init_am_assignments))
        self.acoustic_model = FBGMM(
            torch.as_tensor(embeddings, device=self.device), am_param_prior,
            am_alpha, am_K, assignments, covariance_type=covariance_type,
            lms=lms, device=self.device)

        self.batch_size = (int(batch_size) if batch_size
                           else min(64, self.utterances.D))
        self._rng = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        utt = self.utterances
        self.W_dp = (min(self.n_slices_max, utt.N_max)
                     if self.n_slices_max > 0 else utt.N_max)
        self._seg_ids_dp = dp_window(utt.seg_ids, self.W_dp)
        self._seg_durs_dp = dp_window(utt.seg_durations, self.W_dp)
        self.refresh_candidates()

    # ------------------------------------------------------------------ API

    def set_fb_type(self, fb_type: str):
        if fb_type not in ("standard", "viterbi"):
            raise ValueError("invalid `fb_type`: " + fb_type)
        self.fb_type = fb_type
        self._dp_mode = "sample" if fb_type == "standard" else "viterbi"

    def refresh_candidates(self):
        """Rebuild the sweep-static candidate tensors ``X[seg_ids]`` and
        ``log_prior_vec[seg_ids]`` (after replacing ``acoustic_model.X``)."""
        am = self.acoustic_model
        self._cand_X, self._cand_lp = cand_tables(
            self._seg_ids_dp, am.X, am.log_prior_vec)

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

    def get_vec_embed_log_probs(self, vec_ids, durations) -> np.ndarray:
        """Duration-scaled candidate log marginals in the reference's packed
        triangular layout (reference unigram_acoustic_wordseg.py:474-511),
        scored against the current model state."""
        vec_ids = np.asarray(vec_ids)
        durations = np.asarray(durations, dtype=float)
        out = np.full(len(vec_ids), -np.inf)
        valid = vec_ids != -1
        if valid.any():
            out[valid] = self.acoustic_model.log_marg_batch(
                vec_ids[valid].astype(np.int64)).cpu().numpy()
        nan_dur = np.isnan(durations)
        out[nan_dur & valid] = -np.inf
        ok = valid & ~nan_dur
        out[ok] = out[ok] * durations[ok] ** self.time_power_term
        return out + self.wip

    # ------------------------------------------------------------- sampling

    def gibbs_sample(self, n_iter: int, anneal_schedule=None,
                     anneal_start_temp_inv: float = 0.1,
                     anneal_end_temp_inv: float = 1.0,
                     n_anneal_steps: int = -1,
                     anneal_gibbs_am: bool = False) -> dict:
        """Blocked Gibbs sampling over all utterances (reference
        ``gibbs_sample``, unigram_acoustic_wordseg.py:362-472): every sweep
        visits the utterances in a fresh host permutation, in blocks of
        ``batch_size``.  Returns the reference's 8-key record dict."""
        temps = anneal_temperatures(n_iter, anneal_schedule,
                                    anneal_start_temp_inv,
                                    anneal_end_temp_inv, n_anneal_steps)
        record = {k: [] for k in RECORD_KEYS}
        am = self.acoustic_model
        for i_iter in range(n_iter):
            t0 = time.time()
            temp = float(temps[i_iter])
            assign_temp = temp if anneal_gibbs_am else 1.0
            blocks = pad_utterance_order(
                self._rng.permutation(self.utterances.D), self.batch_size)
            log_prob = sum(self.block_step(blk, temp, assign_temp)
                           for blk in blocks)
            m = am.metrics_to_dict(am.sweep_metrics_device())
            record["log_marg"].append(m["log_marg"])
            record["log_marg*length"].append(float(log_prob))
            record["log_prob_z"].append(m["log_prob_z"])
            record["log_prob_X_given_z"].append(m["log_prob_X_given_z"])
            record["anneal_temp"].append(temp)
            record["components"].append(m["components"])
            record["n_tokens"].append(m["n_assigned"])
            record["sample_time"].append(time.time() - t0)
            logger.info("iteration: %d, log_marg: %s", i_iter,
                        record["log_marg"][-1])
        return record

    def block_step(self, idx_blk, anneal_temp: float = 1.0,
                   assign_temp: float = 1.0,
                   dp_noise: Optional[torch.Tensor] = None,
                   chain_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Resample one block of utterances in place.

        ``idx_blk`` [B] host ints: utterance ids, -1 for padding.
        ``dp_noise`` [B, N_max, W_dp] and ``chain_noise`` [B, N_max, K] are
        the standard Gumbel noises of the DP's backward draws and of the
        assignment chain (drawn from the segmenter's generator when None).
        Returns the block's summed DP log probability (a device scalar).
        """
        am, utt, dev = self.acoustic_model, self.utterances, self.device
        X, K, prior = am.X, am.K_max, am.prior
        N_max, W_dp = utt.N_max, self.W_dp
        idx_np = np.asarray(idx_blk, dtype=np.int64)
        B = idx_np.shape[0]
        live_np = np.nonzero(idx_np >= 0)[0]
        packed = _to_device(np.concatenate([idx_np, live_np]), dev)
        valid = packed[:B] >= 0
        idx = packed[:B].clamp_min(0)
        live = packed[B:]
        lengths_blk = torch.where(valid, utt.lengths_dev[idx], 0)
        seg_ids_blk = utt.seg_ids[idx]
        stats = am.stats

        # 1. current segments and leave-one-utterance-out statistics
        old_embeds, _ = gather_block_segments(utt.boundaries_dev[idx],
                                              lengths_blk, seg_ids_blk)
        old_ok = old_embeds >= 0
        old_rows = old_embeds.clamp_min(0).long()
        old_ks = torch.where(old_ok, am.assignments[old_rows], -1)
        Xe_old = X[old_rows]
        lo_counts = stats.counts[None] - counts_contrib(old_ks, old_ok, K)
        sum_xT = leave_out_moments_T(stats, X, old_embeds, old_ks, K,
                                     rows=Xe_old)

        # 2. fused candidate scoring (kernel K1)
        muT, precT = cfv.predictive_params_T(prior, lo_counts, sum_xT)
        w_b = log_weights(lo_counts, am.alpha, K, am.lms,
                          include_denominator=True, dtype=X.dtype)
        log_margs = fixedvar_log_margs_T(
            self._cand_X[idx], self._cand_lp[idx], muT.contiguous(),
            precT.contiguous(), w_b, lo_counts,
            valid_m=lengths_blk * W_dp).reshape(B, N_max, W_dp)
        scores = masked_candidate_scores(
            log_margs, self._seg_ids_dp[idx], self._seg_durs_dp[idx],
            self.time_power_term, self.wip)

        # 3. boundary resampling DP (kernel K2)
        log_prob, new_bounds = segment_dp(
            scores, lengths_blk, self._log_p_continue(stats.counts),
            anneal_temp, n_slices_min=self.n_slices_min, n_slices_max=W_dp,
            mode=self._dp_mode, noise=dp_noise, generator=self._gen)

        # 4. sequential assignment of the new segments (kernel K3)
        new_embeds, _ = gather_block_segments(new_bounds, lengths_blk,
                                              seg_ids_blk)
        new_rows = new_embeds.clamp_min(0).long()
        Xe_new = X[new_rows]
        if chain_noise is None:
            chain_noise = gumbel((B, N_max, K), self._gen, dev, X.dtype)
        viterbi = self.fb_type == "viterbi"
        new_ks = fixedvar_chain(
            new_embeds, Xe_new, am.log_prior_vec[new_rows], chain_noise,
            lo_counts, sum_xT, prior.var, prior.var_0, prior.mu_0,
            assign_temp, alpha=am.alpha, K=K,
            lms=1.0 if viterbi else am.lms, use_argmax=viterbi)

        # 4b. cross-utterance new-component decollision
        if self.decollide_new and B > 1:
            new_ks = decollide_new_components(
                new_ks, (new_embeds >= 0) & valid[:, None], lo_counts,
                stats.counts)

        # 5. merge into the global state
        old_flat = flat_contrib(X, old_embeds, old_ks, K, valid, rows=Xe_old)
        new_flat = flat_contrib(X, new_embeds, new_ks, K, valid, rows=Xe_new)
        am.stats = merge_flat(stats, old_flat, new_flat)
        utt.boundaries_dev[idx[live]] = new_bounds[live]
        pad, N = am._assign_pad, am.N
        vm = valid[:, None]
        clear = torch.where(vm & old_ok, old_embeds, N).reshape(-1).long()
        pad.index_put_((clear,), pad.new_full(clear.shape, -1))
        put = torch.where(vm & (new_embeds >= 0), new_embeds, N)
        pad.index_put_((put.reshape(-1).long(),),
                       new_ks.reshape(-1).to(pad.dtype))
        pad[N] = -1
        return torch.where(valid, log_prob, 0.0).sum()
