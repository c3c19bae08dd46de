"""Unigram acoustic word segmentation, with fixed-variance, diagonal- or
full-covariance components.

Counterpart of ``segmentalist_tpu/segmenters/unigram.py`` (reference
``UnigramAcousticWordseg``, ``unigram_acoustic_wordseg.py:27-564``):
blocked Gibbs sampling that alternates, per block of utterances,

  (a) boundary resampling by forward-filtering backward-sampling over
      duration-scaled candidate log marginals, and
  (b) sequential component reassignment of the new segments.

One block step (:meth:`UnigramAcousticWordseg.block_step`) follows the JAX
package's ``_make_block_step`` (``unigram.py:785-1057``) stage by stage and
runs three hand-written kernels on a CUDA device: the fused scorer (K1; K5
for ``covariance_type="diag"``, K8 for "full"), the DP forward filter (K2)
and the assignment chain (K3; K6 for diag, K9 for full).  All state
lives on the segmenter's ``device``; sampling noise comes from a
``torch.Generator`` seeded from ``seed``, or is injected by the caller.

Within a sweep each utterance is visited once and reads only its own
assignments, so the ``[N]`` assignment vector is updated in place after
every block (the JAX package defers that merge to the end of the sweep;
the result is the same).

The module-level DP of the reference (:func:`forward_backward`,
:func:`forward_backward_viterbi`) takes one utterance's scores in the
reference's packed triangular layout (:func:`_tri_to_dense`,
:func:`_dense_to_tri`) and runs ``ops.dp.segment_dp`` on a batch of one:
kernel K2 on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.fbgmm import FBGMM, log_weights
from ..ops.cuda_chain import fixedvar_chain
from ..ops.cuda_diag_chain import diag_chain
from ..ops.dp import segment_dp
from ..utils.annealing import anneal_temperatures
from ..utils.tracing import annotate
from .blocked import RECORD_KEYS, BlockedWordseg

__all__ = ["RECORD_KEYS", "UnigramAcousticWordseg", "forward_backward",
           "forward_backward_viterbi"]


def _tri_to_dense(vec, N, W):
    """One utterance's packed triangular score vector (``corpus.py``'s
    layout) -> dense [1, N, W] float64 scores, -inf where the span would
    start before the utterance."""
    vec = np.asarray(vec, dtype=float)
    out = np.full((1, N, W), -np.inf)
    tg, wg = np.mgrid[0:N, 0:W]
    ok = wg <= tg
    idx = (tg + 1) * tg // 2 + tg - wg
    out[0][ok] = vec[idx[ok]]
    return out


def _dense_to_tri(dense, lengths):
    """Dense [U, N_max, W] scores -> a packed triangular vector an
    utterance (the reference's layout, ``utterances.py:59-65``); slots of
    spans wider than the ``W`` window come back -inf."""
    dense = np.asarray(dense, dtype=float)
    _, N_max, W = dense.shape
    t = np.arange(N_max)
    tt = np.repeat(t, t + 1)  # packed slot -> span end t
    jj = np.concatenate([np.arange(k + 1) for k in t])  # -> span start
    ww = tt - jj  # -> window index (duration - 1)
    ok = ww < W
    out = []
    for u, N in enumerate(lengths):
        T = N * (N + 1) // 2
        vec = np.full(T, -np.inf)
        m = ok[:T]
        vec[m] = dense[u, tt[:T][m], ww[:T][m]]
        out.append(vec)
    return out


def utterance_dp(vec, log_p_continue, N, n_slices_min, n_slices_max,
                 anneal_temp, mode, noise=None, generator=None,
                 device="cuda", dtype=torch.float32):
    """``ops.dp.segment_dp`` on one utterance's packed triangular scores:
    ``(log_prob, boundaries [N] bool numpy)``.  ``noise`` [N, W] is the
    backward draws' standard Gumbel noise (sample mode; drawn from
    ``generator`` when None, or from torch's default generator when that
    is None too)."""
    W = min(n_slices_max, N) if n_slices_max > 0 else N
    dev = resolve_device(device)
    scores = torch.as_tensor(_tri_to_dense(vec, N, W), dtype=dtype,
                             device=dev)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype,
                                device=dev).reshape(1, N, W)
    log_prob, bounds = segment_dp(
        scores, torch.tensor([N], dtype=torch.int32, device=dev),
        log_p_continue, anneal_temp, n_slices_min=n_slices_min,
        n_slices_max=W, mode=mode, noise=noise, generator=generator)
    return float(log_prob[0]), bounds[0].cpu().numpy()


def forward_backward(vec_embed_log_probs, log_p_continue, N, n_slices_min=0,
                     n_slices_max=0, i_utt=None, anneal_temp=1, noise=None,
                     generator=None, device="cuda", dtype=torch.float32):
    """Module-level forward filtering, backward sampling over one
    utterance's packed triangular scores (reference ``forward_backward``,
    unigram_acoustic_wordseg.py:653-756): ``(log_prob, boundaries)``.  The
    JAX package's ``key`` becomes ``noise`` [N, W] (e.g.
    ``jax.random.gumbel`` of that key at that shape) or a
    ``torch.Generator``.  Runs on the card (kernel K2, float32) unless
    ``device`` is "cpu"."""
    return utterance_dp(vec_embed_log_probs, log_p_continue, N,
                        n_slices_min, n_slices_max, anneal_temp, "sample",
                        noise, generator, device, dtype)


def forward_backward_viterbi(vec_embed_log_probs, log_p_continue, N,
                             n_slices_min=0, n_slices_max=0, i_utt=None,
                             anneal_temp=None, device="cuda",
                             dtype=torch.float32):
    """Module-level Viterbi twin (reference ``forward_backward_viterbi``,
    unigram_acoustic_wordseg.py:759-864): ``(log_prob, boundaries)``, ties
    toward shorter segments."""
    return utterance_dp(vec_embed_log_probs, log_p_continue, N,
                        n_slices_min, n_slices_max, 1.0, "viterbi",
                        device=device, dtype=dtype)


class UnigramAcousticWordseg(BlockedWordseg):
    """Unigram word segmentation of speech using acoustic word embeddings.

    Constructor parameters mirror the JAX package (and the reference,
    ``unigram_acoustic_wordseg.py:118-125``); ``am_class`` is accepted for
    signature parity and the port's FBGMM is always used.

    covariance_type : "fixed", "diag" or "full".

    batch_size : utterances resampled per blocked-Gibbs step (default
        ``min(64, U)``).
    seed : seeds the host RNG of the initialisation (the draws the JAX
        package takes from numpy's global RNG, in the same order), the host
        RNG of the per-sweep utterance order, and the device generator of
        the sampling noise.
    device : where the state lives and the kernels run: the CUDA card by
        default (raises when there is none); "cpu" when the caller asks for
        it, which runs the kernels' plain PyTorch versions.
    """

    def __init__(self, am_class, am_alpha, am_K, am_param_prior,
                 embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
                 seed_boundaries_dict=None, seed_assignments_dict=None,
                 covariance_type="fixed", n_slices_min=0, n_slices_max=20,
                 min_duration=0, p_boundary_init=0.5, beta_sent_boundary=2.0,
                 lms=1.0, wip=0.0, fb_type="standard",
                 init_am_assignments="rand", time_power_term=1.0,
                 batch_size: Optional[int] = None, seed: int = 0,
                 decollide_new: bool = True, device="cuda"):
        self.set_fb_type(fb_type)
        self._init_embeds = None
        embeddings, assignments, am_K = self._init_corpus(
            am_K, embedding_mats, vec_ids_dict, durations_dict,
            landmarks_dict, seed_boundaries_dict, seed_assignments_dict,
            n_slices_min, n_slices_max, min_duration, p_boundary_init,
            beta_sent_boundary, wip, time_power_term, init_am_assignments,
            seed, decollide_new, device, one_by_one=True)
        self.acoustic_model = FBGMM(
            torch.as_tensor(embeddings, device=self.device), am_param_prior,
            am_alpha, am_K, assignments, covariance_type=covariance_type,
            lms=lms, seed=seed, device=self.device)
        if self._init_embeds is not None:
            # "one-by-one": each initial segment drawn against the ones
            # before it, in corpus order (the JAX package's
            # gibbs_sample_inside_loop_i loop, unigram.py:238-245): one K10
            # launch with the delete off
            self.acoustic_model.reassign_items(self._init_embeds)
        self._init_sampler(batch_size, seed)

    # ------------------------------------------------------------------ API

    def set_fb_type(self, fb_type: str):
        if fb_type not in ("standard", "viterbi"):
            raise ValueError("invalid `fb_type`: " + fb_type)
        self.fb_type = fb_type
        self._dp_mode = "sample" if fb_type == "standard" else "viterbi"

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

    def get_vec_embed_log_probs_all(self, utt_ids=None) -> list:
        """:meth:`get_vec_embed_log_probs` for many utterances at once (the
        JAX package's batch scorer, ``unigram.py:326-374``): one pass over
        the dense corpus tensors (``BlockedWordseg._dense_candidate_scores``:
        kernel K1 for the fixed-variance family, plain tensor code for the
        others), returned in the packed triangular layout, one vector an
        utterance of ``utt_ids`` (default: all, in corpus order).  Spans
        wider than the stored window come back -inf."""
        am = self.acoustic_model
        w = log_weights(am.stats.counts, am.alpha, am.K_max, am.lms,
                        include_denominator=True, dtype=am.X.dtype)
        return _dense_to_tri(*self._dense_candidate_scores(utt_ids, w))

    def sweep_metrics(self) -> dict:
        return self.acoustic_model.sweep_metrics()

    def _candidate_weights(self, blk) -> torch.Tensor:
        """[B, K] mixture-weight terms of a block's candidate scores: the
        Dirichlet weights of the leave-out counts."""
        am = self.acoustic_model
        return log_weights(blk.lo_counts, am.alpha, am.K_max, am.lms,
                           include_denominator=True, dtype=am.X.dtype)

    # ------------------------------------------------------------- sampling

    def gibbs_sample(self, n_iter: int, am_n_iter: int = 0,
                     anneal_schedule=None,
                     anneal_start_temp_inv: float = 0.1,
                     anneal_end_temp_inv: float = 1.0,
                     n_anneal_steps: int = -1,
                     anneal_gibbs_am: bool = False, monitor_i=None,
                     validate: bool = False,
                     debug_gibbs_only: bool = False) -> dict:
        """Blocked Gibbs sampling over all utterances (reference
        ``gibbs_sample``, unigram_acoustic_wordseg.py:362-472): every sweep
        visits the utterances in a fresh host permutation, in blocks of
        ``batch_size``, after ``am_n_iter`` sequential sweeps of the
        acoustic model alone over its assigned items (the JAX package's
        ``unigram.py:449-452``; one K10 launch each for the fixed and diag
        families).  Returns the reference's 8-key record dict.

        ``monitor_i`` / ``validate``: a per-sweep trace of one utterance,
        logged at DEBUG level, and the sampler-invariant checks, which
        raise ``utils.debug.ValidationError`` after the last sweep (the
        reference's ``i_debug_monitor`` / NaN asserts; see
        ``utils/debug.py``).  ``debug_gibbs_only``: resample only the
        monitored utterance each sweep (the reference's standing flag,
        unigram_acoustic_wordseg.py:20, :451-452; requires
        ``monitor_i``)."""
        if debug_gibbs_only and monitor_i is None:
            raise AssertionError("debug_gibbs_only requires monitor_i")
        temps = anneal_temperatures(n_iter, anneal_schedule,
                                    anneal_start_temp_inv,
                                    anneal_end_temp_inv, n_anneal_steps)
        return self._sample_sweeps(temps, anneal_gibbs_am, am_n_iter,
                                   monitor_i=monitor_i, validate=validate,
                                   debug_only=debug_gibbs_only)

    def segment(self, *args, **kwargs) -> dict:
        """Alias of :meth:`gibbs_sample` (the JAX package's ``segment``,
        unigram.py:493)."""
        return self.gibbs_sample(*args, **kwargs)

    def gibbs_sample_i(self, i: int, anneal_temp: float = 1.0,
                       anneal_gibbs_am: bool = False) -> float:
        """Resample the boundaries and components of utterance ``i`` alone:
        a block of one (reference ``gibbs_sample_i``,
        unigram_acoustic_wordseg.py:252-360; the JAX package's
        ``unigram.py:376-382``), through the sweep's block runner, so that
        in the per-shard mode the rank that owns ``i`` resamples it and
        the sweep's assignment merge runs.  Returns its DP log
        probability."""
        assign_temp = anneal_temp if anneal_gibbs_am else 1.0
        return float(self._run_blocks(np.array([[int(i)]]), anneal_temp,
                                      assign_temp))

    def get_log_margs_i(self, i: int):
        """Log marginals of utterance ``i``'s segments with the utterance
        held out (reference ``get_log_margs_i``,
        unigram_acoustic_wordseg.py:539-564): its segments leave the model,
        are scored, and the state is put back."""
        embeds = [e for e in self.utterances.get_segmented_embeds_i(i)
                  if e != -1]
        am = self.acoustic_model
        saved = (am.stats, am._assign_pad.clone())
        for e in embeds:
            am.del_item(e)
        out = [float(v) for v in am.log_marg_batch(embeds)]
        am.stats, am._assign_pad = saved
        return out

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
        am = self.acoustic_model
        K, prior = am.K_max, am.prior
        with annotate("seg.block"):
            # 1. current segments and leave-one-utterance-out statistics
            with annotate("seg.block.leave_out"):
                blk = self._leave_out(idx_blk, split=True)
                dp_noise, chain_noise = self._own_noise(
                    blk, dp_noise, chain_noise, self._dp_mode == "sample")

            # 2. fused candidate scoring (K1 / K5 / K8), boundary
            # resampling (K2)
            with annotate("seg.block.score"):
                scores = self._candidate_scores(
                    blk, self._candidate_weights(blk), self._dp_mode)
            with annotate("seg.block.dp"):
                log_prob, new_bounds = self._resample_boundaries(
                    blk, scores, anneal_temp, self._dp_mode, dp_noise)

            # 3. sequential assignment of the new segments (kernel K3 / K6
            # / K9); Viterbi takes the argmax without the lms scaling
            # (fbgmm.py:475)
            with annotate("seg.block.chain"):
                new_embeds, Xe_new, lpe_new = self._new_segments(blk,
                                                                 new_bounds)
                viterbi = self.fb_type == "viterbi"
                noise = self._chain_noise(chain_noise, blk.idx.shape[0])
                opts = dict(alpha=am.alpha, K=K,
                            lms=1.0 if viterbi else am.lms,
                            use_argmax=viterbi)
                data = (new_embeds, Xe_new, lpe_new, noise, blk.lo_counts,
                        blk.sum_xT)
                if self._family == "full":
                    new_ks = self._full_chain(
                        blk, new_embeds, Xe_new, noise, am.alpha,
                        opts["lms"], assign_temp, use_argmax=viterbi)
                elif self._family == "diag":
                    new_ks = diag_chain(*data, blk.sum_sqT, prior.m_0,
                                        *self._k0_v0, prior.S_0, assign_temp,
                                        **opts)
                else:
                    new_ks = fixedvar_chain(*data, prior.var, prior.var_0,
                                            prior.mu_0, assign_temp, **opts)

            # 4. decollision and the merge into the global state
            with annotate("seg.block.merge"):
                return self._merge(blk, new_bounds, new_embeds, Xe_new,
                                   new_ks, log_prob)[0]


if __name__ == "__main__":  # smoke demo (reference unigram_acoustic_wordseg.py:871-963)
    from segmentalist_torch.demos import run_demo

    run_demo("unigram_seg")
