"""Smoothed, interpolated maximum-likelihood bigram language model.

Counterpart of ``segmentalist_tpu/models/bigram_lm.py`` (reference
``BigramSmoothLM``, ``bigram_lms.py``).  The count tables live on the
segmenter's device as integer tensors

    unigram_counts [K]    int32
    bigram_counts  [K, K] int32

and every probability query is a vectorised function of them.  Count
updates are integer ``index_add_`` over flat ``j * K + i`` pair keys:
integer addition is exact and independent of order, so the run-dependent
order of CUDA atomics does not matter here (the JAX package built the same
deltas with bf16 one-hot matmuls, a TPU scatter workaround).

Component slots are never relabelled (masking instead of compaction), so
the LM rows stay aligned with the acoustic model's slots by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class BigramLMState(NamedTuple):
    unigram_counts: torch.Tensor  # [K] int32
    bigram_counts: torch.Tensor   # [K, K] int32


# The tighter of two id bounds, as in the JAX package: ids must fit the key
# field of transcript_pairs_batch's (position << 20) | id packing, and the
# corpus log_prob_z replay's pair keys j * K + i (sentinel K * K) must fit
# int32, so K <= floor(sqrt(2^31 - 1)).
_K_MAX_LM = min(1 << 20, 46340)
_PAIR_KEY_BITS = 20  # component ids < 2^20; positions < 2^11 (int32 safe)


def empty_lm_state(K: int, device=None) -> BigramLMState:
    if K > _K_MAX_LM:
        raise ValueError(
            "bigram LM supports K <= %d (got %d): int32 pair keys j*K+i in "
            "the log_prob_z replay overflow past that" % (_K_MAX_LM, K))
    return BigramLMState(
        unigram_counts=torch.zeros(K, dtype=torch.int32, device=device),
        bigram_counts=torch.zeros((K, K), dtype=torch.int32, device=device),
    )


def log_prob_vec_i(state: BigramLMState, a, K: int,
                   dtype=torch.float32) -> torch.Tensor:
    """[K] log unigram probabilities (reference ``log_prob_vec_i``,
    bigram_lms.py:64-69)."""
    c = state.unigram_counts.to(dtype)
    return torch.log(c + a / K) - torch.log(c.sum() + a)


def prob_vec_i(state: BigramLMState, a, K: int,
               dtype=torch.float32) -> torch.Tensor:
    c = state.unigram_counts.to(dtype)
    return (c + a / K) / (c.sum() + a)


def prob_vec_given_j(state: BigramLMState, j, intrp_lambda, a, b, K: int,
                     dtype=torch.float32) -> torch.Tensor:
    """[K] conditional bigram probabilities given previous component ``j``
    (reference ``prob_vec_given_j``, bigram_lms.py:84-91)."""
    uni = prob_vec_i(state, a, K, dtype)
    row = state.bigram_counts[j].to(dtype)
    cj = state.unigram_counts[j].to(dtype)
    big = (row + b / K) / (cj + b)
    return intrp_lambda * uni + (1.0 - intrp_lambda) * big


def transcript_pairs(transcript: torch.Tensor):
    """(prev, cur) index pairs of one padded transcript ([S] int32, -1
    pads); -1 entries are skipped, carrying the previous context over them,
    like the reference's ``continue`` (bigram_acoustic_wordseg.py:483-486).
    A pair is valid where both entries are >= 0."""
    pj, pi = transcript_pairs_batch(transcript[None])
    return pj[0], pi[0]


def transcript_pairs_batch(transcripts: torch.Tensor,
                           return_prev_pos: bool = False):
    """Batched :func:`transcript_pairs`: forward-fill the last valid
    component with one cumulative max over ``(position << 20) | id``
    (monotone in position, so the max is the latest valid id).

    transcripts [B, S] int32 (-1 pads) -> (pj, pi) each [B, S] int32; with
    ``return_prev_pos`` also the previous valid position per slot ([B, S],
    -1 where none), decoded from the same encoding.
    """
    B, S = transcripts.shape
    if S >= 1 << (31 - _PAIR_KEY_BITS):
        raise ValueError("transcripts longer than %d segments"
                         % ((1 << (31 - _PAIR_KEY_BITS)) - 1))
    dev = transcripts.device
    t = transcripts.to(torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    valid = t >= 0
    enc = torch.where(valid, (pos << _PAIR_KEY_BITS) | t, -1)
    inc = torch.cummax(enc, dim=1).values
    prev = torch.cat([inc.new_full((B, 1), -1), inc[:, :-1]], dim=1)
    pj = torch.where((prev >= 0) & valid,
                     prev & ((1 << _PAIR_KEY_BITS) - 1), -1)
    pi = torch.where(valid, t, -1)
    if return_prev_pos:
        prev_pos = torch.where(prev >= 0, prev >> _PAIR_KEY_BITS, -1)
        return pj, pi, prev_pos
    return pj, pi


def _signed_counts(keys: torch.Tensor, sign: torch.Tensor,
                   n: int) -> torch.Tensor:
    """[n] int32 sums of ``sign`` per key; keys equal to ``n`` are dropped."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    out.index_add_(0, keys.reshape(-1).long(), sign.reshape(-1))
    return out[:n]


def _count_delta(tokens, pj, pi, ok, sign, K: int) -> BigramLMState:
    """Signed unigram and bigram counts of the tokens and (prev, cur) pairs
    of ``tokens`` [R, S] in the rows where ``ok`` [R, S] holds."""
    cur = (tokens >= 0) & ok
    pair = (pj >= 0) & (pi >= 0) & ok
    tok_key = torch.where(cur, tokens.long(), K)
    pair_key = torch.where(pair, pj.long() * K + pi.long(), K * K)
    sign = sign.to(torch.int32).expand(tokens.shape)
    return BigramLMState(
        unigram_counts=_signed_counts(tok_key, sign, K),
        bigram_counts=_signed_counts(pair_key, sign, K * K).reshape(K, K),
    )


def apply_delta(state: BigramLMState, delta: BigramLMState) -> BigramLMState:
    """``state + delta``, table by table."""
    return BigramLMState(*(g + d for g, d in zip(state, delta)))


def add_block_counts(state: BigramLMState, transcripts: torch.Tensor,
                     valid: torch.Tensor, sign: int = 1) -> BigramLMState:
    """Add (``sign`` +1) or remove (-1) a block of transcripts [B, S] in the
    rows where ``valid`` [B] holds (counts are additive, so no
    per-utterance sequencing is needed)."""
    K = state.unigram_counts.shape[0]
    pj, pi = transcript_pairs_batch(transcripts)
    ok = valid[:, None].expand(transcripts.shape)
    delta = _count_delta(transcripts, pj, pi, ok,
                         torch.tensor(sign, device=transcripts.device), K)
    return apply_delta(state, delta)


def block_count_delta(old_ks: torch.Tensor, new_ks: torch.Tensor,
                      valid: torch.Tensor, K: int,
                      pairs_old=None) -> BigramLMState:
    """Signed LM count delta of a block swap (remove ``old_ks``, add
    ``new_ks``, both [B, S], in the rows where ``valid`` [B] holds).
    ``pairs_old`` reuses the caller's ``transcript_pairs_batch(old_ks)``."""
    if pairs_old is None:
        pairs_old = transcript_pairs_batch(old_ks)
    pj_n, pi_n = transcript_pairs_batch(new_ks)
    B, S = old_ks.shape
    ok = valid[:, None].expand(B, S)
    sign = torch.cat([old_ks.new_full((B, S), -1),
                      new_ks.new_full((B, S), 1)])
    return _count_delta(
        torch.cat([old_ks, new_ks]), torch.cat([pairs_old[0], pj_n]),
        torch.cat([pairs_old[1], pi_n]), torch.cat([ok, ok]), sign, K)


def add_transcript_counts(state: BigramLMState, transcript: torch.Tensor,
                          sign: int = 1) -> BigramLMState:
    """Add (sign=+1) / remove (sign=-1) one utterance's counts (reference
    ``counts_from_utterance`` / ``remove_counts_from_utterance``,
    bigram_lms.py:98-114)."""
    return add_block_counts(
        state, transcript[None],
        torch.ones(1, dtype=torch.bool, device=transcript.device), sign)


class BigramSmoothLM:
    """Reference-parity class wrapper (``BigramSmoothLM``,
    bigram_lms.py:17-114); ``state`` lives on ``device``: the CUDA card by
    default (raises when there is none), the CPU when the caller asks."""

    def __init__(self, intrp_lambda, a, b, K, device="cuda"):
        self.intrp_lambda = float(intrp_lambda)
        self.a = float(a)
        self.b = float(b)
        self.K = int(K)
        self.state = empty_lm_state(self.K, resolve_device(device))

    # numpy views of the count tables (the reference exposes raw arrays)
    @property
    def unigram_counts(self) -> np.ndarray:
        return self.state.unigram_counts.cpu().numpy()

    @property
    def bigram_counts(self) -> np.ndarray:
        return self.state.bigram_counts.cpu().numpy()

    def prob_i(self, i) -> float:
        return float(self.prob_vec_i()[i])

    def prob_i_given_j(self, i, j) -> float:
        return float(self.prob_vec_given_j(j)[i])

    def log_prob_vec_i(self) -> np.ndarray:
        return log_prob_vec_i(self.state, self.a, self.K,
                              torch.float64).cpu().numpy()

    def prob_vec_i(self) -> np.ndarray:
        return prob_vec_i(self.state, self.a, self.K,
                          torch.float64).cpu().numpy()

    def log_prob_vec_given_j(self, j) -> np.ndarray:
        return np.log(self.prob_vec_given_j(j))

    def prob_vec_given_j(self, j) -> np.ndarray:
        return prob_vec_given_j(self.state, j, self.intrp_lambda, self.a,
                                self.b, self.K, torch.float64).cpu().numpy()

    def counts_from_data(self, data):
        for utterance in data:
            self.counts_from_utterance(utterance)

    def _transcript(self, utterance) -> torch.Tensor:
        return torch.as_tensor(np.asarray(list(utterance), dtype=np.int32),
                               device=self.state.unigram_counts.device)

    def counts_from_utterance(self, utterance):
        self.state = add_transcript_counts(self.state,
                                           self._transcript(utterance), 1)

    def remove_counts_from_utterance(self, utterance):
        self.state = add_transcript_counts(self.state,
                                           self._transcript(utterance), -1)


if __name__ == "__main__":  # smoke demo (reference bigram_lms.py:117-156)
    from segmentalist_torch.demos import run_demo

    run_demo("bigram_lm")
