"""The port's bigram LM (``segmentalist_torch.models.bigram_lm``) and its
corpus ``log_prob_z`` replay against the JAX package: integer tables
exactly, probabilities at float64 to rtol 1e-12."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import bigram_lm as jlm
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)
from segmentalist_tpu.utils.synth import synthetic_corpus as jax_synth

import segmentalist_tpu as jtpu
from segmentalist_torch.models import bigram_lm as tlm
from segmentalist_torch.segmenters.bigram import log_prob_z_replay

K, B, S = 7, 9, 6


def _transcripts(seed, shape=(B, S), k=K):
    return np.random.RandomState(seed).randint(-1, k, shape).astype(np.int32)


def _state(seed):
    """An LM state of random transcripts, in both packages."""
    ts = _transcripts(seed)
    valid = np.ones(B, bool)
    j = jlm.add_block_counts(jlm.empty_lm_state(K), jnp.asarray(ts),
                             jnp.asarray(valid))
    t = tlm.add_block_counts(tlm.empty_lm_state(K), torch.as_tensor(ts),
                             torch.as_tensor(valid))
    return j, t


def _eq_state(t, j):
    npt.assert_array_equal(t.unigram_counts.numpy(),
                           np.asarray(j.unigram_counts))
    npt.assert_array_equal(t.bigram_counts.numpy(),
                           np.asarray(j.bigram_counts))
    assert t.unigram_counts.dtype == t.bigram_counts.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_add_block_counts_matches_jax(seed):
    ts = _transcripts(seed)
    valid = np.random.RandomState(seed + 10).rand(B) < 0.7
    for sign in (1, -1):
        j = jlm.add_block_counts(jlm.empty_lm_state(K), jnp.asarray(ts),
                                 jnp.asarray(valid), sign=sign)
        t = tlm.add_block_counts(tlm.empty_lm_state(K), torch.as_tensor(ts),
                                 torch.as_tensor(valid), sign=sign)
        _eq_state(t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_count_delta_matches_jax(seed):
    rng = np.random.RandomState(seed)
    old, new = _transcripts(seed), _transcripts(seed + 100)
    valid = rng.rand(B) < 0.75
    j = jlm.block_count_delta(jnp.asarray(old), jnp.asarray(new),
                              jnp.asarray(valid), K)
    for pairs_old in (None, tlm.transcript_pairs_batch(torch.as_tensor(old))):
        t = tlm.block_count_delta(torch.as_tensor(old), torch.as_tensor(new),
                                  torch.as_tensor(valid), K,
                                  pairs_old=pairs_old)
        _eq_state(t, j)


def test_transcript_pairs_match_jax():
    ts = _transcripts(3)
    ts[2] = -1
    jpj, jpi, jpos = jlm.transcript_pairs_batch(jnp.asarray(ts),
                                                return_prev_pos=True)
    tpj, tpi, tpos = tlm.transcript_pairs_batch(torch.as_tensor(ts),
                                                return_prev_pos=True)
    for t, j in ((tpj, jpj), (tpi, jpi), (tpos, jpos)):
        npt.assert_array_equal(t.numpy(), np.asarray(j))
    for row in ts:
        for t, j in zip(tlm.transcript_pairs(torch.as_tensor(row)),
                        jlm.transcript_pairs(jnp.asarray(row))):
            npt.assert_array_equal(t.numpy(), np.asarray(j))


def test_add_transcript_counts_matches_jax():
    j, t = _state(4)
    for row in _transcripts(5, (3, 8)):
        for sign in (1, -1):
            j = jlm.add_transcript_counts(j, jnp.asarray(row), sign=sign)
            t = tlm.add_transcript_counts(t, torch.as_tensor(row), sign=sign)
            _eq_state(t, j)


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_probabilities_match_jax(lam):
    j, t = _state(6)
    a, b = 1.2, 1.7
    npt.assert_allclose(
        tlm.log_prob_vec_i(t, a, K, torch.float64).numpy(),
        np.asarray(jlm.log_prob_vec_i(j, a, K, jnp.float64)), rtol=1e-12)
    npt.assert_allclose(
        tlm.prob_vec_i(t, a, K, torch.float64).numpy(),
        np.asarray(jlm.prob_vec_i(j, a, K, jnp.float64)), rtol=1e-12)
    for jj in range(K):
        npt.assert_allclose(
            tlm.prob_vec_given_j(t, jj, lam, a, b, K, torch.float64).numpy(),
            np.asarray(jlm.prob_vec_given_j(j, jj, lam, a, b, K,
                                            jnp.float64)), rtol=1e-12)


def test_k_guard_matches_jax():
    tlm.empty_lm_state(46340)
    with pytest.raises(ValueError, match="K <= 46340"):
        tlm.empty_lm_state(46341)


def test_lm_identities():
    """Reference LM identities (tests/test_bigram.py, reference
    tests/test_bigram_lms.py:13-74)."""
    intrp_lambda, a, b, k = 0.1, 1, 2, 5
    lm = tlm.BigramSmoothLM(intrp_lambda, a, b, k, device="cpu")
    lm.counts_from_data([[1, 1, 3, 4, 0], [4, 4], [1, 0, 2, 2, 2, 2, 3, 1],
                         [3, 3, 1]])
    npt.assert_allclose(
        lm.prob_i_given_j(1, 3),
        intrp_lambda * lm.prob_i(1) + (1 - intrp_lambda) * (2.0 + b / k)
        / (4 + b), rtol=1e-12)
    npt.assert_allclose(lm.prob_i(1), (5.0 + a / k) / (18 + a), rtol=1e-12)
    pv = lm.prob_vec_i()
    for i in range(k):
        npt.assert_allclose(pv[i], lm.prob_i(i), rtol=1e-12)
    pj = lm.prob_vec_given_j(3)
    for i in range(k):
        npt.assert_allclose(pj[i], lm.prob_i_given_j(i, 3), rtol=1e-12)
    npt.assert_allclose(lm.log_prob_vec_i(), np.log(pv), rtol=1e-12)
    npt.assert_allclose(lm.log_prob_vec_given_j(3), np.log(pj), rtol=1e-12)


def test_lm_add_remove_roundtrip():
    lm = tlm.BigramSmoothLM(0.2, 1.0, 2.0, 4, device="cpu")
    lm.counts_from_utterance([0, 1, 1, 3])
    lm.counts_from_utterance([2, 0])
    uni0, big0 = lm.unigram_counts.copy(), lm.bigram_counts.copy()
    lm.counts_from_utterance([3, 3, 1])
    lm.remove_counts_from_utterance([3, 3, 1])
    npt.assert_array_equal(lm.unigram_counts, uni0)
    npt.assert_array_equal(lm.bigram_counts, big0)
    # -1 pads carry context over, like the reference's `continue`.
    lm2 = tlm.BigramSmoothLM(0.2, 1.0, 2.0, 4, device="cpu")
    lm2.counts_from_utterance([0, 1, 3])
    lm3 = tlm.BigramSmoothLM(0.2, 1.0, 2.0, 4, device="cpu")
    lm3.counts_from_utterance([0, -1, 1, -1, 3, -1])
    npt.assert_array_equal(lm2.bigram_counts, lm3.bigram_counts)


def _python_replay(ts, lam, a, b, k):
    """Direct replay of the reference recursion
    (bigram_acoustic_wordseg.py:287-305)."""
    uni, big, n, total = np.zeros(k), np.zeros((k, k)), 0, 0.0
    for row in ts:
        j_prev = -1
        for cur in row:
            if cur < 0:
                continue
            p = (uni[cur] + a / k) / (n + a)
            if j_prev >= 0:
                p = lam * p + (1 - lam) * (big[j_prev, cur] + b / k) \
                    / (uni[j_prev] + b)
                big[j_prev, cur] += 1
            total += np.log(p)
            uni[cur] += 1
            n += 1
            j_prev = cur
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_prob_z_replay_matches_jax(seed):
    em, vi, du, lmk, _ = jax_synth(n_utterances=5, n_landmarks_max=5, D=3,
                                   K_true=2, n_slices_max=3, seed=3)
    prior = jtpu.FixedVarPrior.create(0.05 * np.ones(3), np.zeros(3),
                                      np.ones(3))
    lam, a, b, k = 0.15, 1.2, 2.0, 4
    np.random.seed(3)
    jseg = JaxBigram(
        am_K=k, am_param_prior=prior,
        lm_params={"type": "smooth", "intrp_lambda": lam, "a": a, "b": b},
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lmk, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=3, fb_type="unigram", batch_size=2, seed=3)
    ts = _transcripts(seed, (11, 9), k)
    want = float(jseg._build_log_prob_z_fn()(jnp.asarray(ts)))
    got = float(log_prob_z_replay(torch.as_tensor(ts), lam, a, b, k,
                                  torch.float64))
    npt.assert_allclose(got, want, rtol=1e-12)
    npt.assert_allclose(got, _python_replay(ts, lam, a, b, k), rtol=1e-12)
