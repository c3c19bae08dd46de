"""Property-style fuzzing of the port's unigram and bigram segmenters:
random corpora, random hyperparameters, invariant checks (the JAX
package's ``tests/test_fuzz_invariants.py``; its k-means case is in
``tests/test_torch_kmeans_seg.py``).

Every run validates its sweeps (``validate=True``).  A Viterbi sweep is a
function of the sampler state and the host RNG, so replaying it from a
snapshot taken with ``utils/checkpoint.segmenter_state`` reproduces it; a
bigram segmenter's LM tables equal a rebuild from its transcripts.
"""

import numpy as np
import pytest

import segmentalist_torch as pt
from segmentalist_torch.utils import checkpoint as ckpt
from segmentalist_torch.utils.synth import synthetic_corpus


def _check_segmentation(seg):
    am = seg.acoustic_model
    n_tokens = 0
    for i in range(seg.utterances.D):
        N = seg.utterances.lengths[i]
        assert seg.utterances.boundaries[i][N - 1], \
            "final boundary must always be set"
        n_tokens += sum(1 for e in seg.utterances.get_segmented_embeds_i(i)
                        if e != -1)
    # assigned embeddings == segments of the current segmentation
    assert int((am.assignments >= 0).sum()) == n_tokens
    counts = am.stats.counts.numpy()
    assert counts.sum() == n_tokens
    assert counts.min() >= 0


@pytest.mark.parametrize("seed,cov_type,fb_type", [
    (0, "fixed", "standard"), (1, "fixed", "standard"),
    (2, "fixed", "standard"), (7, "diag", "standard"),
    (8, "full", "standard"), (10, "full", "standard"),
    (11, "fixed", "viterbi"), (12, "diag", "viterbi"),
    (14, "full", "viterbi"),
])
def test_unigram_fuzz(seed, cov_type, fb_type):
    rng = np.random.RandomState(seed)
    n_lm = rng.randint(3, 9)
    W = rng.randint(2, min(5, n_lm) + 1)
    D = rng.randint(2, 6)
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=rng.randint(3, 9), n_landmarks_max=n_lm, D=D,
        K_true=rng.randint(2, 4), n_slices_max=W, seed=seed)
    if cov_type == "fixed":
        prior = pt.FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D),
                                        np.ones(D))
    elif cov_type == "diag":
        prior = pt.NIW.create(np.zeros(D), 0.1, float(D) + 3.0,
                              0.2 * np.ones(D))
    else:
        prior = pt.NIW.create(np.zeros(D), 0.1, float(D) + 3.0,
                              0.2 * np.eye(D) + 0.02 * np.ones((D, D)))
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=float(rng.uniform(0.5, 5)),
        am_K=rng.randint(3, 10), am_param_prior=prior, embedding_mats=em,
        vec_ids_dict=vi, durations_dict=du, landmarks_dict=lm,
        covariance_type=cov_type,
        p_boundary_init=float(rng.uniform(0.2, 0.9)),
        beta_sent_boundary=float(rng.choice([-1, 2.0])),
        n_slices_min=int(rng.choice([0, 1])), n_slices_max=W,
        time_power_term=float(rng.choice([1.0, 1.2])),
        wip=float(rng.uniform(-1, 1)), batch_size=int(rng.randint(1, 5)),
        fb_type=fb_type, seed=seed, device="cpu")
    rec = seg.gibbs_sample(3, validate=True)
    if fb_type == "viterbi":
        # deterministic given (sampler state, host RNG): a sweep replayed
        # from a snapshot reproduces it exactly
        snap = ckpt.segmenter_state(seg)
        seg.gibbs_sample(1, validate=True)
        a1 = seg.acoustic_model.assignments.numpy().copy()
        b1 = seg.utterances.boundaries.copy()
        ckpt.load_segmenter_state(seg, snap)
        seg.gibbs_sample(1, validate=True)
        np.testing.assert_array_equal(a1,
                                      seg.acoustic_model.assignments.numpy())
        np.testing.assert_array_equal(b1, seg.utterances.boundaries)
    assert np.isfinite(rec["log_marg"]).all()
    _check_segmentation(seg)


@pytest.mark.parametrize("seed", [5, 6])
def test_bigram_fuzz(seed):
    rng = np.random.RandomState(seed)
    n_lm = rng.randint(3, 8)
    W = rng.randint(2, min(4, n_lm) + 1)
    D = rng.randint(2, 5)
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=rng.randint(3, 8), n_landmarks_max=n_lm, D=D,
        K_true=2, n_slices_max=W, seed=seed)
    prior = pt.FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D),
                                    np.ones(D))
    lm_params = {"type": "smooth",
                 "intrp_lambda": float(rng.uniform(0, 0.5)),
                 "a": float(rng.uniform(0.5, 3)),
                 "b": float(rng.uniform(0.5, 3))}
    seg = pt.BigramAcousticWordseg(
        am_K=rng.randint(3, 8), am_param_prior=prior, lm_params=lm_params,
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=float(rng.uniform(0.2, 0.9)),
        beta_sent_boundary=-1, n_slices_max=W, fb_type="unigram",
        batch_size=int(rng.randint(1, 4)), seed=seed, device="cpu")
    rec = seg.gibbs_sample(3, validate=True)
    assert np.isfinite(rec["log_marg"]).all()
    _check_segmentation(seg)
    # the LM count tables equal a rebuild on the host from the transcripts
    fresh = pt.BigramSmoothLM(lm_params["intrp_lambda"], lm_params["a"],
                              lm_params["b"], seg.lm.K, device="cpu")
    fresh.counts_from_data([[int(k) for k in seg.get_unsup_transcript_i(i)]
                            for i in range(seg.utterances.D)])
    np.testing.assert_array_equal(seg.lm.unigram_counts,
                                  fresh.unigram_counts)
    np.testing.assert_array_equal(seg.lm.bigram_counts, fresh.bigram_counts)


def test_dp_window_narrower_than_stored_spans():
    """A segmenter ``n_slices_max`` below the spans present in the data:
    the DP chooses only spans within its window."""
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=5, n_landmarks_max=6, D=3, K_true=2, n_slices_max=4,
        seed=9)
    prior = pt.FixedVarPrior.create(0.05 * np.ones(3), np.zeros(3),
                                    np.ones(3))
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=5, am_param_prior=prior,
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=2, batch_size=2, seed=9, device="cpu")
    assert seg.utterances.W >= 2
    seg.gibbs_sample(3, validate=True)
    for i in range(seg.utterances.D):
        spans = [b - a for a, b in
                 seg.utterances.get_segmented_landmark_indices(i)]
        # non-leading spans obey the window (the leading remainder and the
        # fallback may be shorter, never longer)
        assert all(s <= 2 for s in spans[1:]), (i, spans)
