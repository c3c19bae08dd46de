"""The port's bigram segmenter against the JAX package, end to end.

Both packages are built from one small synthetic corpus at one seed; the
JAX state (acoustic statistics, assignments, boundaries and LM tables) is
carried into the port with ``segmentalist_torch.interop`` and block steps
of each run on the same DP and chain noise (the noise the JAX bigram block
step draws from its key, ``bigram.py:1029``, ``:1125``; ``dp.py:196``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import segmentalist_tpu as jtpu
from segmentalist_tpu.ops.stats import suff_stats_from_assignments
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.segmenters.blocked import RECORD_KEYS
from segmentalist_torch.utils.synth import synthetic_corpus

U, N_MAX, D, K, B, W = 12, 8, 4, 16, 4, 4
LM = {"type": "smooth", "intrp_lambda": 0.2, "a": 1.2, "b": 1.5}


def _kwargs(**kw):
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=U, n_landmarks_max=N_MAX,
                                         D=D, K_true=3, n_slices_max=W, seed=3)
    args = dict(am_K=K, lm_params=LM, embedding_mats=em, vec_ids_dict=vi,
                durations_dict=du, landmarks_dict=lm, p_boundary_init=0.5,
                beta_sent_boundary=2.0, n_slices_max=W, batch_size=B, seed=5,
                lms=1.3, wip=-0.1, time_power_term=0.9, fb_type="unigram")
    args.update(kw)
    return args


def _prior(pkg):
    return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                    np.ones(D))


def _pair(**kw):
    np.random.seed(kw.get("seed", 5))  # the JAX init draws from numpy's RNG
    jseg = JaxBigram(am_param_prior=_prior(jtpu), **_kwargs(**kw))
    tseg = pt.BigramAcousticWordseg(am_param_prior=_prior(pt), device="cpu",
                                    **_kwargs(**kw))
    return jseg, tseg


def _jax_state(jseg):
    am = jseg.acoustic_model
    return {
        "X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
        "sum_x": np.asarray(am.stats.sum_x),
        "sum_sq": np.asarray(am.stats.sum_sq),
        "assignments": np.asarray(am.assignments),
        "boundaries": np.asarray(jseg._boundaries_dev),
        "var": np.asarray(am.prior.var), "mu_0": np.asarray(am.prior.mu_0),
        "var_0": np.asarray(am.prior.var_0),
        "unigram_counts": np.asarray(jseg.lm.state.unigram_counts),
        "bigram_counts": np.asarray(jseg.lm.state.bigram_counts),
    }


def _assert_lm_equal(tseg, uni, big):
    npt.assert_array_equal(tseg.lm.unigram_counts, np.asarray(uni))
    npt.assert_array_equal(tseg.lm.bigram_counts, np.asarray(big))


def test_same_seed_same_initial_state():
    jseg, tseg = _pair()
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                           np.asarray(jseg.acoustic_model.assignments))
    npt.assert_array_equal(tseg.acoustic_model.stats.counts.numpy(),
                           np.asarray(jseg.acoustic_model.stats.counts))
    _assert_lm_equal(tseg, jseg.lm.unigram_counts, jseg.lm.bigram_counts)
    npt.assert_allclose(tseg.log_prob_z(), jseg.log_prob_z(), rtol=1e-12)
    npt.assert_allclose(tseg.log_marg(), jseg.log_marg(), rtol=1e-12)


def test_block_step_matches_jax():
    """Three consecutive block steps (the last one padded) on carried-across
    state and shared noise give exactly JAX's boundaries, assignments,
    counts and LM tables."""
    jseg, tseg = _pair()
    interop.load_state(tseg, _jax_state(jseg))
    am, utt = jseg.acoustic_model, jseg.utterances
    step = jseg._make_block_step(B, pallas=True, reduce_fn=lambda t: t,
                                 assignments_only=False)
    cand_X, cand_lp = jseg._cand_tables()
    carry = (am.stats, am.assignments, jseg._boundaries_dev, jseg.lm.state,
             jax.random.PRNGKey(21), jnp.zeros((), am.X.dtype))
    tam = tseg.acoustic_model
    lp_prev = 0.0
    for block in ([7, 2, 11, 0], [1, 3, 5, 9], [10, 4, -1, -1]):
        block = np.array(block, dtype=np.int64)
        key = carry[4]  # the key this step splits
        (stats, assignments, bounds, lm_state, key_out, lp), upd = step(
            carry, jnp.asarray(block), utt.seg_ids, utt.seg_durations,
            utt.lengths_dev, 2.0, 1.5, cand_X_all=cand_X,
            cand_lp_all=cand_lp)
        assignments = jcommon.merge_assignments(assignments, *upd,
                                                lambda t: t)
        carry = (stats, assignments, bounds, lm_state, key_out, lp)

        # the noise the JAX step drew (bigram.py:1029, :1125; dp.py:196)
        _, k_dp, k_assign = jax.random.split(key, 3)
        dp_noise = jax.random.gumbel(k_dp, (B, N_MAX, tseg.W_dp), am.X.dtype)
        chain_noise = jax.random.gumbel(k_assign, (B, N_MAX, K), am.X.dtype)
        lp_t = tseg.block_step(
            block, 2.0, 1.5, dp_noise=torch.as_tensor(np.array(dp_noise)),
            chain_noise=torch.as_tensor(np.array(chain_noise)))

        npt.assert_array_equal(tseg.utterances.boundaries, np.asarray(bounds))
        npt.assert_array_equal(tam.assignments.numpy(),
                               np.asarray(assignments))
        npt.assert_array_equal(tam.stats.counts.numpy(),
                               np.asarray(stats.counts))
        _assert_lm_equal(tseg, lm_state.unigram_counts,
                         lm_state.bigram_counts)
        npt.assert_allclose(tam.stats.sum_x.numpy(), np.asarray(stats.sum_x),
                            rtol=1e-10, atol=1e-10)
        npt.assert_allclose(tam.stats.sum_sq.numpy(),
                            np.asarray(stats.sum_sq), rtol=1e-10, atol=1e-10)
        npt.assert_allclose(float(lp_t), float(lp) - lp_prev, rtol=1e-10)
        lp_prev = float(lp)


def test_gibbs_sample_record_and_lm_bookkeeping():
    _, tseg = _pair()
    rec = tseg.gibbs_sample(5)
    assert set(rec) == set(RECORD_KEYS)
    assert all(len(v) == 5 for v in rec.values())
    assert np.isfinite(rec["log_marg"]).all()
    assert np.isfinite(rec["log_prob_z"]).all()
    npt.assert_allclose(rec["log_marg"], np.add(rec["log_prob_z"],
                                                rec["log_prob_X_given_z"]),
                        rtol=1e-12)
    # the LM counts stay those of the acoustic model and of a fresh recount
    npt.assert_array_equal(tseg.lm.unigram_counts,
                           tseg.acoustic_model.stats.counts.numpy())
    uni, big = tseg.lm.unigram_counts, tseg.lm.bigram_counts
    tseg.set_lm_counts()
    _assert_lm_equal(tseg, uni, big)
    npt.assert_allclose(rec["log_prob_z"][-1], tseg.log_prob_z(), rtol=1e-12)
    for i in range(U):
        assert all(k >= 0 for k in tseg.get_unsup_transcript_i(i))
    assert np.isfinite(tseg.gibbs_sample_i(3))


def test_assignments_only_keeps_boundaries():
    _, tseg = _pair()
    before = tseg.utterances.boundaries
    rec = tseg.gibbs_sample(3, assignments_only=True)
    npt.assert_array_equal(tseg.utterances.boundaries, before)
    assert rec["log_marg*length"] == [0.0, 0.0, 0.0]
    npt.assert_array_equal(tseg.lm.unigram_counts,
                           tseg.acoustic_model.stats.counts.numpy())


def test_unported_modes_raise():
    _, tseg = _pair(fb_type="bigram")
    with pytest.raises(NotImplementedError):
        tseg.gibbs_sample(1)
    with pytest.raises(NotImplementedError):
        tseg.gibbs_sample(1, am_n_iter=1)
    with pytest.raises(NotImplementedError):
        tseg.get_vec_embed_log_probs_bigram([0], [1.0])
    # diag and full are ported (tests/test_torch_diag.py,
    # tests/test_torch_full.py); an unknown family raises
    with pytest.raises(ValueError):
        pt.BigramAcousticWordseg(am_param_prior=_prior(pt), device="cpu",
                                 **_kwargs(covariance_type="spherical"))
    with pytest.raises(NotImplementedError):
        tseg.acoustic_model.gibbs_sample(1)


def _demo_corpus():
    """Reference demo (bigram_acoustic_wordseg.py:771-817), as in
    tests/test_bigram.py."""
    mat1 = np.array(
        [[1.55329044, 0.82568932, 0.56011276],
         [1.10640768, -0.41715366, 0.30323529],
         [1.24183824, -2.39021548, 0.02369367],
         [1.26094544, -0.27567053, 1.35731148],
         [1.59711416, -0.54917262, -0.56074459],
         [-0.4298405, 1.39010761, -1.2608597]])
    mat2 = np.array(
        [[1.63075195, 0.25297823, -1.75406467],
         [-0.59324473, 0.96613426, -0.20922202],
         [0.97066059, -1.22315308, -0.37979187],
         [-0.31613254, -0.07262261, -1.04392799],
         [-1.11535652, 0.33905751, 1.85588856],
         [-1.08211738, 0.88559445, 0.2924617]])
    vec_ids = np.array([0, 1, 3, 2, 4, 5])  # packed triangle of 3 slices
    return ({"test1": mat1, "test2": mat2},
            {"test1": vec_ids.copy(), "test2": vec_ids.copy()},
            {"test1": [1, 2, 1, 3, 2, 1], "test2": [1, 2, 1, 3, 2, 1]},
            {"test1": [1, 2, 3], "test2": [1, 2, 3]})


def _demo_pair():
    mats, vids, durs, lms_d = _demo_corpus()
    S_0 = 0.002 * np.ones(3)

    def kw(pkg):
        return dict(
            am_K=3, am_param_prior=pkg.FixedVarPrior.create(
                S_0, np.zeros(3), S_0 / 0.05),
            lm_params={"type": "smooth", "intrp_lambda": 0, "a": 0.5,
                       "b": 0.5},
            embedding_mats=mats, vec_ids_dict=vids, durations_dict=durs,
            landmarks_dict=lms_d, p_boundary_init=0.9, beta_sent_boundary=-1,
            n_slices_max=2, fb_type="unigram", lms=1.0, batch_size=1, seed=1)

    np.random.seed(1)
    return (JaxBigram(**kw(jtpu)),
            pt.BigramAcousticWordseg(device="cpu", **kw(pt)))


def test_demo_corpus_scores_match_jax():
    """get_vec_embed_log_probs_unigram and log_marg_i_embed_unigram on the
    reference demo corpus, against the JAX package at float64."""
    jseg, tseg = _demo_pair()
    npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                           np.asarray(jseg.acoustic_model.assignments))
    _assert_lm_equal(tseg, jseg.lm.unigram_counts, jseg.lm.bigram_counts)
    for i in range(2):
        vids = tseg.utterances.vec_ids[i]
        durs = tseg.utterances.durations[i]
        npt.assert_allclose(tseg.get_vec_embed_log_probs_unigram(vids, durs),
                            jseg.get_vec_embed_log_probs_unigram(vids, durs),
                            rtol=1e-10)
    for i_embed in range(12):
        npt.assert_allclose(tseg.log_marg_i_embed_unigram(i_embed),
                            jseg.log_marg_i_embed_unigram(i_embed),
                            rtol=1e-10)


def test_inside_loop_draw_matches_jax():
    """gibbs_sample_inside_loop_i_embed on the noise the JAX version draws
    from its key (``bigram.py:382-383``, ``ops/random.py``)."""
    jseg, tseg = _demo_pair()
    for i_embed, j_prev in ((0, -1), (3, 1), (7, 0), (11, 2)):
        state = {k: np.array(v) for k, v in _jax_state(jseg).items()}
        state["assignments"][i_embed] = -1
        jam = jseg.acoustic_model
        jam.assignments = jnp.asarray(state["assignments"])
        jam.stats = suff_stats_from_assignments(jam.X, jam.assignments,
                                                jam.K_max)
        state.update(counts=np.asarray(jam.stats.counts),
                     sum_x=np.asarray(jam.stats.sum_x),
                     sum_sq=np.asarray(jam.stats.sum_sq))
        interop.load_state(tseg, state)
        _, sub = jax.random.split(jam.key)
        noise = jax.random.gumbel(sub, (3,), jnp.float64)
        k_j = jseg.gibbs_sample_inside_loop_i_embed(i_embed, j_prev, 0.8)
        k_t = tseg.gibbs_sample_inside_loop_i_embed(
            i_embed, j_prev, 0.8, noise=torch.as_tensor(np.array(noise)))
        assert k_t == k_j
        npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                               np.asarray(jam.assignments))
        npt.assert_allclose(tseg.acoustic_model.stats.sum_x.numpy(),
                            np.asarray(jam.stats.sum_x), rtol=1e-12)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.BigramAcousticWordseg(am_param_prior=_prior(pt), device="cuda",
                                 **_kwargs())
