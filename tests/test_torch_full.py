"""The port's full-covariance segmenters against the JAX package, end to
end.

Both packages are built from one small synthetic corpus at one seed with
``covariance_type="full"``; the JAX state (statistics with [K, D, D]
second moments, assignments, boundaries, the NIW prior with a [D, D]
``S_0`` and, for the bigram segmenter, the LM tables) is carried into the
port with ``segmentalist_torch.interop`` and block steps of each run on the
same DP and chain noise (the noise the JAX block steps draw from their
keys).  Boundaries, assignments and counts are identical; the statistics
and the DP log probability agree to 1e-9 relative (``torch.linalg``'s
Cholesky is not the JAX package's unrolled one).  Also: the driver
surface, and the default device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import segmentalist_tpu as jtpu
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)
from segmentalist_tpu.segmenters.unigram import (
    UnigramAcousticWordseg as JaxUnigram)

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.models import cov_module
from segmentalist_torch.ops import cuda_fullcov_chain, cuda_fullcov_score
from segmentalist_torch.segmenters.blocked import RECORD_KEYS
from segmentalist_torch.utils.synth import synthetic_corpus

U, N_MAX, D, K, B, W = 12, 8, 3, 16, 4, 4
LM = {"type": "smooth", "intrp_lambda": 0.2, "a": 1.2, "b": 1.5}
BLOCKS = ([7, 2, 11, 0], [1, 3, 5, 9], [10, 4, -1, -1])


def _prior(pkg):
    S_0 = 0.4 * np.eye(D) + 0.05 * np.ones((D, D))
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _kwargs(bigram, **kw):
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=U, n_landmarks_max=N_MAX,
                                         D=D, K_true=3, n_slices_max=W, seed=3)
    args = dict(am_K=K, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                landmarks_dict=lm, covariance_type="full",
                p_boundary_init=0.5, beta_sent_boundary=2.0, n_slices_max=W,
                batch_size=B, seed=5, lms=1.3, wip=-0.1, time_power_term=0.9)
    if bigram:
        args.update(lm_params=LM, fb_type="unigram")
    else:
        args.update(am_alpha=1.0)
    args.update(kw)
    return args


def _port(bigram=False, device="cpu", **kw):
    if bigram:
        return pt.BigramAcousticWordseg(am_param_prior=_prior(pt),
                                        device=device, **_kwargs(True, **kw))
    return pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                     device=device, **_kwargs(False, **kw))


def _pair(bigram=False, **kw):
    np.random.seed(kw.get("seed", 5))  # the JAX init draws from numpy's RNG
    if bigram:
        jseg = JaxBigram(am_param_prior=_prior(jtpu), **_kwargs(True, **kw))
    else:
        jseg = JaxUnigram(jtpu.FBGMM, am_param_prior=_prior(jtpu),
                          **_kwargs(False, **kw))
    return jseg, _port(bigram, **kw)


def _jax_state(jseg):
    am = jseg.acoustic_model
    state = {
        "X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
        "sum_x": np.asarray(am.stats.sum_x),
        "sum_sq": np.asarray(am.stats.sum_sq),
        "assignments": np.asarray(am.assignments),
        "boundaries": np.asarray(jseg._boundaries_dev),
        **{k: np.asarray(getattr(am.prior, k))
           for k in interop.PRIOR_KEYS["full"]},
    }
    if hasattr(jseg, "lm"):
        state.update(unigram_counts=np.asarray(jseg.lm.state.unigram_counts),
                     bigram_counts=np.asarray(jseg.lm.state.bigram_counts))
    return state


def _run_block_steps(jseg, tseg, bigram):
    """Three consecutive block steps (the last one padded) of each package
    on shared noise, compared after every step."""
    interop.load_state(tseg, _jax_state(jseg))
    am, utt = jseg.acoustic_model, jseg.utterances
    kw = dict(assignments_only=False) if bigram else {}
    step = jseg._make_block_step(B, pallas=True, reduce_fn=lambda t: t, **kw)
    cand_X, cand_lp = jseg._cand_tables()
    head = (am.stats, am.assignments, jseg._boundaries_dev)
    lm = (jseg.lm.state,) if bigram else ()
    carry = head + lm + (jax.random.PRNGKey(21), jnp.zeros((), am.X.dtype))
    tam = tseg.acoustic_model
    lp_prev = 0.0
    for block in BLOCKS:
        block = np.array(block, dtype=np.int64)
        key = carry[-2]  # the key this step splits
        out, upd = step(carry, jnp.asarray(block), utt.seg_ids,
                        utt.seg_durations, utt.lengths_dev, 2.0, 1.5,
                        cand_X_all=cand_X, cand_lp_all=cand_lp)
        stats, assignments, bounds = out[:3]
        assignments = jcommon.merge_assignments(assignments, *upd,
                                                lambda t: t)
        carry = (stats, assignments) + tuple(out[2:])
        lp = out[-1]

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
        npt.assert_allclose(tam.stats.sum_x.numpy(), np.asarray(stats.sum_x),
                            rtol=1e-10, atol=1e-10)
        npt.assert_allclose(tam.stats.sum_sq.numpy(),
                            np.asarray(stats.sum_sq), rtol=1e-10, atol=1e-10)
        npt.assert_allclose(float(lp_t), float(lp) - lp_prev, rtol=1e-9)
        lp_prev = float(lp)
        if bigram:
            lm_state = out[3]
            npt.assert_array_equal(tseg.lm.unigram_counts,
                                   np.asarray(lm_state.unigram_counts))
            npt.assert_array_equal(tseg.lm.bigram_counts,
                                   np.asarray(lm_state.bigram_counts))


@pytest.mark.parametrize("fb_type", ["standard", "viterbi"])
def test_unigram_block_steps_match_jax(fb_type):
    """Full FFBS and full Viterbi block steps (K8, K2, K9 in sample or
    argmax mode) equal JAX's on shared noise."""
    jseg, tseg = _pair(fb_type=fb_type)
    _run_block_steps(jseg, tseg, bigram=False)


def test_bigram_block_steps_match_jax():
    """Full bigram block steps (K8 with the LM's unigram weights, K2, K9's
    bigram mode) equal JAX's, both LM tables included."""
    jseg, tseg = _pair(bigram=True)
    _run_block_steps(jseg, tseg, bigram=True)


def test_same_seed_same_initial_state_and_log_marg():
    for bigram in (False, True):
        jseg, tseg = _pair(bigram=bigram)
        npt.assert_array_equal(tseg.utterances.boundaries,
                               np.asarray(jseg._boundaries_dev))
        npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                               np.asarray(jseg.acoustic_model.assignments))
        npt.assert_allclose(tseg.acoustic_model.stats.sum_sq.numpy(),
                            np.asarray(jseg.acoustic_model.stats.sum_sq),
                            rtol=1e-12)
        npt.assert_allclose(tseg.acoustic_model.log_prob_X_given_z(),
                            jseg.acoustic_model.log_prob_X_given_z(),
                            rtol=1e-10)
        npt.assert_allclose(tseg.log_marg() if bigram
                            else tseg.acoustic_model.log_marg(),
                            jseg.log_marg() if bigram
                            else jseg.acoustic_model.log_marg(), rtol=1e-10)


def test_bigram_unigram_scores_and_inside_loop_match_jax():
    """The bigram driver's unigram-marginal scorers and its one-embedding
    Gibbs step route through the full family (``am.cov``, ``add_item`` of
    outer products), as the JAX driver's do."""
    jseg, tseg = _pair(bigram=True)
    for i in (0, 5):
        vids = tseg.utterances.vec_ids[i]
        durs = tseg.utterances.durations[i]
        npt.assert_allclose(tseg.get_vec_embed_log_probs_unigram(vids, durs),
                            jseg.get_vec_embed_log_probs_unigram(vids, durs),
                            rtol=1e-9)
    npt.assert_allclose(tseg.log_marg_i_embed_unigram(7),
                        jseg.log_marg_i_embed_unigram(7), rtol=1e-9)
    jam, tam = jseg.acoustic_model, tseg.acoustic_model
    i_embed = int(np.nonzero(np.asarray(jam.assignments) == -1)[0][0])
    k = tseg.gibbs_sample_inside_loop_i_embed(
        i_embed, -1, 1.0, noise=torch.zeros(K, dtype=torch.float64))
    npt.assert_allclose(
        tam.stats.sum_sq[k].numpy() - np.asarray(jam.stats.sum_sq)[k],
        np.outer(tam.X[i_embed].numpy(), tam.X[i_embed].numpy()),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bigram", [False, True])
def test_driver_surface(bigram):
    """The 8-key record with finite log_marg; the full kernels' plain
    versions ran (the wrappers count only kernel launches, so the counts
    stay 0 on the CPU); a bigram segmenter's LM counts track the acoustic
    counts."""
    tseg = _port(bigram)
    before = (cuda_fullcov_score.launches, cuda_fullcov_chain.launches,
              cuda_fullcov_chain.bigram_launches)
    rec = tseg.gibbs_sample(3)
    assert set(rec) == set(RECORD_KEYS)
    assert all(len(v) == 3 for v in rec.values())
    assert np.isfinite(rec["log_marg"]).all()
    npt.assert_allclose(rec["log_marg"], np.add(rec["log_prob_z"],
                                                rec["log_prob_X_given_z"]),
                        rtol=1e-12)
    assert (cuda_fullcov_score.launches, cuda_fullcov_chain.launches,
            cuda_fullcov_chain.bigram_launches) == before
    if bigram:
        npt.assert_array_equal(tseg.lm.unigram_counts,
                               tseg.acoustic_model.stats.counts.numpy())


@pytest.mark.parametrize("bigram", [False, True])
def test_default_device_is_the_card(bigram):
    """Without ``device`` the segmenters run on the CUDA card, and raise
    where there is none; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    kw = _kwargs(bigram)
    with pytest.raises(RuntimeError, match="CUDA"):
        if bigram:
            pt.BigramAcousticWordseg(am_param_prior=_prior(pt), **kw)
        else:
            pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                      **kw)
    assert _port(bigram).device.type == "cpu"


def test_default_device_of_the_parts_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X = np.zeros((3, D))
    for build in (lambda: pt.BigramSmoothLM(0.1, 1.0, 1.0, 4),
                  lambda: pt.FBGMM(X, _prior(pt), 1.0, 4, np.zeros(3)),
                  lambda: pt.Utterances([1], [np.array([0])], [[1]], [[1]])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert pt.BigramSmoothLM(0.1, 1.0, 1.0, 4, device="cpu").K == 4


def test_fbgmm_defaults_to_the_full_family():
    """FBGMM's covariance_type defaults to "full", as the reference's does
    (segmentalist_tpu/models/fbgmm.py:119)."""
    X = np.random.RandomState(0).randn(5, D)
    am = pt.FBGMM(X, _prior(pt), 1.0, 4, np.array([0, 1, 0, -1, 2]),
                  device="cpu")
    assert am.covariance_type == "full" and am.full_cov
    assert am.cov is cov_module("full")


def test_native_source_is_the_port_own_copy():
    """The port compiles its own copy of the corpus helpers, byte for byte
    the JAX package's, so both give the same initial segmentation."""
    import os

    from segmentalist_torch import native

    ours = native.SOURCE
    theirs = os.path.join(os.path.dirname(jtpu.__file__), "native",
                          "corpus_ops.cpp")
    assert os.path.dirname(ours) == os.path.dirname(native.__file__)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
