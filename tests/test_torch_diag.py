"""The port's diagonal-covariance segmenters against the JAX package, end to
end.

Both packages are built from one small synthetic corpus at one seed with
``covariance_type="diag"``; the JAX state (statistics, assignments,
boundaries, the NIW prior and, for the bigram segmenter, the LM tables) is
carried into the port with ``segmentalist_torch.interop`` and block steps
of each run on the same DP and chain noise (the noise the JAX block steps
draw from their keys: ``unigram.py:956, :974``; ``bigram.py:1029,
:1125``).  Also: the diag Viterbi oracle of
``tests/test_exact_posterior_diag.py`` on the port's segmenter, and the
driver surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.special import gammaln
from scipy.special import logsumexp as lse

import segmentalist_tpu as jtpu
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)
from segmentalist_tpu.segmenters.unigram import (
    UnigramAcousticWordseg as JaxUnigram)

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.ops import cuda_diag_chain, cuda_score
from segmentalist_torch.segmenters.blocked import RECORD_KEYS
from segmentalist_torch.utils.synth import synthetic_corpus

U, N_MAX, D, K, B, W = 12, 8, 4, 16, 4, 4
LM = {"type": "smooth", "intrp_lambda": 0.2, "a": 1.2, "b": 1.5}
BLOCKS = ([7, 2, 11, 0], [1, 3, 5, 9], [10, 4, -1, -1])


def _prior(pkg):
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, 0.4 * np.ones(D))


def _kwargs(bigram, **kw):
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=U, n_landmarks_max=N_MAX,
                                         D=D, K_true=3, n_slices_max=W, seed=3)
    args = dict(am_K=K, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                landmarks_dict=lm, covariance_type="diag",
                p_boundary_init=0.5, beta_sent_boundary=2.0, n_slices_max=W,
                batch_size=B, seed=5, lms=1.3, wip=-0.1, time_power_term=0.9)
    if bigram:
        args.update(lm_params=LM, fb_type="unigram")
    else:
        args.update(am_alpha=1.0)
    args.update(kw)
    return args


def _pair(bigram=False, **kw):
    np.random.seed(kw.get("seed", 5))  # the JAX init draws from numpy's RNG
    if bigram:
        return (JaxBigram(am_param_prior=_prior(jtpu), **_kwargs(True, **kw)),
                pt.BigramAcousticWordseg(am_param_prior=_prior(pt),
                                         **_kwargs(True, **kw)))
    return (JaxUnigram(jtpu.FBGMM, am_param_prior=_prior(jtpu),
                       **_kwargs(False, **kw)),
            pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                      **_kwargs(False, **kw)))


def _jax_state(jseg):
    am = jseg.acoustic_model
    state = {
        "X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
        "sum_x": np.asarray(am.stats.sum_x),
        "sum_sq": np.asarray(am.stats.sum_sq),
        "assignments": np.asarray(am.assignments),
        "boundaries": np.asarray(jseg._boundaries_dev),
        **{k: np.asarray(getattr(am.prior, k))
           for k in interop.PRIOR_KEYS["diag"]},
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
        npt.assert_allclose(float(lp_t), float(lp) - lp_prev, rtol=1e-10)
        lp_prev = float(lp)
        if bigram:
            lm_state = out[3]
            npt.assert_array_equal(tseg.lm.unigram_counts,
                                   np.asarray(lm_state.unigram_counts))
            npt.assert_array_equal(tseg.lm.bigram_counts,
                                   np.asarray(lm_state.bigram_counts))


@pytest.mark.parametrize("fb_type", ["standard", "viterbi"])
def test_unigram_block_steps_match_jax(fb_type):
    """Diag FFBS (kernels K5 grouped, K2, K6) and diag Viterbi (K5 exact,
    K6 argmax) block steps equal JAX's exactly on shared noise."""
    jseg, tseg = _pair(fb_type=fb_type)
    _run_block_steps(jseg, tseg, bigram=False)


def test_bigram_block_steps_match_jax():
    """Diag bigram block steps (K5 with the LM's unigram weights, K2, K7)
    equal JAX's exactly, both LM tables included."""
    jseg, tseg = _pair(bigram=True)
    _run_block_steps(jseg, tseg, bigram=True)


def test_same_seed_same_initial_state_and_log_marg():
    for bigram in (False, True):
        jseg, tseg = _pair(bigram=bigram)
        npt.assert_array_equal(tseg.utterances.boundaries,
                               np.asarray(jseg._boundaries_dev))
        npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                               np.asarray(jseg.acoustic_model.assignments))
        npt.assert_allclose(tseg.acoustic_model.log_prob_X_given_z(),
                            jseg.acoustic_model.log_prob_X_given_z(),
                            rtol=1e-10)
        npt.assert_allclose(tseg.log_marg() if bigram
                            else tseg.acoustic_model.log_marg(),
                            jseg.log_marg() if bigram
                            else jseg.acoustic_model.log_marg(), rtol=1e-10)


def test_bigram_unigram_scores_match_jax():
    """get_vec_embed_log_probs_unigram and log_marg_i_embed_unigram route
    through the diag family (``am.cov``), as the JAX driver's do."""
    jseg, tseg = _pair(bigram=True)
    for i in (0, 5):
        vids = tseg.utterances.vec_ids[i]
        durs = tseg.utterances.durations[i]
        npt.assert_allclose(tseg.get_vec_embed_log_probs_unigram(vids, durs),
                            jseg.get_vec_embed_log_probs_unigram(vids, durs),
                            rtol=1e-10)
    for i_embed in (0, 7, 30):
        npt.assert_allclose(tseg.log_marg_i_embed_unigram(i_embed),
                            jseg.log_marg_i_embed_unigram(i_embed),
                            rtol=1e-10)


@pytest.mark.parametrize("bigram", [False, True])
def test_driver_surface(bigram):
    """The 8-key record with finite log_marg; the diag kernels' plain
    versions ran (the wrappers count only kernel launches, so the counts
    stay 0 on the CPU)."""
    _, tseg = _pair(bigram=bigram)
    before = (cuda_score.diag_launches, cuda_diag_chain.launches,
              cuda_diag_chain.bigram_launches)
    rec = tseg.gibbs_sample(3)
    assert set(rec) == set(RECORD_KEYS)
    assert all(len(v) == 3 for v in rec.values())
    assert np.isfinite(rec["log_marg"]).all()
    npt.assert_allclose(rec["log_marg"], np.add(rec["log_prob_z"],
                                                rec["log_prob_X_given_z"]),
                        rtol=1e-12)
    assert (cuda_score.diag_launches, cuda_diag_chain.launches,
            cuda_diag_chain.bigram_launches) == before
    if bigram:
        npt.assert_array_equal(tseg.lm.unigram_counts,
                               tseg.acoustic_model.stats.counts.numpy())


@pytest.mark.parametrize("bigram", [False, True])
def test_full_covariance_raises_naming_m11(bigram):
    kw = _kwargs(bigram, covariance_type="full")
    prior = pt.NIW.create(np.zeros(D), 0.5, D + 3.0, np.eye(D))
    with pytest.raises(NotImplementedError, match="M11"):
        if bigram:
            pt.BigramAcousticWordseg(am_param_prior=prior, **kw)
        else:
            pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=prior, **kw)


# -- the diag Viterbi oracle (tests/test_exact_posterior_diag.py:188-) ----

D_O, K0_O, V0_O, ALPHA_O = 2, 1.2, 4.0, 1.0
M_0_O, S_0_O = np.array([0.15, -0.3]), np.array([0.8, 1.3])
PATTERNS = {(0, 1): [(0, 2)], (1, 1): [(0, 1), (1, 2)]}


def _pattern_embeds(p):
    return [e * (e - 1) // 2 + s for s, e in PATTERNS[p]]


def _pred(x, n, sx, sq):
    k_n, v_n = K0_O + n, V0_O + n
    m_n = (K0_O * M_0_O + sx) / k_n
    var = (k_n + 1.0) / (k_n * v_n) * (S_0_O + K0_O * M_0_O ** 2 + sq
                                       - k_n * m_n ** 2)
    return sum(gammaln((v_n + 1) / 2) - gammaln(v_n / 2)
               - 0.5 * np.log(v_n * np.pi * var[d])
               - (v_n + 1) / 2 * np.log1p((x[d] - m_n[d]) ** 2 / var[d] / v_n)
               for d in range(D_O))


def test_viterbi_move_matches_argmax_oracle():
    """fb_type="viterbi" with diag is deterministic: resampling utterance 0
    alone picks the max-product segmentation under the exact Student-t
    scores, then the MAP assignments with chained statistics (no lms, no
    weight denominator; reference fbgmm.py:465-494)."""
    rng = np.random.RandomState(17)
    emb0, emb1 = rng.randn(3, D_O) * 1.1, rng.randn(3, D_O) * 0.9
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=ALPHA_O, am_K=2,
        am_param_prior=pt.NIW.create(M_0_O, K0_O, V0_O, S_0_O),
        embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(3), "u1": np.arange(3)},
        durations_dict={"u0": [1, 2, 1], "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2], "u1": [1, 2]}, covariance_type="diag",
        p_boundary_init=0.5, beta_sent_boundary=-1, n_slices_max=2,
        time_power_term=0.0, wip=0.0, batch_size=1, seed=23,
        fb_type="viterbi")
    am = seg.acoustic_model
    X_all, assign = am.X.numpy(), am.assignments.numpy()
    c, sx, sq = np.zeros(2), np.zeros((2, D_O)), np.zeros((2, D_O))
    old = set(e for e in seg.utterances.get_segmented_embeds_i(0) if e != -1)
    for i, k in enumerate(assign):
        if k >= 0 and i not in old:
            c[k] += 1
            sx[k] += X_all[i]
            sq[k] += X_all[i] ** 2

    def score(x, k, c, sx, sq):
        return _pred(x, c[k], sx[k], sq[k])

    def cand(e):
        return lse([np.log(ALPHA_O / 2 + c[k]) - np.log(c.sum() + ALPHA_O)
                    + score(emb0[e], k, c, sx, sq) for k in range(2)])

    best_p = max(PATTERNS, key=lambda p: sum(cand(e)
                                             for e in _pattern_embeds(p)))
    best_ks = []
    for e in _pattern_embeds(best_p):
        k = int(np.argmax([np.log(ALPHA_O / 2 + c[kk])
                           + score(emb0[e], kk, c, sx, sq)
                           for kk in range(2)]))
        best_ks.append(k)
        c[k] += 1
        sx[k] += emb0[e]
        sq[k] += emb0[e] ** 2

    start = (am.stats, am.assignments.clone(),
             seg.utterances.boundaries_dev.clone())
    for t in range(3):  # deterministic under any noise
        am.stats, am.assignments = start[0], start[1].clone()
        seg.utterances.boundaries_dev = start[2].clone()
        seg._gen.manual_seed(100 + t)
        seg.block_step(np.array([0]))
        bounds = tuple(seg.utterances.boundaries[0, :2].astype(int).tolist())
        assert bounds == best_p
        ks = [int(am.assignments[e]) for e in _pattern_embeds(bounds)]
        assert ks == best_ks
