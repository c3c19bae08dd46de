"""The port's unigram segmenter against the JAX package, end to end.

Both packages are built from one small synthetic corpus at one seed; the
JAX state is carried into the port with ``segmentalist_torch.interop`` and
one block step of each runs on the same DP and chain noise (the noise the
JAX block step draws from its key, ``unigram.py:956``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import segmentalist_tpu as jtpu
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters.unigram import (
    UnigramAcousticWordseg as JaxWordseg)
from segmentalist_tpu.utils.synth import synthetic_corpus as jax_synth

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.segmenters.unigram import RECORD_KEYS
from segmentalist_torch.utils.synth import synthetic_corpus

U, N_MAX, D, K, B, W = 12, 8, 4, 16, 4, 4


def _corpus():
    return synthetic_corpus(n_utterances=U, n_landmarks_max=N_MAX, D=D,
                            K_true=3, n_slices_max=W, seed=3)


def _kwargs(**kw):
    em, vi, du, lm, _ = _corpus()
    args = dict(am_alpha=1.0, am_K=K, embedding_mats=em, vec_ids_dict=vi,
                durations_dict=du, landmarks_dict=lm, p_boundary_init=0.5,
                beta_sent_boundary=2.0, n_slices_max=W, batch_size=B,
                seed=5, lms=1.3, wip=-0.1, time_power_term=0.9)
    args.update(kw)
    return args


def _prior(pkg):
    return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                    np.ones(D))


def _pair(**kw):
    np.random.seed(kw.get("seed", 5))  # the JAX init draws from numpy's RNG
    jseg = JaxWordseg(jtpu.FBGMM, am_param_prior=_prior(jtpu), **_kwargs(**kw))
    tseg = pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                     device="cpu", **_kwargs(**kw))
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
    }


def test_synthetic_corpus_copy_matches():
    for a, b in zip(_corpus(), jax_synth(n_utterances=U, n_landmarks_max=N_MAX,
                                         D=D, K_true=3, n_slices_max=W,
                                         seed=3)):
        assert a.keys() == b.keys()
        for k in a:
            npt.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_same_seed_same_initial_state():
    jseg, tseg = _pair()
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                           np.asarray(jseg.acoustic_model.assignments))
    npt.assert_array_equal(tseg.acoustic_model.stats.counts.numpy(),
                           np.asarray(jseg.acoustic_model.stats.counts))
    npt.assert_array_equal(tseg.utterances.seg_ids.numpy(),
                           np.asarray(jseg.utterances.seg_ids))


@pytest.mark.parametrize("fb_type", ["standard", "viterbi"])
def test_block_step_matches_jax(fb_type):
    """Three consecutive block steps (the last one padded) on carried-across
    state and shared noise give exactly JAX's boundaries and assignments."""
    jseg, tseg = _pair(fb_type=fb_type)
    interop.load_state(tseg, _jax_state(jseg))
    am, utt = jseg.acoustic_model, jseg.utterances
    step = jseg._make_block_step(B, pallas=True, reduce_fn=lambda t: t)
    cand_X, cand_lp = jseg._cand_tables()
    carry = (am.stats, am.assignments, jseg._boundaries_dev,
             jax.random.PRNGKey(21), jnp.zeros((), am.X.dtype))
    tam = tseg.acoustic_model
    lp_prev = 0.0
    for block in ([7, 2, 11, 0], [1, 3, 5, 9], [10, 4, -1, -1]):
        block = np.array(block, dtype=np.int64)
        key = carry[3]  # the key this step splits
        (stats, assignments, bounds, key_out, lp), upd = step(
            carry, jnp.asarray(block), utt.seg_ids, utt.seg_durations,
            utt.lengths_dev, 2.0, 1.5, cand_X_all=cand_X,
            cand_lp_all=cand_lp)
        assignments = jcommon.merge_assignments(assignments, *upd,
                                                lambda t: t)
        carry = (stats, assignments, bounds, key_out, lp)

        # the noise the JAX step drew (unigram.py:956, :974; dp.py:196)
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


def test_seed_boundaries_and_assignments_match_jax():
    em, vi, du, lm, truth = _corpus()
    rng = np.random.RandomState(0)
    seed_b = {u: [lm[u][j] for j in np.flatnonzero(truth[u])] for u in truth}
    seed_a = {u: ["w%d" % rng.randint(3) for _ in seed_b[u]] for u in truth}
    jseg, tseg = _pair(seed_boundaries_dict=seed_b,
                       seed_assignments_dict=seed_a, am_K=None)
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tseg.acoustic_model.assignments.numpy(),
                           np.asarray(jseg.acoustic_model.assignments))
    assert tseg.seed_to_cluster == jseg.seed_to_cluster
    assert tseg.acoustic_model.K_max == jseg.acoustic_model.K_max == 3


def test_gibbs_sample_record():
    _, tseg = _pair()
    rec = tseg.gibbs_sample(4)
    assert set(rec) == set(RECORD_KEYS)
    assert all(len(v) == 4 for v in rec.values())
    assert np.isfinite(rec["log_marg"]).all()
    npt.assert_allclose(rec["log_marg"], np.add(rec["log_prob_z"],
                                                rec["log_prob_X_given_z"]))
    for i in range(U):
        assert all(k >= 0 for k in tseg.get_unsup_transcript_i(i))


def test_annealed_viterbi_sampling_runs():
    _, tseg = _pair(fb_type="viterbi")
    rec = tseg.gibbs_sample(3, anneal_schedule="linear",
                            anneal_gibbs_am=True)
    assert np.isfinite(rec["log_marg"]).all()
    npt.assert_allclose(rec["anneal_temp"], 1.0 / np.linspace(0.1, 1.0, 3))


def test_gibbs_sample_takes_am_n_iter_second():
    """The reference's positional order (n_iter, am_n_iter,
    anneal_schedule, ...): "linear" binds to the schedule, and am_n_iter
    runs that many acoustic-model sweeps (sequential, assigned items only)
    before each sweep: the unassigned candidate spans stay unassigned and
    log_marg stays finite."""
    _, tseg = _pair()
    rec = tseg.gibbs_sample(1, 0, "linear")
    npt.assert_allclose(rec["anneal_temp"], [10.0])
    am = tseg.acoustic_model
    calls = []
    inner = am.gibbs_sample

    def counted(n_iter, consider_unassigned=True, **kw):
        calls.append((n_iter, consider_unassigned))
        return inner(n_iter, consider_unassigned, **kw)

    am.gibbs_sample = counted
    rec = tseg.gibbs_sample(2, 1)
    assert calls == [(1, False), (1, False)]
    assert np.isfinite(rec["log_marg"]).all()
    assigned = am.assignments.numpy() >= 0
    assert assigned.sum() == int(am.stats.counts.sum()) == rec["n_tokens"][-1]


def test_the_am_sweeps_statistics_are_rebuilt_from_the_assignments():
    """After its ``am_n_iter`` sweeps the acoustic model's statistics are
    rebuilt from its assignments, so the item chain's float32 running
    sums, which drift, never reach the block steps."""
    from segmentalist_torch.ops.stats import suff_stats_from_assignments

    _, tseg = _pair()
    am = tseg.acoustic_model
    inner = am.gibbs_sample

    def drifted(*a, **kw):
        out = inner(*a, **kw)
        am.stats = am.stats._replace(sum_x=am.stats.sum_x + 0.5)
        return out

    def step(*a, **k):  # the block steps read the statistics only
        seen.append((am.stats, suff_stats_from_assignments(
            am.X, am.assignments, am.K_max, am.full_cov)))
        return torch.zeros(())

    seen = []
    am.gibbs_sample = drifted
    tseg.block_step = step
    tseg.gibbs_sample(2, 1)
    assert len(seen) > 2
    for got, want in seen:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _toy_segmenter():
    """The reference's one-utterance toy corpus
    (``tests/test_unigram_wordseg.py:19-66``)."""
    emb = np.array([
        [-0.2702691, -0.12348549, -0.20069546, -0.10067126, -0.32822475,
         -0.24878924, -0.17988801, -0.13201745, 0.66409844, -0.44816282],
        [-0.27186683, -0.12384345, -0.20049213, -0.10272419, -0.32618827,
         -0.24660945, -0.17784701, -0.13362537, 0.66524321, -0.44805479],
        [-0.2465426, -0.06354388, -0.22458388, 0.79060942, 0.48230717,
         -0.11888564, 0.06724239, -0.04977163, 0.06908087, 0.03395205]])
    S_0 = 0.002 * np.ones(10)
    prior = pt.FixedVarPrior.create(S_0, np.zeros(10), S_0 / 0.05)
    return pt.UnigramAcousticWordseg(
        pt.FBGMM, 10.0, 2, prior, {"test": emb},
        {"test": np.array([0, 1, 2])}, {"test": [1, 2, 1]},
        {"test": [1, 2]}, seed_boundaries_dict={"test": [2]},
        beta_sent_boundary=-1, n_slices_max=20, batch_size=1, device="cpu")


def test_vec_embed_log_probs_match_reference_values():
    """Reference-pinned candidate scores (tests/test_unigram_wordseg.py:69)."""
    seg = _toy_segmenter()
    seg.acoustic_model.setup_components(2, np.array([0, -1, 1]))
    got = seg.get_vec_embed_log_probs(seg.utterances.vec_ids[0],
                                      seg.utterances.durations[0])
    npt.assert_almost_equal(got, [17.5548998, 35.103967, 17.5548998],
                            decimal=5)


def test_log_marg_matches_reference_pinned_states():
    """Reference-pinned log_marg values (tests/test_unigram_wordseg.py:87)."""
    am = _toy_segmenter().acoustic_model
    am.setup_components(2, np.array([-1, 0, -1]))
    npt.assert_allclose(am.log_marg(), -5.9368664797514707, rtol=1e-6)
    am.setup_components(2, np.array([0, -1, 1]))
    npt.assert_allclose(am.log_marg(), -11.969040866436707, rtol=1e-6)


def test_one_by_one_init_is_refused():
    """The name is kept from when the port refused "one-by-one"; the init
    now runs: every initial segment is assigned, in corpus order, against
    the statistics of the segments before it, and nothing else is."""
    seg = pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                    init_am_assignments="one-by-one",
                                    device="cpu", **_kwargs())
    am = seg.acoustic_model
    embeds = seg.utterances.all_segmented_embeds()
    embeds = embeds[embeds >= 0]
    assigned = np.flatnonzero(am.assignments.numpy() >= 0)
    npt.assert_array_equal(np.sort(embeds), assigned)
    assert int(am.stats.counts.sum()) == len(embeds)
    rec = seg.gibbs_sample(2, 1)
    assert np.isfinite(rec["log_marg"]).all()


def _am_prior(pkg, cov):
    if cov == "fixed":
        return _prior(pkg)
    return pkg.NIW.create(np.zeros(D), 0.5, D + 3.0,
                          0.5 * np.eye(D) + 0.05 * np.ones((D, D)))


@pytest.mark.parametrize("cov", ["fixed", "full"])
def test_one_by_one_init_matches_jax(monkeypatch, cov):
    """``init_am_assignments="one-by-one"`` draws every initial segment in
    corpus order against the segments before it (JAX:
    ``gibbs_sample_inside_loop_i`` a segment on ``split(key)`` noise; the
    port: one ``reassign_items`` chain, K10's or, full, K11's plain
    version).  On the JAX noise the port's model is the JAX model:
    identical assignments and counts, sums to float64 rounding."""
    seed = 5
    np.random.seed(seed)
    jseg = JaxWordseg(jtpu.FBGMM, am_param_prior=_am_prior(jtpu, cov),
                      init_am_assignments="one-by-one",
                      **_kwargs(covariance_type=cov))
    embeds = jseg.utterances.all_segmented_embeds()
    n = int((embeds >= 0).sum())
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (K,), jnp.float64)))
    monkeypatch.setattr(pt.FBGMM, "draw_noise",
                        lambda self, rows: torch.as_tensor(np.stack(noise)))
    tseg = pt.UnigramAcousticWordseg(pt.FBGMM,
                                     am_param_prior=_am_prior(pt, cov),
                                     init_am_assignments="one-by-one",
                                     device="cpu",
                                     **_kwargs(covariance_type=cov))
    jam, tam = jseg.acoustic_model, tseg.acoustic_model
    assert tam.covariance_type == cov
    npt.assert_array_equal(tam.assignments.numpy(),
                           np.asarray(jam.assignments))
    npt.assert_array_equal(tam.stats.counts.numpy(),
                           np.asarray(jam.stats.counts))
    for a, b in ((jam.stats.sum_x, tam.stats.sum_x),
                 (jam.stats.sum_sq, tam.stats.sum_sq)):
        npt.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                            atol=1e-12)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.UnigramAcousticWordseg(pt.FBGMM, am_param_prior=_prior(pt),
                                  device="cuda", **_kwargs())
