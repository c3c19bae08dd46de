"""The port's checkpoint and resume (``utils/checkpoint.py``).

The JAX package's checkpoint tests (``tests/test_native_and_checkpoint.py:
93-232``) on the port: a roundtrip restores the state, the bigram LM tables
included; and a segmenter restored into a fresh one (another host RNG,
another generator seed) continues the uninterrupted chain bit for bit, in
every driver and family, across a k-means statistics rebuild and with the
acoustic model's own sweeps (``am_n_iter``).  Then a checkpoint written by
the JAX package (its own ``segmenter_state`` and ``_flatten``, in its npz
layout) continues in the port: the next block step on shared noise equals
the JAX block step at float64, and segmental k-means equals three JAX
sweeps.
"""

import os

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
from segmentalist_tpu.segmenters.kmeans_seg import (
    SegmentalKMeansWordseg as JaxKMeansSeg)
from segmentalist_tpu.segmenters.unigram import (
    UnigramAcousticWordseg as JaxUnigram)
from segmentalist_tpu.utils import checkpoint as jckpt

import segmentalist_torch as pt
from segmentalist_torch.segmenters import kmeans_seg
from segmentalist_torch.utils import checkpoint as ckpt
from segmentalist_torch.utils.synth import synthetic_corpus

LM_PARAMS = {"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0}
D = 4


def _build_segmenter(n_utterances=8, batch_size=4, seed=0):
    """``__graft_entry__._build_segmenter`` of the JAX tests, on the port."""
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=n_utterances, n_landmarks_max=6, D=10, K_true=4,
        n_slices_max=3, seed=seed)
    prior = pt.FixedVarPrior.create(0.05 * np.ones(10), np.zeros(10),
                                    np.ones(10))
    return pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=8, am_param_prior=prior,
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=3, batch_size=batch_size, seed=seed, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    seg = _build_segmenter(seed=5)
    seg.gibbs_sample(2)
    ckpt.save_checkpoint(str(tmp_path / "ck"), seg, step=2)
    assert os.path.exists(tmp_path / "ck" / "step_00000002.npz")
    am = seg.acoustic_model
    before = (am.stats.counts.clone(), am.assignments.clone(),
              seg.utterances.boundaries.copy())
    seg.gibbs_sample(2)  # perturb, then restore
    ckpt.restore_checkpoint(str(tmp_path / "ck"), seg, step=2)
    npt.assert_array_equal(am.stats.counts.numpy(), before[0].numpy())
    npt.assert_array_equal(am.assignments.numpy(), before[1].numpy())
    npt.assert_array_equal(seg.utterances.boundaries, before[2])
    rec = seg.gibbs_sample(1)  # the restored state samples on
    assert np.isfinite(rec["log_marg"][-1])


def test_checkpoint_roundtrip_bigram_lm_state(tmp_path):
    """Bigram segmenter checkpoints hold the LM count tables."""
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=6, n_landmarks_max=5, D=3, K_true=2, n_slices_max=3,
        seed=11)
    prior = pt.FixedVarPrior.create(0.05 * np.ones(3), np.zeros(3),
                                    np.ones(3))
    seg = pt.BigramAcousticWordseg(
        am_K=5, am_param_prior=prior, lm_params=LM_PARAMS,
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=3, fb_type="unigram", batch_size=3, seed=11,
        device="cpu")
    seg.gibbs_sample(2)
    ckpt.save_checkpoint(str(tmp_path / "ck"), seg, step=2)
    uni, big = seg.lm.unigram_counts.copy(), seg.lm.bigram_counts.copy()
    seg.gibbs_sample(2)
    ckpt.restore_checkpoint(str(tmp_path / "ck"), seg, step=2)
    npt.assert_array_equal(seg.lm.unigram_counts, uni)
    npt.assert_array_equal(seg.lm.bigram_counts, big)
    rec = seg.gibbs_sample(1)
    assert np.isfinite(rec["log_marg"][-1])


# ------------------------------------------------------ bit-exact resume

def _corpus(seed=7):
    return synthetic_corpus(n_utterances=8, n_landmarks_max=6, D=D,
                            K_true=3, n_slices_max=3, seed=seed)[:4]


def _prior(cov):
    if cov == "fixed":
        return pt.FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D),
                                       np.ones(D))
    S_0 = 0.2 * np.ones(D) if cov == "diag" else 0.2 * np.eye(D)
    return pt.NIW.create(np.zeros(D), 0.1, D + 3.0, S_0)


def _resume_segmenter(kind, cov, seed):
    em, vi, du, lm = _corpus()
    common = dict(embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                  landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=3,
                  batch_size=3, seed=seed, device="cpu")
    if kind == "kmeans":
        return pt.SegmentalKMeansWordseg(am_K=8, **common)
    if kind == "bigram":
        return pt.BigramAcousticWordseg(
            am_K=8, am_param_prior=_prior(cov), covariance_type=cov,
            lm_params=LM_PARAMS, fb_type="unigram", beta_sent_boundary=-1,
            **common)
    return pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=8, am_param_prior=_prior(cov),
        covariance_type=cov, beta_sent_boundary=-1, **common)


RESUMED = {  # name: (driver, family, sampling keywords)
    "unigram_fixed": ("unigram", "fixed", {}),
    "unigram_diag": ("unigram", "diag", {}),
    "unigram_full": ("unigram", "full", {}),
    "bigram": ("bigram", "fixed", {}),
    "kmeans": ("kmeans", None, {}),
    "unigram_fixed_am": ("unigram", "fixed", {"am_n_iter": 1}),
}


def _sweeps(seg, n, **kw):
    if isinstance(seg, pt.SegmentalKMeansWordseg):
        return seg.segment(n, validate=True, **kw)
    return seg.gibbs_sample(n, validate=True, **kw)


@pytest.mark.parametrize("name", list(RESUMED))
def test_checkpoint_resume_unchunked_is_bit_exact(name, tmp_path,
                                                  monkeypatch):
    """3 sweeps, save, 3 more; a fresh segmenter (another seed, so another
    host RNG, generator and initial state) restores and runs the same 3:
    the two end identical in every saved array, the generator's state
    included.  k-means rebuilds its statistics every 2 sweeps here, so the
    resumed sweeps cross a rebuild (after the first of them)."""
    kind, cov, kw = RESUMED[name]
    monkeypatch.setattr(kmeans_seg, "_RESYNC_EVERY", 2)
    seg_b = _resume_segmenter(kind, cov, seed=7)
    _sweeps(seg_b, 3, **kw)
    ckpt.save_checkpoint(str(tmp_path / "ck"), seg_b, step=3)
    _sweeps(seg_b, 3, **kw)

    seg_c = _resume_segmenter(kind, cov, seed=99)
    seg_c._rng = np.random.RandomState(999)  # overwritten by the restore
    if hasattr(seg_c, "_gen"):
        seg_c._gen.manual_seed(12345)
    ckpt.restore_checkpoint(str(tmp_path / "ck"), seg_c, step=3)
    if kind == "kmeans":
        assert seg_c._sweeps_since_resync == 1
    _sweeps(seg_c, 3, **kw)

    want = ckpt._flatten(ckpt.segmenter_state(seg_b))
    got = ckpt._flatten(ckpt.segmenter_state(seg_c))
    assert got.keys() == want.keys()
    for k in want:
        npt.assert_array_equal(got[k], want[k], err_msg=k)
    if hasattr(seg_b, "_gen"):
        # the shared generator: restored in place, not replaced
        assert seg_c._gen is seg_c.acoustic_model.generator
        assert "torch_generator/state" in want


def test_generator_state_of_another_device_type_is_not_restored(tmp_path,
                                                                caplog):
    """A CUDA generator's state is not set into a CPU generator: the
    sampler state is restored, the generator keeps its own, with a
    warning."""
    seg = _resume_segmenter("unigram", "fixed", seed=7)
    state = ckpt.segmenter_state(seg)
    state["torch_generator"] = {"state": np.zeros(16, np.uint8),
                                "device_type": np.asarray("cuda")}
    seg.gibbs_sample(1)
    gen_before = seg._gen.get_state().clone()
    ckpt.load_segmenter_state(seg, state)
    assert torch.equal(seg._gen.get_state(), gen_before)
    assert "not restored" in caplog.text
    npt.assert_array_equal(seg.utterances.boundaries, state["boundaries"])


# ------------------------------------------- a JAX checkpoint, continued

def _jax_prior():
    return jtpu.FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D),
                                     np.ones(D))


def _jax_checkpoint(jseg, path, step):
    """What ``jckpt.save_checkpoint`` writes without orbax: the JAX
    package's own state tree in its npz layout."""
    os.makedirs(path, exist_ok=True)
    state = jax.tree.map(np.asarray, jckpt.segmenter_state(jseg))
    np.savez(os.path.join(path, "step_%08d.npz" % step),
             **jckpt._flatten(state))
    return state


def _assert_restored(tseg, jstate):
    tam = tseg.acoustic_model
    npt.assert_array_equal(tseg.utterances.boundaries, jstate["boundaries"])
    if "kmeans_state" in jstate:
        for k, v in jstate["kmeans_state"].items():
            npt.assert_array_equal(getattr(tam.state, k).numpy(), v)
        npt.assert_array_equal(tam.random_means.numpy(),
                               jstate["random_means"])
        assert tseg._sweeps_since_resync == 0
    else:
        for k, v in jstate["stats"].items():
            npt.assert_array_equal(getattr(tam.stats, k).numpy(), v)
        npt.assert_array_equal(tam.assignments.numpy(), jstate["assignments"])
    if "lm" in jstate:
        npt.assert_array_equal(tseg.lm.unigram_counts,
                               jstate["lm"]["unigram_counts"])
        npt.assert_array_equal(tseg.lm.bigram_counts,
                               jstate["lm"]["bigram_counts"])
    h = jstate["host_rng"]
    _, keys, pos, has_gauss, cached = tseg._rng.get_state()
    npt.assert_array_equal(keys, h["keys"])
    assert (pos, has_gauss, cached) == (int(h["pos"]), int(h["has_gauss"]),
                                        float(h["cached"]))


def _fbgmm_pair(bigram, seed=5):
    em, vi, du, lm = _corpus(seed)
    common = dict(am_K=8, embedding_mats=em, vec_ids_dict=vi,
                  durations_dict=du, landmarks_dict=lm, p_boundary_init=0.5,
                  beta_sent_boundary=-1, n_slices_max=3, batch_size=3,
                  seed=seed)
    np.random.seed(seed)
    if bigram:
        jseg = JaxBigram(am_param_prior=_jax_prior(), lm_params=LM_PARAMS,
                         fb_type="unigram", **common)
        tseg = pt.BigramAcousticWordseg(
            am_param_prior=_prior("fixed"), lm_params=LM_PARAMS,
            fb_type="unigram", device="cpu", **dict(common, seed=seed + 1))
    else:
        jseg = JaxUnigram(jtpu.FBGMM, am_alpha=1.0,
                          am_param_prior=_jax_prior(), **common)
        tseg = pt.UnigramAcousticWordseg(
            pt.FBGMM, am_alpha=1.0, am_param_prior=_prior("fixed"),
            device="cpu", **dict(common, seed=seed + 1))
    return jseg, tseg


@pytest.mark.parametrize("bigram", [False, True], ids=["unigram", "bigram"])
def test_jax_checkpoint_continues_in_the_port(bigram, tmp_path):
    """A JAX checkpoint (after a JAX sweep) restores into a port segmenter
    built with another seed: its state equals the JAX state, and the next
    block step on shared noise equals the JAX block step from that state
    at float64."""
    jseg, tseg = _fbgmm_pair(bigram)
    jseg.gibbs_sample(1, validate=True)
    jstate = _jax_checkpoint(jseg, str(tmp_path / "ck"), 1)
    ckpt.restore_checkpoint(str(tmp_path / "ck"), tseg, step=1)
    _assert_restored(tseg, jstate)

    am, utt = jseg.acoustic_model, jseg.utterances
    B, N_max, K = 3, utt.N_max, am.K_max
    kw = {"assignments_only": False} if bigram else {}
    step = jseg._make_block_step(B, pallas=True, reduce_fn=lambda t: t, **kw)
    cand_X, cand_lp = jseg._cand_tables()
    key = jax.random.PRNGKey(21)
    carry = ((am.stats, am.assignments, jseg._boundaries_dev)
             + ((jseg.lm.state,) if bigram else ())
             + (key, jnp.zeros((), am.X.dtype)))
    block = np.array([6, 1, 3], dtype=np.int64)
    out, upd = step(carry, jnp.asarray(block), utt.seg_ids,
                    utt.seg_durations, utt.lengths_dev, 2.0, 1.5,
                    cand_X_all=cand_X, cand_lp_all=cand_lp)
    stats, assignments, bounds = out[:3]
    assignments = jcommon.merge_assignments(assignments, *upd, lambda t: t)
    # the noise the JAX step drew (unigram.py:956, :974; dp.py:196)
    _, k_dp, k_assign = jax.random.split(key, 3)
    dp_noise = jax.random.gumbel(k_dp, (B, N_max, tseg.W_dp), am.X.dtype)
    chain_noise = jax.random.gumbel(k_assign, (B, N_max, K), am.X.dtype)
    lp_t = tseg.block_step(block, 2.0, 1.5,
                           dp_noise=torch.as_tensor(np.array(dp_noise)),
                           chain_noise=torch.as_tensor(np.array(chain_noise)))
    tam = tseg.acoustic_model
    npt.assert_array_equal(tseg.utterances.boundaries, np.asarray(bounds))
    npt.assert_array_equal(tam.assignments.numpy(), np.asarray(assignments))
    npt.assert_array_equal(tam.stats.counts.numpy(), np.asarray(stats.counts))
    npt.assert_allclose(tam.stats.sum_x.numpy(), np.asarray(stats.sum_x),
                        rtol=1e-10, atol=1e-10)
    npt.assert_allclose(tam.stats.sum_sq.numpy(), np.asarray(stats.sum_sq),
                        rtol=1e-10, atol=1e-10)
    npt.assert_allclose(float(lp_t), float(out[-1]), rtol=1e-10)
    if bigram:
        npt.assert_array_equal(tseg.lm.unigram_counts,
                               np.asarray(out[3].unigram_counts))
        npt.assert_array_equal(tseg.lm.bigram_counts,
                               np.asarray(out[3].bigram_counts))


def test_jax_kmeans_checkpoint_continues_in_the_port(tmp_path):
    """A JAX segmental k-means checkpoint after two sweeps restores into a
    port segmenter built with another seed (the counter of sweeps since
    the last statistics rebuild at 0, which the JAX checkpoint lacks), and
    three further sweeps of each equal at float64: both order them with
    the restored host RNG (JAX below 8 sweeps)."""
    em, vi, du, lm = _corpus(5)
    kw = dict(p_boundary_init=0.5, n_slices_max=3, batch_size=3, wip=-0.3)
    np.random.seed(5)
    jseg = JaxKMeansSeg(6, em, vi, du, lm, seed=5, **kw)
    tseg = pt.SegmentalKMeansWordseg(6, em, vi, du, lm, seed=6,
                                     device="cpu", **kw)
    jseg.segment(2)
    jstate = _jax_checkpoint(jseg, str(tmp_path / "ck"), 2)
    ckpt.restore_checkpoint(str(tmp_path / "ck"), tseg, step=2)
    _assert_restored(tseg, jstate)
    rj, rt = jseg.segment(3), tseg.segment(3)
    npt.assert_allclose(rt["sum_neg_len_sqrd_norm"],
                        rj["sum_neg_len_sqrd_norm"], rtol=1e-10)
    jam, tam = jseg.acoustic_model, tseg.acoustic_model
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tam.assignments.numpy(),
                           np.asarray(jam.state.assignments))
    npt.assert_array_equal(tam.state.counts.numpy(),
                           np.asarray(jam.state.counts))
    npt.assert_allclose(tam.state.sum_x.numpy(), np.asarray(jam.state.sum_x),
                        rtol=1e-12, atol=1e-12)
