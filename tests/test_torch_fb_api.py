"""The port's module-level triangular DP API and the drivers' batch
scorers against the JAX package's.

``forward_backward`` runs on the Gumbel noise the JAX function draws from
its key (``jax.random.gumbel`` of that key at [1, N, W]), so both draw the
same segmentation; the Viterbi functions draw nothing.  The batch scorers
(``get_vec_embed_log_probs_all``,
``get_vec_embed_log_probs_unigram_all``) score every candidate of the
corpus against the global statistics, which the JAX segmenter's state,
carried across with ``interop.load_state``, fixes for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import segmentalist_tpu as jtpu
from segmentalist_tpu.segmenters import unigram as jun
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)
from segmentalist_tpu.segmenters.kmeans_seg import (
    forward_backward_kmeans_viterbi as jax_kmeans_viterbi)

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.ops import cuda_score
from segmentalist_torch.segmenters import unigram as tun
from segmentalist_torch.segmenters.kmeans_seg import (
    forward_backward_kmeans_viterbi)
from segmentalist_torch.utils.synth import synthetic_corpus

F64 = torch.float64


def _vec(seed, N):
    rng = np.random.RandomState(seed)
    vec = rng.randn(N * (N + 1) // 2) * 2.0
    vec[rng.rand(vec.size) < 0.1] = -np.inf  # missing embeddings
    return vec


@pytest.mark.parametrize("N,W", [(1, 1), (5, 3), (7, 7), (9, 4)])
def test_triangular_layout_matches_jax(N, W):
    """``_tri_to_dense`` and ``_dense_to_tri`` give the JAX package's
    arrays exactly, and round-trip the windowed slots."""
    vec = _vec(N, N)
    dense = tun._tri_to_dense(vec, N, W)
    npt.assert_array_equal(dense, jun._tri_to_dense(vec, N, W))
    lengths = [N, max(N - 2, 1)]
    stack = np.concatenate([dense, dense])
    for got, want in zip(tun._dense_to_tri(stack, lengths),
                         jun._dense_to_tri(stack, lengths)):
        npt.assert_array_equal(got, want)
    back = tun._dense_to_tri(dense, [N])[0]
    t = np.repeat(np.arange(N), np.arange(1, N + 1))
    start = np.concatenate([np.arange(k + 1) for k in range(N)])
    windowed = t - start < W
    npt.assert_array_equal(back[windowed], vec[windowed])
    assert np.all(back[~windowed] == -np.inf)


@pytest.mark.parametrize("n_min,n_max,lpc,temp", [
    (0, 0, -0.2, 1.0), (0, 3, np.log(0.7), 1.0), (2, 4, -0.1, 0.6)])
def test_forward_backward_matches_jax_on_shared_noise(n_min, n_max, lpc,
                                                      temp):
    N = 9
    vec = _vec(11, N)
    W = min(n_max, N) if n_max > 0 else N
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        lp_j, b_j = jun.forward_backward(vec, lpc, N, n_min, n_max,
                                         anneal_temp=temp, key=key)
        noise = np.array(jax.random.gumbel(key, (1, N, W), jnp.float64))
        lp_t, b_t = tun.forward_backward(vec, lpc, N, n_min, n_max,
                                         anneal_temp=temp, noise=noise[0],
                                         device="cpu", dtype=F64)
        npt.assert_array_equal(b_t, b_j)
        npt.assert_allclose(lp_t, lp_j, rtol=1e-12)


@pytest.mark.parametrize("n_min,n_max", [(0, 0), (0, 3), (2, 4), (1, 9)])
def test_viterbi_functions_match_jax(n_min, n_max):
    N = 9
    for seed in range(3):
        vec = _vec(20 + seed, N)
        lp_j, b_j = jun.forward_backward_viterbi(vec, -0.3, N, n_min, n_max)
        lp_t, b_t = tun.forward_backward_viterbi(vec, -0.3, N, n_min, n_max,
                                                 device="cpu", dtype=F64)
        npt.assert_array_equal(b_t, b_j)
        npt.assert_allclose(lp_t, lp_j, rtol=1e-12)
        ob_j, kb_j = jax_kmeans_viterbi(vec, N, n_min, n_max)
        ob_t, kb_t = forward_backward_kmeans_viterbi(vec, N, n_min, n_max,
                                                     device="cpu", dtype=F64)
        npt.assert_array_equal(kb_t, kb_j)
        npt.assert_allclose(ob_t, ob_j, rtol=1e-12)


def test_forward_backward_draws_from_the_generator():
    vec, N = _vec(3, 8), 8
    runs = [tun.forward_backward(vec, -0.1, N, n_slices_max=4,
                                 generator=torch.Generator().manual_seed(2),
                                 device="cpu")[1] for _ in range(2)]
    npt.assert_array_equal(*runs)
    assert runs[0][N - 1]


def test_module_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vec = _vec(0, 4)
    for call in (lambda: tun.forward_backward(vec, 0.0, 4),
                 lambda: tun.forward_backward_viterbi(vec, 0.0, 4),
                 lambda: forward_backward_kmeans_viterbi(vec, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --------------------------------------------------------- batch scorers

U, N_MAX, D, K, W = 10, 8, 3, 12, 4
LM = {"type": "smooth", "intrp_lambda": 0.2, "a": 1.2, "b": 1.5}


def _prior(pkg, cov):
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                        np.ones(D))
    S_0 = 0.4 * np.ones(D) if cov == "diag" else 0.4 * np.eye(D) + 0.05
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _segmenters(cov, bigram):
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=U, n_landmarks_max=N_MAX,
                                         D=D, K_true=3, n_slices_max=W,
                                         seed=8)
    args = dict(am_K=K, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                landmarks_dict=lm, covariance_type=cov, p_boundary_init=0.5,
                beta_sent_boundary=2.0, n_slices_max=W, batch_size=4, seed=6,
                lms=1.3, wip=-0.1, time_power_term=0.9)
    if bigram:
        args.update(lm_params=LM, fb_type="unigram")
        np.random.seed(6)
        jseg = JaxBigram(am_param_prior=_prior(jtpu, cov), **args)
        tseg = pt.BigramAcousticWordseg(am_param_prior=_prior(pt, cov),
                                        device="cpu", **args)
    else:
        np.random.seed(6)
        jseg = jun.UnigramAcousticWordseg(
            jtpu.FBGMM, am_alpha=1.0, am_param_prior=_prior(jtpu, cov),
            **args)
        tseg = pt.UnigramAcousticWordseg(
            pt.FBGMM, am_alpha=1.0, am_param_prior=_prior(pt, cov),
            device="cpu", **args)
    am = jseg.acoustic_model
    state = {"X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
             "sum_x": np.asarray(am.stats.sum_x),
             "sum_sq": np.asarray(am.stats.sum_sq),
             "assignments": np.asarray(am.assignments),
             "boundaries": np.asarray(jseg._boundaries_dev)}
    state.update({k: np.asarray(getattr(am.prior, k))
                  for k in interop.PRIOR_KEYS[cov]})
    if bigram:
        state.update(unigram_counts=np.asarray(jseg.lm.state.unigram_counts),
                     bigram_counts=np.asarray(jseg.lm.state.bigram_counts))
    interop.load_state(tseg, state)
    return jseg, tseg


@pytest.mark.parametrize("bigram", [False, True])
@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_batch_scorers_match_jax(cov, bigram):
    """Every utterance's packed vector: the windowed entries to rtol 1e-10
    at float64, the -inf pattern identical; ``utt_ids`` picks rows; the
    per-utterance scorer agrees on every windowed slot."""
    jseg, tseg = _segmenters(cov, bigram)
    name = ("get_vec_embed_log_probs_unigram" if bigram
            else "get_vec_embed_log_probs")
    before = cuda_score.launches
    got = getattr(tseg, name + "_all")()
    assert cuda_score.launches == before  # the CPU takes K1's plain version
    want = getattr(jseg, name + "_all")()
    assert len(got) == len(want) == U
    utt = tseg.utterances
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        npt.assert_array_equal(np.isneginf(g), np.isneginf(w))
        fin = np.isfinite(w)
        npt.assert_allclose(g[fin], w[fin], rtol=1e-10)
        T = g.shape[0]
        per = getattr(tseg, name)(utt.vec_ids[i, :T], utt.durations[i, :T])
        npt.assert_allclose(g[fin], per[fin], rtol=1e-10)
    sub = getattr(tseg, name + "_all")(utt_ids=[3, 0])
    npt.assert_array_equal(sub[0], got[3])
    npt.assert_array_equal(sub[1], got[0])
