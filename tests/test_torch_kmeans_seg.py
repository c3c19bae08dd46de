"""The port's segmental k-means segmenter against the JAX package's, end
to end, and the JAX tests' oracles and invariants on the port.

Both packages are built from one small synthetic corpus at one seed: the
JAX segmenter takes its initial draws from numpy's global RNG after
``np.random.seed(seed)``, the port the same draws from
``RandomState(seed)``.  The block step has no sampling noise (a Viterbi DP,
then nearest means), so at float64 the port reproduces the JAX
trajectory exactly; runs stay under 8 sweeps, where the JAX package still
takes its utterance orders from the host RNG.  On the CPU the DP is K2's
plain version (``ops/dp.segment_dp_plain``).
"""

import itertools

import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.segmenters.kmeans_seg import (
    SegmentalKMeansWordseg as JaxKMeansSeg)

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.models.kmeans import kmeans_state_from_assignments
from segmentalist_torch.ops import cuda_dp
from segmentalist_torch.segmenters.kmeans_seg import RECORD_KEYS
from segmentalist_torch.utils.synth import synthetic_corpus

F32_AGREE = 0.99   # share of identical boundaries / assignments at float32
F32_OBJ_RTOL = 1e-5

CORPORA = {  # constructor keywords beyond the corpus
    "base": {},
    "n_slices_min_1": {"n_slices_min": 1},
    "n_slices_min_2": {"n_slices_min": 2},
    "min_duration": {"min_duration": 15},  # masks every one-slice span
}


def _corpus(dtype="float64", U=12, N_max=8, D=3, W=4, seed=3):
    em, vi, du, lm, truth = synthetic_corpus(
        n_utterances=U, n_landmarks_max=N_max, D=D, K_true=3,
        n_slices_max=W, seed=seed)
    return {k: v.astype(dtype) for k, v in em.items()}, vi, du, lm, truth


def _kwargs(**kw):
    args = dict(n_slices_max=4, batch_size=4, seed=5, wip=-0.3)
    args.update(kw)
    return args


def _pair(am_K=6, dtype="float64", corpus=None, **kw):
    em, vi, du, lm, _ = corpus or _corpus(dtype)
    args = _kwargs(**kw)
    np.random.seed(args["seed"])  # the JAX init draws from numpy's RNG
    jseg = JaxKMeansSeg(am_K, em, vi, du, lm, **args)
    tseg = pt.SegmentalKMeansWordseg(am_K, em, vi, du, lm, device="cpu",
                                     **args)
    return jseg, tseg


def _jax_state(jseg):
    am = jseg.acoustic_model
    return {"X": np.asarray(am.X), "counts": np.asarray(am.state.counts),
            "sum_x": np.asarray(am.state.sum_x),
            "assignments": np.asarray(am.state.assignments),
            "random_means": np.asarray(am.random_means),
            "boundaries": np.asarray(jseg._boundaries_dev)}


def _assert_same_state(jseg, tseg, rtol=1e-12, atol=1e-12):
    jam, tam = jseg.acoustic_model, tseg.acoustic_model
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tam.assignments.numpy(),
                           np.asarray(jam.state.assignments))
    npt.assert_array_equal(tam.state.counts.numpy(),
                           np.asarray(jam.state.counts))
    npt.assert_allclose(tam.state.sum_x.numpy(), np.asarray(jam.state.sum_x),
                        rtol=rtol, atol=atol)


# ------------------------------------------------------ against the JAX

def test_same_seed_same_initial_state():
    for init in ("rand", "spread"):
        jseg, tseg = _pair(init_am_assignments=init)
        _assert_same_state(jseg, tseg)
        npt.assert_array_equal(tseg.acoustic_model.random_means.numpy(),
                               np.asarray(jseg.acoustic_model.random_means))


def test_bench_configuration_starts_from_the_jax_state():
    """``utils/profiling.bench_kmeans_segmenter`` builds ``bench.py:442-452``'s
    segmenter (float32) in the JAX package's initial state after
    ``np.random.seed(0)``."""
    from segmentalist_torch.utils.profiling import (bench_corpus,
                                                    bench_kmeans_segmenter)

    tseg, _ = bench_kmeans_segmenter(20, "cpu")
    em, vi, du, lm, _ = bench_corpus(20)
    np.random.seed(0)
    jseg = JaxKMeansSeg(1000, em, vi, du, lm, p_boundary_init=0.5,
                        n_slices_max=6, batch_size=125, seed=0)
    _assert_same_state(jseg, tseg, rtol=1e-6, atol=1e-5)
    assert (tseg.acoustic_model.K_max, tseg.batch_size, tseg.W_dp) == (
        1000, 125, 6)


@pytest.mark.parametrize("inbetween", [0, 1])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_segment_matches_jax_f64(corpus, inbetween):
    """``segment(5)``, with and without a k-means iteration after each
    sweep: identical boundaries, assignments and counts, the records to
    rtol 1e-10."""
    jseg, tseg = _pair(**CORPORA[corpus])
    rj = jseg.segment(5, n_iter_inbetween_kmeans=inbetween)
    rt = tseg.segment(5, n_iter_inbetween_kmeans=inbetween)
    assert set(rt) == set(RECORD_KEYS) == set(rj)
    for k in ("components", "n_tokens"):
        assert rt[k] == rj[k], k
    for k in ("sum_neg_sqrd_norm", "sum_neg_len_sqrd_norm"):
        npt.assert_allclose(rt[k], rj[k], rtol=1e-10, err_msg=k)
    _assert_same_state(jseg, tseg, rtol=1e-10)


@pytest.mark.parametrize("inbetween", [0, 1])
def test_segment_matches_jax_f32(inbetween):
    """float32: boundaries and assignments agree to ``F32_AGREE``, the
    objectives to ``F32_OBJ_RTOL``."""
    jseg, tseg = _pair(am_K=8, dtype="float32",
                       corpus=_corpus("float32", U=24, N_max=10, D=4))
    rj = jseg.segment(5, n_iter_inbetween_kmeans=inbetween)
    rt = tseg.segment(5, n_iter_inbetween_kmeans=inbetween)
    assert tseg.acoustic_model.X.dtype == torch.float32
    b_j = np.asarray(jseg._boundaries_dev)
    a_j = np.asarray(jseg.acoustic_model.state.assignments)
    assert (tseg.utterances.boundaries == b_j).all(1).mean() >= F32_AGREE
    assert (tseg.acoustic_model.assignments.numpy() == a_j).mean() \
        >= F32_AGREE
    for k in ("sum_neg_sqrd_norm", "sum_neg_len_sqrd_norm"):
        npt.assert_allclose(rt[k], rj[k], rtol=F32_OBJ_RTOL, err_msg=k)


def test_block_step_from_a_loaded_jax_state_matches():
    """One block step of each package from one state, the JAX segmenter's
    after two sweeps, carried across with ``interop.load_state``."""
    jseg, tseg = _pair(seed=9)
    jseg.segment(2)
    interop.load_state(tseg, _jax_state(jseg))
    _assert_same_state(jseg, tseg)
    block = np.array([7, 2, -1, 11])
    obj_j = jseg._run_blocks(block.reshape(1, -1))
    before = cuda_dp.launches
    obj_t = float(tseg.block_step(block))
    assert cuda_dp.launches == before  # the CPU takes the plain version
    npt.assert_allclose(obj_t, obj_j, rtol=1e-12)
    _assert_same_state(jseg, tseg)


def test_load_state_asks_for_the_kmeans_keys():
    _, tseg = _pair()
    with pytest.raises(KeyError, match="random_means"):
        interop.load_state(tseg, {k: None for k in interop.KMEANS_KEYS
                                  if k != "random_means"})


def test_vec_embed_neg_len_sqrd_norms_match_jax():
    jseg, tseg = _pair()
    jseg.segment(1)
    tseg.segment(1)
    utt = tseg.utterances
    for i in (0, 5, 11):
        T = utt.lengths[i] * (utt.lengths[i] + 1) // 2
        args = (utt.vec_ids[i, :T], utt.durations[i, :T])
        got = tseg.get_vec_embed_neg_len_sqrd_norms(*args)
        want = jseg.get_vec_embed_neg_len_sqrd_norms(*args)
        npt.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        npt.assert_allclose(got[fin], want[fin], rtol=1e-12)
        assert tseg.get_max_unsup_transcript_i(i) == [
            int(k) for k in jseg.get_max_unsup_transcript_i(i)]
        assert tseg.get_unsup_transcript_i(i) == [
            int(k) for k in jseg.get_unsup_transcript_i(i)]


def test_segment_i_matches_jax():
    jseg, tseg = _pair(batch_size=3)
    for i in (4, 0, 4):
        npt.assert_allclose(tseg.segment_i(i), jseg.segment_i(i),
                            rtol=1e-12)
    _assert_same_state(jseg, tseg)


# ---------------------------------------------- the JAX tests' oracles

_PATTERNS = {  # boundaries at landmarks 0, 1, 2 -> (start, end) spans
    (0, 0, 1): [(0, 3)],
    (1, 0, 1): [(0, 1), (1, 3)],
    (0, 1, 1): [(0, 2), (2, 3)],
    (1, 1, 1): [(0, 1), (1, 2), (2, 3)],
}


def _pattern_embeds(pattern):
    return [e * (e - 1) // 2 + s for s, e in _PATTERNS[pattern]]


def test_segment_move_matches_argmax_oracle():
    """``segment_i`` is deterministic: duration-scaled best-component
    distances per candidate (reference kmeans_acoustic_wordseg.py:334-351),
    the max-sum segmentation (:449-555), then nearest means (:436-442),
    against every segmentation enumerated.  The means are the global ones,
    the block step's (the JAX package's ``kmeans_seg.py:535``; its own
    oracle test leaves the utterance out, which agrees on that toy)."""
    rng = np.random.RandomState(21)
    emb0 = rng.randn(6, 2) * 1.3
    emb1 = rng.randn(3, 2)
    durations = np.array([1.0, 2.0, 1.0, 3.0, 2.0, 1.0])
    wip = 0.7
    seg = pt.SegmentalKMeansWordseg(
        am_K=3, embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(6), "u1": np.arange(3)},
        durations_dict={"u0": durations.astype(int).tolist(),
                        "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2, 3], "u1": [1, 2]}, p_boundary_init=0.5,
        n_slices_max=3, wip=wip, batch_size=1, seed=19, device="cpu")
    am = seg.acoustic_model
    means = am.means().numpy()

    def d2(e):
        return ((emb0[e][None, :] - means) ** 2).sum(-1)

    def score(p):
        return sum(-d2(e).min() * durations[e] + wip
                   for e in _pattern_embeds(p))

    best = max(_PATTERNS, key=score)
    best_ks = [int(np.argmin(d2(e))) for e in _pattern_embeds(best)]
    st0, b0 = am.state, seg.utterances.boundaries
    for _ in range(3):  # deterministic: the same move from the same state
        am.state, seg.utterances.boundaries = st0, b0
        obj = seg.segment_i(0)
        bounds = tuple(seg.utterances.boundaries[0, :3].astype(int).tolist())
        assert bounds == best
        npt.assert_allclose(obj, score(best), rtol=1e-12)
        assert [int(am.assignments[e]) for e in
                _pattern_embeds(bounds)] == best_ks


def _check_segmentation(seg):
    """The final boundary is set, and the assigned items are exactly the
    current segments (tests/test_fuzz_invariants.py)."""
    n_tokens = 0
    for i in range(seg.utterances.D):
        N = seg.utterances.lengths[i]
        assert seg.utterances.boundaries[i][N - 1]
        n_tokens += sum(1 for e in seg.utterances.get_segmented_embeds_i(i)
                        if e != -1)
    am = seg.acoustic_model
    assert int((am.assignments >= 0).sum()) == n_tokens
    assert int(am.state.counts.sum()) == n_tokens
    assert int(am.state.counts.min()) >= 0


@pytest.mark.parametrize("seed", [3, 4])
def test_kmeans_fuzz(seed):
    """tests/test_fuzz_invariants.py::test_kmeans_fuzz on the port."""
    rng = np.random.RandomState(seed)
    n_lm = rng.randint(3, 8)
    W = rng.randint(2, min(4, n_lm) + 1)
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=rng.randint(3, 8), n_landmarks_max=n_lm,
        D=rng.randint(2, 5), K_true=2, n_slices_max=W, seed=seed)
    seg = pt.SegmentalKMeansWordseg(
        am_K=rng.randint(3, 8), embedding_mats=em, vec_ids_dict=vi,
        durations_dict=du, landmarks_dict=lm,
        p_boundary_init=float(rng.uniform(0.2, 0.9)), n_slices_max=W,
        wip=float(rng.uniform(-1, 1)), batch_size=int(rng.randint(1, 4)),
        seed=seed, device="cpu")
    rec = seg.segment(3, n_iter_inbetween_kmeans=int(rng.choice([0, 1])))
    assert np.isfinite(rec["sum_neg_sqrd_norm"]).all()
    _check_segmentation(seg)


def test_spread_init():
    """tests/test_init_paths.py::test_kmeans_spread_init on the port: the
    spread balances the components (max - min <= 1 among the used)."""
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=5, n_landmarks_max=5,
                                         D=3, K_true=2, n_slices_max=3,
                                         seed=13)
    seg = pt.SegmentalKMeansWordseg(
        am_K=4, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, init_am_assignments="spread",
        p_boundary_init=0.5, n_slices_max=3, batch_size=2, seed=13,
        device="cpu")
    counts = seg.acoustic_model.state.counts.numpy()
    assert counts.max() - counts[counts > 0].min() <= 1
    rec = seg.segment(2)
    assert np.isfinite(rec["sum_neg_sqrd_norm"]).all()


def test_statistics_resync_after_128_sweeps():
    """tests/test_chunked_sweeps.py::test_kmeans_chunked_sweeps's rebuild
    check over 130 sweeps: the statistics equal a rebuild from the
    assignments, the exact rebuild having run at sweep 128."""
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=12, n_landmarks_max=6,
                                         D=6, K_true=4, n_slices_max=3,
                                         seed=5)
    seg = pt.SegmentalKMeansWordseg(
        am_K=8, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, n_slices_max=3, batch_size=4, seed=3,
        device="cpu")
    record = seg.segment(130)
    assert all(len(v) == 130 for v in record.values())
    assert np.isfinite(record["sum_neg_sqrd_norm"]).all()
    assert seg._sweeps_since_resync == 2
    am = seg.acoustic_model
    rebuilt = kmeans_state_from_assignments(am.X, am.assignments, am.K_max)
    npt.assert_array_equal(am.state.counts.numpy(), rebuilt.counts.numpy())
    npt.assert_allclose(am.state.sum_x.numpy(), rebuilt.sum_x.numpy(),
                        atol=1e-5)


def _toy_corpus():
    """tests/test_kmeans.py's toy: two "words" over 3-landmark
    utterances."""
    rng = np.random.RandomState(0)
    w1, w2 = rng.randn(4), rng.randn(4) + 4.0
    mats, vids, durs, lms = {}, {}, {}, {}
    for u in range(4):
        vec_ids = -1 * np.ones(6, dtype=int)
        rows = []
        for i_embed, (start, end) in enumerate(
                (s, e) for s in range(3) for e in range(s, 3)):
            vec_ids[(end + 1) * end // 2 + start] = i_embed
            if (start, end) == (0, 0):
                rows.append(w1 + 0.05 * rng.randn(4))
            elif (start, end) == (1, 2):
                rows.append(w2 + 0.05 * rng.randn(4))
            else:
                rows.append(rng.randn(4) * 2.0)
        mats["utt%d" % u] = np.array(rows)
        vids["utt%d" % u] = vec_ids
        durs["utt%d" % u] = [1, 2, 1, 3, 2, 1]
        lms["utt%d" % u] = [1, 2, 3]
    return mats, vids, durs, lms


def _toy_segmenter(batch_size):
    mats, vids, durs, lms = _toy_corpus()
    return pt.SegmentalKMeansWordseg(
        am_K=3, embedding_mats=mats, vec_ids_dict=vids, durations_dict=durs,
        landmarks_dict=lms, p_boundary_init=0.5, n_slices_max=3,
        batch_size=batch_size, seed=1, device="cpu")


def test_segmental_kmeans_runs_and_improves():
    """tests/test_kmeans.py::test_segmental_kmeans_runs_and_improves."""
    seg = _toy_segmenter(2)
    record = seg.segment(5, n_iter_inbetween_kmeans=1)
    assert record["sum_neg_len_sqrd_norm"][-1] \
        >= record["sum_neg_len_sqrd_norm"][0]
    for i in range(4):
        assert all(k >= 0 for k in seg.get_unsup_transcript_i(i))
        assert seg.get_max_unsup_transcript_i(i)
    v = seg.get_vec_embed_neg_len_sqrd_norms(seg.utterances.vec_ids[0],
                                             seg.utterances.durations[0])
    assert np.isfinite(v).all()


def test_segment_i_moves_one_utterance():
    """tests/test_kmeans.py::test_segmental_kmeans_batch1_matches_semantics:
    ``segment_i`` changes only its own utterance's boundaries."""
    seg = _toy_segmenter(1)
    before = seg.utterances.boundaries
    seg.segment_i(2)
    after = seg.utterances.boundaries
    for i in (0, 1, 3):
        npt.assert_array_equal(after[i], before[i])
    assert after[2][2]


def test_segmenter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mats, vids, durs, lms = _toy_corpus()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.SegmentalKMeansWordseg(3, mats, vids, durs, lms)
    with pytest.raises(NotImplementedError):
        pt.SegmentalKMeansWordseg(3, mats, vids, durs, lms,
                                  seed_boundaries_dict={u: [3] for u in lms},
                                  seed_assignments_dict={u: [0] for u in lms},
                                  device="cpu")


def test_ties_break_toward_shorter_segments():
    """Every candidate costs the same a slice: every segmentation ties,
    and the Viterbi DP takes one-slice segments throughout (the plain
    version's tie rule, K2's too)."""
    U = 3
    mats = {"u%d" % u: np.zeros((6, 2)) for u in range(U)}
    vids = {u: np.arange(6) for u in mats}
    durs = {u: [1, 2, 1, 3, 2, 1] for u in mats}
    lms = {u: [1, 2, 3] for u in mats}
    seg = pt.SegmentalKMeansWordseg(2, mats, vids, durs, lms, n_slices_max=3,
                                    wip=0.0, batch_size=U, seed=0,
                                    device="cpu")
    obj = seg.segment(1)["sum_neg_len_sqrd_norm"][0]
    assert obj == 0.0
    assert seg.utterances.boundaries.all()
    # the one-slice spans' packed slots 0, 2, 5, six rows an utterance
    assert list(itertools.chain(*(seg.utterances.get_segmented_embeds_i(i)
                                  for i in range(U)))) == [
        6 * u + e for u in range(U) for e in (0, 2, 5)]
