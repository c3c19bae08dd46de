"""The port at the papers' shapes against the JAX package, on the CPU.

The papers embed a span in D 130 dims (10 x 13 downsampled MFCCs), and
``bench.py``'s ``unigram_fixed_long`` row runs utterances of up to 120
landmarks; the other tests run D <= 13 and N_max <= 20.  Here, at float64
on shared noise (the noise the JAX block steps draw from their keys, as
``tests/test_torch_unigram.py`` recreates it):

- block steps at D 130 (unigram fixed, diag and full FFBS, full Viterbi,
  bigram fixed) and at N_max 120 (unigram fixed, bigram) equal JAX's:
  boundaries, assignments, counts and LM tables identical, sums to 1e-10;
- ``SegmentalKMeansWordseg.segment`` at D 130 equals JAX's;
- the FBGMM's sequential sweep at D 130 in the three families equals
  JAX's ``lax.scan``;
- ``utils/profiling.bench_corpus`` at D 130 and N_max 120 is the JAX
  package's ``synthetic_corpus`` (its defaults unchanged);
- the kernels' pure-Python launch plans, at the shapes the segmenters
  hand them at D 130 with K 1000 and at N_max 120 (recorded from the plain
  versions the CPU runs), choose the forms ``chip_smoke.py`` phase 9
  demands of the card (``chip_smoke.D130_FORMS``);
- ``utils/profiling.py``'s ``--D`` and ``--n-landmarks-max`` reach the
  bench segmenter it builds.
"""

import os
import sys

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
from segmentalist_tpu.utils.synth import synthetic_corpus as jax_synth

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.ops import (cuda_chain, cuda_diag_chain, cuda_dp,
                                    cuda_fullcov_chain, cuda_fullcov_score,
                                    cuda_item_chain, cuda_score, dp)
from segmentalist_torch.utils.profiling import bench_corpus
from segmentalist_torch.utils.synth import synthetic_corpus

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import D130_FORMS  # noqa: E402  the forms phase 9 demands

LM = {"type": "smooth", "intrp_lambda": 0.2, "a": 1.2, "b": 1.5}
# U utterances, N_max landmarks, D dims, K components, B a block, W slices
SHAPES = {"d130": dict(U=8, N_max=6, D=130, K=8, B=4, W=4),
          "n120": dict(U=3, N_max=120, D=4, K=8, B=2, W=6)}
BLOCKS = {"d130": ([5, 2, 7, 0], [1, 3, 6, 4], [6, 0, -1, -1]),
          "n120": ([2, 0], [1, -1], [0, 2])}


def _prior(pkg, cov, D):
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                        np.ones(D))
    S_0 = (0.4 * np.ones(D) if cov == "diag"
           else 0.4 * np.eye(D) + 0.05 * np.ones((D, D)))
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _kwargs(shape, cov, bigram, **kw):
    s = SHAPES[shape]
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=s["U"], n_landmarks_max=s["N_max"], D=s["D"], K_true=3,
        n_slices_max=s["W"], seed=3)
    args = dict(am_K=s["K"], embedding_mats=em, vec_ids_dict=vi,
                durations_dict=du, landmarks_dict=lm, covariance_type=cov,
                p_boundary_init=0.5, beta_sent_boundary=2.0,
                n_slices_max=s["W"], batch_size=s["B"], seed=5, lms=1.3,
                wip=-0.1, time_power_term=0.9)
    args.update(dict(lm_params=LM, fb_type="unigram") if bigram
                else dict(am_alpha=1.0))
    args.update(kw)
    return args


def _pair(shape, cov, bigram, **kw):
    D = SHAPES[shape]["D"]
    args = _kwargs(shape, cov, bigram, **kw)
    np.random.seed(args["seed"])  # the JAX init draws from numpy's RNG
    if bigram:
        jseg = JaxBigram(am_param_prior=_prior(jtpu, cov, D), **args)
        tseg = pt.BigramAcousticWordseg(am_param_prior=_prior(pt, cov, D),
                                        device="cpu", **args)
    else:
        jseg = JaxUnigram(jtpu.FBGMM, am_param_prior=_prior(jtpu, cov, D),
                          **args)
        tseg = pt.UnigramAcousticWordseg(
            pt.FBGMM, am_param_prior=_prior(pt, cov, D), device="cpu",
            **args)
    return jseg, tseg


def _jax_state(jseg, cov):
    am = jseg.acoustic_model
    state = {
        "X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
        "sum_x": np.asarray(am.stats.sum_x),
        "sum_sq": np.asarray(am.stats.sum_sq),
        "assignments": np.asarray(am.assignments),
        "boundaries": np.asarray(jseg._boundaries_dev),
        **{k: np.asarray(getattr(am.prior, k))
           for k in interop.PRIOR_KEYS[cov]},
    }
    if hasattr(jseg, "lm"):
        state.update(unigram_counts=np.asarray(jseg.lm.state.unigram_counts),
                     bigram_counts=np.asarray(jseg.lm.state.bigram_counts))
    return state


BLOCK_CASES = [("d130", "fixed", False, "standard"),
               ("d130", "diag", False, "standard"),
               ("d130", "full", False, "standard"),
               ("d130", "full", False, "viterbi"),
               ("d130", "fixed", True, "standard"),
               ("n120", "fixed", False, "standard"),
               ("n120", "fixed", True, "standard")]


@pytest.mark.parametrize("shape,cov,bigram,fb_type", BLOCK_CASES)
def test_block_steps_match_jax(shape, cov, bigram, fb_type):
    """Three consecutive block steps (the last one padded) of each package
    from the JAX state carried across, on the JAX steps' own noise:
    boundaries, assignments, counts and LM tables identical, the sums to
    1e-10 and the DP log probability to 1e-9 relative."""
    kw = {} if bigram else {"fb_type": fb_type}
    jseg, tseg = _pair(shape, cov, bigram, **kw)
    interop.load_state(tseg, _jax_state(jseg, cov))
    s = SHAPES[shape]
    am, utt = jseg.acoustic_model, jseg.utterances
    step = jseg._make_block_step(
        s["B"], pallas=False, reduce_fn=lambda t: t,
        **(dict(assignments_only=False) if bigram else {}))
    cand_X, cand_lp = jseg._cand_tables()
    head = (am.stats, am.assignments, jseg._boundaries_dev)
    lm = (jseg.lm.state,) if bigram else ()
    carry = head + lm + (jax.random.PRNGKey(21), jnp.zeros((), am.X.dtype))
    tam = tseg.acoustic_model
    lp_prev = 0.0
    for block in BLOCKS[shape]:
        block = np.array(block, dtype=np.int64)
        key = carry[-2]  # the key this step splits
        out, upd = step(carry, jnp.asarray(block), utt.seg_ids,
                        utt.seg_durations, utt.lengths_dev, 2.0, 1.5,
                        cand_X_all=cand_X, cand_lp_all=cand_lp)
        stats, assignments = out[:2]
        assignments = jcommon.merge_assignments(assignments, *upd,
                                                lambda t: t)
        carry = (stats, assignments) + tuple(out[2:])
        _, k_dp, k_assign = jax.random.split(key, 3)
        N_max = tseg.utterances.N_max  # the corpus's longest utterance
        dp_noise = jax.random.gumbel(
            k_dp, (s["B"], N_max, tseg.W_dp), am.X.dtype)
        chain_noise = jax.random.gumbel(
            k_assign, (s["B"], N_max, s["K"]), am.X.dtype)
        lp_t = tseg.block_step(
            block, 2.0, 1.5, dp_noise=torch.as_tensor(np.array(dp_noise)),
            chain_noise=torch.as_tensor(np.array(chain_noise)))

        npt.assert_array_equal(tseg.utterances.boundaries,
                               np.asarray(out[2]))
        npt.assert_array_equal(tam.assignments.numpy(),
                               np.asarray(assignments))
        npt.assert_array_equal(tam.stats.counts.numpy(),
                               np.asarray(stats.counts))
        for got, want in ((tam.stats.sum_x, stats.sum_x),
                          (tam.stats.sum_sq, stats.sum_sq)):
            npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                atol=1e-10)
        npt.assert_allclose(float(lp_t), float(out[-1]) - lp_prev,
                            rtol=1e-9)
        lp_prev = float(out[-1])
        if bigram:
            npt.assert_array_equal(tseg.lm.unigram_counts,
                                   np.asarray(out[3].unigram_counts))
            npt.assert_array_equal(tseg.lm.bigram_counts,
                                   np.asarray(out[3].bigram_counts))


def test_kmeans_segment_matches_jax_at_d130():
    """``segment(5)`` at D 130: identical boundaries, assignments and
    counts, the sums and the records to 1e-10 relative."""
    em, vi, du, lm, _ = synthetic_corpus(n_utterances=12, n_landmarks_max=8,
                                         D=130, K_true=3, n_slices_max=4,
                                         seed=3)
    args = dict(n_slices_max=4, batch_size=4, seed=5, wip=-0.3)
    np.random.seed(5)  # the JAX init draws from numpy's RNG
    jseg = JaxKMeansSeg(6, em, vi, du, lm, **args)
    tseg = pt.SegmentalKMeansWordseg(6, em, vi, du, lm, device="cpu", **args)
    rj, rt = jseg.segment(5), tseg.segment(5)
    for k in ("components", "n_tokens"):
        assert rt[k] == rj[k], k
    for k in ("sum_neg_sqrd_norm", "sum_neg_len_sqrd_norm"):
        npt.assert_allclose(rt[k], rj[k], rtol=1e-10, err_msg=k)
    jam, tam = jseg.acoustic_model, tseg.acoustic_model
    npt.assert_array_equal(tseg.utterances.boundaries,
                           np.asarray(jseg._boundaries_dev))
    npt.assert_array_equal(tam.assignments.numpy(),
                           np.asarray(jam.state.assignments))
    npt.assert_array_equal(tam.state.counts.numpy(),
                           np.asarray(jam.state.counts))
    npt.assert_allclose(tam.state.sum_x.numpy(), np.asarray(jam.state.sum_x),
                        rtol=1e-10)


@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_fbgmm_sequential_sweep_matches_jax_at_d130(cov):
    """``FBGMM.sequential_sweep`` (K10's plain version; the full family's:
    K11's) at D 130, N 40, K 6 equals JAX's ``lax.scan`` sweep on the JAX
    model's own noise over two sweeps at two temperatures."""
    N, D, K = 40, 130, 6
    rng = np.random.RandomState(0)
    X = (2.0 * rng.randn(3, D))[rng.randint(0, 3, N)] + 0.7 * rng.randn(N, D)
    asg = rng.randint(-1, 4, N)
    jam = jtpu.FBGMM(X, _prior(jtpu, cov, D), 1.3, K, asg,
                     covariance_type=cov, lms=1.1, key=jax.random.PRNGKey(7))
    tam = pt.FBGMM(X, _prior(pt, cov, D), 1.3, K, asg, covariance_type=cov,
                   lms=1.1, device="cpu")
    fn = jam._get_sweep_fn("sequential", True)
    for temp in (1.0, 0.6):
        _, sub = jax.random.split(jam.key)
        noise = np.array(jax.vmap(lambda k: jax.random.gumbel(
            k, (K,), jnp.float64))(jax.random.split(sub, N)))
        jam.stats, jam.assignments, jam.key = fn(
            jam.stats, jam.assignments, jam.key, np.asarray(temp))
        tam.sequential_sweep(temp, True, noise=torch.as_tensor(noise))
        npt.assert_array_equal(tam.assignments.numpy(),
                               np.asarray(jam.assignments))
        npt.assert_array_equal(tam.stats.counts.numpy(),
                               np.asarray(jam.stats.counts))
        for got, want in ((tam.stats.sum_x, jam.stats.sum_x),
                          (tam.stats.sum_sq, jam.stats.sum_sq)):
            npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                atol=1e-10)


@pytest.mark.parametrize("kw,jax_kw", [
    ({}, dict(n_landmarks_max=20, D=13)),
    (dict(D=130), dict(n_landmarks_max=20, D=130)),
    (dict(n_landmarks_max=120), dict(n_landmarks_max=120, D=13)),
])
def test_bench_corpus_is_the_jax_corpus(kw, jax_kw):
    """``bench_corpus`` is ``bench.py``'s corpus (float32 embeddings) at
    the papers' width and at the long row's length, and by default the
    flagship's."""
    got = bench_corpus(4, **kw)
    want = jax_synth(n_utterances=4, K_true=50, n_slices_max=6, seed=0,
                     **jax_kw)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            npt.assert_array_equal(np.asarray(a[k]), np.asarray(
                b[k]).astype(np.float32) if b is want[0] else b[k])
    assert all(v.dtype == np.float32 for v in got[0].values())
    assert next(iter(got[0].values())).shape[1] == jax_kw["D"]


# The H100's opt-in shared memory a block less the largest static arrays
# of the kernels (tests/test_torch_chain.py), and its largest cluster.
H100_SMEM_LIMIT = 232_448 - 1_024
H100_MAX_CLUSTER = 16


def _form_of(kernel):
    """``plan_of(*plain_args)``: the form (as ``cuda_lib.count_form``
    names it) that ``kernel``'s plan chooses under the H100's limits for
    the arguments of its plain version."""
    lim, cap = H100_SMEM_LIMIT, H100_MAX_CLUSTER

    def rows(Xc, prior_c, tab, *a):  # K1: tab is mu [B, D, K]
        return "%d rows" % cuda_score.launch_plan(
            Xc.shape[-1], tab.shape[-1], Xc.shape[1], lim).rows

    def k5(*args):  # the composition is the last argument
        return rows(*args) + (" exact" if args[-1] else " grouped")

    def k8(Xc, prior_c, g, t, tslot, *a):
        return "%d rows" % cuda_fullcov_score.launch_plan(
            Xc.shape[-1], tslot.shape[-1], Xc.shape[1], lim).rows

    def chain(mod, bigram):
        return lambda embeds, Xe, lp, gumbel, *a: mod.launch_plan(
            Xe.shape[-1], gumbel.shape[-1], embeds.shape[1], bigram,
            lim).form

    def k9(bigram):
        def form(embeds, Xe, lp, gumbel, base, counts, m0, P0, ld0, tk0,
                 *a):
            p = cuda_fullcov_chain.launch_plan(
                Xe.shape[-1], gumbel.shape[-1], embeds.shape[1],
                tk0.shape[1], bigram, lim)
            return (p.form + (" ring %d" % p.ring if p.ring else "")
                    + (" bigram" if bigram else ""))
        return form

    def k2(scores, lengths, lpc, temp, n_min, use_max, noise, *a):
        p = cuda_dp.launch_plan(scores.shape[1], scores.shape[2],
                                noise is not None, lim)
        return "%s %d warps" % (p.form, p.warps)

    def k10(family, Xe, lp, gumbel, *a):
        p = cuda_item_chain.item_launch_plan(family, Xe.shape[-1],
                                             gumbel.shape[-1], lim, cap)
        return "C%d %s" % (p.cluster, p.tables)

    def k11(X, lp, noise, *a):
        p = cuda_item_chain.full_launch_plan(X.shape[-1], noise.shape[-1],
                                             lim, cap)
        return "%s C%d tables %s work %s" % (p.form, p.cluster, p.tables,
                                             p.work)

    return {
        "K1": rows, "K5": k5, "K8": k8, "K2": k2,
        "K3": chain(cuda_chain, False), "K4": chain(cuda_chain, True),
        "K6": chain(cuda_diag_chain, False),
        "K7": chain(cuda_diag_chain, True), "K9": k9(False),
        "K9 bigram": k9(True), "K10": k10, "K11": k11}[kernel]


# each kernel's plain version, called where the CPU runs it
PLAIN = {"K1": (cuda_score, "fixedvar_scores_plain"),
         "K5": (cuda_score, "diag_scores_plain"),
         "K8": (cuda_fullcov_score, "fullcov_scores_plain"),
         "K2": (dp, "segment_dp_plain"),
         "K3": (cuda_chain, "fixedvar_chain_plain"),
         "K4": (cuda_chain, "bigram_fixedvar_chain_plain"),
         "K6": (cuda_diag_chain, "diag_chain_plain"),
         "K7": (cuda_diag_chain, "bigram_diag_chain_plain"),
         "K9": (cuda_fullcov_chain, "fullcov_chain_plain"),
         "K9 bigram": (cuda_fullcov_chain, "bigram_fullcov_chain_plain"),
         "K10": (cuda_item_chain, "item_chain_plain"),
         "K11": (cuda_item_chain, "full_chain_plain")}


def _segmenter_forms(family, bigram, kind, D, n_landmarks_max, monkeypatch):
    """Each kernel's forms at the shapes a segmenter hands it: the
    segmenter (K 1000, the bench configuration in blocks of 4 on the
    bench corpus's first four utterances, float64) runs one sweep on the
    CPU while each plain version records the form its kernel's plan would
    choose; returns {kernel: {form, ...}} (K9's bigram mode under
    "K9")."""
    from segmentalist_torch.utils.profiling import (bench_kmeans_segmenter,
                                                    bench_segmenter)

    forms = {}

    def record(kernel):
        mod, name = PLAIN[kernel]
        plain, form_of = getattr(mod, name), _form_of(kernel)

        def wrapped(*args, **kwargs):
            forms.setdefault(kernel.split()[0], set()).add(form_of(*args))
            return plain(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    for kernel in PLAIN:
        record(kernel)
    em, *rest = bench_corpus(4, D=D, n_landmarks_max=n_landmarks_max)
    corpus = ({k: v.astype(np.float64) for k, v in em.items()}, *rest)
    if kind == "kmeans":
        seg, _ = bench_kmeans_segmenter(device="cpu", corpus=corpus)
        seg.segment(1)
    else:
        kw = {"init_am_assignments": "one-by-one"} if kind == "am" else {}
        seg, _ = bench_segmenter(family, bigram, device="cpu", corpus=corpus,
                                 batch_size=4, **kw)
        # K10 / K11 plan by D and K alone: the one-by-one init shows them
        seg.gibbs_sample(1)
    return forms


@pytest.mark.parametrize("path,family,bigram,kind,kernels", [
    ("unigram_fixed_d130", "fixed", False, "gibbs", ("K1", "K2", "K3")),
    ("bigram_d130", "fixed", True, "gibbs", ("K1", "K2", "K4")),
    ("unigram_diag_d130", "diag", False, "gibbs", ("K5", "K2", "K6")),
    ("bigram_diag_d130", "diag", True, "gibbs", ("K5", "K2", "K7")),
    ("unigram_full_d130", "full", False, "gibbs", ("K8", "K2", "K9")),
    ("bigram_full_d130", "full", True, "gibbs", ("K8", "K2", "K9")),
    ("unigram_fixed_am_d130", "fixed", False, "am",
     ("K1", "K2", "K3", "K10")),
    ("unigram_full_am_d130", "full", False, "am", ("K8", "K2", "K9", "K11")),
    ("kmeans_wordseg_d130", None, False, "kmeans", ("K2",)),
    ("unigram_fixed_long", "fixed", False, "gibbs", ("K1", "K2", "K3")),
])
def test_segmenter_shapes_choose_the_phase9_forms(path, family, bigram,
                                                  kind, kernels,
                                                  monkeypatch):
    """The plans at a segmenter's own shapes (D 130 and K 1000, or N_max
    120) raise for none of its kernels and choose the forms phase 9
    demands of the card: K3 / K4 / K6 / K7 global, K9 stream in both
    modes, K10 at C 16 on chip, K11's CTA form with its tables in device
    memory; the scorers' 64-row tiles and K2's staged rows at D 130 and
    N_max 120."""
    long = path.endswith("long")
    forms = _segmenter_forms(family, bigram, kind, 13 if long else 130,
                             120 if long else 20, monkeypatch)
    assert sorted(forms) == sorted(kernels)
    for k, fs in forms.items():
        if not long and k in D130_FORMS:
            assert all(f.startswith(D130_FORMS[k]) for f in fs), (k, fs)
    want = {"K1": "64 rows", "K5": "64 rows grouped", "K8": "64 rows",
            "K2": "smem 4 warps", "K10": "C16 smem",
            "K11": "cta C16 tables global work smem",
            # the tables on chip at S 120 and D 13, in device memory at D 130
            "K3": "smem" if long else "global",
            "K9": "stream ring 2" + (" bigram" if bigram else "")}
    for k in set(want) & set(forms):
        assert forms[k] == {want[k]}, (k, forms[k])


@pytest.mark.parametrize("argv,builder,shape", [
    (["--cov", "full", "--D", "130"], "bench_segmenter",
     dict(D=130, n_landmarks_max=20)),
    (["--kmeans", "--n-landmarks-max", "120"], "bench_kmeans_segmenter",
     dict(D=13, n_landmarks_max=120)),
])
def test_profiling_cli_builds_the_papers_shapes(argv, builder, shape,
                                                monkeypatch):
    """``python -m segmentalist_torch.utils.profiling`` hands ``--D`` and
    ``--n-landmarks-max`` to the bench segmenter it profiles (the card's
    part is stopped before it starts)."""
    from segmentalist_torch.utils import profiling

    class Built(Exception):
        pass

    def build(*args, **kwargs):
        raise Built(kwargs)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, builder, build)
    with pytest.raises(Built) as got:
        profiling.main(argv)
    assert got.value.args[0] == shape
