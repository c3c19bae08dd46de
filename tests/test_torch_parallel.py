"""The port's multi-device layer (``segmentalist_torch.parallel``) against
the JAX package's (``segmentalist_tpu.parallel``) and against the port's
own single-device sweeps.

The port's ranks are gloo processes on the CPU, spawned by its launcher
(``parallel.dryrun.launch``); they import torch and numpy only and run the
rank functions of ``segmentalist_torch.parallel.dryrun``, several a spawn.
The JAX side runs here, on the virtual CPU devices of ``conftest.py``.  Toy
sizes, as ``tests/test_parallel.py``: D 10, K 8, 13-16 utterances, spans of
up to 3 slices.  Each test is named after its counterpart there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from segmentalist_tpu.parallel import make_mesh as jax_make_mesh
from segmentalist_tpu.parallel import shard_segmenter as jax_shard_segmenter
from segmentalist_tpu.parallel import shard_sweep as jax_shard_sweep
from segmentalist_tpu.segmenters import common as jcommon

from segmentalist_torch.parallel import dryrun, shard_sweep
from segmentalist_torch.segmenters import common as tcommon
from segmentalist_torch.segmenters.common import pad_utterance_order

TIMEOUT = 240.0  # a spawn's limit; every collective fails after it too
FAMILIES_B = ("unigram_fixed", "unigram_full", "bigram", "bigram_diag",
              "bigram_full", "kmeans")


def _unsharded(family, n_utterances, batch_size, seed, sweeps, fb_type=None):
    seg = dryrun.build_segmenter(family, n_utterances, batch_size, seed)
    if fb_type is not None:
        seg.set_fb_type(fb_type)
    return seg, [dryrun.sweep_once(seg) for _ in range(sweeps)]


# --------------------------------------------------- the JAX per-shard case

def _jax_shard_case(seed=4, n_utterances=16, batch_size=8, temps=(2.0, 1.5)):
    """JAX's ``build_unigram_shard_sweep`` on a 2-device mesh, one sweep:
    its inputs (state, blocks, each shard's noise as the sweep draws it)
    and outputs."""
    jseg = ge._build_segmenter(n_utterances=n_utterances,
                               batch_size=batch_size, seed=seed)
    am, utt = jseg.acoustic_model, jseg.utterances
    state = {"X": am.X, "counts": am.stats.counts, "sum_x": am.stats.sum_x,
             "sum_sq": am.stats.sum_sq, "assignments": am.assignments,
             "boundaries": jseg._boundaries_dev, "var": am.prior.var,
             "mu_0": am.prior.mu_0, "var_0": am.prior.var_0}
    state = {k: np.asarray(v) for k, v in state.items()}
    mesh = jax_make_mesh(2)
    jax_shard_segmenter(jseg, mesh)
    sweep, n = jax_shard_sweep.build_unigram_shard_sweep(jseg, mesh)
    order = np.random.RandomState(seed).permutation(n_utterances)
    blocks = jax_shard_sweep.shard_blocks(
        pad_utterance_order(order, batch_size).reshape(-1), n,
        n_utterances // n, batch_size // n)
    key = jax.random.PRNGKey(11)
    dt = am.X.dtype
    stats, assignments, bounds, _, lp = sweep(
        am.stats, am.assignments, jseg._boundaries_dev, key,
        jax_shard_sweep._place_blocks(blocks, mesh, "data"), utt.seg_ids,
        utt.seg_durations, utt.lengths_dev, np.asarray(temps[0], dt),
        np.asarray(temps[1], dt))
    # each shard's noise: fold_in(key, shard) (shard_sweep.py:104), then a
    # split(key, 3) a block step (unigram.py:956) and the DP's and chain's
    # gumbel draws at [B/n, N_max, W_dp] and [B/n, N_max, K]
    b, N_max, W_dp, K = batch_size // n, utt.N_max, 3, am.K_max
    noise = []
    for r in range(n):
        k, per = jax.random.fold_in(key, r), []
        for _ in range(blocks.shape[0]):
            k, k_dp, k_assign = jax.random.split(k, 3)
            per.append((np.asarray(jax.random.gumbel(k_dp, (b, N_max, W_dp),
                                                     dt)),
                        np.asarray(jax.random.gumbel(k_assign, (b, N_max, K),
                                                     dt))))
        noise.append(per)
    job = ("shard_sweep_from_state",
           ("unigram_fixed", n_utterances, batch_size, seed, state, blocks,
            noise, temps))
    want = {"assignments": np.asarray(assignments),
            "boundaries": np.asarray(bounds),
            "stats": [np.asarray(t) for t in stats], "log_prob": float(lp)}
    return job, want


# ---------------------------------------- the JAX per-shard surface case

SURFACE = ("unigram_fixed", "bigram", "kmeans")
MONITORED = (0, 11, 3)  # rank 0, rank 1; the last is the debug-only sweep's
POISONED = 11           # a rank-1 utterance whose final boundary is cleared


def _jax_family(family, n_utterances, batch_size, seed):
    """The JAX toy ``dryrun.build_segmenter`` mirrors: ``ge._build_segmenter``
    (unigram_fixed) and ``tests/test_parallel.py``'s ``_build_family``
    (bigram, kmeans)."""
    if family == "unigram_fixed":
        return ge._build_segmenter(n_utterances=n_utterances,
                                   batch_size=batch_size, seed=seed)
    from segmentalist_tpu import FixedVarPrior
    from segmentalist_tpu.segmenters.bigram import BigramAcousticWordseg
    from segmentalist_tpu.segmenters.kmeans_seg import SegmentalKMeansWordseg
    from segmentalist_tpu.utils.synth import synthetic_corpus

    D = 10
    mats, vec_ids, durs, lms = synthetic_corpus(
        n_utterances=n_utterances, n_landmarks_max=6, D=D, K_true=4,
        n_slices_max=3, seed=seed)[:4]
    corpus = dict(embedding_mats=mats, vec_ids_dict=vec_ids,
                  durations_dict=durs, landmarks_dict=lms,
                  p_boundary_init=0.5, n_slices_max=3,
                  batch_size=batch_size, seed=seed)
    np.random.seed(seed)
    if family == "kmeans":
        return SegmentalKMeansWordseg(am_K=8, **corpus)
    prior = FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D), np.ones(D))
    return BigramAcousticWordseg(
        am_K=8, am_param_prior=prior, covariance_type="fixed",
        lm_params={"type": "smooth", "intrp_lambda": 0.1, "a": 1.0,
                   "b": 1.0},
        fb_type="unigram", beta_sent_boundary=-1, **corpus)


def _jax_state(jseg) -> dict:
    """The JAX segmenter's state under ``interop``'s keys."""
    am = jseg.acoustic_model
    out = {"X": am.X, "boundaries": jseg._boundaries_dev}
    if hasattr(am, "state"):  # k-means
        out.update(am.state._asdict(), random_means=am.random_means)
    else:
        out.update(am.stats._asdict(), assignments=am.assignments,
                   **am.prior._asdict())
        if hasattr(jseg, "lm"):
            out.update(jseg.lm.state._asdict())
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_surface_case(family, seed=5, n_utterances=16, batch_size=8):
    """What the per-shard surface gives in JAX's ``shard_map`` mode on a
    2-device mesh, from the toy's initial state: the monitor traces, the
    validate flags (healthy, and with utterance POISONED's final boundary
    cleared), the batch scores (all utterances, and a shuffled order) and
    the state after one debug-only sweep (the unigram driver on a known
    key, each shard's noise recreated from it; k-means).  Returns the
    port's rank job and the wanted values."""
    jseg = _jax_family(family, n_utterances, batch_size, seed)
    state = _jax_state(jseg)
    mesh = jax_make_mesh(2)
    jax_shard_segmenter(jseg, mesh)
    jax_shard_sweep.use_shard_map_sweep(jseg, mesh)
    want = {"traces": [tuple(np.asarray(t) for t in jseg._monitor_device(i))
                       for i in MONITORED],
            "flags": np.asarray(jseg._validate_device())}
    if family != "kmeans":
        score = (jseg.get_vec_embed_log_probs_unigram_all
                 if family == "bigram" else jseg.get_vec_embed_log_probs_all)
        want["scores"] = score()
        want["scores_order"] = score(
            np.random.RandomState(seed).permutation(n_utterances))
    bounds = jseg._boundaries_dev
    L = jseg.utterances.lengths[POISONED]
    jseg._boundaries_dev = bounds.at[POISONED, L - 1].set(False)
    want["poisoned_flags"] = np.asarray(jseg._validate_device())
    jseg._boundaries_dev = bounds
    noise, want["debug"] = None, None
    m = MONITORED[-1]
    if family == "unigram_fixed":
        am, utt = jseg.acoustic_model, jseg.utterances
        key = jax.random.PRNGKey(11)
        am.key = key
        jseg.gibbs_sample(1, monitor_i=m, debug_gibbs_only=True)
        # each shard's noise: fold_in(key, shard), then split(key, 3) for
        # the one block (as _jax_shard_case)
        b, dt = batch_size // 2, am.X.dtype
        noise = []
        for r in range(2):
            _, k_dp, k_assign = jax.random.split(jax.random.fold_in(key, r),
                                                 3)
            noise.append([(
                np.asarray(jax.random.gumbel(k_dp, (b, utt.N_max, 3), dt)),
                np.asarray(jax.random.gumbel(k_assign, (b, utt.N_max,
                                                        am.K_max), dt)))])
        want["debug"] = {"assignments": np.asarray(am.assignments),
                         "stats": [np.asarray(t) for t in am.stats],
                         "boundaries": np.asarray(jseg._boundaries_dev)}
    elif family == "kmeans":
        jseg.segment(1, monitor_i=m, segment_debug_only=True)
        st = jseg.acoustic_model.state
        want["debug"] = {"assignments": np.asarray(st.assignments),
                         "stats": [np.asarray(st.counts),
                                   np.asarray(st.sum_x)],
                         "boundaries": np.asarray(jseg._boundaries_dev)}
    job = ("shard_surface", (family, n_utterances, batch_size, seed, state,
                             list(MONITORED), POISONED, noise))
    return job, want


# ------------------------------------------------------- the spawns

@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of 2 ranks for the exact-mode, per-shard,
    per-shard-surface and shard_segmenter cases."""
    jax_job, jax_want = _jax_shard_case()
    surface = {fam: _jax_surface_case(fam) for fam in SURFACE}
    jobs = {
        "exact": ("run_sweeps", ("unigram_fixed", 13, 8, 9, 3, "exact")),
        "exact_viterbi": ("run_sweeps", ("unigram_fixed", 13, 8, 6, 2,
                                         "exact", "viterbi")),
        "vs_jax": jax_job,
        "shard_checks": ("shard_checks", (13, 5)),
    }
    for fam in FAMILIES_B:
        jobs["per_shard_" + fam] = ("run_sweeps",
                                    (fam, 16, 8, 5, 2, "per_shard"))
    for fam, (job, _) in surface.items():
        jobs["surface_" + fam] = job
    names = list(jobs)
    res = dryrun.launch(dryrun.run_jobs, 2, args=([jobs[k] for k in names],),
                        device="cpu", timeout=TIMEOUT)
    out = {k: [r[i] for r in res] for i, k in enumerate(names)}
    out["jax_want"] = jax_want
    for fam, (_, want) in surface.items():
        out["surface_want_" + fam] = want
    return out


def _decollide_case(seed=2, n=3, b=2, S=5, K=12):
    """A block of n * b rows with many simultaneous new-component creators
    (``tests/test_torch_ops.py``'s ``test_decollide_new_components``)."""
    rng = np.random.RandomState(seed)
    B = n * b
    counts0 = rng.randint(0, 3, K).astype(np.int32)
    counts0[rng.rand(K) < 0.5] = 0
    lo = np.maximum(counts0[None] - rng.randint(0, 2, (B, K)), 0)
    lo = lo.astype(np.int32)
    ks = rng.randint(-1, K, (B, S)).astype(np.int32)
    mask = rng.rand(B, S) < 0.8
    return ks, mask, lo, counts0


@pytest.fixture(scope="module")
def three_ranks():
    """One spawn of 3 ranks: the gathered decollision, and the per-shard
    sweep on a corpus of 4 utterances, padded to 6, so that the third
    rank's two rows are both dead."""
    case = _decollide_case()
    jobs = [("decollide_rows", case),
            ("run_sweeps", ("unigram_fixed", 4, 6, 10, 2, "per_shard")),
            ("run_sweeps", ("bigram", 4, 6, 10, 2, "per_shard"))]
    res = dryrun.launch(dryrun.run_jobs, 3, args=(jobs,), device="cpu",
                        timeout=TIMEOUT)
    return case, [[r[i] for r in res] for i in range(len(jobs))]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("U,n,b,pads", [(16, 8, 1, 0), (13, 4, 2, 3),
                                        (13, 8, 1, 3), (40, 4, 3, 7),
                                        (6, 3, 2, 1), (9, 2, 5, 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_shard_blocks_matches_jax(U, n, b, pads, seed):
    """The per-shard block layout from random and uneven permutations
    (-1 pads of ``pad_utterance_order``; a corpus padded to a multiple of
    the mesh) equals the JAX package's."""
    rng = np.random.RandomState(seed)
    u_pad = -(-U // n) * n
    order = pad_utterance_order(rng.permutation(U), n * b)
    if pads:
        order = np.concatenate([order.reshape(-1), -np.ones(pads, np.int64)])
    got = shard_sweep.shard_blocks(order, n, u_pad // n, b)
    want = jax_shard_sweep.shard_blocks(order, n, u_pad // n, b)
    npt.assert_array_equal(got, want)
    assert got.shape[1:] == (n, b)


def test_decollide_axis_name_matches_single_call(three_ranks):
    """Decollision over 3 ranks, each holding 2 rows of the block, equals
    the single call on the rows in block order, and JAX's ``axis_name``
    form under ``shard_map`` on a 3-device mesh."""
    (ks, mask, lo, counts0), (rows, *_) = three_ranks
    got = np.concatenate(rows)
    single = tcommon.decollide_new_components(
        *(torch.as_tensor(a) for a in (ks, mask, lo, counts0))).numpy()
    npt.assert_array_equal(got, single)
    assert (got != ks).any()  # the case relabels something
    mesh = jax_make_mesh(3)
    try:
        smap = jax.shard_map
    except AttributeError:  # older jax
        from jax.experimental.shard_map import shard_map as smap
    fn = jax.jit(smap(
        lambda k, m, c: jcommon.decollide_new_components(
            k, m, c, jnp.asarray(counts0), axis_name="data"),
        mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P("data"),
        check_vma=False))
    npt.assert_array_equal(got, np.asarray(fn(ks, mask, lo)))


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_matches_unsharded(two_ranks, ranks):
    """The exact mode equals the port's unsharded sweep at float64 on an
    uneven 13-utterance corpus: identical assignments and boundaries,
    log_marg to rtol 1e-9, on 2 and on 4 ranks."""
    if ranks == 2:
        res = two_ranks["exact"]
    else:
        res = dryrun.launch(dryrun.run_sweeps, 4,
                            args=("unigram_fixed", 13, 8, 9, 3, "exact"),
                            device="cpu", timeout=TIMEOUT)
    seg, recs = _unsharded("unigram_fixed", 13, 8, 9, 3)
    for r in res:
        assert r["u_pad"] == -(-13 // ranks) * ranks
        npt.assert_array_equal(r["assignments"],
                               seg.acoustic_model.assignments.numpy())
        npt.assert_array_equal(r["boundaries"], seg.utterances.boundaries)
        npt.assert_allclose([x["log_marg"][0] for x in r["records"]],
                            [x["log_marg"][0] for x in recs], rtol=1e-9)
        dryrun.check_run(r, "exact mode")


def test_sharded_viterbi_matches_unsharded_exactly(two_ranks):
    """Viterbi in the exact mode: boundaries and assignments exactly the
    unsharded run's; the host boundary view is sliced back to the 13 real
    rows."""
    seg, _ = _unsharded("unigram_fixed", 13, 8, 6, 2, "viterbi")
    for r in two_ranks["exact_viterbi"]:
        assert r["u_pad"] == 14 and r["rows"] == 14
        assert r["boundaries"].shape[0] == 13
        npt.assert_array_equal(r["assignments"],
                               seg.acoustic_model.assignments.numpy())
        npt.assert_array_equal(r["boundaries"], seg.utterances.boundaries)


def test_shard_map_sweep_matches_jax(two_ranks):
    """The per-shard sweep against JAX's ``build_unigram_shard_sweep`` on
    a 2-device mesh, from one state, with the same blocks and each shard's
    noise recreated from ``fold_in(key, shard)`` and the block step's
    ``split(key, 3)``: identical assignments and boundaries, statistics
    and log probability to rtol 1e-10, at float64."""
    want = two_ranks["jax_want"]
    got = two_ranks["vs_jax"]
    for r in got:
        npt.assert_array_equal(r["assignments"], want["assignments"])
        for a, b in zip(r["stats"], want["stats"]):
            npt.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
        npt.assert_allclose(r["log_prob"], want["log_prob"], rtol=1e-10)
    npt.assert_array_equal(np.concatenate([r["boundaries"] for r in got]),
                           want["boundaries"])
    assert not np.array_equal(got[0]["boundaries"], got[1]["boundaries"])


@pytest.mark.parametrize("family", FAMILIES_B)
def test_shard_map_sweep_all_families(two_ranks, family):
    """The per-shard sweep for every driver: after each sweep the
    statistics equal their rebuild from the assignments (counts exactly,
    sums to 1e-10 relative at float64), the LM tables the recount of the
    transcripts, and both ranks hold the same state; each rank holds its
    8 of the 16 utterances."""
    res = two_ranks["per_shard_" + family]
    for r in res:
        assert r["rows"] == 8 and r["rows_live"] == 8
        dryrun.check_run(r, family)
        for c in r["consistency"]:
            assert c["counts_equal"] and c["sum_rel_err"] <= 1e-10
            assert c.get("lm_equal", True)
    npt.assert_array_equal(res[0]["assignments"], res[1]["assignments"])
    npt.assert_array_equal(res[0]["boundaries"], res[1]["boundaries"])
    assert res[0]["boundaries"].shape[0] == 16


def _same_scores(got, want):
    """Scores equal to 1e-9 relative at float64, -inf where masked."""
    npt.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    npt.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=0)


@pytest.mark.parametrize("family", SURFACE)
def test_shard_map_surface_matches_jax(two_ranks, family):
    """After ``use_shard_map_sweep`` on 2 gloo ranks, what reads the corpus
    equals JAX's ``shard_map`` mode on a 2-device mesh from the same state,
    at float64, on every rank: the monitor traces of utterances on both
    ranks (the owner's, broadcast), the validate flags, healthy and with a
    rank-1 utterance poisoned (the flags ORed over the ranks), the batch
    scores of all 16 utterances and of a shuffled order (each owner's rows,
    gathered), and the state after one debug-only sweep (the unigram
    driver on JAX's per-shard noise; k-means; the bigram driver has no
    debug-only flag).  Then ``gibbs_sample(2, monitor_i=0, validate=True)``
    (``segment`` for k-means) runs and logs the same monitor lines on both
    ranks, and a validated debug-only sweep with the rank-1 utterance
    poisoned raises on both."""
    want = two_ranks["surface_want_" + family]
    got = two_ranks["surface_" + family]
    assert not want["poisoned_flags"].all() and want["flags"].all()
    for r in got:
        for (ts, tb, tk), (js, jb, jk) in zip(r["traces"], want["traces"]):
            _same_scores(ts, js)
            npt.assert_array_equal(tb, jb)
            npt.assert_array_equal(tk, jk)
        npt.assert_array_equal(r["flags"], want["flags"])
        npt.assert_array_equal(r["poisoned_flags"], want["poisoned_flags"])
        if family != "kmeans":
            for key in ("scores", "scores_order"):
                assert len(r[key]) == len(want[key])
                for a, b in zip(r[key], want[key]):
                    _same_scores(a, b)
        if want["debug"] is None:
            assert r["debug"] is None and r["raised"] is None
        else:
            d, w = r["debug"], want["debug"]
            npt.assert_array_equal(d["assignments"], w["assignments"])
            npt.assert_array_equal(d["boundaries"], w["boundaries"])
            for a, b in zip(d["stats"], w["stats"]):
                npt.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
            assert "missing final utterance boundary" in r["raised"]
        recs = r["records"]
        vals = recs.get("log_marg", recs.get("sum_neg_sqrd_norm"))
        assert len(vals) == 2 and np.all(np.isfinite(vals))
        assert len(r["log"]) == 4 and r["log"] == got[0]["log"]
        assert "monitor utterance 0" in r["log"][0]


@pytest.mark.parametrize("job", [1, 2], ids=["unigram", "bigram"])
def test_uneven_corpus_shard_map_sweep(three_ranks, job):
    """The per-shard sweep on 3 ranks and 4 utterances: the third rank's
    two rows are both dead, its blocks all -1.  No rank hangs, and the
    state stays consistent and the same on every rank."""
    _, results = three_ranks
    res = results[job]
    assert [r["rows_live"] for r in res] == [2, 2, 0]
    for r in res:
        assert r["u_pad"] == 6 and r["batch_size"] == 6
        dryrun.check_run(r, "uneven")
        assert all(c["sum_rel_err"] <= 1e-10 for c in r["consistency"])
    assert (res[0]["assignments"] >= 0).sum() > 0


def test_shard_segmenter_drops_cached_sweep_and_chunk_fns(two_ranks):
    """``shard_segmenter`` rounds batch_size up to the mesh (5 -> 6), pads
    13 utterances to 14 and derives the corpus tables anew from the padded
    corpus; it raises when the ranks' segmenters differ, and ``make_mesh``
    raises when asked for CUDA without a card."""
    for r in two_ranks["shard_checks"]:
        assert r["batch_size"] == 6
        assert r["rows"] == {"_seg_ids_dp": 14, "_seg_durs_dp": 14,
                             "_cand_X": 14, "_cand_lp": 14}
        assert r["host_boundary_rows"] == 13
        assert "differ" in r["mismatch"]
        if not torch.cuda.is_available():
            assert "CUDA is not available" in r["cuda_mesh"]


def test_launcher_fails_when_a_rank_fails():
    """A rank that raises fails the launch, with its traceback; a
    collective that one rank skips fails on the group (its peer gone, or
    the timeout) instead of hanging."""
    with pytest.raises(RuntimeError, match="unknown family"):
        dryrun.launch(dryrun.run_sweeps, 2,
                      args=("no_such_family", 8, 2, 0, 1), device="cpu",
                      timeout=60.0)
    with pytest.raises((RuntimeError, TimeoutError)):
        dryrun.launch(dryrun.collective_on, 2, args=([0],), device="cpu",
                      timeout=20.0)


def test_launcher_keeps_a_dying_ranks_stderr():
    """A rank that writes to file descriptor 2 below Python and aborts
    (SIGABRT, as an uncaught C++ exception in a backend's thread does)
    fails the launch with that text and faulthandler's Python stack."""
    with pytest.raises(RuntimeError) as info:
        dryrun.launch(dryrun.abort_rank, 2, args=("a C-level abort",),
                      device="cpu", timeout=60.0)
    msg = str(info.value)
    assert "exit code -6" in msg
    assert "a C-level abort (rank" in msg
    assert "Fatal Python error: Aborted" in msg and "abort_rank" in msg


def test_launcher_defaults_to_the_card(monkeypatch):
    """The launcher and the dry run run on the card unless the caller asks
    for the CPU: without one, the default raises before any rank starts
    (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dryrun.launch(dryrun.collective_on, 2, args=([0],),
                                       timeout=20.0),
                 lambda: dryrun.dryrun_multichip(2, timeout=20.0),
                 lambda: dryrun.main(["--ranks", "2"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_dryrun_multichip_entry():
    """The dry run on 2 ranks: the exact mode and the per-shard mode of
    every driver on an uneven corpus of 7 utterances."""
    res = dryrun.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert len(res) == 2
    for what, r in res[0].items():
        assert r["u_pad"] == 8 and r["batch_size"] == 2
        assert r["digests"] == res[1][what]["digests"]
