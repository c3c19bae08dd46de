"""The benchmark's plain reference of the bigram model
(``perfbench/reference/bigram.py``) and its two cells at a tiny size on
the CPU: the LM's rebuild, leave-out weights, conditional probabilities
and replay against closed forms on hand-made transcripts and against the
port's own LM code; a tiny bigram cell (D 6, K 12, 10 utterances, blocks
of 4) through ``perfbench.run.run_cell`` that comes out correct, and
faults planted under it that do not; a tiny fixed cell with the one-by-one
init and ``am_n_iter`` 1 that an item fault fails; and the bigram driver's
sweep through a ``block_step`` wrapped with the unigram driver's
signature, as the benchmark's check sweep wraps it.

Imports torch, numpy, the port and ``perfbench`` only (no JAX)."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "perfbench", "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import perfbench_tiny as tiny  # noqa: E402
from perfbench import faults_bigram, faults_items  # noqa: E402
from perfbench.faults import FAULTS  # noqa: E402
from perfbench.reference import bigram as ref  # noqa: E402

LM_PARAMS = {"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0}
# K 3: tokens 0 0 1 0 2 / 1 1 / (none) / 2 0
HAND = [[0, 0, 1, 0, 2], [1, 1], [], [2, 0]]


def _lm(K=3, lam=0.1, a=1.0, b=1.0, lms=1.0):
    return ref.LM({"lm": dict(LM_PARAMS, intrp_lambda=lam, a=a, b=b),
                   "lms": lms}, K)


# ------------------------------------------------------------ closed forms

def test_the_lm_rebuild_counts_tokens_and_pairs_within_transcripts():
    uni, big = ref.lm_counts(HAND, 3)
    assert uni.tolist() == [4, 3, 2]
    want = np.zeros((3, 3), dtype=int)
    for j, k in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)):
        want[j, k] += 1
    assert (big == want).all()
    assert ref.own_pairs(HAND[0]) == {0: {0: 1, 1: 1, 2: 1}, 1: {0: 1}}


def test_leave_out_weights_and_bigram_probabilities_closed_form():
    lm = _lm(lam=0.25, a=2.0, b=0.5, lms=1.5)
    blk = ref.LMBlock(lm, HAND, [0, 3], "cpu", torch.float64)
    # row 0 leaves out 0 0 1 0 2: unigram 4-3, 3-1, 2-1 = (1, 2, 1), N 4
    assert blk.uni_lo[0].tolist() == [1.0, 2.0, 1.0]
    want = [1.5 * math.log((c + 2.0 / 3) / (4 + 2.0)) for c in (1, 2, 1)]
    assert np.allclose(blk.log_uni()[0].numpy(), want, rtol=1e-14)
    # row 3 leaves out 2 0: unigram (3, 3, 1), N 7; its own pair (2, 0)
    # leaves bigram row 2 of the others empty
    w = blk.weights(np.array([-1, 2]))
    assert np.allclose(w[0].numpy(), want, rtol=1e-14)
    u, N = (3, 3, 1), 7
    for k in range(3):
        p = 0.25 * (u[k] + 2.0 / 3) / (N + 2.0) + 0.75 * (0 + 0.5 / 3) / (
            u[2] + 0.5)
        assert math.isclose(float(w[1, k]), 1.5 * math.log(p), rel_tol=1e-14)
    # row 0 after a 0: every pair (0, .) is its own, so the others' bigram
    # row 0 is empty; its own unigram count of 0 is 1
    w = blk.weights(np.array([0, 0]))
    big_others = {0: (0, 0, 0)}
    for k in range(3):
        p = 0.25 * ((1, 2, 1)[k] + 2.0 / 3) / 6.0 + 0.75 * (
            big_others[0][k] + 0.5 / 3) / (1 + 0.5)
        assert math.isclose(float(w[0, k]), 1.5 * math.log(p),
                            rel_tol=1e-14)


def test_the_replay_closed_form():
    lm = _lm()
    a3, b3 = 1.0 / 3, 1.0 / 3
    want = 0.0
    uni, big, n = [0, 0, 0], {}, 0
    for tr in HAND:
        j = None
        for i in tr:
            p = (uni[i] + a3) / (n + 1.0)
            if j is not None:
                p = 0.1 * p + 0.9 * (big.get((j, i), 0) + b3) / (uni[j] + 1.0)
                big[j, i] = big.get((j, i), 0) + 1
            want += math.log(p)
            uni[i] += 1
            n += 1
            j = i
    assert math.isclose(lm.log_prob_z(HAND), want, rel_tol=1e-14)
    # the first token: (0 + 1/3) / (0 + 1)
    assert math.isclose(lm.log_prob_z([[1]]), math.log(1.0 / 3),
                        rel_tol=1e-14)


def _padded(transcripts):
    S = max(1, max(len(t) for t in transcripts))
    out = np.full((len(transcripts), S), -1, dtype=np.int32)
    for u, t in enumerate(transcripts):
        out[u, :len(t)] = t
    return torch.as_tensor(out)


def _random_transcripts(rng, U, K):
    return [rng.randint(0, K, rng.randint(0, 7)).tolist() for _ in range(U)]


def test_the_replay_matches_the_ports():
    from segmentalist_torch.segmenters.bigram import log_prob_z_replay

    rng = np.random.RandomState(11)
    for lam in (0.1, 0.7):
        lm = _lm(K=9, lam=lam, a=1.5, b=0.5)
        ts = _random_transcripts(rng, 30, 9)
        got = float(log_prob_z_replay(_padded(ts), lam, 1.5, 0.5, 9,
                                      torch.float64))
        assert math.isclose(lm.log_prob_z(ts), got, rel_tol=1e-12)


def test_the_chain_weights_match_the_ports_plain_k4_weights():
    from segmentalist_torch.models.bigram_lm import (
        add_block_counts, empty_lm_state, transcript_pairs_batch)
    from segmentalist_torch.ops.cuda_chain import (bigram_constants,
                                                   bigram_lm_weights)

    rng = np.random.RandomState(12)
    K, lam, a, b = 8, 0.3, 1.0, 2.0
    ts = _random_transcripts(rng, 25, K)
    rows = [3, 0, 17, 9]
    lm = _lm(K=K, lam=lam, a=a, b=b, lms=1.3)
    blk = ref.LMBlock(lm, ts, rows, "cpu", torch.float64)
    all_t = _padded(ts)
    st = add_block_counts(empty_lm_state(K, "cpu"), all_t,
                          torch.ones(len(ts), dtype=torch.bool))
    own = _padded([ts[u] for u in rows])
    own_counts = torch.stack([torch.bincount(own[r][own[r] >= 0].long(),
                                             minlength=K)
                              for r in range(len(rows))]).to(torch.int32)
    corr_j, corr_i = transcript_pairs_batch(own)
    weights = bigram_lm_weights(st.unigram_counts[None] - own_counts,
                                st.bigram_counts, corr_j, corr_i,
                                bigram_constants(a, b, lam, K), K, 1.3,
                                torch.float64)
    for _ in range(20):
        j_prev = rng.randint(-1, K, len(rows))
        got = weights(None, torch.as_tensor(j_prev))
        assert torch.allclose(blk.weights(j_prev), got, rtol=1e-13,
                              atol=0)


# ---------------------------------------------------- the tiny cells

ALL_FAULTS = dict(FAULTS, **faults_bigram.FAULTS, **faults_items.FAULTS)


def _run(root, name, **kw):
    """A tiny cell's run with one sweep in its window, so that the state
    the check sweep starts from is the same on every run."""
    return tiny.run_tiny(root, name, seconds=0.0, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark tree with three more cells: ``tb`` the bigram
    configuration at D 6, K 12 and blocks of 4 on 10 utterances of 2-14
    landmarks, ``tv`` the same with a flat acoustic prior (var 100, so the
    LM decides the chains' draws), ``tfa`` the fixed configuration on the
    ``am1`` traffic cut to 10 utterances; each with its benchmark cell's
    limits."""
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    pb = os.path.join(r, "perfbench")
    with open(os.path.join(pb, "configs", "tiny_fixed.json")) as f:
        fixed = json.load(f)
    with open(os.path.join(tiny.PERFBENCH, "configs",
                           "bigram_fixed_d130.json")) as f:
        big = json.load(f)
    big.update(D=6, am_K=12, batch_size=4, name="tiny_bigram")
    flat = dict(big, name="tiny_bigram_flat",
                prior=dict(big["prior"], var=100.0))
    with open(os.path.join(tiny.PERFBENCH, "traffic", "am1.json")) as f:
        am1 = json.load(f)
    am1.update(n_utterances=10, n_landmarks_max=9, K_true=4,
               warmup_sweeps=1)
    with open(os.path.join(pb, "traffic", "tinyam1.json"), "w") as f:
        json.dump(am1, f)
    with open(os.path.join(r, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in (big, flat):
        path = "perfbench/configs/%s.json" % c["name"]
        with open(os.path.join(r, path), "w") as f:
            json.dump(c, f)
        bench["configs"].append({"name": c["name"], "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    cells = {"tb": ("tiny_bigram", "tinylong", "bigram_fixed_d130.long"),
             "tv": ("tiny_bigram_flat", "tinylong", "bigram_fixed_d130.long"),
             "tfa": (fixed["name"], "tinyam1", "unigram_fixed_d130.am1")}
    for name, (conf, traffic, limits) in cells.items():
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        with open(os.path.join(tiny.PERFBENCH, "limits",
                               limits + ".json")) as f:
            lim = json.load(f)
        with open(os.path.join(pb, "limits", name + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


@pytest.mark.parametrize("name", ["tb", "tfa"])
def test_the_program_passes_a_tiny_cell(root, name):
    res, checks, readings = _run(root, name, full=True,
                                          with_control=True)
    assert res["correct"], checks
    assert readings["mismatch"] == 0 and readings["draw_gap"] == 0.0
    if name == "tb":
        assert readings["lpz_err"] < 1e-6
        assert "control.lpz_err" in readings
    else:
        assert readings["item_gap"] == 0.0


@pytest.mark.parametrize("fault", ["scores_altered", "boundary_altered",
                                   "bigram_unchanged",
                                   "bigram_chain_altered", "replay_altered",
                                   "lm_stale"])
def test_a_fault_fails_the_tiny_bigram_cell(root, monkeypatch, fault):
    ALL_FAULTS[fault](monkeypatch)
    res, checks = _run(root, "tb")
    assert not res["correct"], checks


def test_the_unigram_drivers_unchanged_fault_ends_the_bigram_run(
        root, monkeypatch):
    """``faults.py``'s ``unchanged`` merge returns no LM delta.  The bigram
    step counts its LM inside the merge, so the fault leaves the LM's
    tables unchanged too: the run ends, and not correct."""
    FAULTS["unchanged"](monkeypatch)
    res, checks = _run(root, "tb")
    assert not res["correct"], checks


def test_the_check_sees_the_bigram_term_where_the_lm_decides(root,
                                                             monkeypatch):
    """Under a flat acoustic prior the program's chains read no gap, and
    chains that drop the bigram term (lambda 1) read gaps of nats."""
    res, checks, readings = _run(root, "tv", full=True)
    assert res["correct"] and readings["chain_gap"] == 0.0, checks
    from segmentalist_torch.segmenters import bigram

    inner = bigram.bigram_fixedvar_chain
    monkeypatch.setattr(
        bigram, "bigram_fixedvar_chain",
        lambda *a, **k: inner(*a, **dict(k, intrp_lambda=1.0)))
    res, checks, readings = _run(root, "tv", full=True)
    assert readings["chain_gap"] > 1.0, checks


@pytest.mark.parametrize("fault", ["items_altered", "item_draws_altered"])
def test_an_item_fault_fails_the_tiny_am1_cell(root, monkeypatch, fault):
    ALL_FAULTS[fault](monkeypatch)
    res, checks, readings = _run(root, "tfa", full=True)
    assert not res["correct"], checks
    assert readings["item_gap"] > 10.0


# ---------------------------------------------- the driver's call convention

def _bigram_segmenter(seed=3):
    from segmentalist_torch.utils import profiling

    corpus = profiling.bench_corpus(10, D=4, n_landmarks_max=8)
    return profiling.bench_segmenter("fixed", True, corpus=corpus,
                                     device="cpu", am_K=12, batch_size=4,
                                     seed=seed)[0]


def test_a_bigram_sweep_runs_through_a_unigram_signature_block_step():
    """The check sweep's wrapper takes the unigram driver's arguments
    alone; the bigram sweep calls it so, and runs to its end."""
    seg = _bigram_segmenter()
    inner, calls = seg.block_step, []

    def step(idx_blk, anneal_temp=1.0, assign_temp=1.0, dp_noise=None,
             chain_noise=None):
        calls.append(len(idx_blk))
        return inner(idx_blk, anneal_temp, assign_temp, dp_noise=dp_noise,
                     chain_noise=chain_noise)

    seg.block_step = step
    rec = seg.gibbs_sample(2)
    assert len(calls) == 2 * 3 and np.isfinite(rec["log_marg"]).all()
    seg.gibbs_sample_i(0)
    assert len(calls) == 2 * 3 + 1


def test_the_call_convention_leaves_the_sweep_bit_identical():
    """A sweep that hands ``assignments_only=False`` to every block step,
    as the driver did, and one that leaves it out: the same records, state
    and LM tables, bit for bit."""
    a, b = _bigram_segmenter(), _bigram_segmenter()
    inner = b.block_step
    b.block_step = lambda *args, **kw: inner(
        *args, **dict(kw, assignments_only=False))
    ra, rb = a.gibbs_sample(3), b.gibbs_sample(3)
    for k in ra:
        if k != "sample_time":
            assert ra[k] == rb[k], k
    assert torch.equal(a.acoustic_model.assignments,
                       b.acoustic_model.assignments)
    assert torch.equal(a.utterances.boundaries_dev,
                       b.utterances.boundaries_dev)
    for ta, tb in zip(a.lm.state, b.lm.state):
        assert torch.equal(ta, tb)
