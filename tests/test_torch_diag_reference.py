"""The benchmark's plain reference of the diagonal-covariance model
(``perfbench/reference/unigram_diag.py``, ``families_diag.py``) and its
cells at a tiny size on the CPU: the family's log density against the
closed form of a product of univariate Student's t densities and against
the port's own predictive and exact scorer; a tiny diag cell (D 6, K 12, 10
utterances, blocks of 4) through ``perfbench.run.run_cell`` that comes out
correct, and each fault of ``perfbench/faults_diag.py`` planted under it
failing it; the K5 and K6 work counts on a hand-made summary and the
three readers on synthetic profiler events; and the program's
``seg.diag.tables`` span, opened twice a diag block step and never on the
fixed family's.

Imports torch, numpy, the port and ``perfbench`` only (no JAX)."""

import json
import math
import os
import sys
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "perfbench", "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import perfbench_tiny as tiny  # noqa: E402
from perfbench import faults_diag  # noqa: E402
from perfbench.reference import families_diag  # noqa: E402
from perfbench.work import diag_k5, diag_k6  # noqa: E402

D, K = 6, 12


def _prior(rng, dtype=torch.float64):
    return {"m_0": torch.as_tensor(rng.randn(D), dtype=dtype),
            "k_0": 0.3, "v_0": D + 2.5,
            "S_0": torch.as_tensor(0.2 + rng.rand(D), dtype=dtype)}


def _stats(rng, counts):
    """Sums and [K, D, D] second moments of ``counts`` random members a
    component."""
    sx = np.zeros((K, D))
    ssq = np.zeros((K, D, D))
    for k, n in enumerate(counts):
        X = rng.randn(n, D) * (0.5 + rng.rand(D)) + 2.0 * rng.randn(D)
        sx[k], ssq[k] = X.sum(0), X.T @ X
    return (torch.as_tensor(counts, dtype=torch.float64),
            torch.as_tensor(sx), torch.as_tensor(ssq))


# ------------------------------------------------------------ closed forms

def test_the_diag_density_is_a_product_of_students_t():
    rng = np.random.RandomState(1)
    pr = _prior(rng)
    fam = families_diag.Diag(pr)
    n, sx, ssq = _stats(rng, rng.randint(1, 9, K))
    mu, var, v = fam.params(n, sx, ssq)
    X = torch.as_tensor(rng.randn(20, D) * 2.0)
    got = fam.logpdf_rows((mu, var, v), X, elements=7 * K * D)
    k_n, v_n = pr["k_0"] + n, pr["v_0"] + n
    m_n = (pr["k_0"] * pr["m_0"] + sx) / k_n[:, None]
    s_n = (pr["S_0"] + pr["k_0"] * pr["m_0"] ** 2
           + torch.diagonal(ssq, dim1=-2, dim2=-1) - k_n[:, None] * m_n ** 2)
    scale = torch.sqrt((k_n + 1)[:, None] / (k_n * v_n)[:, None] * s_n)
    t = torch.distributions.StudentT(v_n[:, None], m_n, scale)
    want = t.log_prob(X[:, None, :]).sum(-1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-10)
    # the same under one component for its own rows, and the prior's
    many = fam.logpdf_many((mu, var, v), X[None].expand(K, 20, D), chunk=5)
    assert torch.allclose(many, want.T, rtol=1e-12, atol=1e-10)
    var0 = (pr["k_0"] + 1) / (pr["k_0"] * pr["v_0"]) * pr["S_0"]
    t0 = torch.distributions.StudentT(torch.tensor(pr["v_0"], dtype=X.dtype),
                                      pr["m_0"],
                                      torch.sqrt(var0))
    assert torch.allclose(fam.log_prior(X), t0.log_prob(X).sum(-1),
                          rtol=1e-12, atol=1e-10)


def test_the_diag_scores_match_the_ports_exact_scorer():
    """The reference's mixture score of every row against the port's
    ``components_diag.predictive_params`` and ``diag_scores_plain`` in its
    exact composition, float64, on seeded random statistics."""
    from segmentalist_torch.models import components_diag as cdg
    from segmentalist_torch.ops.cuda_score import diag_scores_plain
    from segmentalist_torch.ops.stats import SuffStats
    from segmentalist_torch.priors import NIW

    rng = np.random.RandomState(2)
    pr = _prior(rng)
    counts = rng.randint(0, 9, K)
    counts[:3] = [0, 1, 0]
    n, sx, ssq = _stats(rng, counts)
    fam = families_diag.Diag(pr)
    X = torch.as_tensor(rng.randn(30, D) * 2.0)
    safe = torch.where(n > 0, n, 1.0)
    post = fam.logpdf_rows(fam.params(safe, sx, ssq), X)
    prior_x = fam.log_prior(X)
    w = torch.as_tensor(rng.randn(K))
    want = torch.logsumexp(
        w + torch.where(n > 0, post, prior_x[:, None]), dim=-1)

    niw = NIW.create(pr["m_0"].numpy(), pr["k_0"], pr["v_0"],
                     pr["S_0"].numpy(), device="cpu").to(dtype=torch.float64)
    p = cdg.predictive_params(niw, SuffStats(
        n.long(), sx, torch.diagonal(ssq, dim1=-2, dim2=-1).contiguous()))
    T = lambda a: a.T[None].contiguous()  # noqa: E731  [K, D] -> [1, D, K]
    got = diag_scores_plain(X[None], prior_x[None], T(p.mu), T(p.inv_var),
                            p.log_prod_var[None], p.v[None], w[None],
                            torch.as_tensor(counts, dtype=torch.int32)[None],
                            exact=True)[0]
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-10)
    assert torch.allclose(cdg.log_prior(niw, X), prior_x, rtol=1e-12)


# ---------------------------------------------------------- the tiny cell

def _run(root, name, **kw):
    """A tiny cell's run with one sweep in its window."""
    return tiny.run_tiny(root, name, seconds=0.0, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark tree with ``td``: the diag configuration at D 6,
    K 12 and blocks of 4 on 10 utterances of 2-14 landmarks, with the
    limits of ``unigram_diag_d130.long``."""
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    pb = os.path.join(r, "perfbench")
    with open(os.path.join(tiny.PERFBENCH, "configs",
                           "unigram_diag_d130.json")) as f:
        cfg = json.load(f)
    cfg.update(D=D, am_K=K, batch_size=4, name="tiny_diag")
    path = "perfbench/configs/tiny_diag.json"
    with open(os.path.join(r, path), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tiny.PERFBENCH, "limits",
                           "unigram_diag_d130.long.json")) as f:
        lim = json.load(f)
    with open(os.path.join(pb, "limits", "td.json"), "w") as f:
        json.dump(lim, f)
    with open(os.path.join(r, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_diag", "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "td", "config": "tiny_diag",
                               "traffic": "tinylong", "chips": 1,
                               "why": "test"})
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


def test_the_program_passes_the_tiny_diag_cell(root):
    res, checks, readings = _run(root, "td", full=True, with_control=True)
    assert res["correct"], checks
    assert readings["mismatch"] == 0 and readings["draw_gap"] == 0.0
    assert "control.score_err" in readings


@pytest.mark.parametrize("fault", sorted(faults_diag.FAULTS))
def test_a_diag_fault_fails_the_tiny_diag_cell(root, monkeypatch, fault):
    faults_diag.FAULTS[fault](monkeypatch)
    res, checks = _run(root, "td")
    assert not res["correct"], checks


# ------------------------------------------------------------ work counts

# one block of two utterances: D 5 (two groups of four), K 5
S = {"D": 5, "K": 5, "W": 2, "K_occ": 3, "lengths": np.array([3, 2]),
     "rows": np.array([5, 3]), "occ": np.array([3, 2]),
     "touched": np.array([1, 2]), "steps": np.array([2, 1]),
     "slot_steps": 4, "claimed": 1}


def test_the_diag_score_count():
    w = diag_k5.count(S)
    # pairs 5*3 + 3*2 = 21 at 5*5 + 2 + 8 = 35; components 3 + 3 = 6 at D
    assert w.flops == 21 * 35 + 6 * 5
    # two group logs and an exp a pair, a log a row, 3 a component
    assert w.sfu == 21 * 3 + 8 + 6 * 3
    # rows 8 * (5 + 2) floats; tables 6 * (2*5 + 2); 2 rows of 5 weights
    # and counts
    assert w.bytes == 8 * 7 * 4 + 6 * 12 * 4 + 2 * 5 * 8


def test_the_diag_chain_count():
    w = diag_k6.count(S)
    # column steps 2*3 + 1*2 = 8 at 5*5 + 8 = 33; 3 steps of 2*5; 3 + 6
    # derivations at 8*5 + 30 = 70
    assert w.flops == 8 * 33 + 3 * 10 + 9 * 70
    # four logs a column step; D + 3 a derivation
    assert w.sfu == 8 * 4 + 9 * 8
    assert w.bytes == 3 * (5 + 5 + 1) * 4 + 6 * 2 * 5 * 4 + 2 * 5 * 4


def _ev(name, dev, start, end, id_=0, device_us=0.0):
    return NS(name=name, device_type=NS(name=dev), id=id_,
              time_range=NS(start=start, end=end), is_user_annotation=False,
              device_time_total=device_us)


def test_the_diag_readers_on_synthetic_events():
    """The rooflines take their counts by name over their ranges' device
    time; the tables' reader sums the span's device time a sweep and reads
    nothing where the program has no span."""
    from perfbench import find, trace

    events = [
        _ev("diag_scorer", "CPU", 0, 10),
        _ev("cudaLaunchKernel", "CPU", 2, 3, 1),
        _ev("diag_chain", "CPU", 20, 30),
        _ev("cudaLaunchKernel", "CPU", 21, 22, 2),
        _ev("seg.diag.tables", "CPU", 40, 50, device_us=6.0),
        _ev("seg.diag.tables", "CPU", 60, 70, device_us=3.0),
        _ev("scores_kernel", "CUDA", 5, 15, 1),
        _ev("chain_kernel", "CUDA", 25, 45, 2)]
    ranges = {"diag_scorer": [], "diag_chain": []}
    ctx = trace.Ctx(tiny.ROOT, "diag", 3, 1, 1.0, 1.0, events, ranges,
                    {"block": [S, S], "am": []})
    read = {n: find.module(tiny.ROOT, "metrics", n).read for n in (
        "diag_scorer_roofline", "diag_chain_roofline",
        "diag_tables_ms_per_sweep")}
    assert read["diag_scorer_roofline"](ctx) == pytest.approx(
        100 * (diag_k5.count(S) + diag_k5.count(S)).seconds() / 10e-6)
    assert read["diag_chain_roofline"](ctx) == pytest.approx(
        100 * (diag_k6.count(S) + diag_k6.count(S)).seconds() / 20e-6)
    assert read["diag_tables_ms_per_sweep"](ctx) == pytest.approx(9e-3 / 3)
    # the family's stage lookup finds no count: older readers stay silent
    assert ctx.work("score") is None and ctx.work("chain") is None
    bare = trace.Ctx(tiny.ROOT, "diag", 3, 1, 1.0, 1.0, events[:4] + events[6:],
                     ranges, {"block": [S], "am": []})
    assert read["diag_tables_ms_per_sweep"](bare) is None


# -------------------------------------------------------------- the span

def _segmenter(cov):
    from segmentalist_torch.utils import profiling

    corpus = profiling.bench_corpus(8, D=4, n_landmarks_max=8)
    return profiling.bench_segmenter(cov, False, corpus=corpus,
                                     device="cpu", am_K=12, batch_size=8,
                                     seed=1)[0]


@pytest.mark.parametrize("cov, opened", [("diag", 2), ("fixed", 0)])
def test_a_block_step_opens_the_diag_tables_span(cov, opened):
    seg = _segmenter(cov)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg.block_step(np.arange(8))
    names = [e.name for e in prof.events() if e.device_type.name == "CPU"]
    assert names.count("seg.block") == 1
    assert names.count("seg.diag.tables") == opened
    if opened:
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.name.startswith("seg."))
        holders = []
        for a, b, name in spans:
            if name == "seg.diag.tables":
                holders.append(max(
                    (s for s in spans if s[0] <= a and b <= s[1]
                     and s[2] not in ("seg.diag.tables", "seg.block")),
                    default=(0, 0, None))[2])
        assert holders == ["seg.block.leave_out", "seg.block.score"]
    assert math.isfinite(float(seg.acoustic_model.stats.sum_x.sum()))
