"""The program's profiler spans (``segmentalist_torch/utils/tracing.py``):
the span tree of one sweep of each driver on the CPU, that no span costs
a ``record_function`` call while no profiler records, and, on a card,
that every blocking device-to-host read of a sweep goes through
``tracing.fetch``.

Imports torch, numpy and the port only, so the card test runs where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import segmentalist_torch as pt
from segmentalist_torch.utils import profiling, tracing

STAGES = ("seg.block.leave_out", "seg.block.score", "seg.block.dp",
          "seg.block.chain", "seg.block.merge")
DRIVERS = ("unigram_fixed", "unigram_full", "bigram", "kmeans")
N_UTT, BATCH = 10, 4  # three block steps a sweep


def _segmenter(driver: str, device="cpu", n_utterances=N_UTT, D=4,
               batch_size=BATCH, am_K=12):
    corpus = profiling.bench_corpus(n_utterances, D=D, n_landmarks_max=8)
    if driver == "kmeans":
        em, vi, du, lm, _ = corpus
        return pt.SegmentalKMeansWordseg(
            am_K, em, vi, du, lm, p_boundary_init=0.5, n_slices_max=6,
            batch_size=batch_size, seed=1, device=device)
    cov = "full" if driver == "unigram_full" else "fixed"
    return profiling.bench_segmenter(
        cov, driver == "bigram", corpus=corpus, device=device, am_K=am_K,
        batch_size=batch_size, seed=1)[0]


def _sweep(seg):
    if isinstance(seg, pt.SegmentalKMeansWordseg):
        return seg.segment(1)
    return seg.gibbs_sample(1)


def _span_tree(events):
    """[(name, start, end, parent name or None)] of the ``seg.*`` spans in
    order of their start, a span's parent the innermost other span that
    holds it."""
    spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in events if e.name.startswith("seg.")
                   and e.device_type.name == "CPU")
    out = []
    for i, (a, nb, name) in enumerate(spans):
        holders = [s for j, s in enumerate(spans)
                   if j != i and s[0] <= a and -s[1] >= -nb]
        parent = max(holders)[2] if holders else None
        out.append((name, a, -nb, parent))
    return out


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_sweep_makes_the_span_tree(driver):
    seg = _segmenter(driver)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(seg)
    tree = _span_tree(prof.events())
    names = [t[0] for t in tree]
    parent = {i: t[3] for i, t in enumerate(tree)}
    assert names.count("seg.sweep") == 1
    assert parent[names.index("seg.sweep")] is None
    for name in ("seg.sweep.blocks", "seg.sweep.metrics"):
        assert names.count(name) == 1
        assert parent[names.index(name)] == "seg.sweep"
    blocks = [i for i, n in enumerate(names) if n == "seg.block"]
    assert len(blocks) == -(-N_UTT // BATCH)
    assert all(parent[i] == "seg.sweep.blocks" for i in blocks)
    for i in blocks:
        a, b = tree[i][1], tree[i][2]
        inside = [t for t in tree if t[3] == "seg.block"
                  and a <= t[1] and t[2] <= b]
        assert tuple(t[0] for t in inside) == STAGES
    assert names.count("seg.block.dp") == len(blocks)
    syncs = [i for i, n in enumerate(names) if n.startswith("seg.sync.")]
    assert syncs, "a sweep fetches its record"
    assert all(parent[i] is not None and parent[i].startswith("seg.")
               for i in syncs)
    assert parent[names.index("seg.sync.metrics")] == "seg.sweep.metrics"


@pytest.mark.parametrize("driver", DRIVERS)
def test_no_record_function_while_no_profiler_records(driver, monkeypatch):
    seg = _segmenter(driver)

    def refuse(self):
        raise AssertionError("a span entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        refuse)
    rec = _sweep(seg)
    assert len(rec["sample_time"]) == 1


def test_annotate_is_a_shared_no_op_until_a_profiler_records():
    assert tracing.annotate("seg.a") is tracing.annotate("seg.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate("seg.a"):
            torch.ones(2).add(1)
    assert "seg.a" in [e.key for e in prof.key_averages()]


def test_fetch_reads_inside_its_sync_span():
    t = torch.tensor([1.5, 2.0], dtype=torch.float64)
    assert tracing.fetch("here", t) == [1.5, 2.0]
    assert tracing.fetch("here", t[0]) == 1.5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate("seg.outer"):
            tracing.fetch("here", t)
    tree = _span_tree(prof.events())
    assert [(n, p) for n, _, _, p in tree] == [
        ("seg.outer", None), ("seg.sync.here", "seg.outer")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there, and the sync debug mode is the card's")
    from segmentalist_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ("unigram_fixed", "unigram_full",
                                    "bigram"))
def test_every_blocking_read_of_a_sweep_is_a_fetch(driver, cuda_device):
    """In the "error" sync debug mode any read that waits on the card
    raises, but ``tracing.fetch``'s own.  The fixed family's sweeps (the
    unigram and the bigram driver) run with their glue replayed as CUDA
    graphs, captured in the warm-up (two full blocks of 16 a sweep, two
    stages each); the full family's stays eager."""
    from segmentalist_torch.segmenters import graphs

    seg = _segmenter(driver, cuda_device, n_utterances=40, D=13,
                     batch_size=16, am_K=64)
    _sweep(seg)  # warm-up: the library's build, the kernels' plans, the
    torch.cuda.synchronize()  # graphs' capture
    replays, captures = graphs.glue_graph_replays, graphs.glue_graph_captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = _sweep(seg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(rec["log_marg"][0])
    assert graphs.glue_graph_captures == captures
    assert graphs.glue_graph_replays - replays == (
        0 if driver == "unigram_full" else 4)


# the bigram LM's spans and the stage span that holds each
LM_SPANS = {"seg.lm.leave_out": "seg.block.leave_out",
            "seg.lm.delta": "seg.block.merge",
            "seg.lm.replay": "seg.sweep.metrics"}


def test_a_bigram_sweep_opens_the_lm_spans_inside_their_stages():
    """One ``seg.lm.leave_out`` and one ``seg.lm.delta`` (the counts added
    into the tables in place) a block step, one ``seg.lm.replay`` a sweep,
    each in its stage; the unigram driver opens none (with no profiler, the
    bigram driver's spans make no ``record_function`` call:
    ``test_no_record_function_while_no_profiler_records``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(_segmenter("bigram"))
    tree = _span_tree(prof.events())
    blocks = sum(1 for t in tree if t[0] == "seg.block")
    lm = [(n, p) for n, _, _, p in tree if n.startswith("seg.lm.")]
    assert set(lm) == set(LM_SPANS.items())
    names = [n for n, _ in lm]
    assert names.count("seg.lm.leave_out") == blocks
    assert names.count("seg.lm.delta") == blocks
    assert names.count("seg.lm.replay") == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(_segmenter("unigram_fixed"))
    assert not [t for t in _span_tree(prof.events())
                if t[0].startswith("seg.lm.")]
