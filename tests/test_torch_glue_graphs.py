"""The CUDA graphs of the fixed family's block-step glue
(``segmentalist_torch/segmenters/graphs.py``) on the CPU: the gate's
decision, the assignment sink's device fill, and the cache's bookkeeping
(warm-up, capture, replay, the state buffers and their rebinds) with a
stand-in for ``torch.cuda.CUDAGraph`` that replays by running the captured
stage again on its static inputs, bit for bit against the eager sweeps.
The graphs themselves are captured on a card (``tests/test_torch_cuda.py``).

Imports torch, numpy and the port only.
"""

import numpy as np
import pytest
import torch

from segmentalist_torch.segmenters import graphs
from segmentalist_torch.segmenters.common import put_assignments
from segmentalist_torch.utils import profiling

CUDA = torch.device("cuda")
N_UTT, BATCH = 10, 4  # blocks of 4, 4 and a padded 2


@pytest.mark.parametrize("case,expect", [
    (dict(), True),
    (dict(family="full"), False),
    (dict(family="diag"), False),
    (dict(shard=object()), False),
    (dict(n_live=3), False),
    (dict(split=False), False),
    (dict(n_live=1, B=1), True),
    (dict(device=torch.device("cpu")), False),
])
def test_the_gate_decides_by_what_the_stage_can_observe(case, expect):
    args = dict(device=CUDA, family="fixed", shard=None, split=True,
                n_live=4, B=4)
    args.update(case)
    assert graphs.graphed(**args) is expect


@pytest.mark.parametrize("family", ["fixed", "diag", "full"])
def test_on_a_cpu_tensor_the_gate_is_always_eager(family):
    cpu = torch.device("cpu")
    for split in (True, False):
        assert not graphs.graphed(cpu, family, None, split, 4, 4)
    seg = _segmenter(cov=family)
    before = _counts()
    seg.gibbs_sample(1)
    assert _counts() == before


def test_put_assignments_fills_the_sink_and_writes_every_other_row():
    N = 9
    pad = torch.arange(N + 1, dtype=torch.int32)
    pad[N] = 7  # a padded row wrote here
    valid = torch.tensor([True, False])
    old = torch.tensor([[0, 2, -1], [5, 6, -1]], dtype=torch.int32)
    new = torch.tensor([[1, -1, -1], [4, -1, -1]], dtype=torch.int32)
    ks = torch.tensor([[30, 31, 32], [40, 41, 42]], dtype=torch.int32)
    want = pad.clone()
    want[[0, 2]] = -1      # the valid row's old segments clear
    want[1] = 30           # and its new one is set
    want[N] = -1           # the sink
    put_assignments(pad, valid, old, new, ks)
    assert torch.equal(pad, want)


def _segmenter(bigram=False, cov="fixed", **kw):
    corpus = profiling.bench_corpus(N_UTT, D=4, n_landmarks_max=8)
    return profiling.bench_segmenter(cov, bigram, corpus=corpus,
                                     device="cpu", am_K=12,
                                     batch_size=BATCH, seed=1, **kw)[0]


def _counts():
    return (graphs.glue_graph_replays, graphs.glue_graph_eager,
            graphs.glue_graph_captures)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _StandIn:
    """A captured stage on the CPU: capturing runs nothing that stays (the
    state buffers are put back), and a replay runs the stage on the static
    inputs and writes its results into the capture's outputs."""

    def __init__(self, body, inputs, bufs):
        self.body, self.inputs = body, inputs
        saved = [b.clone() for b in bufs]
        self.out = body(*inputs)
        for b, s in zip(bufs, saved):
            b.copy_(s)

    def replay(self):
        _copy_into(self.out, self.body(*self.inputs))


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU: the gate takes the CPU for a card, captures
    make :class:`_StandIn`, and pinning host memory is the identity."""
    gate = graphs.graphed
    monkeypatch.setattr(graphs, "graphed",
                        lambda device, *a, **k: gate(CUDA, *a, **k))

    def capture(self, device, body, inputs):
        g = _StandIn(body, inputs, self._bufs)
        return g, g.out

    monkeypatch.setattr(graphs.GlueGraphs, "_capture", capture)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)


def _state(seg):
    am = seg.acoustic_model
    lm = tuple(seg.lm.state) if hasattr(seg, "lm") else ()
    return [t.clone() for t in (*am.stats, am.assignments,
                                seg.utterances.boundaries_dev, *lm)]


def _run(seg, sweeps, am_n_iter):
    kw = {} if am_n_iter is None else {"am_n_iter": am_n_iter}
    recs = [seg.gibbs_sample(1, **kw) for _ in range(sweeps)]
    return [{k: v for k, v in r.items() if k != "sample_time"}
            for r in recs], _state(seg)


@pytest.mark.parametrize("driver,am_n_iter", [
    ("unigram", 0), ("unigram", 1), ("bigram", None)])
def test_replayed_glue_equals_the_eager_sweeps(stand_in, monkeypatch,
                                               driver, am_n_iter):
    """Three sweeps through the cache equal three eager ones bit for bit,
    the bigram driver's LM tables included; a block size warms up once and
    captures once a stage, every later full block replays both stages (the
    bigram driver's LM leave-out and count update inside them), and the
    padded block runs eagerly."""
    bigram = driver == "bigram"
    seg = _segmenter(bigram)
    before = _counts()
    recs, state = _run(seg, 3, am_n_iter)
    replays, eager, captures = (b - a for a, b in zip(before, _counts()))
    stages = 2
    full = 3 * (N_UTT // BATCH)  # full blocks in three sweeps
    assert (eager, captures) == (stages, stages)
    assert replays == stages * (full - 1)

    monkeypatch.setattr(graphs, "graphed", lambda *a, **k: False)
    want_recs, want_state = _run(_segmenter(bigram), 3, am_n_iter)
    assert recs == want_recs
    for got, want in zip(state, want_state):
        assert torch.equal(got, want)


def test_a_rebound_state_is_copied_in_and_a_replaced_input_recaptures(
        stand_in):
    seg = _segmenter()
    seg.gibbs_sample(1)
    am = seg.acoustic_model
    _, _, captures = _counts()
    am.assignments = am.assignments.clone()      # the setter rebinds
    am.stats = type(am.stats)(*(t.clone() for t in am.stats))
    seg.utterances.boundaries_dev = seg.utterances.boundaries_dev.clone()
    seg.block_step(np.arange(BATCH))             # a full block replays
    assert _counts()[2] == captures
    bufs = seg._glue_graphs._bufs
    assert am.stats.counts is bufs[0] and am._assign_pad is bufs[3]
    assert seg.utterances.boundaries_dev is bufs[4]
    am.X = am.X.clone()                          # read by both stages
    seg.gibbs_sample(1)
    assert _counts()[2] == captures + 2


def test_a_rebound_lm_state_is_copied_in_before_the_next_replay(stand_in,
                                                                monkeypatch):
    """The bigram LM's tables are graph state: a rebound ``lm.state`` (here
    tables of other counts) goes into the buffers before the next replay,
    with no capture, and the replayed block step reads it as an eager one
    does."""
    seg = _segmenter(bigram=True)
    seg.gibbs_sample(1)
    captures = _counts()[2]
    bump = lambda st: type(st)(*(t + 1 for t in st))  # noqa: E731
    seg.lm.state = bump(seg.lm.state)
    seg.block_step(np.arange(BATCH))             # a full block replays
    assert _counts()[2] == captures
    bufs = seg._glue_graphs._bufs
    assert (seg.lm.state.unigram_counts is bufs[5]
            and seg.lm.state.bigram_counts is bufs[6])

    monkeypatch.setattr(graphs, "graphed", lambda *a, **k: False)
    want = _segmenter(bigram=True)
    want.gibbs_sample(1)
    want.lm.state = bump(want.lm.state)
    want.block_step(np.arange(BATCH))
    for got, w in zip(_state(seg), _state(want)):
        assert torch.equal(got, w)


def test_a_new_state_shape_drops_every_graph_and_the_buffers(stand_in):
    seg = _segmenter()
    seg.gibbs_sample(1)
    glue = seg._glue_graphs
    assert glue._graphs and glue._bufs is not None
    am = seg.acoustic_model
    am.stats = type(am.stats)(*(torch.cat([t, t[:1] * 0])
                                for t in am.stats))
    glue._check_shapes(seg)
    assert not glue._graphs and glue._bufs is None and not glue._blocks


def test_block_step_returns_a_log_probability_no_replay_overwrites(
        stand_in):
    seg = _segmenter()
    blocks = [np.arange(4), np.arange(4, 8), np.arange(4), np.arange(4, 8)]
    lps = [seg.block_step(b) for b in blocks]
    held = [float(lp) for lp in lps]
    seg.block_step(np.arange(4))
    assert [float(lp) for lp in lps] == held
