"""CUDA graphs of the fixed family's block-step glue.

A block step's two glue stages launch well over a hundred small kernels
between them: the leave-out (stage 1: the block's old segments, their
components and the leave-out moments; for the bigram segmenter also the
LM's old pairs and leave-out unigram counts) and the merge (stage 4: the
decollision, the merge kernel, the writes into the state and the bigram
LM's count update).  Issued one by one from the host, they set the pace of
the fixed family's sweeps, and the card waits on them.  On a card,
:class:`GlueGraphs` captures each stage once per block size as a
``torch.cuda.CUDAGraph`` and replays it for every block that
:func:`graphed` admits.  A graph is a capture of the functions
the eager path calls (``BlockedWordseg._leave_out_rows`` and
``_merge_rows``), so the graphed and the eager path give the same bits.

- The first call of a block size runs eagerly (the warm-up); the next
  captures, then replays.
- Before a replay the stage's inputs go into the graph's static buffers:
  the leave-out's index upload (from pinned host memory, asynchronously),
  the merge's outputs of the eager stages (the new boundaries, segments,
  their vectors and components, the DP's log probabilities).
- The state the graphs read and write (``am.stats``, ``am._assign_pad``,
  ``utterances.boundaries_dev`` and, where the segmenter has an LM, its
  ``lm.state`` tables) lives in fixed buffers that the merge updates in
  place.  Code that rebinds one of them (the rebuild of the statistics
  after the am sweeps, the ``assignments`` setter, an eager merge,
  ``set_lm_counts``, a checkpoint load) is followed, before the next
  replay, by a copy into the buffer and a rebind to it, never by a
  capture.
- A graph is captured again only where the state's shapes change (every
  graph is dropped) or a tensor it reads that is not state is replaced
  (``am.X``, the corpus's ``seg_ids`` and ``lengths_dev``; for the merge,
  the leave-out graph's ``Block``).
- No random draw is captured: the DP's and the chain's noise and the
  kernels K1, K2 and K3 (K4) run in the eager stages between the two
  graphs.

A replay overwrites its outputs: the leave-out's ``Block`` is valid until
the next block step's leave-out, and the merge hands back a copy of its
log probability.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.bigram_lm import BigramLMState
from ..ops.stats import SuffStats

# glue stage calls of block steps that replayed a graph; qualifying ones
# run eagerly (the warm-ups, and merges of a block the leave-out did not
# replay); captures.  Summed over the process (readers take differences).
glue_graph_replays = 0
glue_graph_eager = 0
glue_graph_captures = 0


def graphed(device: torch.device, family: str, shard, split: bool,
            n_live: int, B: int) -> bool:
    """Whether a glue stage replays a graph: on a card, for the fixed
    family, off a mesh, in a block step (``split``) whose ``B`` rows are
    all live."""
    return (device.type == "cuda" and family == "fixed" and shard is None
            and split and n_live == B)


def _state(seg) -> tuple:
    """The tensors the graphs update in place: the statistics, the
    assignments, the boundaries and a segmenter's LM tables."""
    am = seg.acoustic_model
    lm = tuple(seg.lm.state) if hasattr(seg, "lm") else ()
    return (*am.stats, am._assign_pad, seg.utterances.boundaries_dev, *lm)


def _refs(seg) -> tuple:
    """The tensors the graphs read that are not state."""
    utt = seg.utterances
    return seg.acoustic_model.X, utt.seg_ids, utt.lengths_dev


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple     # static input buffers
    out: object       # static outputs, overwritten by every replay
    refs: tuple       # what it read when captured, compared by identity


class GlueGraphs:
    """The captured glue stages of one segmenter, by (stage, block size),
    and the state buffers they share."""

    def __init__(self):
        self._graphs = {}     # (stage, B) -> _Graph, or None once warmed up
        self._blocks = {}     # B -> the leave-out graph's Block
        self._shapes = None   # the state's shapes and dtypes
        self._bufs = None     # the state buffers
        self._stream = None   # the capture stream

    def leave_out(self, seg, packed: np.ndarray):
        """Stage 1 of a block step (``seg._leave_out_rows``) on the block's
        ``packed`` [2 B] host ids and live positions."""
        B = packed.shape[0] // 2
        host = torch.from_numpy(packed).pin_memory()
        blk, replayed = self._run(seg, "leave_out", B, (host,),
                                  lambda p: seg._leave_out_rows(p, B),
                                  _refs(seg))
        if replayed:
            self._blocks[B] = blk
        return blk

    def merge(self, seg, blk, args: tuple, lm_delta=None) -> torch.Tensor:
        """Stage 4 of a block step (``seg._merge_rows``): ``args`` are its
        new boundaries, segments, their vectors and components and the DP's
        log probabilities; ``lm_delta`` the bigram segmenter's in-place
        update of its LM tables.  Returns the block's summed log
        probability.  A block whose leave-out did not replay merges
        eagerly."""
        B = blk.valid.shape[0]
        lp, replayed = self._run(
            seg, "merge", B, args,
            lambda *a: seg._merge_rows(blk, *a, lm_delta, in_place=True)[0],
            _refs(seg) + (blk, seg.decollide_new),
            ready=blk is self._blocks.get(B),
            eager=lambda *a: seg._merge_rows(blk, *a, lm_delta)[0])
        return lp.clone() if replayed else lp

    def _run(self, seg, stage, B, args, body, refs, ready=True, eager=None):
        """``(outputs, replayed)`` of ``body(*args)``: eagerly (``eager``
        where given) on the first call of a block size or where not
        ``ready``, else by a replay, captured first where needed."""
        global glue_graph_replays, glue_graph_eager, glue_graph_captures
        self._check_shapes(seg)
        key = (stage, B)
        if key not in self._graphs or not ready:
            self._graphs.setdefault(key, None)
            glue_graph_eager += 1
            return (eager or body)(*(a.to(seg.device, non_blocking=True)
                                     for a in args)), False
        self._bind_state(seg)
        g = self._graphs[key]
        if g is None or any(a is not b for a, b in zip(g.refs, refs)):
            self._graphs[key] = None  # the old graph's pool goes first
            inputs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                       device=seg.device) for a in args)
            for buf, a in zip(inputs, args):
                buf.copy_(a, non_blocking=True)
            graph, out = self._capture(seg.device, body, inputs)
            g = self._graphs[key] = _Graph(graph, inputs, out, refs)
            glue_graph_captures += 1
        else:
            for buf, a in zip(g.inputs, args):
                buf.copy_(a, non_blocking=True)
        g.graph.replay()
        glue_graph_replays += 1
        return g.out, True

    def _capture(self, device, body, inputs):
        """``(graph, outputs)`` of ``body(*inputs)`` captured on this
        object's side stream of ``device``."""
        with torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                out = body(*inputs)
        return graph, out

    def _check_shapes(self, seg):
        """Drop every graph and the state buffers where the state's shapes
        or dtypes changed."""
        shapes = tuple((t.shape, t.dtype) for t in _state(seg))
        if shapes != self._shapes:
            self._shapes, self._bufs = shapes, None
            self._graphs.clear()
            self._blocks.clear()

    def _bind_state(self, seg):
        """Point the segmenter's state at the buffers, copying in what was
        rebound since the last replay."""
        cur = _state(seg)
        if self._bufs is None:
            self._bufs = tuple(torch.empty_like(t) for t in cur)
        if all(c is b for c, b in zip(cur, self._bufs)):
            return
        for c, b in zip(cur, self._bufs):
            if c is not b:
                b.copy_(c)
        am = seg.acoustic_model
        am.stats = SuffStats(*self._bufs[:3])
        am._assign_pad = self._bufs[3]
        seg.utterances.boundaries_dev = self._bufs[4]
        if hasattr(seg, "lm"):
            seg.lm.state = BigramLMState(*self._bufs[5:])
