"""Named host spans inside the port, on the profiler's clock.

A span is a ``torch.profiler.record_function`` range: a host event of the
profile's Kineto trace, on the same timeline as the CUPTI device events.
A kernel therefore belongs to the innermost span open when its launch was
made (launch correlation, as ``perfbench/trace.py`` reads it), and an idle gap of the device opens inside the span the host
was in.

Spans exist exactly while a ``torch.profiler.profile`` records: with none,
:func:`annotate` reads one flag and returns a shared no-op context, with
no ``record_function`` call.  The program's spans, nested as below (every
name begins with ``seg.``):

    seg.sweep                one sweep of a driver's loop
      seg.sweep.am           the acoustic model's ``am_n_iter`` sweeps
      seg.sweep.blocks       the sweep's block steps (``_run_blocks``)
        seg.block            one block step, opened inside ``block_step``
          seg.block.leave_out  stage 1: the block's index upload, its old
                               segments and leave-outs, its rows' noise
            seg.diag.tables    the diag family's leave-out moment tables
                               ``sum_xT`` / ``sum_sqT`` [B, D, K]
            seg.lm.leave_out   the bigram LM's old pairs and leave-out
                               unigram counts
          seg.block.score      stage 2a: the mixture weights, the scorer
                               (K1 / K5 / K8; k-means' distances) and the
                               candidates' masking
            seg.diag.tables    the diag family's predictive tables (``m_nT``,
                               ``varT``, ``1 / varT``, the log variances)
          seg.block.dp         stage 2b: ``segment_dp`` (K2 and its noise)
          seg.block.chain      stage 3: the new segments, the chain's
                               noise and the chain (K3 / K4 / K6 / K7 /
                               K9; k-means' nearest means)
          seg.block.merge      stage 4: decollision and the merge of the
                               statistics, boundaries and assignments
            seg.lm.delta       the bigram LM's count update: a block's
                               signed counts added into the tables in
                               place (the per-shard mode: the dense
                               delta, then its addition)
      seg.sweep.metrics      the sweep's record quantities and their fetch
        seg.lm.replay        the bigram corpus log P(z) replay
    seg.sync.<site>          a call that waits for the device
                             (:func:`blocking`, :func:`fetch`)

``utils/profiling.py`` :func:`trace` around a driver's ``gibbs_sample`` /
``segment`` captures them in one Chrome trace above the kernels they
launched.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A named host span (a context manager): a profiler range while a
    ``torch.profiler.profile`` records, else a shared no-op context."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def blocking(site: str):
    """The span ``seg.sync.<site>`` around a call that makes the host wait
    for the device: a read of a device tensor, or a write from pageable
    host memory, which drains the stream first.  Every such call of a
    sweep runs inside one; under ``torch.cuda.set_sync_debug_mode`` it
    alone may synchronise, so a test in the "error" mode finds every
    other."""
    with annotate("seg.sync." + site):
        mode = (torch.cuda.get_sync_debug_mode()
                if torch.cuda.is_initialized() else 0)
        if mode:
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if mode:
                torch.cuda.set_sync_debug_mode(mode)


def fetch(site: str, value: torch.Tensor):
    """``value.tolist()``, the host's blocking read of a device tensor,
    in :func:`blocking`'s span ``seg.sync.<site>``."""
    with blocking(site):
        return value.tolist()
