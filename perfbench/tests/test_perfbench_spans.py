"""The readers of the program's own spans (``glue_host_ms_per_block``,
``sweep_edge_ms``, ``sync_wait_ms_per_sweep``) on synthetic profiler
events; a span's row on the device timeline is no device work, and an
idle gap the host spends in Python glue is named by the innermost
``seg.*`` span open at its start."""

from types import SimpleNamespace as NS

import pytest

import perfbench_tiny as tiny
from perfbench import spans, trace
from perfbench.metrics import (glue_host_ms_per_block, idle_share,
                               kernels_per_block, sweep_edge_ms,
                               sync_wait_ms_per_sweep)


def ev(name, dev, start, end, id_=0, annotation=False):
    return NS(name=name, device_type=NS(name=dev), id=id_,
              time_range=NS(start=start, end=end),
              is_user_annotation=annotation)


def span(name, start, end):
    return ev(name, "CPU", start, end, annotation=True)


def events():
    """One sweep (µs): acoustic-model sweeps, two block steps with the
    benchmark's bookkeeping read before the first and a wait in the first
    merge, the record's fetches."""
    return [
        span("seg.sweep", 0, 1000),
        span("seg.sweep.am", 20, 60),
        span("seg.sweep.blocks", 100, 800),
        ev(trace.BOOKKEEPING, "CPU", 100, 118),
        ev("cudaMemcpyAsync", "CPU", 105, 106, 9),
        span("seg.block", 119, 450),
        span("seg.block.leave_out", 120, 170),
        ev("aten::index", "CPU", 125, 135),
        ev("cudaLaunchKernel", "CPU", 130, 131, 1),
        span("seg.block.score", 170, 250),
        span("seg.block.dp", 250, 300),
        span("seg.block.chain", 300, 400),
        span("seg.block.merge", 400, 450),
        ev("cudaLaunchKernel", "CPU", 404, 405, 2),
        span("seg.sync.assign_sink", 440, 445),
        span("seg.block", 460, 790),
        span("seg.block.leave_out", 460, 480),
        span("seg.block.merge", 700, 790),
        ev("cudaLaunchKernel", "CPU", 702, 703, 3),
        span("seg.sweep.metrics", 800, 950),
        span("seg.sync.metrics", 900, 940),
        span("seg.sync.log_prob", 940, 945),
        # device: three kernels, the bookkeeping's copy, and the rows
        # Kineto puts on the device timeline for the program's spans
        ev("index_kernel", "CUDA", 140, 150, 1),
        ev("merge_kernel", "CUDA", 405, 415, 2),
        ev("add_kernel", "CUDA", 710, 720, 3),
        ev("Memcpy DtoD", "CUDA", 106, 108, 9),
        ev("seg.block", "CUDA", 140, 415, annotation=True),
        ev("seg.block.merge", "CUDA", 405, 720, annotation=True)]


def ctx_of(evs, sweeps=1, blocks_per_sweep=2):
    return trace.Ctx(tiny.ROOT, "fixed", sweeps, blocks_per_sweep, 1e-3,
                     1e-3, evs, {}, {"block": [], "am": []})


def test_readers_time_the_spans():
    ctx = ctx_of(events())
    # leave_out 50 + 20 µs, merge 50 + 90 µs less its wait (5), over 2
    # block steps
    assert glue_host_ms_per_block.read(ctx) == pytest.approx(0.1025)
    # 1000 µs less the am sweeps (40), the blocks (700, the bookkeeping
    # and the block steps inside them) and the fetches (45)
    assert sweep_edge_ms.read(ctx) == pytest.approx(0.215)
    # the fetches and the merge's wait
    assert sync_wait_ms_per_sweep.read(ctx) == pytest.approx(0.050)
    ctx2 = ctx_of(events() + [ev(e.name, "CPU", e.time_range.start + 1000,
                                 e.time_range.end + 1000)
                              for e in events() if e.name.startswith("seg.")
                              and e.device_type.name == "CPU"],
                  sweeps=2)
    assert glue_host_ms_per_block.read(ctx2) == pytest.approx(0.1025)
    assert sweep_edge_ms.read(ctx2) == pytest.approx(0.215)
    assert sync_wait_ms_per_sweep.read(ctx2) == pytest.approx(0.050)


def test_self_time_clips_children_and_counts_overlap_once():
    inner = [(10, 30), (20, 40), (35, 38), (90, 120)]
    assert spans.covered(inner, (0, 100)) == pytest.approx(40)
    assert spans.covered(inner, (25, 95)) == pytest.approx(20)
    assert spans.covered([], (0, 100)) == 0


def test_a_program_without_spans_leaves_the_metrics_out():
    ctx = ctx_of([e for e in events() if not e.name.startswith("seg.")])
    for reader in (glue_host_ms_per_block, sweep_edge_ms,
                   sync_wait_ms_per_sweep):
        assert reader.read(ctx) is None


def test_span_rows_on_the_device_timeline_are_no_device_work():
    ctx = ctx_of(events())
    assert sorted(e.name for e in ctx.device) == [
        "add_kernel", "index_kernel", "merge_kernel"]
    assert kernels_per_block.read(ctx) == 3 / 2
    assert ctx.busy_s == pytest.approx(30e-6)
    assert idle_share.read(ctx) == pytest.approx(97.0)
    assert not [n for n, _ in ctx.breakdown()["device_ops"]
                if n.startswith("seg.")]


def test_an_idle_gap_in_glue_is_named_by_the_innermost_span():
    gaps = ctx_of(events()).breakdown()["idle_gaps"]
    # [415, 710]: the merge's Python after its launch; [150, 405]: the
    # scorer's, DP's and chain's stages, opened in the leave-out
    assert gaps[0] == ["seg.block.merge", pytest.approx(295e-6)]
    assert gaps[1] == ["seg.block.leave_out", pytest.approx(255e-6)]
