"""The traced slice of a ``--trace 1`` run: a few sweeps under
``torch.profiler``, after the untraced window, with the program's stage
functions wrapped from outside in profiler ranges and the state read
around every block step, for the per-layer readers (``metrics/``).

Device work is attributed to a range by launch correlation: a device
event belongs to the range inside which its launch call on the host
(``cudaLaunchKernel`` and kin, matched by correlation id) was made, which
also catches the kernels the program launches through ctypes.  The
benchmark's own reads of the state run in the range ``BOOKKEEPING`` and
are left out of every count.
"""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from . import capture, work
from .peaks import Work

BOOKKEEPING = "perfbench.bookkeeping"


def _spans(events, name):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type.name == "CPU")
    return spans, [a for a, _ in spans]


def _inside(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def block_summary(t, K: int, D: int, idx, a0, b0, a1, b1) -> dict:
    """A block step's state, read before (a0, b0) and after (a1, b1):
    per utterance its live candidate rows, its leave-out occupied
    components, its touched components and its new segments (the chain's
    steps); the chain's live-slot steps and claimed slots; the occupied
    components at the block's start."""
    idx = [int(u) for u in idx if u >= 0]
    counts = np.bincount(a0[a0 >= 0], minlength=K)
    K_occ = int((counts > 0).sum())
    rows, occ, touched, steps = [], [], [], []
    slot_steps = claimed = 0
    for u in idx:
        live = (t.seg_ids[u] >= 0) & np.isfinite(t.seg_durs[u])
        rows.append(int(live.sum()))
        own = {}
        for e in t.embeds(u, b0[u]):
            if e >= 0 and a0[e] >= 0:
                own[int(a0[e])] = own.get(int(a0[e]), 0) + 1
        occ.append(K_occ - sum(counts[k] == c for k, c in own.items()))
        touched.append(len(own))
        slots = set(own)
        new = [e for e in t.embeds(u, b1[u]) if e >= 0]
        steps.append(len(new))
        for e in new:
            slot_steps += len(slots)
            k = int(a1[e])
            if k >= 0 and k not in slots:
                slots.add(k)
                claimed += 1
    return {"D": D, "K": K, "W": t.W, "K_occ": K_occ,
            "lengths": t.lengths[idx], "rows": np.array(rows),
            "occ": np.array(occ), "touched": np.array(touched),
            "steps": np.array(steps), "slot_steps": slot_steps,
            "claimed": claimed}


def am_summary(K: int, D: int, a0, a1) -> dict:
    """A sequential sweep's items and occupied columns at its start and
    end."""
    occ = [int((np.bincount(a[a >= 0], minlength=K) > 0).sum())
           for a in (a0, a1)]
    return {"D": D, "K": K, "items": int((a0 >= 0).sum()),
            "occ_start": occ[0], "occ_end": occ[1]}


class Ctx:
    """What the per-layer readers read: the profiled slice's device
    events by range, the needed work by stage, the times."""

    def __init__(self, root, family, sweeps, blocks_per_sweep, untraced_s,
                 window_s, events, ranges, summaries):
        self.root, self.family = root, family
        self.sweeps = sweeps
        self.blocks = sweeps * blocks_per_sweep
        self.untraced_s = untraced_s          # a sweep, outside the trace
        self.window_s = window_s              # the traced slice's wall time
        self.summaries = summaries            # {"block": [...], "am": [...]}
        launches = [e for e in events if e.device_type.name == "CPU"
                    and e.name.startswith("cu")]
        names = set(ranges) | {BOOKKEEPING}
        device = [e for e in events if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in names]
        by_range = {}
        for name in names:
            spans, starts = _spans(events, name)
            ids = {e.id for e in launches
                   if _inside(spans, starts, e.time_range.start)}
            by_range[name] = [e for e in device if e.id in ids]
        book = {id(e) for e in by_range.pop(BOOKKEEPING)}
        self.device = [e for e in device if id(e) not in book]
        self.by_range = by_range
        self.host = [e for e in events if e.device_type.name == "CPU"
                     and not e.name.startswith("cu")
                     and e.name not in names]
        iv = sorted((e.time_range.start, e.time_range.end)
                    for e in self.device)
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_intervals = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e6

    def require(self, ranges):
        """Fail where a wrapped range launched no kernel: its metric
        would read 0."""
        for name in ranges:
            if not any(self.is_kernel(e) for e in self.by_range.get(name,
                                                                    [])):
                raise RuntimeError("trace: the range %r launched no device "
                                   "work in the profiled sweeps" % name)

    @staticmethod
    def is_kernel(e) -> bool:
        return not e.name.startswith(("Memcpy", "Memset"))

    def range_s(self, name) -> float:
        return sum(e.time_range.end - e.time_range.start
                   for e in self.by_range.get(name, [])) / 1e6

    def work(self, stage: str):
        """The needed work of ``stage`` over the slice (None where the
        family has no count of it)."""
        mod = work.find(self.root, self.family, stage)
        if mod is None:
            return None
        total = Work()
        for s in self.summaries[mod.LEVEL]:
            total = total + mod.count(s)
        return total

    def roofline(self, range_name: str, stage: str):
        """Percent of the range's device time that the stage's needed
        work takes at the peaks."""
        w, t = self.work(stage), self.range_s(range_name)
        if w is None or t <= 0:
            return None
        return 100.0 * w.seconds() / t

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the innermost host operation open at the gap's
        start."""
        by_name = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for (_, a), (b, _) in zip(self.busy_intervals,
                                  self.busy_intervals[1:]):
            gaps.append((b - a, a))
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:top]:
            open_ = [e for e in self.host
                     if e.time_range.start <= at <= e.time_range.end]
            name = (max(open_, key=lambda e: e.time_range.start).name
                    if open_ else "(no host op)")
            out.append([name, length / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


def profiled_slice(root, system, sweep, n_sweeps: int, ranges: dict,
                   tables, cfg, untraced_s: float) -> Ctx:
    """Profile ``n_sweeps`` calls of ``sweep()`` with the ``ranges``
    ({range name: ["module:attribute", ...]}) wrapped around the program's
    stage functions that exist, and the state read around every block
    step and sequential sweep."""
    from torch.profiler import ProfilerActivity, profile

    am, utt = system.acoustic_model, system.utterances
    K, D = cfg["am_K"], cfg["D"]
    raw = {"block": [], "am": []}
    patched = []
    for name, specs in ranges.items():
        for spec in specs:
            try:
                mod, attr = capture.resolve(spec)
                inner = getattr(mod, attr)
            except (ImportError, AttributeError):
                continue

            def wrapped(*a, _inner=inner, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _inner(*a, **k)

            setattr(mod, attr, wrapped)
            patched.append((mod, attr, inner))
    orig_step, orig_seq = system.block_step, am.sequential_sweep

    def read():
        with torch.profiler.record_function(BOOKKEEPING):
            return am.assignments.clone(), utt.boundaries_dev.clone()

    def step(idx_blk, *a, **k):
        before = read()
        out = orig_step(idx_blk, *a, **k)
        raw["block"].append((np.asarray(idx_blk), before, read()))
        return out

    def seq(*a, **k):
        before = read()[0]
        out = orig_seq(*a, **k)
        raw["am"].append((before, read()[0]))
        return out

    system.block_step, am.sequential_sweep = step, seq
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_sweeps):
                sweep()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    finally:
        del system.block_step
        del am.sequential_sweep
        for mod, attr, inner in patched:
            setattr(mod, attr, inner)
    summaries = {
        "block": [block_summary(tables, K, D, idx, b[0].cpu().numpy(),
                                b[1].cpu().numpy(), a[0].cpu().numpy(),
                                a[1].cpu().numpy())
                  for idx, b, a in raw["block"]],
        "am": [am_summary(K, D, b.cpu().numpy(), a.cpu().numpy())
               for b, a in raw["am"]]}
    blocks = -(-tables.U // cfg["batch_size"])
    ctx = Ctx(root, cfg["family"], n_sweeps, blocks, untraced_s, window_s,
              prof.events(), ranges, summaries)
    ctx.key_averages = prof.key_averages()
    ctx.require(ranges)
    return ctx
