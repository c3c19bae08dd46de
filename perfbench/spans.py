"""The program's own host spans in a traced slice (``seg.*``, opened by
``segmentalist_torch/utils/tracing.py``), for the per-layer readers that
time the host: each span's interval on the profiler's clock (µs), read
from ``trace.Ctx.host``.  A program without the spans gives none, and
those readers leave their metric out."""

from __future__ import annotations


def intervals(ctx, *names, prefix=None) -> list:
    """[(start, end)] of the host spans called one of ``names`` or whose
    name begins with ``prefix``, in order of their start."""
    return sorted(
        (e.time_range.start, e.time_range.end) for e in ctx.host
        if e.name in names or (prefix and e.name.startswith(prefix)))


def covered(spans, within) -> float:
    """The µs of the interval ``within`` that the ``spans`` cover (their
    union, clipped to it)."""
    a0, b0 = within
    total, end = 0.0, a0
    for a, b in spans:
        a, b = max(a, end), min(b, b0)
        if b > a:
            total += b - a
            end = b
    return total
