"""sweep_edge_ms (ms): a sweep's host self time at its edge, the
program's span ``seg.sweep`` less the part its block steps
(``seg.sweep.blocks``), acoustic-model sweeps (``seg.sweep.am``) and
blocking reads (``seg.sync.*``) cover: the utterance order and its
padding, the record quantities' launches, the record and the logging,
a sweep."""

from .. import spans

RANGES = {}


def read(ctx):
    sweeps = spans.intervals(ctx, "seg.sweep")
    if not sweeps:
        return None
    inner = spans.intervals(ctx, "seg.sweep.blocks", "seg.sweep.am",
                            prefix="seg.sync.")
    self_us = sum((b - a) - spans.covered(inner, (a, b)) for a, b in sweeps)
    return self_us / 1e3 / ctx.sweeps
