"""lm_host_ms_per_sweep (ms): host time a sweep spends in the bigram
LM's own stages, the program's spans ``seg.lm.*`` (``seg.lm.leave_out``:
the block's old pairs and leave-out unigram counts; ``seg.lm.delta``: the
signed [K, K] count delta and its addition; ``seg.lm.replay``: the corpus
log P(z) replay of the sweep's record), less the blocking waits inside
them (``seg.sync.*``), summed over the profiled sweeps and divided by
them.  A program without the spans gives none."""

from .. import spans

RANGES = {}


def read(ctx):
    lm = spans.intervals(ctx, prefix="seg.lm.")
    if not lm:
        return None
    waits = spans.intervals(ctx, prefix="seg.sync.")
    us = sum((b - a) - spans.covered(waits, (a, b)) for a, b in lm)
    return us / 1e3 / ctx.sweeps
