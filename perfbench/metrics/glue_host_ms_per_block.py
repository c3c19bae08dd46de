"""glue_host_ms_per_block (ms): host time a block step spends in its
glue stages, the program's spans ``seg.block.leave_out`` (the index
upload, the old segments and the leave-out statistics) and
``seg.block.merge`` (decollision and the merge), less their blocking
waits (``seg.sync.*``, which ``sync_wait_ms_per_sweep`` reads), summed
over the profiled block steps and divided by them."""

from .. import spans

RANGES = {}


def read(ctx):
    glue = spans.intervals(ctx, "seg.block.leave_out", "seg.block.merge")
    if not glue:
        return None
    waits = spans.intervals(ctx, prefix="seg.sync.")
    us = sum((b - a) - spans.covered(waits, (a, b)) for a, b in glue)
    return us / 1e3 / ctx.blocks
