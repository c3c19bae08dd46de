"""sync_wait_ms_per_sweep (ms): host time a sweep spends in its blocking
device-to-host reads, the program's spans ``seg.sync.*`` (each a read
that waits out the device's queue), a sweep."""

from .. import spans

RANGES = {}


def read(ctx):
    iv = spans.intervals(ctx, prefix="seg.sync.")
    if not iv:
        return None
    return sum(b - a for a, b in iv) / 1e3 / ctx.sweeps
