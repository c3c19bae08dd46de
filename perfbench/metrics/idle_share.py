"""idle_share (%): the share of a sweep's wall time (untraced, from the
window of the same process) in which no device operation ran (the
profiled slice's busy time a sweep)."""

RANGES = {}


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.sweeps / ctx.untraced_s)
