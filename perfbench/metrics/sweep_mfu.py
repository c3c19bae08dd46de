"""sweep_mfu (%): a sweep's needed work at the chip's peaks (the largest
of operations, bytes and special-function results over their peak rates,
the work of every stage counted from the state in ``work/``) over the
untraced wall time of a sweep."""

RANGES = {}
STAGES = ("score", "dp", "chain", "params", "item_chain")


def read(ctx):
    total = None
    for stage in STAGES:
        w = ctx.work(stage)
        if w is not None:
            total = w if total is None else total + w
    if total is None:
        return None
    return 100.0 * total.seconds() / (ctx.sweeps * ctx.untraced_s)
