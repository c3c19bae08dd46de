"""diag_scorer_roofline (%): the diagonal-covariance candidate scorer's (K5,
grouped composition) needed work at the peaks over the device time
launched inside the program's ``diag_log_margs_T`` call.  The work is
``work/diag_k5.py``'s, loaded by its name (not found by the family's stage
lookup, so ``ctx.work("score")`` of the diag family stays None)."""

from .. import find
from ..peaks import Work

RANGES = {"diag_scorer": [
    "segmentalist_torch.segmenters.blocked:diag_log_margs_T"]}


def roofline(ctx, range_name: str, count: str):
    """Percent of the range's device time that the needed work of the
    count ``work/<count>.py`` takes at the peaks; None where the range
    ran nothing."""
    t = ctx.range_s(range_name)
    if t <= 0:
        return None
    mod = find.module(ctx.root, "work", count)
    w = sum((mod.count(s) for s in ctx.summaries[mod.LEVEL]), Work())
    return 100.0 * w.seconds() / t


def read(ctx):
    return roofline(ctx, "diag_scorer", "diag_k5")
