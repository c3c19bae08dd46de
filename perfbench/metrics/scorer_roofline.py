"""scorer_roofline (%): the candidate scorer's (K1 / K8) needed work at
the peaks over the device time launched inside the program's scorer
call."""

BLOCKED = "segmentalist_torch.segmenters.blocked:"
RANGES = {"scorer": [BLOCKED + "fixedvar_log_margs_T",
                     BLOCKED + "fullcov_log_margs"]}


def read(ctx):
    return ctx.roofline("scorer", "score")
