"""kernels_per_block (kernels/block): device kernels of the profiled
sweeps (copies and fills left out) over their block steps."""

RANGES = {}


def read(ctx):
    return sum(1 for e in ctx.device if ctx.is_kernel(e)) / ctx.blocks
