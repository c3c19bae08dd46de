"""dp_roofline (%): the segmentation DP's (K2, with its noise draw)
needed work at the peaks over the device time launched inside the
program's ``segment_dp`` call."""

RANGES = {"dp": ["segmentalist_torch.segmenters.blocked:segment_dp"]}


def read(ctx):
    return ctx.roofline("dp", "dp")
