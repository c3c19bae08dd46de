"""chain_roofline (%): the assignment chain's (K3 / K9) needed work at
the peaks over the device time launched inside the chain call the block
step makes."""

RANGES = {"chain": ["segmentalist_torch.segmenters.unigram:fixedvar_chain",
                    "segmentalist_torch.segmenters.blocked:fullcov_chain"]}


def read(ctx):
    return ctx.roofline("chain", "chain")
