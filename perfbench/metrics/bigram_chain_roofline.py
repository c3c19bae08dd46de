"""bigram_chain_roofline (%): the bigram assignment chain's (K4) needed
work at the peaks over the device time launched inside the bigram chain
call the block step makes."""

RANGES = {"bigram_chain": [
    "segmentalist_torch.segmenters.bigram:bigram_fixedvar_chain"]}


def read(ctx):
    return ctx.roofline("bigram_chain", "bigram_chain")
