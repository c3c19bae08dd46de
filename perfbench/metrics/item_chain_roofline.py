"""item_chain_roofline (%): the acoustic model's sequential sweep's (K11)
needed work at the peaks over the device time launched inside its item
chain call."""

RANGES = {"item_chain": ["segmentalist_torch.models.fbgmm:item_chain"]}


def read(ctx):
    return ctx.roofline("item_chain", "item_chain")
