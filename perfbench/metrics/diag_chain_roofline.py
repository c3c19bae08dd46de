"""diag_chain_roofline (%): the diagonal-covariance assignment chain's
(K6) needed work at the peaks (``work/diag_k6.py``) over the device time
launched inside the chain call the unigram block step makes."""

from .diag_scorer_roofline import roofline

RANGES = {"diag_chain": ["segmentalist_torch.segmenters.unigram:diag_chain"]}


def read(ctx):
    return roofline(ctx, "diag_chain", "diag_k6")
