"""K2, the segmentation DP with its noise: for an utterance of L
landmarks and window W, L - 1 forward steps of 4 W + 2 operations, W exps
and a log; L nodes of 5 W operations for the draw; the draw's L W Gumbel
variates (two logs each).  Bytes: the scores and the noise once (written
and read), the boundaries and the log probability once."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    W = s["W"]
    L = s["lengths"].astype(float)
    steps = float((L - 1).clip(0).sum())
    nodes = float(L.sum())
    flops = steps * (4 * W + 2) + nodes * 5 * W
    sfu = steps * (W + 1) + nodes * W * 2
    n_bytes = nodes * W * 4 * 3 + nodes + len(L) * 8
    return Work(flops, n_bytes, sfu)
