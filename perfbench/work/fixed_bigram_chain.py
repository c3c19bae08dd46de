"""K4, the fixed-variance bigram assignment chain: K3's count
(``fixed_chain.py``: the fits, the Gumbel-max, the joined column's
update) plus the LM's weight of every one of the K slots at every step:
after the utterance's first segment the K-wide row of the previous draw
in the [K, K] bigram table, read once a step, and the interpolation
``lam (u_k + a/K) / (n + a) + (1 - lam) (row_k - corr_k + b/K) / (u_j +
b)`` (8 operations and a log a slot); at the first segment the unigram
weight (2 operations and a log a slot).  Bytes: the bigram rows (K
counts a step after the first) and each utterance's leave-out unigram
counts (K) and old pairs (2 a segment) once."""

from ..peaks import Work
from . import fixed_chain

LEVEL = "block"


def count(s) -> Work:
    K = s["K"]
    steps = s["steps"].astype(float)
    after = float((steps - 1).clip(0).sum())
    first = float((steps > 0).sum())
    lm = Work(flops=K * (8 * after + 2 * first),
              bytes=(after * K + len(steps) * K + 2 * float(steps.sum())) * 4,
              sfu=K * (after + first))
    return fixed_chain.count(s) + lm
