"""Blocks to merge, for the tests of the merge kernel and its plain version
(``segmentalist_torch/ops/cuda_merge.py``); imports no JAX.

:func:`merge_case` builds global statistics from an assignment vector and
a block's old and new segments with every edge the merge meets: a padded
row (``valid`` False), ``-1`` embeds and components, a component the block
empties, one it creates, and one with more members a side than the
kernel's staged chunk (64 rows).
:func:`one_hot_merge` is the one-hot composition the merge replaces.
"""

import numpy as np
import torch

from segmentalist_torch.ops.stats import (SuffStats,
                                          suff_stats_from_assignments)
from segmentalist_torch.segmenters.common import flat_contrib

FAMILIES = ("fixed", "diag", "full")


def merge_case(family, B, S, D, K=40, dtype=torch.float32, seed=0,
               device="cpu", k_used=None):
    """(stats, valid [B], old, new): old / new are (rows [B, S, D], embeds
    [B, S] int32, ks [B, S] int32).  Component 0 has about 100 members a
    side, spread over the block (more than the kernel's staged chunk of
    64 rows, and over every scan pass); component 1's members are all
    among the block's old segments, and the new segments leave it;
    component K - 1 is empty and the new segments create it; the last row
    is padding.  The other
    members belong to components 2 .. ``k_used`` - 1 (default K - 2)."""
    rng = np.random.RandomState(seed)
    M = B * S
    N = 2 * M + 37
    X = rng.randn(N, D) * (1.0 + rng.rand(D))
    hi = K - 1 if k_used is None else k_used
    a = rng.randint(2, hi, N)
    a[rng.rand(N) < 0.1] = -1
    old_e = rng.permutation(N)[:M].reshape(B, S)
    old_e[rng.rand(B, S) < 0.15] = -1
    old_e[:, -1] = -1
    live = old_e[: B - 1][old_e[: B - 1] >= 0]
    a[a == 1] = 2
    a[live[: min(30, live.size)]] = 1           # emptied by the block
    rest = live[30:]
    a[rest[::max(1, rest.size // 100)][:100]] = 0   # > 64 old members
    old_k = np.where(old_e >= 0, a[np.maximum(old_e, 0)], -1)
    new_e = rng.permutation(N)[:M].reshape(B, S)
    new_e[rng.rand(B, S) < 0.1] = -1
    new_k = rng.randint(2, hi, (B, S))
    new_k[rng.rand(B, S) < 0.1] = -1
    new_k.reshape(-1)[::max(1, M // 100)] = 0   # > 64 new members
    new_k[1, :3] = K - 1                        # created by the block
    new_e[1, :3] = np.arange(3)
    new_k[B - 1, 0] = 0
    valid = np.ones(B, bool)
    valid[-1] = False
    Xt = torch.as_tensor(X, dtype=dtype)
    stats = suff_stats_from_assignments(Xt, torch.as_tensor(a), K,
                                        full_cov=family == "full")
    if family != "full":
        stats = stats._replace(sum_sq=stats.sum_sq + torch.as_tensor(
            rng.rand(K, D), dtype=dtype))

    def side(e, k):
        e = torch.as_tensor(e, dtype=torch.int32)
        k = torch.as_tensor(k, dtype=torch.int32)
        rows = Xt[e.clamp_min(0).long()]
        return tuple(t.to(device) for t in (rows, e, k))

    return (type(stats)(*(t.to(device) for t in stats)),
            torch.as_tensor(valid, device=device),
            side(old_e, old_k), side(new_e, new_k))


def one_hot_merge(stats, valid, old, new):
    """``stats + (flat_contrib(new) - flat_contrib(old))``, statistic by
    statistic in that order (the JAX package's ``merge_flat``)."""
    K, D = stats.sum_x.shape
    full = stats.sum_sq.dim() == 3
    o, n = (flat_contrib(rows[0, 0].new_zeros((1, D)), e, k, K, valid,
                         rows=rows, full_cov=full) for rows, e, k in (old,
                                                                      new))
    return SuffStats(*(g + (b - a) for g, a, b in zip(stats, o, n)))
