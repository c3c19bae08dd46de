"""The merge's plain version (``ops/cuda_merge.py`` ``merge_stats_plain``,
the ordered per-component sum the merge kernel computes) against the
one-hot composition it replaces (``flat_contrib`` twice, then the JAX
package's ``merge_flat`` order) and against a loop over each component's
members in item order, on the CPU, at float32 and float64, for the fixed,
diag and full statistics' shapes.  The card tests (``test_torch_cuda.py``)
hold the kernel to it."""

import pytest
import torch

from merge_cases import FAMILIES, merge_case, one_hot_merge
from segmentalist_torch.ops import cuda_merge
from segmentalist_torch.ops.stats import item_sq

DTYPES = (torch.float32, torch.float64)
SHAPES = ((6, 40, 7), (5, 24, 13))


def _case(family, dtype, shape=SHAPES[0], seed=0):
    B, S, D = shape
    return merge_case(family, B, S, D, dtype=dtype, seed=seed)


def _members(valid, side, K):
    rows, e, k = side
    ok = (e >= 0) & (k >= 0) & (k < K) & valid[:, None]
    return ok.reshape(-1), k.reshape(-1), rows.reshape(-1, rows.shape[-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_one_hot_composition(family, dtype, shape):
    """Counts exact, sums to rounding (one order against the matrix
    product's), the full second moments symmetric, and the rows of
    untouched components the input's bits."""
    stats, valid, old, new = _case(family, dtype, shape)
    got = cuda_merge.merge_stats_plain(stats, valid, old, new)
    want = one_hot_merge(stats, valid, old, new)
    assert torch.equal(got.counts, want.counts)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    if family == "full":
        assert torch.equal(got.sum_sq, got.sum_sq.transpose(1, 2))
    K = stats.counts.shape[0]
    touched = torch.zeros(K, dtype=torch.bool)
    for side in (old, new):
        ok, k, _ = _members(valid, side, K)
        touched[k[ok].long()] = True
    assert not touched.all()
    for g, s in zip(got, stats):
        assert torch.equal(g[~touched], s[~touched])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_sums_each_component_in_item_order(family, dtype):
    """Bit for bit the sum of each component's members taken one by one in
    increasing item order from 0, then ``g + (n - o)``."""
    stats, valid, old, new = _case(family, dtype, SHAPES[1], seed=3)
    got = cuda_merge.merge_stats_plain(stats, valid, old, new)
    K, D = stats.sum_x.shape
    full = family == "full"
    sides = [_members(valid, s, K) for s in (old, new)]
    for k in range(K):
        sums = []
        for ok, ks, rows in sides:
            x = torch.zeros(D, dtype=dtype)
            sq = torch.zeros((D, D) if full else (D,), dtype=dtype)
            for n in torch.nonzero(ok & (ks == k)).reshape(-1):
                x = x + rows[n]
                sq = sq + item_sq(rows[n], full)
            sums.append((x, sq))
        if all(not (ok & (ks == k)).any() for ok, ks, _ in sides):
            continue
        (xo, sqo), (xn, sqn) = sums
        assert torch.equal(got.sum_x[k], stats.sum_x[k] + (xn - xo))
        assert torch.equal(got.sum_sq[k], stats.sum_sq[k] + (sqn - sqo))


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_edge_components(family):
    """The emptied component reads count 0, the created one its new
    members alone, and the padded row adds nothing."""
    stats, valid, old, new = _case(family, torch.float64)
    K = stats.counts.shape[0]
    got = cuda_merge.merge_stats_plain(stats, valid, old, new)
    assert int(stats.counts[1]) > 0 and int(got.counts[1]) == 0
    assert int(stats.counts[K - 1]) == 0 and int(got.counts[K - 1]) == 3
    torch.testing.assert_close(got.sum_x[K - 1], new[0][1, :3].sum(0),
                               rtol=1e-12, atol=1e-12)
    valid_all = torch.ones_like(valid)
    padded = cuda_merge.merge_stats_plain(stats, valid_all, old, new)
    assert not torch.equal(padded.counts, got.counts)


@pytest.mark.parametrize("family", FAMILIES)
def test_wrapper_on_cpu_takes_the_plain_version(family):
    """``merge_stats`` on CPU tensors: the plain version's bits, into new
    tensors, or into ``stats``'s own with ``in_place``; no launch."""
    stats, valid, old, new = _case(family, torch.float32)
    want = cuda_merge.merge_stats_plain(stats, valid, old, new)
    before = cuda_merge.launches
    got = cuda_merge.merge_stats(stats, valid, old, new)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(g is s for g, s in zip(got, stats))
    kept = tuple(t.clone() for t in stats)
    same = cuda_merge.merge_stats(stats, valid, old, new, in_place=True)
    assert all(s is t for s, t in zip(same, stats))
    assert all(torch.equal(s, w) for s, w in zip(stats, want))
    assert not torch.equal(kept[1], stats.sum_x)
    assert cuda_merge.launches == before
