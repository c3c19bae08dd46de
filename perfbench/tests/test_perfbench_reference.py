"""The plain reference against the port's plain path on the CPU at a tiny
size, its pieces against the program's, and the faults the check has to
catch: a run with the timed path broken underneath comes out not
correct."""

import numpy as np
import pytest
import torch

import perfbench_tiny as tiny
from perfbench.faults import FAULTS
from perfbench.reference import common, families


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tf", "tl", "tu", "ta"])
def test_the_program_passes(root, name):
    res, checks = tiny.run_tiny(root, name)
    assert res["correct"], checks
    r = {n: v for n, v, _ in checks}
    assert r["mismatch"] == 0 and r["check_failed"] == 0


def test_dp_gaps_of_its_own_draws_are_zero():
    g = torch.Generator().manual_seed(3)
    B, N, W = 5, 9, 3
    scores = torch.randn((B, N, W), generator=g, dtype=torch.float64) * 4
    scores[:, :2, 2] = float("-inf")
    scores[:, 0, 1] = float("-inf")
    lengths = np.array([9, 7, 3, 1, 5])
    noise = -torch.log(-torch.log(torch.rand((B, N, W), generator=g,
                                             dtype=torch.float64)))
    nl, rev = common.node_logits(scores, lengths, -0.1, 0)
    bounds = common.dp_sample(nl, noise, lengths, 1.0)
    assert common.dp_gaps(nl, rev, noise, lengths, bounds,
                          1.0)[0].max() == 0.0
    moved = bounds.copy()
    moved[0, 3] = ~moved[0, 3]
    assert common.dp_gaps(nl, rev, noise, lengths, moved, 1.0)[0][0] > 0


def test_the_dp_matches_the_programs_plain_dp():
    from segmentalist_torch.ops import dp

    g = torch.Generator().manual_seed(4)
    B, N, W = 6, 10, 4
    scores = torch.randn((B, N, W), generator=g) * 3
    for t in range(W - 1):
        scores[:, t, t + 1:] = float("-inf")
    lengths = torch.tensor([10, 8, 4, 2, 1, 6], dtype=torch.int32)
    noise = -torch.log(-torch.log(torch.rand((B, N, W), generator=g)))
    lp, bounds = dp.segment_dp_plain(scores, lengths, -0.2, 1.0, 0, False,
                                     noise)
    nl, rev = common.node_logits(scores.double(), lengths.numpy(), -0.2, 0)
    ref = common.dp_sample(nl, noise, lengths.numpy(), 1.0)
    assert (ref == bounds.numpy()).all()
    _, path, _ = common.dp_gaps(nl, rev, noise, lengths.numpy(), ref, 1.0)
    assert np.allclose(path, lp.double().numpy(), rtol=1e-5)


def test_decollide_matches_the_programs():
    from segmentalist_torch.segmenters.common import (
        decollide_new_components)

    rng = np.random.RandomState(5)
    for _ in range(20):
        B, S, K = 6, 5, 12
        counts0 = rng.randint(0, 3, K) * (rng.rand(K) < 0.5)
        lo = np.maximum(counts0[None] - rng.randint(0, 2, (B, K)), 0)
        ks = rng.randint(0, K, (B, S))
        mask = rng.rand(B, S) < 0.8
        got = decollide_new_components(
            torch.tensor(ks, dtype=torch.int32), torch.tensor(mask),
            torch.tensor(lo, dtype=torch.int32),
            torch.tensor(counts0, dtype=torch.int32)).numpy()
        want = common.decollide(ks, mask, lo, counts0)
        assert (got[mask] == want[mask]).all()


def test_families_match_the_programs():
    from segmentalist_torch.models import components_fixedvar as cf
    from segmentalist_torch.models import components_full as cu
    from segmentalist_torch.ops.stats import SuffStats
    from segmentalist_torch.priors import NIW, FixedVarPrior

    g = torch.Generator().manual_seed(6)
    D, K = 4, 5
    X = torch.randn((30, D), generator=g, dtype=torch.float64)
    a = torch.randint(-1, K, (30,), generator=g)
    n, sx, ssq = common.one_hot_sums(X, a, K, True)
    x = torch.randn((D,), generator=g, dtype=torch.float64)
    pf = FixedVarPrior.create(np.full(D, 0.05), np.zeros(D), np.ones(D))
    ref = families.Fixed({"var": pf.var, "mu_0": pf.mu_0,
                          "var_0": pf.var_0})
    prog = cf.log_post_pred(cf.predictive_params(
        pf, SuffStats(n, sx, ssq.diagonal(dim1=-2, dim2=-1))), x)
    assert torch.allclose(ref.logpdf(ref.params(n, sx), x), prog)
    assert torch.allclose(ref.log_prior(x), cf.log_prior(pf, x))
    pn = NIW.create(np.zeros(D), 0.05, D + 3.0, 0.05 * np.eye(D))
    ref = families.Full({"m_0": pn.m_0, "k_0": 0.05, "v_0": D + 3.0,
                         "S_0": pn.S_0})
    prog = cu.log_post_pred(cu.predictive_params(pn, SuffStats(n, sx, ssq)),
                            x)
    assert torch.allclose(ref.logpdf(ref.params(n, sx, ssq), x), prog)
    assert torch.allclose(ref.log_prior(x), cu.log_prior(pn, x))
    rows = ref.logpdf_rows(ref.params(n, sx, ssq), X[:7])
    assert torch.allclose(rows[3], ref.logpdf(ref.params(n, sx, ssq), X[3]))


# ------------------------------------------------------------- the faults

# the faults each cell can have and its compared numbers catch (no cell
# crosses chips, so none leaves an exchange out); the tiny am cell takes
# the full flagship's limits, which see its block steps' faults
CAUGHT = {
    "tf": ("unchanged", "half_batch", "chain_altered", "boundary_altered",
           "scores_altered"),
    "tl": ("unchanged", "half_batch", "chain_altered", "boundary_altered",
           "scores_altered"),
    "tu": ("unchanged", "half_batch", "chain_altered", "boundary_altered",
           "scores_altered"),
    "ta": ("unchanged", "half_batch", "chain_altered", "boundary_altered",
           "scores_altered")}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in CAUGHT.items()
                                        for f in fs])
def test_a_fault_is_not_correct(root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res, checks = tiny.run_tiny(root, name)
    assert not res["correct"], checks


def test_an_item_fault_shows_in_its_reading(root, monkeypatch):
    """K11's draws are read (``item_gap``) on the tiny am cell, though no
    cell of the benchmark compares them yet: the reading separates a
    planted fault."""
    FAULTS["items_altered"](monkeypatch)
    res, checks, readings = tiny.run_tiny(root, "ta", full=True)
    assert readings["item_gap"] > 1.0
