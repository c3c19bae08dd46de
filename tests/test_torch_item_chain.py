"""Kernels K10 and K11's plain versions (``ops/cuda_item_chain.py``)
against the JAX package's FBGMM step, and their launch plans.

K10 (fixed, diag) and K11 (full) are the FBGMM's sequential Gibbs sweep as
one chain over items: the JAX ``step`` of
``segmentalist_tpu/models/fbgmm.py:529-563`` with the delete on (the
sweep) and off (``reassign_items``, ``:351-381``).  On shared noise the
plain versions draw the JAX package's components and end on its
statistics; K10's is the plain chain loop of K3 / K6 with the delete, so
with the delete off it is K3's chain; K11's re-derives a column with its
own right-looking Cholesky helper, held here to ``components_full``'s.
The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.special import gammaln

import segmentalist_tpu as jtpu

import segmentalist_torch as pt
from segmentalist_torch.ops import cuda_chain, cuda_item_chain
from segmentalist_torch.ops.cuda_diag_chain import gr_table


def _prior(pkg, cov, D):
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.3 + np.arange(D) / D, np.zeros(D),
                                        np.ones(D))
    S_0 = 0.4 + np.arange(D) / D
    if cov == "full":
        S_0 = np.diag(S_0) + 0.05 * np.ones((D, D))
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _case(cov, N, D, K, dtype, seed):
    rng = np.random.RandomState(seed)
    X = ((2.0 * rng.randn(4, D))[rng.randint(0, 4, N)]
         + 0.8 * rng.randn(N, D)).astype(dtype)
    asg = rng.randint(-1, min(K, 5), N)
    jp = _prior(jtpu, cov, D)
    if dtype == np.float32:
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    jam = jtpu.FBGMM(X, jp, 0.9, K, asg, covariance_type=cov, lms=1.2,
                     key=jax.random.PRNGKey(seed))
    tam = pt.FBGMM(X, _prior(pt, cov, D), 0.9, K, asg, covariance_type=cov,
                   lms=1.2, device="cpu")
    return jam, tam


def _run_plain(tam, ids, k_old, noise, temp):
    before = cuda_item_chain.launches
    ks, stats = cuda_item_chain.item_chain(
        tam.covariance_type, tam.X[ids], tam.log_prior_vec[ids],
        torch.as_tensor(noise), k_old, tam.stats, tam.prior, tam.alpha,
        tam.K_max, tam.lms, temp)
    assert cuda_item_chain.launches == before  # a CPU tensor: no kernel
    return ks, stats


def _check(jam, ks, stats, ids, tol):
    npt.assert_array_equal(ks.numpy(), np.asarray(jam.assignments)[ids])
    npt.assert_array_equal(stats.counts.numpy(), np.asarray(jam.stats.counts))
    for a, b in ((jam.stats.sum_x, stats.sum_x),
                 (jam.stats.sum_sq, stats.sum_sq)):
        npt.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol)


CASES = [(cov, dtype, D) for cov in ("fixed", "diag", "full")
         for dtype, D in ((np.float64, 2), (np.float64, 13),
                          (np.float32, 13))]


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 1e-4


@pytest.mark.parametrize("cov,dtype,D", CASES)
def test_plain_with_delete_equals_the_jax_sweep(cov, dtype, D):
    """Delete on: one chain over every item (old columns, -1 for the
    unassigned) equals one ``_build_sequential_sweep`` on shared noise."""
    jam, tam = _case(cov, 48, D, 7, dtype, seed=D)
    N, K = jam.N, jam.K_max
    _, sub = jax.random.split(jam.key)
    keys = jax.random.split(sub, N)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (K,), dtype))(
        keys))
    fn = jam._get_sweep_fn("sequential", True)
    jam.stats, jam.assignments, jam.key = fn(
        jam.stats, jam.assignments, jam.key, np.asarray(0.8, dtype))
    ids = torch.arange(N)
    ks, stats = _run_plain(tam, ids, tam.assignments.clone(), noise, 0.8)
    _check(jam, ks, stats, np.arange(N), _tol(dtype))


@pytest.mark.parametrize("cov,dtype,D", CASES)
def test_plain_without_delete_equals_jax_reassign_items(cov, dtype, D):
    """Delete off: a chain over unassigned items equals ``reassign_items``
    (its fold_in noise) on shared noise."""
    jam, tam = _case(cov, 40, D, 6, dtype, seed=D + 1)
    ids = np.flatnonzero(np.asarray(jam.assignments) < 0)
    K = jam.K_max
    _, sub = jax.random.split(jam.key)
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(sub, j), (K,), dtype)) for j in range(len(ids))])
    jam.reassign_items(ids, anneal_temp=1.1)
    ks, stats = _run_plain(tam, torch.as_tensor(ids),
                           torch.full((len(ids),), -1, dtype=torch.int32),
                           noise, 1.1)
    _check(jam, ks, stats, ids, _tol(dtype))


def test_plain_without_delete_is_the_k3_chain():
    """With the delete off, K10's fixed plain version is K3's plain chain
    on one utterance: the same loop, the same ks."""
    rng = np.random.RandomState(3)
    n, D, K = 30, 5, 9
    X = torch.as_tensor(rng.randn(n, D), dtype=torch.float32)
    prior = _prior(pt, "fixed", D).to(dtype=torch.float32)
    noise = torch.as_tensor(-np.log(-np.log(rng.rand(n, K))),
                            dtype=torch.float32)
    counts = torch.as_tensor(rng.randint(0, 3, K), dtype=torch.int32)
    sum_x = counts[:, None] * torch.as_tensor(rng.randn(K, D),
                                              dtype=torch.float32)
    stats = pt.models.fbgmm.SuffStats(counts, sum_x, sum_x * sum_x)
    lp = pt.components_fixedvar.log_prior_batch(prior, X)
    ks, _ = cuda_item_chain.item_chain(
        "fixed", X, lp, noise, torch.full((n,), -1, dtype=torch.int32),
        stats, prior, 1.0, K, 1.0, 0.8)
    prec0 = 1.0 / prior.var_0
    want = cuda_chain.fixedvar_chain_plain(
        torch.zeros((1, n), dtype=torch.int32), X[None], lp[None],
        noise[None], counts[None], sum_x.T[None], 1.0 / prior.var, prec0,
        prec0 * prior.mu_0, 0.8, 1.0, K, 1.0, False)
    npt.assert_array_equal(ks.numpy(), want[0].numpy())


def test_gr_table_is_the_exact_lgamma_difference():
    got = gr_table(5.5, 40, torch.float64, "cpu").numpy()
    v = 5.5 + np.arange(41)
    npt.assert_allclose(got, gammaln((v + 1) / 2) - gammaln(v / 2),
                        rtol=1e-13, atol=1e-13)


def test_item_chain_refuses_what_it_does_not_run():
    X = torch.zeros((3, 2))
    stats = pt.models.fbgmm.SuffStats(torch.zeros(4, dtype=torch.int32),
                                      torch.zeros(4, 2), torch.zeros(4, 2))
    k_old = torch.full((3,), -1, dtype=torch.int32)
    prior = _prior(pt, "fixed", 2)
    with pytest.raises(ValueError, match="spherical"):
        cuda_item_chain.item_chain("spherical", X, X[:, 0], None, k_old,
                                   stats, prior, 1.0, 4)
    with pytest.raises(ValueError, match="noise"):
        cuda_item_chain.item_chain("fixed", X, X[:, 0], None, k_old, stats,
                                   prior, 1.0, 4)
    ks, out = cuda_item_chain.item_chain(
        "fixed", X[:0], X[:0, 0], None, k_old[:0], stats, prior, 1.0, 4,
        use_argmax=True)
    assert ks.shape == (0,)
    npt.assert_array_equal(out.sum_x.numpy(), stats.sum_x.numpy())


LIMIT = 232448 - 1024  # an H100's opt-in shared memory less static arrays


@pytest.mark.parametrize("D", [13, 24])
def test_chol_inv_logdet_equals_jax(D):
    """K11's factorisation helper (right-looking, no ``torch.linalg``)
    against ``components_full._chol_inv_logdet``: the unrolled branch at D
    13, the batched one (LAPACK) at D 24; float64, L^-1 lower triangular,
    ``inv = L^-T L^-1`` and log det to 1e-11 relative (1e-12 absolute)."""
    from segmentalist_tpu.models.components_full import _chol_inv_logdet

    rng = np.random.RandomState(D)
    A = rng.randn(6, D, D)
    covar = A @ A.transpose(0, 2, 1) / D + 0.3 * np.eye(D)
    inv_j, ld_j = _chol_inv_logdet(jnp.asarray(covar))
    Y, ld = cuda_item_chain.chol_inv_logdet(torch.as_tensor(covar))
    Y = Y.numpy()
    npt.assert_array_equal(np.triu(Y, 1), 0.0)
    npt.assert_allclose(Y.transpose(0, 2, 1) @ Y, np.asarray(inv_j),
                        rtol=1e-11, atol=1e-12)
    npt.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-11,
                        atol=1e-12)
    npt.assert_allclose(Y @ covar @ Y.transpose(0, 2, 1),
                        np.broadcast_to(np.eye(D), covar.shape), atol=1e-11)


def test_full_count_terms_are_the_student_t_constants():
    """K11's count table: lgamma((v + D)/2) - lgamma(v/2) - D/2 (log v +
    log pi) with v = v0 + c - D + 1, exact to float64 rounding."""
    D, v0 = 13, 16.0
    got = cuda_item_chain.full_count_terms(v0, D, 50, torch.float64,
                                           "cpu").numpy()
    v = v0 + np.arange(51) - D + 1
    want = (gammaln((v + D) / 2) - gammaln(v / 2)
            - D / 2 * (np.log(v) + np.log(np.pi)))
    npt.assert_allclose(got, want, rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("family", ["fixed", "diag"])
def test_launch_plans(family):
    """K10's plan on an H100 (clusters of up to 16): the toy (K 4) on one
    CTA of a scoring warp and two update warps; the flagship on eight CTAs
    (125 columns, four scoring warps a CTA, tables and sums on chip); D 40
    on eight too; D 130 on sixteen (63 columns), still on chip, or in
    device memory where clusters stop at eight; K 4000 at D 130 in device
    memory on sixteen CTAs of eight scoring warps.  Above D 32 the diag
    family scores a column with a group of threads (pairs at D 40, fours
    at D 130: eight scoring warps), the fixed family with one.  A small
    limit moves the flagship to sixteen CTAs, then off chip; a card of
    single-CTA clusters runs it on one CTA of 320 threads.  A forced C the
    card cannot schedule, a C that is no power of two, a K whose counts,
    weights and noise alone do not fit, and an empty shape are refused."""
    lp, sb = cuda_item_chain.launch_plan, cuda_item_chain.smem_bytes
    split = family == "diag"
    assert lp(family, 2, 4, LIMIT, 16) == (1, 96, "smem",
                                           sb(family, 2, 4, 1, False))
    assert lp(family, 13, 1000, LIMIT, 16) == (
        8, 192, "smem", sb(family, 13, 1000, 8, False))
    assert lp(family, 40, 1000, LIMIT, 16)[:3] == (
        8, 320 if split else 192, "smem")
    assert lp(family, 130, 1000, LIMIT, 16) == (
        16, 320 if split else 128, "smem",
        sb(family, 130, 1000, 16, False))
    assert lp(family, 130, 1000, LIMIT, 8) == (
        8, 320 if split else 192, "global", sb(family, 130, 1000, 8, True))
    assert lp(family, 130, 4000, LIMIT, 16) == (
        16, 320, "global", sb(family, 130, 4000, 16, True))
    assert lp(family, 13, 1000, 20 * 1024, 16)[:3] == (16, 128, "smem")
    assert lp(family, 13, 1000, 5 * 1024, 16)[:3] == (16, 128, "global")
    one = lp(family, 13, 1000, LIMIT, 1)
    assert one[:2] == (1, 320) and one.smem == sb(family, 13, 1000, 1,
                                                  one.tables == "global")
    assert lp(family, 13, 1000, LIMIT, 16, cluster=2)[:2] == (2, 320)
    assert lp(family, 130, 1000, LIMIT, 16, cluster=4)[:3] == (
        4, 320, "global")
    for C, cap in ((8, 16), (3, 16), (16, 8)):
        with pytest.raises(ValueError, match="not schedulable"):
            lp(family, 2 if C == 8 else 13, 4 if C == 8 else 1000, LIMIT,
               cap, cluster=C)
    with pytest.raises(ValueError, match="no %s item chain form" % family):
        lp(family, 2, 300000, LIMIT, 16)
    with pytest.raises(ValueError, match="no K10 item chain"):
        lp(family, 0, 1000, LIMIT, 16)


def test_smem_bytes_by_hand():
    """K10's carving counted by hand for the flagship at its plan's C 8
    (P 125 columns, W 6 warps, a thread a column) and D 130 at C 16 (P
    63; fixed: W 4, a thread a column; diag: W 10, groups of four a
    column): the entry slots 2 C W uint4 (8 C W words); on chip the tables
    (two), the running sums (two) and the terms (fixed one, diag two) a
    column; counts, weights and two noise rows [4, P]; x and the log prior
    of three items [3, D + 1]; the prior vectors (fixed three, diag two)
    and the two update warps' logs and fit addends [4, D]; the diag
    family's 64 scoring groups' addends [64, D]."""
    sb = cuda_item_chain.smem_bytes
    assert sb("fixed", 13, 1000, 8, False) == 4 * (
        8 * 8 * 6 + (4 * 13 + 1) * 125 + 4 * 125 + 3 * 14 + 3 * 13
        + 4 * 13) == 30568
    assert sb("diag", 13, 1000, 8, False) == 4 * (
        8 * 8 * 6 + (4 * 13 + 2) * 125 + 4 * 125 + 3 * 14 + 2 * 13
        + 4 * 13) == 31016
    assert sb("fixed", 130, 1000, 16, False) == 4 * (
        8 * 16 * 4 + (4 * 130 + 1) * 63 + 4 * 63 + 3 * 131 + 3 * 130
        + 4 * 130) == 139560
    assert sb("diag", 130, 1000, 16, False) == 4 * (
        8 * 16 * 10 + (4 * 130 + 2) * 63 + 4 * 63 + 3 * 131 + 2 * 130
        + 4 * 130 + 64 * 130) == 175644
    assert sb("diag", 130, 1000, 16, True) == 4 * (
        8 * 16 * 10 + 4 * 63 + 3 * 131 + 2 * 130 + 4 * 130 + 64 * 130)
    split, threads = cuda_item_chain.item_split, cuda_item_chain.item_threads
    assert [split("diag", 130, 1000, C) for C in (1, 2, 4, 8, 16)] == [
        1, 1, 1, 2, 4]
    assert [split("diag", D, 1000, 16) for D in (13, 32, 33, 130)] == [
        1, 1, 4, 4]
    assert [split("fixed", 130, 1000, C) for C in (1, 8, 16)] == [1, 1, 1]
    for family in ("fixed", "diag"):
        assert [threads(family, 13, 1000, C) for C in (
            1, 2, 4, 8, 16)] == [320, 320, 320, 192, 128]
        assert threads(family, 2, 4, 1) == 96
        assert threads(family, 130, 4000, 16) == 320
    assert threads("fixed", 130, 1000, 16) == 128
    assert threads("diag", 130, 1000, 16) == 320


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [13, 40, 130])
@pytest.mark.parametrize("family", ["fixed", "diag"])
def test_item_smem_bytes_every_cluster(family, D, C):
    """K10's bytes a CTA at K 1000 for every C, on chip and in device
    memory, from the carving: P = ceil(K / C) columns, S scoring threads a
    column (1 up to D 32 and for the fixed family; else 4, 2 or 1 so that
    S P fits 256 threads), W = 2 + min(8, ceil(S P / 32)) warps, and where
    S > 1 the scoring groups' addends; what fits the H100's limit is what
    the plan may pick (D 13 from C 1, fixed, or C 2, diag; D 40 from C 4;
    D 130 at C 16 only)."""
    P = -(-1000 // C)
    S = 1
    if D > 32 and family == "diag":
        S = 4
        while S > 1 and S * P > 256:
            S //= 2
    W = 2 + min(8, -(-S * P // 32))
    terms, prior = (1, 3) if family == "fixed" else (2, 2)
    base = (8 * C * W + 4 * P + 3 * (D + 1) + prior * D + 4 * D
            + (32 * (W - 2) // S * D if S > 1 else 0))
    on_chip = 4 * (base + (4 * D + terms) * P)
    assert cuda_item_chain.item_split(family, D, 1000, C) == S
    assert cuda_item_chain.item_threads(family, D, 1000, C) == 32 * W
    assert cuda_item_chain.smem_bytes(family, D, 1000, C, False) == on_chip
    assert cuda_item_chain.smem_bytes(family, D, 1000, C, True) == 4 * base
    fits = on_chip <= LIMIT
    least = {13: 1 if family == "fixed" else 2, 40: 4, 130: 16}[D]
    assert fits == (C >= least)
    plan = cuda_item_chain.launch_plan(family, D, 1000, LIMIT, 16, cluster=C)
    assert plan == (C, 32 * W, "smem" if fits else "global",
                    on_chip if fits else 4 * base)


def test_full_launch_plans():
    """K11's plan on an H100 (clusters of up to 16): the toy (K 4, so C at
    most K) on one CTA of a scoring warp and two update warps; the
    flagship and D 24 on eight CTAs (125 columns and four scoring warps a
    CTA, tables on chip); D 40 (the CTA form) on 16 with its tables on
    chip; D 130 on 16 with its tables in device memory; D 240 with its
    work area there too.  A small limit moves the tables off chip, a card
    of single-CTA clusters runs the flagship on one CTA of 256 threads; a
    forced C the card cannot schedule, a D past 256 and a K whose counts
    alone do not fit are refused."""
    lp = cuda_item_chain.launch_plan
    fsb = cuda_item_chain.full_smem_bytes
    toy = lp("full", 2, 4, LIMIT, 16)
    assert toy == ("warp", 1, 96, "smem", "smem", fsb(2, 4, 1, False, False))
    assert lp("full", 13, 1000, LIMIT, 16) == (
        "warp", 8, 192, "smem", "smem", fsb(13, 1000, 8, False, False))
    assert lp("full", 24, 1000, LIMIT, 16)[:5] == (
        "warp", 8, 192, "smem", "smem")
    assert lp("full", 40, 1000, LIMIT, 16)[:5] == (
        "cta", 16, 1024, "smem", "smem")
    assert lp("full", 40, 1000, LIMIT, 8)[:5] == (
        "cta", 8, 1024, "global", "smem")
    assert lp("full", 130, 1000, LIMIT, 16) == (
        "cta", 16, 1024, "global", "smem", fsb(130, 1000, 16, True, False))
    assert lp("full", 240, 50, LIMIT, 16) == (
        "cta", 16, 1024, "global", "global", fsb(240, 50, 16, True, True))
    assert lp("full", 13, 1000, 30 * 1024, 16)[:5] == (
        "warp", 16, 128, "smem", "smem")
    assert lp("full", 13, 1000, 20 * 1024, 16)[:5] == (
        "warp", 16, 128, "global", "smem")
    assert lp("full", 13, 1000, LIMIT, 1) == (
        "warp", 1, 256, "global", "smem", fsb(13, 1000, 1, True, False))
    assert lp("full", 13, 1000, LIMIT, 16, cluster=2)[:5] == (
        "warp", 2, 256, "smem", "smem")
    with pytest.raises(ValueError, match="not schedulable"):
        lp("full", 2, 4, LIMIT, 16, cluster=8)
    with pytest.raises(ValueError, match="not schedulable"):
        lp("full", 13, 1000, LIMIT, 8, cluster=16)
    with pytest.raises(ValueError, match="no full item chain form"):
        lp("full", 257, 1000, LIMIT, 16)
    with pytest.raises(ValueError, match="no full item chain form"):
        lp("full", 2, 600000, LIMIT, 16)


def test_full_smem_bytes_by_hand():
    """K11's carving counted by hand, with P the largest share of columns
    made odd: counts, weights and two items' noise [4, P], x and the log
    prior of three items [3, D + 1]; on chip the tables, D + D (D + 1)/2 +
    1 words a column; the CTA form's work area of D D + 2 D words (none in
    device memory; the warp form derives in registers)."""
    fsb = cuda_item_chain.full_smem_bytes
    assert fsb(2, 4, 1, False, False) == 4 * (4 * 5 + 3 * 3 + 6 * 5) == 236
    assert fsb(13, 1000, 8, False, False) == 4 * (
        4 * 125 + 3 * 14 + 105 * 125) == 54668
    assert fsb(13, 1000, 16, True, False) == 4 * (4 * 63 + 3 * 14)
    assert fsb(24, 1000, 8, False, False) == 4 * (
        4 * 125 + 3 * 25 + 325 * 125) == 164800
    assert fsb(40, 1000, 16, False, False) == 4 * (
        4 * 63 + 3 * 41 + 861 * 63 + 1600 + 80) == 225192
    assert fsb(130, 1000, 16, True, False) == 4 * (
        4 * 63 + 3 * 131 + 16900 + 260) == 71220
    assert fsb(240, 50, 16, True, True) == 4 * (4 * 5 + 3 * 241) == 2972
    assert fsb(13, 1000, 2, False, False) == 4 * (
        4 * 501 + 3 * 14 + 105 * 501) == 218604
    assert [cuda_item_chain.full_threads(D, 1000, C) for D, C in (
        (13, 1), (13, 4), (13, 8), (13, 16), (32, 16), (33, 16))] == [
            256, 256, 192, 128, 128, 1024]
    assert cuda_item_chain.full_threads(2, 4, 4) == 96


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("K", [4, 200, 1000, 1500])
def test_full_column_ranges_cover_every_column_once(K, C):
    """The CTAs' column ranges (K11's and K10's r K / C split) cover 0 ..
    K - 1 once each, in order, none empty where C <= K, none wider than
    the largest share the plans size (ceil(K / C))."""
    ranges = [cuda_item_chain.full_col_range(K, C, r) for r in range(C)]
    owned = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    npt.assert_array_equal(owned, np.arange(K))
    widths = [hi - lo for lo, hi in ranges]
    assert max(widths) <= -(-K // C)
    if C <= K:
        assert min(widths) >= 1
