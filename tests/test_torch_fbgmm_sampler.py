"""The port's FBGMM Gibbs sampler against the JAX package's.

Both packages build an ``FBGMM`` from the same data and assignments; the
sweeps of both run on shared Gumbel noise, recreated from the JAX model's
key exactly as its sweeps draw it (sequential and blocked: ``key, sub =
split(key)``, a key an item ``split(sub, N)``, ``gumbel(item_key, (K,))``;
``reassign_items``: ``fold_in(sub, j)``; single items: ``split(key)``).
Assignments are identical and the statistics agree to float64 rounding
(1e-12).  The distributional tests (recovery, the stationary distribution
of the sequential sweep) run on the port's own noise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.special import gammaln, logsumexp as lse

import segmentalist_tpu as jtpu
from segmentalist_tpu.ops.stats import decollide_new_items as jax_decollide

import segmentalist_torch as pt
from segmentalist_torch.ops.stats import decollide_new_items


def _prior(pkg, cov, D):
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                        np.ones(D))
    S_0 = 0.4 * np.ones(D) if cov == "diag" else 0.4 * np.eye(D)
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _models(cov, N=30, D=2, K=6, dtype=np.float64, seed=0, **kw):
    """A JAX and a port FBGMM on the same clustered data with a third of
    the items unassigned."""
    rng = np.random.RandomState(seed)
    X = ((2.0 * rng.randn(3, D))[rng.randint(0, 3, N)]
         + 0.7 * rng.randn(N, D)).astype(dtype)
    asg = rng.randint(-1, 4, N)
    asg[rng.rand(N) < 0.2] = -1
    jp, tp = _prior(jtpu, cov, D), _prior(pt, cov, D)
    if dtype == np.float32:
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    jam = jtpu.FBGMM(X, jp, 1.3, K, asg, covariance_type=cov, lms=1.1,
                     key=jax.random.PRNGKey(seed + 7), **kw)
    tam = pt.FBGMM(X, tp, 1.3, K, asg, covariance_type=cov, lms=1.1,
                   device="cpu", **kw)
    return jam, tam


def _item_noise(key, n, K, dtype):
    """(next key, [n, K] noise) of one sweep of the JAX model."""
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, n)
    return key, np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (K,), dtype))(keys))


def _same_state(jam, tam, tol=1e-12):
    npt.assert_array_equal(np.asarray(jam.assignments),
                           tam.assignments.numpy())
    npt.assert_array_equal(np.asarray(jam.stats.counts),
                           tam.stats.counts.numpy())
    for a, b in ((jam.stats.sum_x, tam.stats.sum_x),
                 (jam.stats.sum_sq, tam.stats.sum_sq)):
        npt.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol)


SWEEP_CASES = ([(cov, np.float64, 2) for cov in ("fixed", "diag", "full")]
               + [(cov, np.float32, 13) for cov in ("fixed", "diag")])


@pytest.mark.parametrize("consider_unassigned", [True, False])
@pytest.mark.parametrize("cov,dtype,D", SWEEP_CASES)
def test_sequential_sweep_matches_jax(cov, dtype, D, consider_unassigned):
    """``FBGMM.sequential_sweep`` (K10's plain version; the full family's:
    K11's) equals ``_build_sequential_sweep`` on shared noise over
    three sweeps at two temperatures; float64 to 1e-12, float32 (D 13) to
    a few float32 ulps of the largest sum (~170: 1e-4; the JAX package
    builds its first statistics by a one-hot product, the port in item
    order) with identical assignments."""
    jam, tam = _models(cov, D=D, dtype=dtype)
    fn = jam._get_sweep_fn("sequential", consider_unassigned)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    for temp in (1.0, 0.6, 1.0):
        _, noise = _item_noise(jam.key, jam.N, jam.K_max, dtype)
        jam.stats, jam.assignments, jam.key = fn(
            jam.stats, jam.assignments, jam.key, np.asarray(temp, dtype))
        tam.sequential_sweep(temp, consider_unassigned,
                             noise=torch.as_tensor(noise))
        _same_state(jam, tam, tol)
    if not consider_unassigned:  # the unassigned items stay so
        assert (tam.assignments.numpy() == -1).sum() > 0


@pytest.mark.parametrize("decollide", [True, False])
@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_blocked_sweep_matches_jax(cov, decollide):
    """``FBGMM.blocked_sweep`` equals ``_build_blocked_sweep`` on shared
    noise, with new components decollided or sent to the first empty
    slot; ``consider_unassigned`` both ways."""
    jam, tam = _models(cov, K=8, decollide_new=decollide)
    for cu, temp in ((True, 1.0), (False, 0.7), (True, 1.0)):
        fn = jam._get_sweep_fn("blocked", cu)
        _, noise = _item_noise(jam.key, jam.N, jam.K_max, np.float64)
        jam.stats, jam.assignments, jam.key = fn(
            jam.stats, jam.assignments, jam.key, np.asarray(temp))
        tam.blocked_sweep(temp, cu, noise=torch.as_tensor(noise))
        _same_state(jam, tam)


def test_blocked_sweep_oscillation_matches_jax():
    """At K well above the data's clusters the blocked sweep oscillates
    (simultaneous moves: most items leave for a few components, then
    scatter again into empty ones).  On the first 300 spans of the
    synthetic corpus the bench draws (float32, the bench's fixed-variance
    prior, K 100, uniformly drawn columns) the port's sweep follows the
    JAX package's trajectory on shared noise over five sweeps: identical
    assignments, log_marg to 1e-6 relative (float32 sums in another
    order), and in both it falls after its second sweep."""
    from segmentalist_torch.segmenters.blocked import process_embeddings
    from segmentalist_torch.utils.profiling import bench_prior
    from segmentalist_torch.utils.synth import synthetic_corpus

    em, vi, _, _, _ = synthetic_corpus(
        n_utterances=12, n_landmarks_max=20, D=13, K_true=50,
        n_slices_max=6, seed=0)
    X = np.asarray(process_embeddings(
        {k: v.astype(np.float32) for k, v in em.items()}, vi)[0])[:300]
    N, K, D = X.shape[0], 100, 13
    f32 = np.float32
    jp = jtpu.FixedVarPrior.create(np.full(D, 0.05, f32), np.zeros(D, f32),
                                   np.ones(D, f32))
    asg = np.random.RandomState(0).randint(0, K, N)
    jam = jtpu.FBGMM(X, jp, 1.0, K, asg, covariance_type="fixed",
                     key=jax.random.PRNGKey(0))
    tam = pt.FBGMM(X, bench_prior("fixed", D, "cpu"), 1.0, K, asg,
                   covariance_type="fixed", device="cpu")
    fn = jam._get_sweep_fn("blocked", True)
    want, got = [], []
    for _ in range(5):
        _, noise = _item_noise(jam.key, N, K, f32)
        jam.stats, jam.assignments, jam.key = fn(
            jam.stats, jam.assignments, jam.key, np.asarray(1.0, f32))
        tam.blocked_sweep(1.0, True, noise=torch.tensor(noise))
        npt.assert_array_equal(tam.assignments.numpy(),
                               np.asarray(jam.assignments))
        want.append(float(jam.log_marg()))
        got.append(float(tam.log_marg()))
    npt.assert_allclose(got, want, rtol=1e-6)
    assert want[2] < want[1] and got[2] < got[1]


def _reassign_noise(key, n, K):
    """(next key, [n, K] noise) of the JAX model's ``reassign_items``."""
    key, sub = jax.random.split(key)
    return key, np.array([np.asarray(jax.random.gumbel(
        jax.random.fold_in(sub, j), (K,), jnp.float64))
        for j in range(n)]).reshape(n, K)


def _patch_noise(tam, noises):
    """Make the port's model draw the given noises, in order."""
    it = iter(noises)
    tam.draw_noise = lambda rows: torch.as_tensor(next(it))


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_set_K_and_reassign_items_match_jax(cov, grow):
    """``set_K`` keeps the largest components and re-draws the orphans one
    by one (``reassign_items``, K10 with the delete off), or grows the slot
    count; then ``reassign_items`` of the unassigned items on shared
    noise."""
    jam, tam = _models(cov, N=40, K=6, seed=2)
    K_new = 9 if grow else 2
    orphans = int(((np.asarray(jam.assignments) >= 0)
                   & ~np.isin(np.asarray(jam.assignments),
                              np.argsort(np.asarray(jam.stats.counts))
                              [-K_new:])).sum())
    _, n1 = _reassign_noise(jam.key, orphans, K_new)
    jam.set_K(K_new)
    _patch_noise(tam, [n1] if orphans and not grow else [])
    tam.set_K(K_new)
    assert tam.K_max == jam.K_max == K_new
    _same_state(jam, tam)
    ids = np.flatnonzero(np.asarray(jam.assignments) < 0)
    _, n2 = _reassign_noise(jam.key, len(ids), K_new)
    jam.reassign_items(ids, anneal_temp=0.8)
    tam.reassign_items(ids, anneal_temp=0.8, noise=torch.as_tensor(n2))
    _same_state(jam, tam)
    assert tam.get_n_assigned() == jam.get_n_assigned() == jam.N
    assert tam.K == jam.K


@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_single_item_api_matches_jax(cov):
    """``del_item``, ``gibbs_sample_inside_loop_i`` (on the noise of the
    JAX model's next key), ``map_assign_i`` (no lms scaling, as the
    reference), ``log_marg_i``, ``K`` and ``get_n_assigned``."""
    jam, tam = _models(cov, N=24, K=5, seed=3)
    for i in (3, 11, 0):
        jam.del_item(i)
        tam.del_item(i)
        _same_state(jam, tam)
        npt.assert_allclose(tam.log_marg_i(i), jam.log_marg_i(i),
                            rtol=1e-12)
        _, sub = jax.random.split(jam.key)
        noise = np.asarray(jax.random.gumbel(sub, (jam.K_max,), jnp.float64))
        jam.gibbs_sample_inside_loop_i(i, anneal_temp=0.9)
        tam.gibbs_sample_inside_loop_i(i, anneal_temp=0.9,
                                       noise=torch.as_tensor(noise))
        _same_state(jam, tam)
    for i in (5, 17):
        jam.del_item(i)
        tam.del_item(i)
        jam.map_assign_i(i)
        tam.map_assign_i(i)
        _same_state(jam, tam)
    assert tam.K == jam.K
    assert tam.get_n_assigned() == jam.get_n_assigned()


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_gibbs_sample_record_matches_jax(mode):
    """``gibbs_sample(3)`` returns the reference's six keys with the JAX
    package's values on shared noise (an annealing schedule included)."""
    jam, tam = _models("fixed", N=36, K=6, seed=4)
    key, noises = jam.key, []
    for _ in range(3):
        key, noise = _item_noise(key, jam.N, jam.K_max, np.float64)
        noises.append(noise)
    _patch_noise(tam, noises)
    kw = dict(anneal_schedule="linear", anneal_start_temp_inv=0.5,
              mode=mode)
    want = jam.gibbs_sample(3, **kw)
    got = tam.gibbs_sample(3, **kw)
    assert list(got) == list(want)
    for k in ("log_marg", "log_prob_z", "log_prob_X_given_z"):
        npt.assert_allclose(got[k], want[k], rtol=1e-11)
    npt.assert_allclose(got["anneal_temp"], want["anneal_temp"], rtol=1e-15)
    assert got["components"] == want["components"]
    assert len(got["sample_time"]) == 3
    _same_state(jam, tam)


DECOLLIDE_CASES = {
    # creators of empty slot 2 and 5 in item order, a join of slot 0
    "crafted": ([3, 2, 0, 0, 0, 0, 0, 0, 0, 0], [2, 2, 2, 5, 5, 0]),
    # three creators of slot 0, all slots empty: the fourth saturates
    "exhaustion": ([0, 0, 0], [0, 0, 0, 0]),
    "no_new": ([1, 2, 3], [0, 2, 1, 1]),
}


@pytest.mark.parametrize("case", list(DECOLLIDE_CASES) + ["random"])
def test_decollide_new_items_matches_jax(case):
    """The blocked sweep's relabelling of simultaneous new-component draws
    (the cases of tests/test_decollide.py, flattened to items)."""
    if case == "random":
        rng = np.random.RandomState(1)
        counts = (rng.rand(31) < 0.4) * rng.randint(1, 4, 31)
        k_new = rng.randint(0, 31, 40)
    else:
        counts, k_new = (np.asarray(a) for a in DECOLLIDE_CASES[case])
    want = np.asarray(jax_decollide(jnp.asarray(counts, jnp.int32),
                                    jnp.asarray(k_new, jnp.int32)))
    got = decollide_new_items(torch.as_tensor(counts, dtype=torch.int32),
                              torch.as_tensor(k_new, dtype=torch.int32))
    npt.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["mixed", "none_empty", "all_empty"])
def test_canonicalize_new_component_matches_jax(case):
    """The first-empty birth rule (``stats.py:105-118``): a draw on an
    empty slot moves to the lowest empty one, or to K - 1 when none is
    empty; a draw on an occupied slot stays."""
    from segmentalist_tpu.ops.stats import (
        canonicalize_new_component as jax_canon)
    from segmentalist_torch.ops.stats import canonicalize_new_component

    rng = np.random.RandomState(2)
    counts = {"mixed": (rng.rand(9) < 0.5) * rng.randint(1, 4, 9),
              "none_empty": rng.randint(1, 4, 9),
              "all_empty": np.zeros(9, np.int64)}[case]
    for k in range(9):
        want = int(jax_canon(jnp.asarray(counts, jnp.int32),
                             jnp.asarray(k, jnp.int32)))
        got = canonicalize_new_component(
            torch.as_tensor(counts, dtype=torch.int32), torch.tensor(k))
        assert int(got) == want, (case, k)


# ------------------------------------------------- on the port's own noise

def _gen_data(seed=1, N=60, D=2, K_true=3, mu_scale=6.0, covar_scale=0.5):
    rng = np.random.RandomState(seed)
    z_true = rng.randint(0, K_true, N)
    mu = rng.randn(D, K_true) * mu_scale
    X = (mu[:, z_true] + rng.randn(D, N) * covar_scale).T
    return X, z_true


def _recovery_prior(X, cov):
    D = X.shape[1]
    if cov == "full":
        return pt.NIW.create(np.zeros(D), 0.5 ** 2 / 6.0 ** 2, D + 3,
                             0.5 ** 2 * (D + 3) * np.eye(D))
    if cov == "diag":
        return pt.NIW.create(np.zeros(D), 0.5 ** 2 / 6.0 ** 2, D + 3,
                             0.5 ** 2 * (D + 3) * np.ones(D))
    return pt.FixedVarPrior.create(0.5 ** 2 * np.ones(D), np.zeros(D),
                                   6.0 ** 2 * np.ones(D))


def _purity(assignments, z_true):
    assignments = np.asarray(assignments)
    return sum(np.bincount(z_true[assignments == k]).max()
               for k in np.unique(assignments)) / len(z_true)


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_clustering_recovers_mixture(cov, mode):
    """tests/test_fbgmm.py:48-67 on the port's own noise: on well
    separated 2-D data the sampler recovers the clustering and improves
    log_marg, in every family and both modes."""
    X, z_true = _gen_data()
    np.random.seed(42)
    model = pt.FBGMM(X, _recovery_prior(X, cov), alpha=1.0, K=6,
                     assignments="rand", covariance_type=cov, seed=5,
                     device="cpu")
    record = model.gibbs_sample(25, mode=mode)
    assert record["log_marg"][-1] > record["log_marg"][0]
    assert _purity(model.assignments.numpy(), z_true) >= 0.95
    npt.assert_allclose(np.array(record["log_marg"]),
                        np.array(record["log_prob_z"])
                        + np.array(record["log_prob_X_given_z"]), rtol=1e-9)
    assert record["components"][-1] == model.K


def test_annealing_schedules_run():
    X, _ = _gen_data(N=30)
    model = pt.FBGMM(X, _recovery_prior(X, "fixed"), alpha=1.0, K=4,
                     covariance_type="fixed", device="cpu")
    r1 = model.gibbs_sample(6, anneal_schedule="linear",
                            anneal_start_temp_inv=0.1)
    assert r1["anneal_temp"][0] == pytest.approx(10.0)
    assert r1["anneal_temp"][-1] == pytest.approx(1.0)
    r2 = model.gibbs_sample(6, anneal_schedule="step", n_anneal_steps=3)
    assert len(r2["anneal_temp"]) == 6
    with pytest.raises(ValueError, match="mode"):
        model.gibbs_sample(1, mode="parallel")


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_consider_unassigned_false_keeps_unassigned(mode):
    X, _ = _gen_data(N=20)
    model = pt.FBGMM(X, _recovery_prior(X, "fixed"), alpha=1.0, K=4,
                     assignments=np.array([0] * 10 + [-1] * 10),
                     covariance_type="fixed", device="cpu")
    model.gibbs_sample(3, consider_unassigned=False, mode=mode)
    assert np.all(model.assignments.numpy()[10:] == -1)
    model.gibbs_sample(1, consider_unassigned=True, mode=mode)
    assert np.all(model.assignments.numpy() >= 0)


VAR, MU0, VAR0 = 0.5, 0.0, 2.0  # the fixed-variance prior of level 1 (D 1)


def _pred_logpdf(x, n, sum_x):
    prec, prec0 = 1.0 / VAR, 1.0 / VAR0
    prec_n = prec0 + n * prec
    mu_pred = (prec0 * MU0 + prec * sum_x) / prec_n
    prec_pred = prec_n * prec / (prec_n + prec)
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec_pred)
            - 0.5 * prec_pred * (x - mu_pred) ** 2)


def _log_marg_component(xs):
    lp, n, sx = 0.0, 0.0, 0.0
    for x in xs:
        lp += _pred_logpdf(x, n, sx)
        n += 1.0
        sx += x
    return lp


def test_sequential_stationary_distribution():
    """Level 1 of tests/test_exact_posterior.py (:66-106) on the port's
    own noise: the sequential sweep is exact collapsed Gibbs, so its
    stationary distribution is the enumerated posterior P(z | X) (N 4, K
    2, D 1, 16 states), within total variation 0.05 over 6000 sweeps."""
    X = np.array([-1.3, -0.9, 1.1, 1.6])[:, None]
    N, K, alpha = 4, 2, 1.0
    states = list(itertools.product(range(K), repeat=N))
    logp = np.empty(len(states))
    for s_i, z in enumerate(states):
        z = np.array(z)
        counts = np.bincount(z, minlength=K)
        lpz = (gammaln(alpha) - gammaln(alpha + N)
               + sum(gammaln(c + alpha / K) - gammaln(alpha / K)
                     for c in counts))
        lpx = sum(_log_marg_component(X[z == k, 0]) for k in range(K)
                  if (z == k).any())
        logp[s_i] = lpz + lpx
    exact = np.exp(logp - lse(logp))

    prior = pt.FixedVarPrior.create(VAR * np.ones(1), MU0 * np.ones(1),
                                    VAR0 * np.ones(1))
    model = pt.FBGMM(X, prior, alpha=alpha, K=K, assignments=[0, 0, 1, 1],
                     covariance_type="fixed", seed=42, device="cpu")
    n_sweeps, burn = 6000, 200
    index = {z: i for i, z in enumerate(states)}
    freq = np.zeros(len(states))
    for t in range(n_sweeps):
        model.sequential_sweep(1.0, True)
        if t >= burn:
            freq[index[tuple(model.assignments.tolist())]] += 1
    freq /= freq.sum()
    tv = 0.5 * np.abs(freq - exact).sum()
    assert tv < 0.05, (tv, list(zip(states, exact.round(4), freq.round(4))))


@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
def test_components_view_mutators_and_draws(cov):
    """The component view's ``add_item`` / ``del_item`` /
    ``del_component`` keep the statistics equal to a rebuild from the
    assignments; ``rand_k`` and ``map`` give parameters of the family's
    shapes; the view's prior is the model's."""
    from segmentalist_torch.ops.stats import suff_stats_from_assignments

    X, _ = _gen_data(N=20, D=3)
    model = pt.FBGMM(X, _recovery_prior(X, cov), 1.0, 4, np.arange(20) % 4,
                     covariance_type=cov, device="cpu")
    view = model.components

    def check():
        rebuilt = suff_stats_from_assignments(model.X, model.assignments, 4,
                                              model.full_cov)
        npt.assert_array_equal(model.stats.counts.numpy(),
                               rebuilt.counts.numpy())
        for a, b in ((model.stats.sum_x, rebuilt.sum_x),
                     (model.stats.sum_sq, rebuilt.sum_sq)):
            npt.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)

    view.del_item(5)
    assert int(model.assignments[5]) == -1
    check()
    view.add_item(5, 2)
    assert int(model.assignments[5]) == 2
    check()
    n_members = int((model.assignments == 1).sum())
    view.del_component(1)
    assert int(model.stats.counts[1]) == 0
    assert model.get_n_assigned() == 20 - n_members
    check()
    assert view.prior is model.prior
    draw = view.rand_k(0)
    mean = view.map(0)
    if cov == "full":
        assert draw[0].shape == (3,) and draw[1].shape == (3, 3)
        npt.assert_allclose(mean[1].numpy(), mean[1].numpy().T)
    elif cov == "diag":
        assert draw[0].shape == draw[1].shape == (3,)
        assert (draw[1] > 0).all()
    else:
        assert draw.shape == mean.shape == (3,)
    assert np.isfinite(float(view.log_marg()))
    assert view.log_post_pred(3).shape == (4,)
