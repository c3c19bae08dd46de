"""The port's k-means model (``segmentalist_torch.models.kmeans``) against
the JAX package's, and the JAX tests' analytic checks (tests/test_kmeans.py,
the reference's tests/test_kmeans_components.py) on the port.

Both packages start from one numpy state: the tests seed numpy's global RNG
before each constructor, which both packages draw their initial state from
when given no ``rng``.  float64 runs must agree exactly in assignments and
counts (sums to rtol 1e-12); float32 runs to a share of the assignments,
since the expanded distance form cancels in float32 and products may add in
another order on each side.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models.kmeans import KMeans as JaxKMeans
from segmentalist_tpu.models.kmeans import neg_sqrd_norms as jax_norms

import segmentalist_torch as pt
from segmentalist_torch.models import kmeans as tk

F32_AGREE = 0.99  # share of identical assignments at float32


def _gen(seed=1, N=10, D=3, K_true=4, spread=4.0, noise=0.7):
    rng = np.random.RandomState(seed)
    z_true = rng.randint(0, K_true, N)
    mu = rng.randn(D, K_true) * spread
    X = (mu[:, z_true] + rng.randn(D, N) * noise).T
    return X, z_true


def _port(X, K, assignments, seed=1, **kw):
    np.random.seed(seed)
    return pt.KMeans(X, K, assignments, device="cpu", **kw)


def _pair(X, K, assignments, seed):
    np.random.seed(seed)
    jm = JaxKMeans(X, K, assignments)
    return jm, _port(X, K, assignments, seed)


def _np(t):
    return np.asarray(t.cpu() if torch.is_tensor(t) else t)


# ------------------------------------------------- the JAX tests' oracles

def test_means_and_distances():
    """Reference tests/test_kmeans_components.py:13-79."""
    X, _ = _gen()
    N = X.shape[0]
    np.random.seed(1)
    assignments = np.random.randint(0, 3, N)
    model = _port(X, 3, assignments)
    means = _np(model.means())
    n = 0
    for k in range(3):
        members = X[assignments == k]
        if len(members):
            n += len(members)
            npt.assert_almost_equal(members.mean(axis=0), means[k])
    assert n == N
    for i in range(N):
        expected = [-np.linalg.norm(X[i] - means[k]) ** 2 for k in range(3)]
        npt.assert_almost_equal(_np(model.neg_sqrd_norm(i)), expected)
        assert model.argmax_neg_sqrd_norm_i(i) == int(np.argmax(expected))
        npt.assert_almost_equal(model.max_neg_sqrd_norm_i(i), max(expected))


def test_sum_neg_sqrd_norm():
    """Reference tests/test_kmeans_components.py:82-117."""
    X, _ = _gen()
    N = X.shape[0]
    np.random.seed(1)
    assignments = np.random.randint(0, 3, N)
    model = _port(X, 3, assignments)
    means = _np(model.means())
    expected = sum(-np.linalg.norm(X[i] - means[assignments[i]]) ** 2
                   for i in range(N))
    npt.assert_almost_equal(model.sum_neg_sqrd_norm(), expected)


def test_fit_converges_and_early_stops():
    X, z_true = _gen(N=60, K_true=3)
    model = _port(X, 5, "spread", seed=2)
    record = model.fit(50)
    assert record["n_mean_updates"][-1] == 0  # the early stop fired
    assert len(record["n_mean_updates"]) < 50
    assert record["sum_neg_sqrd_norm"][-1] >= record["sum_neg_sqrd_norm"][0]
    a = _np(model.assignments)
    for k in np.unique(a):  # separated data: every cluster pure
        members = z_true[a == k]
        assert np.bincount(members).max() == len(members)


def test_empty_slots_take_their_random_means():
    X, _ = _gen(N=12)
    model = _port(X, 6, np.array([0] * 6 + [1] * 6), seed=4)
    means = _np(model.means())
    npt.assert_array_equal(means[2:], _np(model.random_means)[2:])
    assert model.K == 2 and model.get_n_assigned() == 12


def test_view_mutators_keep_the_statistics_exact():
    """add_item / del_item / del_component keep (counts, sum_x) equal to
    a rebuild from the mutated assignment vector (the JAX package's
    tests/test_api_surface.py:131-162); a new component takes the first
    empty slot."""
    rng = np.random.RandomState(3)
    X = rng.randn(12, 3)
    km = pt.KMeans(X, 5, rng.randint(0, 4, 12), rng=rng, device="cpu")
    view = km.components

    def check():
        rebuilt = tk.kmeans_state_from_assignments(km.X, km.assignments,
                                                   km.K_max)
        npt.assert_array_equal(_np(km.state.counts), _np(rebuilt.counts))
        npt.assert_allclose(_np(km.state.sum_x), _np(rebuilt.sum_x),
                            atol=1e-12)

    view.del_item(5)
    assert int(km.assignments[5]) == -1
    check()
    view.add_item(5, 2)
    assert int(km.assignments[5]) == 2
    check()
    k_del = int(km.assignments[0])
    n_members = int((km.assignments == k_del).sum())
    view.del_component(k_del)
    assert int(view.counts[k_del]) == 0
    assert km.get_n_assigned() == 12 - n_members
    check()
    first_empty = int(np.flatnonzero(_np(view.counts) == 0)[0])
    view.add_item(0, km.K_max)  # a new component: the first empty slot
    assert int(km.assignments[0]) == first_empty
    check()
    with pytest.raises(ValueError):
        view.add_item(0, 1)  # assigned already
    old = _np(view.random_means).copy()
    view.setup_random_means()
    assert _np(view.random_means).shape == old.shape
    npt.assert_array_equal(_np(view.mean_numerators), _np(km.state.sum_x))
    view.clean_components()


# ------------------------------------------------------ against the JAX

def test_means_distances_and_objective_match_jax():
    X, _ = _gen(N=40, D=4, K_true=5)
    asg = np.random.RandomState(2).randint(-1, 6, 40)
    jm, tm = _pair(X, 6, asg, seed=3)
    npt.assert_array_equal(_np(tm.random_means), np.asarray(jm.random_means))
    npt.assert_array_equal(_np(tm.state.counts), np.asarray(jm.state.counts))
    npt.assert_allclose(_np(tm.state.sum_x), np.asarray(jm.state.sum_x),
                        rtol=1e-12)
    means = _np(tm.means())
    npt.assert_allclose(means, np.asarray(jm.means()), rtol=1e-12)
    got = _np(tk.neg_sqrd_norms(tm.X, tm.means()))
    want = np.asarray(jax_norms(jm.X, jm.means()))
    npt.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    npt.assert_allclose(tm.sum_neg_sqrd_norm(), jm.sum_neg_sqrd_norm(),
                        rtol=1e-12)
    assert tm.K == jm.K and tm.get_n_assigned() == jm.get_n_assigned()
    ids = [3, 0, 17, 39]
    assert tm.get_max_assignments(ids) == [int(k) for k in
                                           jm.get_max_assignments(ids)]


def _init(mode, N, K):
    if mode == "partial":  # a vector with unassigned items
        return np.random.RandomState(7).randint(-1, K, N)
    return mode


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("consider_unassigned", [True, False])
@pytest.mark.parametrize("mode", ["rand", "spread", "each-in-own",
                                  "partial"])
def test_fit_matches_jax(mode, consider_unassigned, dtype):
    """``fit`` a step at a time from one state: float64 assignments,
    counts and records identical at every step (sums rtol 1e-12); float32
    assignments agree to ``F32_AGREE``."""
    N, K = 120, 8
    if mode == "each-in-own":
        N = K = 24
    X, _ = _gen(seed=5, N=N, D=3, K_true=5, spread=2.0, noise=1.2)
    X = X.astype(dtype)
    jm, tm = _pair(X, K, _init(mode, N, K), seed=6)
    for _ in range(20):
        rj = jm.fit(1, consider_unassigned)
        rt = tm.fit(1, consider_unassigned)
        a_j, a_t = np.asarray(jm.assignments), _np(tm.assignments)
        if dtype == "float64":
            npt.assert_array_equal(a_t, a_j)
            npt.assert_array_equal(_np(tm.state.counts),
                                   np.asarray(jm.state.counts))
            npt.assert_allclose(_np(tm.state.sum_x),
                                np.asarray(jm.state.sum_x), rtol=1e-12,
                                atol=1e-12)
            assert rt["n_mean_updates"] == rj["n_mean_updates"]
            assert rt["components"] == rj["components"]
            npt.assert_allclose(rt["sum_neg_sqrd_norm"],
                                rj["sum_neg_sqrd_norm"], rtol=1e-12)
        else:
            assert (a_t == a_j).mean() >= F32_AGREE
        if rj["n_mean_updates"][-1] == 0:
            break
    if not consider_unassigned:
        unassigned = _init(mode, N, K)
        if not isinstance(unassigned, str):
            assert (_np(tm.assignments)[unassigned < 0] == -1).all()


def test_view_mutators_match_jax():
    X, _ = _gen(N=15, D=2)
    asg = np.random.RandomState(1).randint(0, 4, 15)
    jm, tm = _pair(X, 6, asg, seed=2)
    for view in (jm.components, tm.components):
        view.del_item(4)
        view.add_item(4, 9)  # a new component: the first empty slot
        view.del_component(1)
    npt.assert_array_equal(_np(tm.assignments), np.asarray(jm.assignments))
    npt.assert_array_equal(_np(tm.state.counts), np.asarray(jm.state.counts))
    npt.assert_allclose(_np(tm.state.sum_x), np.asarray(jm.state.sum_x),
                        rtol=1e-12, atol=1e-15)


def test_kmeans_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.KMeans(np.zeros((3, 2)), 2, np.zeros(3, int))
    assert pt.KMeans(np.zeros((3, 2)), 2, np.zeros(3, int),
                     device="cpu").device.type == "cpu"
