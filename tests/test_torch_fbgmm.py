"""The port's FBGMM constructor against the JAX package's.

Both packages build an ``FBGMM`` (and a ``BigramFBGMM``) from the same data
after the same ``np.random.seed``: the "rand" assignments come from numpy's
global state in both, "each-in-own" gives every item its own component.
Assignments and counts are identical; the sums agree to float64 rounding
(the JAX package sums by a one-hot matrix product, the port by index
order).
"""

import numpy as np
import numpy.testing as npt
import pytest

import segmentalist_tpu as jtpu
from segmentalist_tpu.models.bigram_fbgmm import BigramFBGMM as JaxBigramFBGMM

import segmentalist_torch as pt
from segmentalist_torch.models.bigram_fbgmm import BigramFBGMM

N, D, K = 9, 3, 12


def _prior(pkg, cov):
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.5 * np.ones(D), np.zeros(D),
                                        np.ones(D))
    S_0 = 0.4 * np.ones(D) if cov == "diag" else 0.4 * np.eye(D)
    return pkg.NIW.create(0.1 * np.ones(D), 0.5, D + 3.0, S_0)


def _same_state(jam, tam):
    npt.assert_array_equal(np.asarray(jam.assignments),
                           tam.assignments.numpy())
    npt.assert_array_equal(np.asarray(jam.stats.counts),
                           tam.stats.counts.numpy())
    for a, b in ((jam.stats.sum_x, tam.stats.sum_x),
                 (jam.stats.sum_sq, tam.stats.sum_sq)):
        npt.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13, atol=1e-13)


def _data():
    return np.random.RandomState(0).randn(N, D)


@pytest.mark.parametrize("cov", ["fixed", "diag", "full"])
@pytest.mark.parametrize("mode", [None, "rand", "each-in-own"])
def test_fbgmm_assignment_modes_match_jax(mode, cov):
    """``assignments`` defaults to "rand" (reference fbgmm.py:118) and takes
    "each-in-own" (fbgmm.py:142-146)."""
    X = _data()
    kw = {} if mode is None else {"assignments": mode}
    np.random.seed(11)
    jam = jtpu.FBGMM(X, _prior(jtpu, cov), 1.0, K, covariance_type=cov, **kw)
    np.random.seed(11)
    tam = pt.FBGMM(X, _prior(pt, cov), 1.0, K, covariance_type=cov,
                   device="cpu", **kw)
    _same_state(jam, tam)
    if mode == "each-in-own":
        npt.assert_array_equal(tam.assignments.numpy(), np.arange(N))


@pytest.mark.parametrize("cov", ["fixed", "diag"])
def test_bigram_fbgmm_defaults_to_rand(cov):
    """BigramFBGMM's ``assignments`` defaults to "rand" (reference
    bigram_fbgmm.py:22)."""
    X = _data()
    np.random.seed(12)
    jam = JaxBigramFBGMM(X, _prior(jtpu, cov), K, covariance_type=cov)
    np.random.seed(12)
    tam = BigramFBGMM(X, _prior(pt, cov), K, covariance_type=cov,
                      device="cpu")
    _same_state(jam, tam)


def test_fbgmm_keeps_decollide_new():
    X = _data()
    prior = _prior(pt, "fixed")
    am = pt.FBGMM(X, prior, 1.0, K, covariance_type="fixed", device="cpu")
    assert am.decollide_new is True
    am = pt.FBGMM(X, prior, 1.0, K, covariance_type="fixed",
                  decollide_new=False, device="cpu")
    assert am.decollide_new is False


def test_fbgmm_setup_components_takes_the_modes():
    """``setup_components`` takes the modes too, after construction."""
    X = _data()
    am = pt.FBGMM(X, _prior(pt, "fixed"), 1.0, K, np.zeros(N, np.int64),
                  covariance_type="fixed", device="cpu")
    am.setup_components(N, "each-in-own")
    npt.assert_array_equal(am.assignments.numpy(), np.arange(N))
    npt.assert_array_equal(am.stats.counts.numpy(), np.ones(N))
