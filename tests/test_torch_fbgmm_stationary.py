"""Level 1 of tests/test_exact_posterior.py (:66-106) on the port's own
noise, in all three families: the FBGMM's sequential sweep is exact
collapsed Gibbs, so its stationary distribution is the enumerated labelled
posterior P(z | X) (N 4, K 2: 16 states), within total variation 0.05
over 6000 sweeps.

Each component's marginal likelihood is the chain of its predictive
densities, as ``_log_marg_component`` forms it for the fixed-variance
family (D 1); the diag and full families chain the unigram oracles'
predictive densities (``tests/test_torch_exact_posterior_diag.py``,
``..._bigram_fullcov.py``; D 2).  The initial state agrees with the JAX
package's FBGMM built from the same arguments.  The CPU runs the diag
case here, the full one in ``tests/test_torch_fbgmm_stationary_full.py``
(each file within a worker's budget) and the fixed one as
``tests/test_torch_fbgmm_sampler.py::test_sequential_stationary_distribution``.
On a card
(``chip_smoke.py``, :data:`CARD_CASES`) each sweep is one launch of K10
(fixed; diag, its exact ``DiagExactChain`` policy) or K11 (full).
"""

import itertools
import time

import numpy as np
import numpy.testing as npt
from scipy.special import gammaln, logsumexp as lse

import segmentalist_torch as pt
from test_torch_exact_posterior_bigram_fullcov import (niw_pred_logpdf,
                                                       niw_prior)
from test_torch_exact_posterior_diag import diag_pred_logpdf, diag_prior
from torch_oracle import float_dtype, one_thread

VAR, MU0, VAR0 = 0.5, 0.0, 2.0  # the fixed-variance prior (D 1)
N, K, ALPHA = 4, 2, 1.0
X_FAMILY = {"fixed": [[-1.3], [-0.9], [1.1], [1.6]],
            "diag": [[-1.3, 0.4], [-0.9, 0.1], [1.1, -0.5], [1.6, -0.2]],
            "full": [[-1.3, 0.4], [-0.9, 0.1], [1.1, -0.5], [1.6, -0.2]]}


def _fixed_pred_logpdf(x, n, sum_x, sum_sq):
    prec, prec0 = 1.0 / VAR, 1.0 / VAR0
    prec_n = prec0 + n * prec
    mu_pred = (prec0 * MU0 + prec * sum_x[0]) / prec_n
    prec_pred = prec_n * prec / (prec_n + prec)
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec_pred)
            - 0.5 * prec_pred * (x[0] - mu_pred) ** 2)


PRED = {"fixed": _fixed_pred_logpdf, "diag": diag_pred_logpdf,
        "full": niw_pred_logpdf}


def _prior(cov, device):
    if cov == "fixed":
        dt = float_dtype(device)
        return pt.FixedVarPrior.create(*(np.full(1, v, dt)
                                         for v in (VAR, MU0, VAR0)))
    return (diag_prior if cov == "diag" else niw_prior)(device)


def _log_marg_component(cov, xs):
    """log p(x_1..x_n) of one component's members by predictive
    chaining."""
    D = xs.shape[1]
    lp, n, sx = 0.0, 0.0, np.zeros(D)
    sq = np.zeros((D, D) if cov == "full" else D)
    for x in xs:
        lp += PRED[cov](x, n, sx, sq)
        n += 1.0
        sx = sx + x
        sq = sq + (np.outer(x, x) if cov == "full" else x ** 2)
    return lp


def exact_posterior(cov, X):
    """The labelled posterior over the K^N assignment vectors."""
    states = list(itertools.product(range(K), repeat=N))
    logp = np.empty(len(states))
    for s_i, z in enumerate(states):
        z = np.array(z)
        counts = np.bincount(z, minlength=K)
        lpz = (gammaln(ALPHA) - gammaln(ALPHA + N)
               + sum(gammaln(c + ALPHA / K) - gammaln(ALPHA / K)
                     for c in counts))
        lpx = sum(_log_marg_component(cov, X[z == k]) for k in range(K)
                  if (z == k).any())
        logp[s_i] = lpz + lpx
    return states, np.exp(logp - lse(logp))


def stationary_model(cov, device="cpu"):
    X = np.array(X_FAMILY[cov], float_dtype(device))
    return pt.FBGMM(X, _prior(cov, device), alpha=ALPHA, K=K,
                    assignments=[0, 0, 1, 1], covariance_type=cov, seed=42,
                    device=device)


def stationary_case(cov, model, n_sweeps=6000, burn=200) -> dict:
    """6000 sequential sweeps (the first 200 burn-in) within total
    variation 0.05 of the enumerated posterior."""
    t0 = time.time()
    X = model.X.cpu().numpy().astype(np.float64)
    states, exact = exact_posterior(cov, X)
    index = {z: i for i, z in enumerate(states)}
    freq = np.zeros(len(states))
    with one_thread(model.device):
        for t in range(n_sweeps):
            model.sequential_sweep(1.0, True)
            if t >= burn:
                freq[index[tuple(model.assignments.tolist())]] += 1
    freq /= freq.sum()
    tv = 0.5 * np.abs(freq - exact).sum()
    assert tv < 0.05, (cov, tv, list(zip(states, exact.round(4),
                                         freq.round(4))))
    return {"tv": tv, "tv_max": 0.05, "trials": n_sweeps - burn,
            "seconds": time.time() - t0}


def card_case(cov):
    return lambda dev: stationary_case(cov, stationary_model(cov, dev))


CARD_CASES = {"fbgmm_stationary_" + cov: card_case(cov)
              for cov in ("fixed", "diag", "full")}


def anchored_model(cov):
    """The port's model on the CPU, its initial state checked against the
    JAX package's FBGMM built from the same arguments."""
    import jax

    import segmentalist_tpu as jtpu

    model = stationary_model(cov)
    jprior = (jtpu.FixedVarPrior if cov == "fixed" else jtpu.NIW).create(
        *(t.numpy() for t in model.prior))
    jmodel = jtpu.FBGMM(model.X.numpy(), jprior, alpha=ALPHA, K=K,
                        assignments=[0, 0, 1, 1], covariance_type=cov,
                        key=jax.random.PRNGKey(42))
    for got, want in ((model.assignments, jmodel.assignments),
                      *zip(model.stats, jmodel.stats)):
        npt.assert_array_equal(got.numpy(), np.asarray(want))
    return model


def test_diag_sequential_stationary_distribution():
    stationary_case("diag", anchored_model("diag"))
