"""tests/test_blocked_sweep_oracle.py's oracle on the port's own noise: one
blocked sweep of the FBGMM.

Every item is scored against the sweep-start frozen statistics with its
own contribution left out of its current column (reference fbgmm.py:367),
drawn independently by Gumbel-max, and an empty-slot draw is put in the
first frozen-empty slot: the sweep's joint distribution is an exact
per-item product, enumerated here from first principles in numpy, and the
frequencies of 4000 sweeps from one state, drawn with the model's own
generator, must match it.  The state is the JAX test's (both packages
build it from the same assignments; the test checks that they agree).
``chip_smoke.py`` runs :data:`CARD_CASES` on a card (the blocked sweep is
plain tensor code there too).
"""

import itertools
import time
from collections import Counter

import numpy as np
import numpy.testing as npt
from scipy.special import logsumexp as lse

import segmentalist_torch as pt
from torch_oracle import check_frequencies, one_thread

VAR, MU0, VAR0 = 0.5, 0.1, 2.0
ALPHA = 1.5
N, K = 3, 3
X_ITEMS = [[0.8], [-0.5], [0.6]]
INIT = [0, 1, 0]  # slot 2 empty at the sweep's start


def _pred_logpdf(x, n, sum_x):
    prec, prec0 = 1.0 / VAR, 1.0 / VAR0
    prec_n = prec0 + n * prec
    mu_pred = (prec0 * MU0 + prec * sum_x) / prec_n
    prec_pred = prec_n * prec / (prec_n + prec)
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec_pred)
            - 0.5 * prec_pred * (x - mu_pred) ** 2)


def blocked_model(device="cpu"):
    """The JAX test's FBGMM (float32 data and prior, as there) on the
    port."""
    f32 = np.float32
    prior = pt.FixedVarPrior.create(*(np.full(1, v, f32)
                                      for v in (VAR, MU0, VAR0)))
    return pt.FBGMM(np.array(X_ITEMS, f32), prior, ALPHA, K,
                    np.array(INIT), covariance_type="fixed", device=device)


def _exact_sweep(fb):
    """The sweep's joint distribution: a product of per-item outcome
    distributions, each from the frozen statistics."""
    X = fb.X.cpu().numpy().astype(np.float64)
    counts = fb.stats.counts.cpu().numpy().astype(float)
    sum_x = fb.stats.sum_x.cpu().numpy()[:, 0].astype(float)
    first_empty = int(np.flatnonzero(counts == 0)[0])
    per_item = np.zeros((N, K))
    for i in range(N):
        logits = []
        for k in range(K):
            c, sx = counts[k], sum_x[k]
            if INIT[i] == k:  # own contribution left out of own column
                c, sx = c - 1, sx - X[i, 0]
            w = np.log(ALPHA / K + c)
            pred = (_pred_logpdf(X[i, 0], c, sx) if c > 0
                    else _pred_logpdf(X[i, 0], 0.0, 0.0))
            logits.append(w + pred)
        p = np.exp(logits - lse(logits))
        # empty-slot draws (of the frozen counts) go to the first empty
        q = np.zeros(K)
        for k in range(K):
            q[first_empty if counts[k] == 0 else k] += p[k]
        per_item[i] = q
    return {ks: np.prod([per_item[i, k] for i, k in enumerate(ks)])
            for ks in itertools.product(range(K), repeat=N)}


def blocked_case(fb, n_trials=4000) -> dict:
    """4000 blocked sweeps from one state within total variation 0.05 of
    the exact product, every outcome of mass above 0.005 within 5
    sigma."""
    t0 = time.time()
    exact = _exact_sweep(fb)
    stats0, assign0 = fb.stats, fb.assignments.clone()
    freq = Counter()
    with one_thread(fb.device):
        for _ in range(n_trials):
            fb.stats, fb.assignments = stats0, assign0
            fb.gibbs_sample(1, mode="blocked")
            freq[tuple(fb.assignments.tolist())] += 1
    tv = check_frequencies(exact, freq, n_trials, 0.05)
    return {"tv": tv, "tv_max": 0.05, "trials": n_trials,
            "seconds": time.time() - t0}


CARD_CASES = {"fbgmm_blocked": lambda dev: blocked_case(blocked_model(dev))}


def test_blocked_sweep_matches_exact_product():
    from segmentalist_tpu import FBGMM, FixedVarPrior

    f32 = np.float32
    jfb = FBGMM(np.array(X_ITEMS, f32),
                FixedVarPrior.create(*(np.full(1, v, f32)
                                       for v in (VAR, MU0, VAR0))),
                ALPHA, K, np.array(INIT), covariance_type="fixed")
    fb = blocked_model()
    for got, want in ((fb.assignments, jfb.assignments),
                      *zip(fb.stats, jfb.stats)):
        npt.assert_array_equal(got.numpy(), np.asarray(want))
    blocked_case(fb)
