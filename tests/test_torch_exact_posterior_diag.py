"""tests/test_exact_posterior_diag.py's oracles on the port's own noise:
the diag-covariance move.

A tiny corpus where one ``gibbs_sample_i(0)`` move's outcome distribution
(segmentation x assignments) is enumerable, with the
normal-inverse-chi-squared posterior-predictive algebra -- products of
univariate Student-t densities from raw moment statistics (reference
``gaussian_components_diag.py:237-259, :347-360``) -- computed from
scratch in numpy.  The move draws with the segmenter's own generator, and
starts from the JAX test's state, carried across by
``interop.load_state``.  ``chip_smoke.py`` runs :data:`CARD_CASES` on a
card, where the move runs K5 (its grouped composition in the sampled DP,
its exact one in the Viterbi DP), K2 and K6.
"""

import itertools

import numpy as np
from scipy.special import gammaln, logsumexp as lse

import segmentalist_torch as pt
from torch_oracle import (anchored, float_dtype, leave_out_moments, tri,
                          transition_case, viterbi_case)

D_D = 2
K0_D, V0_D = 1.2, 4.0
ALPHA_D = 1.0
K = 2

_PATTERNS2 = {  # boundary pair -> segments (start, end exclusive)
    (0, 1): [(0, 2)],
    (1, 1): [(0, 1), (1, 2)],
}


def _pattern_embeds2(pattern):
    return [tri(e, s) for s, e in _PATTERNS2[pattern]]


def _diag_params():
    m_0 = np.array([0.15, -0.3])
    S_0 = np.array([0.8, 1.3])
    return m_0, S_0


def _t_logpdf(x, mu, var, v):
    """Univariate Student-t with dof v, location mu, scale^2 var."""
    dev2 = (x - mu) ** 2 / var
    return (gammaln((v + 1.0) / 2.0) - gammaln(v / 2.0)
            - 0.5 * np.log(v) - 0.5 * np.log(np.pi) - 0.5 * np.log(var)
            - (v + 1.0) / 2.0 * np.log1p(dev2 / v))


def diag_pred_logpdf(x, n, sum_x, sum_sq):
    """Normal-inverse-chi-squared posterior predictive from raw per-dim
    statistics: a product of univariate Student-t's (reference
    gaussian_components_diag.py:237-259)."""
    m_0, S_0 = _diag_params()
    k_n = K0_D + n
    v_n = V0_D + n
    m_n = (K0_D * m_0 + sum_x) / k_n
    s_n = S_0 + K0_D * m_0 ** 2 + sum_sq - k_n * m_n ** 2
    var = (k_n + 1.0) / (k_n * v_n) * s_n
    return sum(_t_logpdf(x[d], m_n[d], var[d], v_n) for d in range(D_D))


def diag_pred(x, k, c, sx, sq):
    """Slot k's predictive density of x under statistics (c, sx, sq); an
    empty slot's is the prior predictive."""
    if c[k] > 0:
        return diag_pred_logpdf(x, c[k], sx[k], sq[k])
    return diag_pred_logpdf(x, 0.0, np.zeros(D_D), np.zeros(D_D))


def diag_prior(device="cpu"):
    m_0, S_0 = _diag_params()
    dt = float_dtype(device)
    return pt.NIW.create(m_0.astype(dt), K0_D, V0_D, S_0.astype(dt))


def diag_segmenter(device="cpu"):
    """The JAX test's ``_build_diag_segmenter`` on the port: two
    utterances of 2 landmarks (3 spans each), K 2, D 2."""
    dt = float_dtype(device)
    rng = np.random.RandomState(17)
    emb0 = (rng.randn(3, D_D) * 1.1).astype(dt)
    emb1 = (rng.randn(3, D_D) * 0.9).astype(dt)
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=ALPHA_D, am_K=K, am_param_prior=diag_prior(device),
        embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(3), "u1": np.arange(3)},
        durations_dict={"u0": [1, 2, 1], "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2], "u1": [1, 2]}, covariance_type="diag",
        p_boundary_init=0.5, beta_sent_boundary=-1, n_slices_max=2,
        time_power_term=0.0, wip=0.0, batch_size=1, seed=23, device=device)
    return seg, emb0.astype(np.float64)


def _cand_scores(seg, emb0):
    """Per-segmentation log scores with utterance 0 left out, and the
    leave-out statistics."""
    lo_c, lo_sx, lo_sq = leave_out_moments(seg)

    def cand_score(e):
        x = emb0[e]
        return lse([np.log(ALPHA_D / K + lo_c[k])
                    - np.log(lo_c.sum() + ALPHA_D)
                    + diag_pred(x, k, lo_c, lo_sx, lo_sq) for k in range(K)])

    return ({p: sum(cand_score(e) for e in _pattern_embeds2(p))
             for p in _PATTERNS2}, lo_c, lo_sx, lo_sq)


def _exact_diag_move_kernel(seg, emb0):
    """Enumerate the gibbs_sample_i(0) outcome distribution with all the
    inverse-chi-squared algebra (leave-out statistics, predictive
    chaining) done directly on raw per-dim moment statistics."""
    seg_logp, lo_c, lo_sx, lo_sq = _cand_scores(seg, emb0)
    z = lse(list(seg_logp.values()))
    probs = {}
    for p in _PATTERNS2:
        embeds = _pattern_embeds2(p)
        for ks in itertools.product(range(K), repeat=len(embeds)):
            c, sx, sq = lo_c.copy(), lo_sx.copy(), lo_sq.copy()
            lp_chain = 0.0
            for e, k in zip(embeds, ks):
                x = emb0[e]
                logits = [np.log(ALPHA_D / K + c[kk])
                          + diag_pred(x, kk, c, sx, sq) for kk in range(K)]
                lp_chain += logits[k] - lse(logits)
                c[k] += 1
                sx[k] += x
                sq[k] += x ** 2
            probs[(p, ks)] = np.exp(seg_logp[p] - z + lp_chain)
    return probs


def diag_case(seg, emb0, n_trials=4000) -> dict:
    """4000 moves within total variation 0.04 of the enumerated kernel,
    every outcome of mass above 0.005 within 5 sigma."""
    exact = _exact_diag_move_kernel(seg, emb0)
    return transition_case(seg, exact, lambda: seg.gibbs_sample_i(0), 2,
                           _pattern_embeds2, n_trials, 0.04)


def diag_viterbi_case(seg, emb0) -> dict:
    """``fb_type="viterbi"`` with diag is deterministic: the argmax-score
    segmentation under the exact per-dimension Student-t scores, then MAP
    assignments with chained statistics (map_assign_i omits the lms
    scaling and the weight denominator, reference fbgmm.py:465-494)."""
    seg.set_fb_type("viterbi")
    seg_logp, c, sx, sq = _cand_scores(seg, emb0)
    best_p = max(_PATTERNS2, key=seg_logp.get)
    best_ks = []
    for e in _pattern_embeds2(best_p):
        x = emb0[e]
        k = int(np.argmax([np.log(ALPHA_D / K + c[kk])
                           + diag_pred(x, kk, c, sx, sq)
                           for kk in range(K)]))
        best_ks.append(k)
        c[k] += 1
        sx[k] += x
        sq[k] += x ** 2
    return viterbi_case(seg, (best_p, tuple(best_ks)), 2, _pattern_embeds2)


CARD_CASES = {
    "unigram_diag": lambda dev: diag_case(*diag_segmenter(dev)),
    "unigram_diag_viterbi": lambda dev: diag_viterbi_case(
        *diag_segmenter(dev)),
}


def _anchored():
    return anchored("test_exact_posterior_diag", "_build_diag_segmenter",
                    diag_segmenter)


def test_diag_single_move_transition_kernel():
    diag_case(*_anchored())


def test_diag_viterbi_move_matches_argmax_oracle():
    diag_viterbi_case(*_anchored())
