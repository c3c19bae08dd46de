"""tests/test_exact_posterior_bigram_fullcov.py's oracles on the port's own
noise: the bigram-conditioned move with the LM leave-out and own-pair
corrections, and the full-NIW touched-slot move.

Each enumerates one ``gibbs_sample_i(0)`` move's outcome distribution
(segmentation x assignments) from first principles in numpy -- the LM
count corrections (reference ``bigram_acoustic_wordseg.py:332-384``, count
removal :410 / :496) and the NIW posterior-predictive algebra (reference
``gaussian_components.py:228-251``) -- and holds 4000 moves drawn with
the segmenter's own generator to it.  Each starts from the JAX test's
state, carried across by ``interop.load_state``.  The bigram enumeration
takes the acoustic predictive density as an argument
(:func:`exact_bigram_move_kernel`), so that
``tests/test_torch_exact_posterior_bigram_{diag,full}.py`` compose it with
the diag and full densities.  ``chip_smoke.py`` runs :data:`CARD_CASES` on a
card: the bigram move through K1, K2 and K4, the full one through K8, K2
and K9.
"""

import itertools

import numpy as np
from scipy.special import gammaln, logsumexp as lse

import segmentalist_torch as pt
from torch_oracle import (anchored, float_dtype, leave_out_moments, tri,
                          transition_case, viterbi_case)

VAR, MU0, VAR0 = 0.5, 0.0, 2.0  # fixed-variance prior (D 1)
K = 2


def _pred_logpdf(x, n, sum_x):
    prec, prec0 = 1.0 / VAR, 1.0 / VAR0
    prec_n = prec0 + n * prec
    mu_pred = (prec0 * MU0 + prec * sum_x) / prec_n
    prec_pred = prec_n * prec / (prec_n + prec)
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec_pred)
            - 0.5 * prec_pred * (x - mu_pred) ** 2)


def _prior_logpdf(x):
    prec0 = 1.0 / VAR0
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec0)
            - 0.5 * prec0 * (x - MU0) ** 2)


def fixedvar_pred(x, k, c, sx, sq):
    """Slot k's fixed-variance predictive density of x (D 1); an empty
    slot's is the reference's prior-density quirk."""
    if c[k] > 0:
        return _pred_logpdf(x[0], c[k], sx[k][0])
    return _prior_logpdf(x[0])


# -------------------------------------------------------------------------
# Bigram move: LM leave-out + own-pair corrections, from first principles.

_PATTERNS3 = {  # boundary triple -> segments (start, end exclusive)
    (0, 0, 1): [(0, 3)],
    (1, 0, 1): [(0, 1), (1, 3)],
    (0, 1, 1): [(0, 2), (2, 3)],
    (1, 1, 1): [(0, 1), (1, 2), (2, 3)],
}

LAM, A_S, B_S = 0.3, 1.5, 2.0  # intrp_lambda, a, b
LM_PARAMS = {"type": "smooth", "intrp_lambda": LAM, "a": A_S, "b": B_S}


def pattern_embeds3(pattern):
    return [tri(e, s) for s, e in _PATTERNS3[pattern]]


def bigram_segmenter(device="cpu", prior=None, emb=None, cov="fixed"):
    """The JAX test's ``_build_bigram_segmenter`` on the port: utterance 0
    has 3 landmarks and all 6 spans embedded, utterance 1 2 landmarks (3
    spans, so that its segmentation gives real unigram and bigram context
    counts).  ``prior``, ``emb`` (utterance 0's and 1's embeddings) and
    ``cov`` put another family on the same layout."""
    dt = float_dtype(device)
    if emb is None:
        emb = (np.random.RandomState(5).randn(6, 1) * 1.2,
               np.array([[0.4], [-0.8], [1.0]]))
        prior = pt.FixedVarPrior.create(*(np.full(1, v, dt)
                                          for v in (VAR, MU0, VAR0)))
    emb0, emb1 = (e.astype(dt) for e in emb)
    seg = pt.BigramAcousticWordseg(
        am_K=K, am_param_prior=prior, lm_params=LM_PARAMS,
        embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(6), "u1": np.arange(3)},
        durations_dict={"u0": [1, 2, 1, 3, 2, 1], "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2, 3], "u1": [1, 2]},
        covariance_type=cov, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=3, time_power_term=0.0, wip=0.0, batch_size=1, seed=11,
        fb_type="unigram", device=device)
    return seg, emb0.astype(np.float64)


def _transcripts(seg):
    """[utt][token] component transcript of the current segmentation."""
    assigns = seg.acoustic_model.assignments.cpu().numpy()
    utt = seg.utterances
    return [[int(assigns[e]) for e in utt.get_segmented_embeds_i(i)
             if e != -1] for i in range(utt.D)]


def exact_bigram_move_kernel(seg, emb0, pred, full=False):
    """Enumerate P(new boundaries, new assignments) of one
    gibbs_sample_i(0) move from the current state, from first principles:
    the LM counts (unigram + bigram tables) are recomputed from the
    transcripts, utterance 0's unigram counts are removed before scoring
    (reference :410) and its own OLD bigram pairs are removed on the fly
    inside the chain conditional (reference :361-368).  ``pred(x, k, c,
    sx, sq)`` is slot k's acoustic predictive density (``full``: sq holds
    outer products)."""
    assignments = seg.acoustic_model.assignments.cpu().numpy()
    trans = _transcripts(seg)
    uni = np.zeros(K)
    big = np.zeros((K, K))
    for t in trans:
        for k in t:
            uni[k] += 1
        for j, i in zip(t[:-1], t[1:]):
            big[j, i] += 1
    lo_c, lo_sx, lo_sq = leave_out_moments(seg, full)
    lo_uni = uni.copy()
    for e in seg.utterances.get_segmented_embeds_i(0):
        if e != -1:
            lo_uni[assignments[e]] -= 1
    own_pairs = list(zip(trans[0][:-1], trans[0][1:]))

    def uni_w(k):
        return np.log(lo_uni[k] + A_S / K) - np.log(lo_uni.sum() + A_S)

    def cand_score(e):
        """Unigram-marginal candidate score with leave-out LM weights
        (reference get_vec_embed_log_probs_unigram, :673-692)."""
        return lse([uni_w(k) + pred(emb0[e], k, lo_c, lo_sx, lo_sq)
                    for k in range(K)])

    seg_logp = {p: sum(cand_score(e) for e in pattern_embeds3(p))
                for p in _PATTERNS3}
    z = lse(list(seg_logp.values()))
    uni_prob = (lo_uni + A_S / K) / (lo_uni.sum() + A_S)

    def chain_weight(k, j_prev):
        if j_prev < 0:
            return uni_w(k)
        row = big[j_prev, k] - sum(
            1.0 for (j, i) in own_pairs if j == j_prev and i == k)
        return np.log(LAM * uni_prob[k] + (1.0 - LAM) * (row + B_S / K)
                      / (lo_uni[j_prev] + B_S))

    probs = {}
    for p in _PATTERNS3:
        embeds = pattern_embeds3(p)
        for ks in itertools.product(range(K), repeat=len(embeds)):
            c, sx, sq = lo_c.copy(), lo_sx.copy(), lo_sq.copy()
            j_prev = -1
            lp_chain = 0.0
            for e, k in zip(embeds, ks):
                x = emb0[e]
                logits = [chain_weight(kk, j_prev) + pred(x, kk, c, sx, sq)
                          for kk in range(K)]
                lp_chain += logits[k] - lse(logits)
                c[k] += 1
                sx[k] += x
                sq[k] += np.outer(x, x) if full else x ** 2
                j_prev = k
            probs[(p, ks)] = np.exp(seg_logp[p] - z + lp_chain)
    return probs


def bigram_case(seg, emb0, pred=fixedvar_pred, full=False,
                n_trials=4000) -> dict:
    """4000 moves within total variation 0.05 of the enumerated kernel,
    every outcome of mass above 0.005 within 5 sigma."""
    exact = exact_bigram_move_kernel(seg, emb0, pred, full)
    return transition_case(seg, exact, lambda: seg.gibbs_sample_i(0), 3,
                           pattern_embeds3, n_trials, 0.05)


# -------------------------------------------------------------------------
# Full-NIW move: touched-slot machinery vs a from-scratch NIW oracle.

D_F = 2
K0_F, V0_F = 1.0, float(D_F) + 2.0
ALPHA_F = 1.0

_PATTERNS2 = {
    (0, 1): [(0, 2)],
    (1, 1): [(0, 1), (1, 2)],
}


def _pattern_embeds2(pattern):
    return [tri(e, s) for s, e in _PATTERNS2[pattern]]


def _niw_params():
    m_0 = np.array([0.1, -0.2])
    S_0 = np.eye(D_F) + 0.15 * np.ones((D_F, D_F))
    return m_0, S_0


def _mvt_logpdf(x, mu, covar, v):
    dev = x - mu
    inv = np.linalg.inv(covar)
    _, logdet = np.linalg.slogdet(covar)
    maha = dev @ inv @ dev
    return (gammaln((v + D_F) / 2.0) - gammaln(v / 2.0)
            - D_F / 2.0 * np.log(v) - D_F / 2.0 * np.log(np.pi)
            - 0.5 * logdet - (v + D_F) / 2.0 * np.log1p(maha / v))


def niw_pred_logpdf(x, n, sum_x, sum_sq):
    """NIW posterior predictive from raw statistics (reference
    gaussian_components.py:161-167, :216-251)."""
    m_0, S_0 = _niw_params()
    k_n = K0_F + n
    v_n = V0_F + n
    m_n = (K0_F * m_0 + sum_x) / k_n
    S_n = (S_0 + K0_F * np.outer(m_0, m_0) + sum_sq
           - k_n * np.outer(m_n, m_n))
    v = v_n - D_F + 1.0
    covar = (k_n + 1.0) / (k_n * v) * S_n
    return _mvt_logpdf(x, m_n, covar, v)


def niw_pred(x, k, c, sx, sq):
    """Slot k's NIW predictive density of x; an empty slot's is the prior
    predictive."""
    if c[k] > 0:
        return niw_pred_logpdf(x, c[k], sx[k], sq[k])
    return niw_pred_logpdf(x, 0.0, np.zeros(D_F), np.zeros((D_F, D_F)))


def niw_prior(device="cpu"):
    m_0, S_0 = _niw_params()
    dt = float_dtype(device)
    return pt.NIW.create(m_0.astype(dt), K0_F, V0_F, S_0.astype(dt))


def fullcov_segmenter(device="cpu"):
    """The JAX test's ``_build_fullcov_segmenter`` on the port: two
    utterances of 2 landmarks, K 2, D 2."""
    dt = float_dtype(device)
    rng = np.random.RandomState(9)
    emb0 = (rng.randn(3, D_F) * 1.1).astype(dt)
    emb1 = (rng.randn(3, D_F) * 0.9).astype(dt)
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=ALPHA_F, am_K=K, am_param_prior=niw_prior(device),
        embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(3), "u1": np.arange(3)},
        durations_dict={"u0": [1, 2, 1], "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2], "u1": [1, 2]}, covariance_type="full",
        p_boundary_init=0.5, beta_sent_boundary=-1, n_slices_max=2,
        time_power_term=0.0, wip=0.0, batch_size=1, seed=13, device=device)
    return seg, emb0.astype(np.float64)


def _full_cand_scores(seg, emb0):
    lo_c, lo_sx, lo_sq = leave_out_moments(seg, full=True)

    def cand_score(e):
        x = emb0[e]
        return lse([np.log(ALPHA_F / K + lo_c[k])
                    - np.log(lo_c.sum() + ALPHA_F)
                    + niw_pred(x, k, lo_c, lo_sx, lo_sq) for k in range(K)])

    return ({p: sum(cand_score(e) for e in _pattern_embeds2(p))
             for p in _PATTERNS2}, lo_c, lo_sx, lo_sq)


def _exact_fullcov_move_kernel(seg, emb0):
    """Enumerate the gibbs_sample_i(0) outcome distribution with all NIW
    algebra (leave-out statistics, predictive chaining) done directly on
    raw moment statistics -- independent of the touched-component
    machinery under test (segmenters/fullcov.py)."""
    seg_logp, lo_c, lo_sx, lo_sq = _full_cand_scores(seg, emb0)
    z = lse(list(seg_logp.values()))
    probs = {}
    for p in _PATTERNS2:
        embeds = _pattern_embeds2(p)
        for ks in itertools.product(range(K), repeat=len(embeds)):
            c, sx, sq = lo_c.copy(), lo_sx.copy(), lo_sq.copy()
            lp_chain = 0.0
            for e, k in zip(embeds, ks):
                x = emb0[e]
                logits = [np.log(ALPHA_F / K + c[kk])
                          + niw_pred(x, kk, c, sx, sq) for kk in range(K)]
                lp_chain += logits[k] - lse(logits)
                c[k] += 1
                sx[k] += x
                sq[k] += np.outer(x, x)
            probs[(p, ks)] = np.exp(seg_logp[p] - z + lp_chain)
    return probs


def fullcov_case(seg, emb0, n_trials=4000) -> dict:
    """4000 moves within total variation 0.05 of the enumerated kernel,
    every outcome of mass above 0.005 within 5 sigma."""
    exact = _exact_fullcov_move_kernel(seg, emb0)
    return transition_case(seg, exact, lambda: seg.gibbs_sample_i(0), 2,
                           _pattern_embeds2, n_trials, 0.05)


def fullcov_viterbi_case(seg, emb0) -> dict:
    """``fb_type="viterbi"`` with the full-NIW family is deterministic:
    argmax-score segmentation, then MAP chained assignments (map_assign_i
    omits the lms scaling and the weight denominator, reference
    fbgmm.py:465-494)."""
    seg.set_fb_type("viterbi")
    seg_logp, c, sx, sq = _full_cand_scores(seg, emb0)
    best_p = max(_PATTERNS2, key=seg_logp.get)
    best_ks = []
    for e in _pattern_embeds2(best_p):
        x = emb0[e]
        k = int(np.argmax([np.log(ALPHA_F / K + c[kk])
                           + niw_pred(x, kk, c, sx, sq)
                           for kk in range(K)]))
        best_ks.append(k)
        c[k] += 1
        sx[k] += x
        sq[k] += np.outer(x, x)
    return viterbi_case(seg, (best_p, tuple(best_ks)), 2, _pattern_embeds2)


CARD_CASES = {
    "bigram": lambda dev: bigram_case(*bigram_segmenter(dev)),
    "unigram_full": lambda dev: fullcov_case(*fullcov_segmenter(dev)),
    "unigram_full_viterbi": lambda dev: fullcov_viterbi_case(
        *fullcov_segmenter(dev)),
}


def _anchored(jax_builder, port_builder):
    return anchored("test_exact_posterior_bigram_fullcov", jax_builder,
                    port_builder)


def test_bigram_single_move_transition_kernel():
    bigram_case(*_anchored("_build_bigram_segmenter", bigram_segmenter))


def test_fullcov_single_move_transition_kernel():
    fullcov_case(*_anchored("_build_fullcov_segmenter", fullcov_segmenter))


def test_fullcov_viterbi_move_matches_argmax_oracle():
    fullcov_viterbi_case(*_anchored("_build_fullcov_segmenter",
                                    fullcov_segmenter))
