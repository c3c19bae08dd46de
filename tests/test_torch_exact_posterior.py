"""Level 2 of tests/test_exact_posterior.py (:202-237) on the port's own
noise: one ``gibbs_sample_i(0)`` move of the unigram segmenter (boundary
resampling, then the sequential assignment chain) has an enumerable
transition distribution from a fixed state (4 segmentations x at most 2^3
assignments); the frequencies over 4000 independent moves from that state
must match it.  Shared-noise parity cannot see a fault in the port's own
noise draws; this test can."""

import itertools

import numpy as np
import torch
from scipy.special import logsumexp as lse

import segmentalist_torch as pt

VAR, MU0, VAR0 = 0.5, 0.0, 2.0  # fixed-variance prior (D 1)


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


def _tri(t_excl, start):
    return t_excl * (t_excl - 1) // 2 + start


_PATTERNS = {  # boundary triple -> segments (start, end exclusive)
    (0, 0, 1): [(0, 3)],
    (1, 0, 1): [(0, 1), (1, 3)],
    (0, 1, 1): [(0, 2), (2, 3)],
    (1, 1, 1): [(0, 1), (1, 2), (2, 3)],
}


def _pattern_embeds(pattern):
    return [_tri(e, s) for s, e in _PATTERNS[pattern]]


def _segmenter():
    """Utterance 0: 3 landmarks, all 6 spans embedded; utterance 1: one
    landmark (the held-out context)."""
    rng = np.random.RandomState(5)
    emb0 = rng.randn(6, 1) * 1.2
    prior = pt.FixedVarPrior.create(VAR * np.ones(1), MU0 * np.ones(1),
                                    VAR0 * np.ones(1))
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=2, am_param_prior=prior,
        embedding_mats={"u0": emb0, "u1": np.array([[0.4]])},
        vec_ids_dict={"u0": np.arange(6), "u1": np.array([0])},
        durations_dict={"u0": [1, 2, 1, 3, 2, 1], "u1": [1]},
        landmarks_dict={"u0": [1, 2, 3], "u1": [1]}, p_boundary_init=0.5,
        beta_sent_boundary=-1, n_slices_max=3, time_power_term=0.0, wip=0.0,
        batch_size=1, seed=7, device="cpu")
    return seg, emb0


def _exact_move_kernel(seg, emb0):
    """P(new boundaries, new assignments) of one move of utterance 0 from
    the segmenter's current state, from first principles."""
    alpha, K = 1.0, 2
    am = seg.acoustic_model
    counts = am.stats.counts.numpy().astype(float)
    sum_x = am.stats.sum_x.numpy()[:, 0].astype(float)
    assignments = am.assignments.numpy()
    lo_counts, lo_sum_x = counts.copy(), sum_x.copy()
    for e in seg.utterances.get_segmented_embeds_i(0):
        if e != -1:
            lo_counts[assignments[e]] -= 1
            lo_sum_x[assignments[e]] -= emb0[e, 0]

    def cand_score(e):
        x = emb0[e, 0]
        terms = [np.log(alpha / K + lo_counts[k])
                 - np.log(lo_counts.sum() + alpha)
                 + (_pred_logpdf(x, lo_counts[k], lo_sum_x[k])
                    if lo_counts[k] > 0 else _prior_logpdf(x))
                 for k in range(K)]
        return lse(terms)

    seg_logp = {p: sum(cand_score(e) for e in _pattern_embeds(p))
                for p in _PATTERNS}
    z = lse(list(seg_logp.values()))
    probs = {}
    for p in _PATTERNS:
        embeds = _pattern_embeds(p)
        for ks in itertools.product(range(K), repeat=len(embeds)):
            c, sx = lo_counts.copy(), lo_sum_x.copy()
            lp_chain = 0.0
            for e, k in zip(embeds, ks):
                x = emb0[e, 0]
                logits = [np.log(alpha / K + c[kk])
                          + (_pred_logpdf(x, c[kk], sx[kk]) if c[kk] > 0
                             else _prior_logpdf(x)) for kk in range(K)]
                lp_chain += logits[k] - lse(logits)
                c[k] += 1
                sx[k] += x
            probs[(p, ks)] = np.exp(seg_logp[p] - z + lp_chain)
    return probs


def test_unigram_single_move_transition_kernel():
    seg, emb0 = _segmenter()
    am, utt = seg.acoustic_model, seg.utterances
    exact = _exact_move_kernel(seg, emb0)
    assert abs(sum(exact.values()) - 1.0) < 1e-9
    stats0, pad0 = am.stats, am._assign_pad.clone()
    bounds0 = utt.boundaries_dev.clone()
    n_trials = 4000
    freq = {key: 0 for key in exact}
    for _ in range(n_trials):
        am.stats, am._assign_pad = stats0, pad0.clone()
        utt.boundaries_dev = bounds0.clone()
        seg.gibbs_sample_i(0)
        bounds = tuple(utt.boundaries_dev[0, :3].to(torch.int64).tolist())
        ks = tuple(int(am.assignments[e]) for e in _pattern_embeds(bounds))
        freq[(bounds, ks)] += 1
    emp = {key: v / n_trials for key, v in freq.items()}
    tv = 0.5 * sum(abs(emp[key] - exact[key]) for key in exact)
    assert tv < 0.04, (tv, sorted(((key, round(exact[key], 4),
                                    round(emp[key], 4)) for key in exact),
                                  key=lambda r: -r[1])[:8])
    for key, p in exact.items():
        if p > 0.005:
            sigma = np.sqrt(p * (1 - p) / n_trials)
            assert abs(emp[key] - p) < 5 * sigma + 1e-9, (key, p, emp[key])
