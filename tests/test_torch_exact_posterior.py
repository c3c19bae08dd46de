"""tests/test_exact_posterior.py's transition-kernel oracles on the port's
own noise.

One ``gibbs_sample_i(0)`` move of the unigram segmenter (boundary
resampling, then the sequential assignment chain) has an enumerable
transition distribution from a fixed state (4 segmentations x at most 2^3
assignments); the frequencies over thousands of independent moves from
that state, drawn with the segmenter's own generator, must match it.
Shared-noise parity cannot see a fault in the port's own noise draws;
these tests can.  Each starts from the JAX test's state, built by its own
builder and carried across by ``interop.load_state``.

Cases: the move at T 1 (:func:`unigram_case`), the annealed move
(:func:`annealed_case`), the Viterbi move against the argmax oracle
(:func:`viterbi_oracle_case`); the per-shard mode's move is in
``tests/test_torch_exact_posterior_shard.py``.  The oracles import no JAX:
``chip_smoke.py`` runs :data:`CARD_CASES` on a card.
"""

import itertools

import numpy as np
from scipy.special import logsumexp as lse

import segmentalist_torch as pt
from torch_oracle import (anchored, float_dtype, tri, transition_case,
                          viterbi_case)

VAR, MU0, VAR0 = 0.5, 0.0, 2.0  # fixed-variance prior (D 1)
ALPHA, K = 1.0, 2


def _pred_logpdf(x, n, sum_x):
    """Posterior predictive N(x | mu_pred, 1/prec_pred) of one dimension
    (gaussian_components_fixedvar.py:163-168, :242-253)."""
    prec, prec0 = 1.0 / VAR, 1.0 / VAR0
    prec_n = prec0 + n * prec
    mu_pred = (prec0 * MU0 + prec * sum_x) / prec_n
    prec_pred = prec_n * prec / (prec_n + prec)
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec_pred)
            - 0.5 * prec_pred * (x - mu_pred) ** 2)


def _prior_logpdf(x):
    """The reference's prior-density quirk: predictive precision taken to
    be precision_0 itself (gaussian_components_fixedvar.py:224-231)."""
    prec0 = 1.0 / VAR0
    return (-0.5 * np.log(2 * np.pi) + 0.5 * np.log(prec0)
            - 0.5 * prec0 * (x - MU0) ** 2)


_PATTERNS = {  # boundary triple -> segments (start, end exclusive)
    (0, 0, 1): [(0, 3)],
    (1, 0, 1): [(0, 1), (1, 3)],
    (0, 1, 1): [(0, 2), (2, 3)],
    (1, 1, 1): [(0, 1), (1, 2), (2, 3)],
}
_PATTERNS2LM = {  # boundary pair -> segments
    (0, 1): [(0, 2)],
    (1, 1): [(0, 1), (1, 2)],
}


def _pattern_embeds(pattern):
    return [tri(e, s) for s, e in _PATTERNS[pattern]]


def _pattern_embeds2(pattern):
    return [tri(e, s) for s, e in _PATTERNS2LM[pattern]]


def _prior(device):
    dt = float_dtype(device)
    return pt.FixedVarPrior.create(*(np.full(1, v, dt)
                                     for v in (VAR, MU0, VAR0)))


def two_utterance_segmenter(device="cpu"):
    """The JAX test's ``_build_two_utterance_segmenter`` on the port:
    utterance 0 has 3 landmarks and all 6 spans embedded; utterance 1 one
    landmark (the held-out context)."""
    dt = float_dtype(device)
    emb0 = (np.random.RandomState(5).randn(6, 1) * 1.2).astype(dt)
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=ALPHA, am_K=K, am_param_prior=_prior(device),
        embedding_mats={"u0": emb0,
                        "u1": np.array([[0.4]], dt)},
        vec_ids_dict={"u0": np.arange(6), "u1": np.array([0])},
        durations_dict={"u0": [1, 2, 1, 3, 2, 1], "u1": [1]},
        landmarks_dict={"u0": [1, 2, 3], "u1": [1]}, p_boundary_init=0.5,
        beta_sent_boundary=-1, n_slices_max=3, time_power_term=0.0, wip=0.0,
        batch_size=1, seed=7, device=device)
    return seg, emb0.astype(np.float64)


def two_landmark_segmenter(device="cpu"):
    """The JAX test's ``_build_two_landmark_segmenter``: utterance 0 has 2
    landmarks (one backward DP draw, so the annealed pattern distribution
    is exactly softmax(pattern_logp / T)); utterance 1 one landmark."""
    dt = float_dtype(device)
    emb0 = (np.random.RandomState(8).randn(3, 1) * 1.2).astype(dt)
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=ALPHA, am_K=K, am_param_prior=_prior(device),
        embedding_mats={"u0": emb0,
                        "u1": np.array([[0.4]], dt)},
        vec_ids_dict={"u0": np.arange(3), "u1": np.array([0])},
        durations_dict={"u0": [1, 2, 1], "u1": [1]},
        landmarks_dict={"u0": [1, 2], "u1": [1]}, p_boundary_init=0.5,
        beta_sent_boundary=-1, n_slices_max=2, time_power_term=0.0, wip=0.0,
        batch_size=1, seed=9, device=device)
    return seg, emb0.astype(np.float64)


def _leave_out(seg, emb0):
    """Utterance 0's leave-out counts and sums (float64 numpy)."""
    am = seg.acoustic_model
    counts = am.stats.counts.cpu().numpy().astype(float)
    sum_x = am.stats.sum_x.cpu().numpy()[:, 0].astype(float)
    assignments = am.assignments.cpu().numpy()
    lo_counts, lo_sum_x = counts.copy(), sum_x.copy()
    for e in seg.utterances.get_segmented_embeds_i(0):
        if e != -1:
            lo_counts[assignments[e]] -= 1
            lo_sum_x[assignments[e]] -= emb0[e, 0]
    return lo_counts, lo_sum_x


def _chain_logits(x, c, sx):
    return [np.log(ALPHA / K + c[kk])
            + (_pred_logpdf(x, c[kk], sx[kk]) if c[kk] > 0
               else _prior_logpdf(x)) for kk in range(K)]


def _pattern_logps(seg, emb0, patterns, embeds_of):
    lo_counts, lo_sum_x = _leave_out(seg, emb0)

    def cand_score(e):
        x = emb0[e, 0]
        return lse([np.log(ALPHA / K + lo_counts[k])
                    - np.log(lo_counts.sum() + ALPHA)
                    + (_pred_logpdf(x, lo_counts[k], lo_sum_x[k])
                       if lo_counts[k] > 0 else _prior_logpdf(x))
                    for k in range(K)])

    return ({p: sum(cand_score(e) for e in embeds_of(p)) for p in patterns},
            lo_counts, lo_sum_x)


def _exact_annealed_move_kernel(seg, emb0, temp, patterns, embeds_of):
    """P(new boundaries, new assignments) of one ``gibbs_sample_i(0,
    anneal_temp=temp, anneal_gibbs_am=True)`` move from the segmenter's
    current state, from first principles.  The backward draw tempers the
    window distribution (unigram_acoustic_wordseg.py:733-741) and each
    assignment draw is tempered (fbgmm.py:436-455); the forward filter is
    not.  At T 1 it is the move of ``gibbs_sample_i(0)`` on any number of
    landmarks; at T != 1 it is exact with one backward step (2
    landmarks), where the pattern distribution is softmax(logp / T)."""
    seg_logp, lo_counts, lo_sum_x = _pattern_logps(seg, emb0, patterns,
                                                   embeds_of)
    za = lse([v / temp for v in seg_logp.values()])
    probs = {}
    for p in patterns:
        embeds = embeds_of(p)
        for ks in itertools.product(range(K), repeat=len(embeds)):
            c, sx = lo_counts.copy(), lo_sum_x.copy()
            lp_chain = 0.0
            for e, k in zip(embeds, ks):
                x = emb0[e, 0]
                logits = np.asarray(_chain_logits(x, c, sx)) / temp
                lp_chain += logits[k] - lse(logits)
                c[k] += 1
                sx[k] += x
            probs[(p, ks)] = np.exp(seg_logp[p] / temp - za + lp_chain)
    return probs


def _exact_move_kernel(seg, emb0):
    """The T 1 move of utterance 0 of :func:`two_utterance_segmenter`."""
    return _exact_annealed_move_kernel(seg, emb0, 1.0, _PATTERNS,
                                       _pattern_embeds)


def unigram_case(seg, emb0, n_trials=4000) -> dict:
    """4000 moves at T 1 within total variation 0.04 of the enumerated
    kernel, every outcome of mass above 0.005 within 5 sigma."""
    exact = _exact_move_kernel(seg, emb0)
    return transition_case(seg, exact, lambda: seg.gibbs_sample_i(0), 3,
                           _pattern_embeds, n_trials, 0.04)


def annealed_case(seg, emb0, temp=3.0, n_trials=4000) -> dict:
    """4000 annealed moves (T 3, the assignment draws tempered too) within
    total variation 0.04 of the enumerated kernel, 5 sigma an outcome;
    the annealed kernel differs from the T 1 kernel by more than 0.05, so
    the case cannot pass with the temperature plumbing broken."""
    exact = _exact_annealed_move_kernel(seg, emb0, temp, _PATTERNS2LM,
                                        _pattern_embeds2)
    exact_t1 = _exact_annealed_move_kernel(seg, emb0, 1.0, _PATTERNS2LM,
                                           _pattern_embeds2)
    assert 0.5 * sum(abs(exact[k] - exact_t1[k]) for k in exact) > 0.05
    return transition_case(
        seg, exact, lambda: seg.gibbs_sample_i(0, anneal_temp=temp,
                                               anneal_gibbs_am=True),
        2, _pattern_embeds2, n_trials, 0.04)


def viterbi_oracle_case(seg, emb0) -> dict:
    """``fb_type="viterbi"`` is deterministic: the move picks the
    argmax-score segmentation (max-product DP over the enumerated
    patterns), then MAP assignments with chained statistics (reference
    forward_backward_viterbi, unigram_acoustic_wordseg.py:759-864, and
    map_assign_i, fbgmm.py:465-494, which omits the lms scaling)."""
    seg.set_fb_type("viterbi")
    seg_logp, c, sx = _pattern_logps(seg, emb0, _PATTERNS, _pattern_embeds)
    best_p = max(_PATTERNS, key=seg_logp.get)
    best_ks = []
    for e in _pattern_embeds(best_p):
        x = emb0[e, 0]
        k = int(np.argmax(_chain_logits(x, c, sx)))
        best_ks.append(k)
        c[k] += 1
        sx[k] += x
    return viterbi_case(seg, (best_p, tuple(best_ks)), 3, _pattern_embeds)


# CARD_CASES[name](device) builds the port's segmenter on ``device`` (no
# JAX state: the oracle is computed from the port's own) and runs a case
CARD_CASES = {
    "unigram_fixed": lambda dev: unigram_case(*two_utterance_segmenter(dev)),
    "unigram_fixed_annealed": lambda dev: annealed_case(
        *two_landmark_segmenter(dev)),
    "unigram_fixed_viterbi": lambda dev: viterbi_oracle_case(
        *two_utterance_segmenter(dev)),
}


def test_unigram_single_move_transition_kernel():
    unigram_case(*anchored("test_exact_posterior",
                          "_build_two_utterance_segmenter",
                          two_utterance_segmenter))


def test_annealed_single_move_transition_kernel():
    annealed_case(*anchored("test_exact_posterior",
                           "_build_two_landmark_segmenter",
                           two_landmark_segmenter))


def test_viterbi_move_matches_argmax_oracle():
    viterbi_oracle_case(*anchored(
        "test_exact_posterior", "_build_two_utterance_segmenter",
        two_utterance_segmenter))
