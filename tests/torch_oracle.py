"""The machinery the port's exact-posterior oracles share.

The oracles (``tests/test_torch_exact_posterior*.py``,
``tests/test_torch_blocked_sweep_oracle.py``,
``tests/test_torch_fbgmm_stationary*.py``) enumerate a move's outcome
distribution from first principles in numpy and hold the frequencies of
many independent moves, drawn with the port's own generator, to it.  On
the CPU each case starts from the JAX test's state, carried across by
``interop.load_state`` (:func:`anchor`, :func:`anchored`);
``chip_smoke.py`` runs the same cases on a card (every draw through the
hand-written kernels), so this module and the oracles import no JAX at
their top: only the CPU tests' anchoring does.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import Counter

import numpy as np
import numpy.testing as npt
import torch

from segmentalist_torch import interop
from segmentalist_torch.ops.stats import SuffStats

P_MIN = 0.005  # outcomes rarer than this have no per-outcome check


def tri(t_excl, start):
    """Embedding id of the span [start, t_excl) of a corpus whose first
    utterance embeds every span (the reference's triangular layout)."""
    return t_excl * (t_excl - 1) // 2 + start


def float_dtype(device):
    """float64 on the CPU (the JAX tests run with x64), float32 (what the
    kernels take) on a card."""
    return np.float64 if torch.device(device).type == "cpu" else np.float32


def jax_state(jseg) -> dict:
    """A JAX segmenter's state as ``interop.load_state`` takes it."""
    am = jseg.acoustic_model
    state = {"X": np.asarray(am.X), "counts": np.asarray(am.stats.counts),
             "sum_x": np.asarray(am.stats.sum_x),
             "sum_sq": np.asarray(am.stats.sum_sq),
             "assignments": np.asarray(am.assignments),
             "boundaries": np.asarray(jseg._boundaries_dev)}
    state.update({k: np.asarray(getattr(am.prior, k))
                  for k in interop.PRIOR_KEYS[am.covariance_type]})
    if hasattr(jseg, "lm"):
        state.update(unigram_counts=np.asarray(jseg.lm.state.unigram_counts),
                     bigram_counts=np.asarray(jseg.lm.state.bigram_counts))
    return state


def port_state(seg) -> dict:
    """The port segmenter's state under the keys of :func:`jax_state`."""
    am = seg.acoustic_model
    state = {"X": am.X, "counts": am.stats.counts, "sum_x": am.stats.sum_x,
             "sum_sq": am.stats.sum_sq, "assignments": am.assignments,
             "boundaries": seg.utterances.boundaries_dev}
    state.update({k: getattr(am.prior, k)
                  for k in interop.PRIOR_KEYS[am.covariance_type]})
    if hasattr(seg, "lm"):
        state.update(unigram_counts=seg.lm.state.unigram_counts,
                     bigram_counts=seg.lm.state.bigram_counts)
    return {k: v.cpu().numpy() for k, v in state.items()}


def anchor(seg, jseg):
    """Carry the JAX segmenter's state into the port's ``seg`` and check
    that the port holds it: the enumerated kernel is then the JAX test's,
    computed from one shared state.  Returns ``seg``."""
    want = jax_state(jseg)
    interop.load_state(seg, want)
    got = port_state(seg)
    assert set(got) == set(want)
    for k, v in want.items():
        npt.assert_array_equal(got[k], v, err_msg=k)
    return seg


@contextlib.contextmanager
def one_thread(device):
    """One intra-op thread while the block runs on the CPU: the moves'
    tensors are tiny, and waking a pool of threads for each of their ops
    (a Cholesky of a 2 x 2 matrix, a ``tril``) costs more than the op."""
    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def anchored(jax_test, jax_builder, port_builder):
    """The JAX test module ``jax_test``'s segmenter from its own builder,
    its state carried into the port's CPU segmenter from ``port_builder``
    (which must embed the same utterance 0); returns (port segmenter,
    utterance 0's embeddings)."""
    jseg, emb0 = getattr(importlib.import_module(jax_test), jax_builder)()
    seg, emb0_port = port_builder("cpu")
    npt.assert_array_equal(emb0_port, emb0)
    return anchor(seg, jseg), emb0


class Snapshot:
    """A segmenter's sampled state (statistics, assignments, boundaries,
    LM tables), put back before every move of a trial loop."""

    def __init__(self, seg):
        am = seg.acoustic_model
        self.seg = seg
        self.stats = SuffStats(*(t.clone() for t in am.stats))
        self.pad = am._assign_pad.clone()
        self.bounds = seg.utterances.boundaries_dev.clone()
        self.lm = (type(seg.lm.state)(*(t.clone() for t in seg.lm.state))
                   if hasattr(seg, "lm") else None)

    def restore(self):
        seg, am = self.seg, self.seg.acoustic_model
        am.stats = SuffStats(*(t.clone() for t in self.stats))
        am._assign_pad = self.pad.clone()
        seg.utterances.boundaries_dev = self.bounds.clone()
        if self.lm is not None:
            seg.lm.state = type(self.lm)(*(t.clone() for t in self.lm))


def move_outcomes(seg, move, n_bounds, embeds_of, n_trials, read=True):
    """Counter of (boundaries of utterance 0, components of its segments)
    over ``n_trials`` calls of ``move()``, each from the segmenter's
    current state, put back before every call; the generator runs on.
    ``embeds_of(bounds)`` lists the segments' embedding ids (those of
    utterance 0 are 0 .. n - 1).  Without ``read`` the moves run and
    nothing is read (a rank that does not hold utterance 0)."""
    snap = Snapshot(seg)
    am, utt = seg.acoustic_model, seg.utterances
    n_embeds = n_bounds * (n_bounds + 1) // 2
    freq = Counter()
    with one_thread(seg.device):
        for _ in range(n_trials):
            snap.restore()
            move()
            if not read:
                continue
            row = torch.cat([utt.boundaries_dev[0, :n_bounds].to(torch.int32),
                             am.assignments[:n_embeds]]).tolist()
            bounds = tuple(row[:n_bounds])
            ks = tuple(row[n_bounds + e] for e in embeds_of(bounds))
            freq[(bounds, ks)] += 1
    snap.restore()
    return freq


def total_variation(exact: dict, freq: Counter, n_trials: int) -> float:
    """Total variation between ``exact`` and the empirical frequencies;
    an outcome outside ``exact``'s support fails."""
    outside = sorted(set(freq) - set(exact))
    assert not outside, ("outcomes the oracle gives no mass", outside)
    return 0.5 * sum(abs(freq.get(k, 0) / n_trials - p)
                     for k, p in exact.items())


def check_frequencies(exact: dict, freq: Counter, n_trials: int,
                      tv_max: float, n_sigma=5.0) -> float:
    """The frequencies within total variation ``tv_max`` of ``exact`` and,
    unless ``n_sigma`` is None, every outcome of mass above ``P_MIN``
    within ``n_sigma`` standard deviations of its expectation.  Returns
    the total variation."""
    assert abs(sum(exact.values()) - 1.0) < 1e-9
    tv = total_variation(exact, freq, n_trials)
    assert tv < tv_max, (tv, sorted(
        ((k, round(p, 4), round(freq.get(k, 0) / n_trials, 4))
         for k, p in exact.items()), key=lambda r: -r[1])[:8])
    if n_sigma is not None:
        for k, p in exact.items():
            if p > P_MIN:
                emp = freq.get(k, 0) / n_trials
                sigma = np.sqrt(p * (1 - p) / n_trials)
                assert abs(emp - p) < n_sigma * sigma + 1e-9, (k, p, emp)
    return tv


def transition_case(seg, exact, move, n_bounds, embeds_of, n_trials,
                    tv_max, n_sigma=5.0) -> dict:
    """Run ``n_trials`` moves and check them against ``exact``; returns
    the case's summary (total variation, trials, seconds)."""
    t0 = time.time()
    freq = move_outcomes(seg, move, n_bounds, embeds_of, n_trials)
    tv = check_frequencies(exact, freq, n_trials, tv_max, n_sigma)
    return {"tv": tv, "tv_max": tv_max, "trials": n_trials,
            "seconds": time.time() - t0}


def viterbi_case(seg, best, n_bounds, embeds_of, n_trials=4) -> dict:
    """Viterbi moves are deterministic: every one of ``n_trials`` moves
    (the generator running on) gives ``best``, the (boundaries,
    components) pair of the argmax oracle."""
    t0 = time.time()
    freq = move_outcomes(seg, lambda: seg.gibbs_sample_i(0), n_bounds,
                         embeds_of, n_trials)
    assert dict(freq) == {best: n_trials}, (dict(freq), best)
    return {"tv": 0.0, "tv_max": 0.0, "trials": n_trials,
            "seconds": time.time() - t0}


def leave_out_moments(seg, full=False):
    """Utterance 0's leave-out statistics from the assignment vector
    itself: (counts [K], sum_x [K, D], sum_sq [K, D] or, with ``full``,
    [K, D, D]) as float64 numpy."""
    am = seg.acoustic_model
    X = am.X.cpu().numpy().astype(np.float64)
    assign = am.assignments.cpu().numpy()
    K, D = am.K_max, X.shape[1]
    old = set(e for e in seg.utterances.get_segmented_embeds_i(0) if e != -1)
    c, sx = np.zeros(K), np.zeros((K, D))
    sq = np.zeros((K, D, D) if full else (K, D))
    for i, k in enumerate(assign):
        if k >= 0 and i not in old:
            c[k] += 1
            sx[k] += X[i]
            sq[k] += np.outer(X[i], X[i]) if full else X[i] ** 2
    return c, sx, sq
