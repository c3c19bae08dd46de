"""The benchmark's synthetic corpus and its quality metric.

A frozen copy of ``segmentalist_torch/utils/synth.py`` (``synthetic_corpus``
and ``boundary_f_score``), kept here so that no change to the program moves
the benchmark's traffic or its yardstick.  Changes from the copy:

* the utterances' sizes come from :func:`utterance_plan`: one fixed
  multiset of utterances, each with its landmark count and its true words'
  lengths (drawn from seed 0), permuted by the run's seed, so that every
  seed gets the same work in another order; the seed draws the prototypes,
  each word's identity and the embeddings' noise;
* the durations are laid out like ``vec_ids``, in the packed triangular
  order (``durations[t (t - 1) / 2 + start]`` for the span of landmarks
  ``start .. t - 1``, NaN where no span is), which is how the program and
  kamperh/segmentalist's ``utterances.py`` read them; the original lists
  them in embedding-row order;
* the embeddings are drawn an utterance at a time in bulk.

Utterances are sequences of "words" drawn from ``K_true`` prototype
embeddings; a candidate span that exactly covers a true word gets its
prototype plus a little noise, any other span a smeared mixture.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def utterance_plan(n_utterances: int, n_landmarks_min: int,
                   n_landmarks_max: int, n_slices_max: int,
                   seed: int) -> List[List[int]]:
    """[n_utterances] lists of true word lengths (in landmarks, each 1 to
    ``n_slices_max``, summing to the utterance's landmark count): one fixed
    multiset (drawn from seed 0), permuted by ``seed``."""
    rng = np.random.RandomState(0)
    lengths = rng.randint(n_landmarks_min, n_landmarks_max + 1, n_utterances)
    plan = []
    for N in lengths:
        words, t = [], 0
        while t < N:
            w = min(rng.randint(1, n_slices_max + 1), N - t)
            words.append(int(w))
            t += w
        plan.append(words)
    order = np.random.RandomState(seed % 2 ** 32).permutation(n_utterances)
    return [plan[i] for i in order]


def synthetic_corpus(plan, D: int, K_true: int, n_slices_max: int,
                     frames_per_slice: int = 10, noise: float = 0.05,
                     seed: int = 0):
    """``(embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
    true_boundaries)`` in the reference's input format, one utterance a
    list of word lengths in ``plan``, embeddings float32."""
    rng = np.random.RandomState(seed % 2 ** 32)
    prototypes = rng.randn(K_true, D) * 3.0

    embedding_mats: Dict[str, np.ndarray] = {}
    vec_ids_dict: Dict[str, np.ndarray] = {}
    durations_dict: Dict[str, np.ndarray] = {}
    landmarks_dict: Dict[str, list] = {}
    true_boundaries: Dict[str, np.ndarray] = {}

    for u, words in enumerate(plan):
        utt = "utt%05d" % u
        N = int(sum(words))
        ends = np.cumsum(words) - 1
        bounds = np.zeros(N, dtype=bool)
        bounds[ends] = True
        ids = rng.randint(0, K_true, len(words))
        word_of_landmark = np.repeat(ids, words)
        true_boundaries[utt] = bounds

        # every span of 1 .. n_slices_max landmarks, start-major
        n_of = np.minimum(N - np.arange(N), n_slices_max)
        start = np.repeat(np.arange(N), n_of)
        end = start + np.arange(len(start)) - np.repeat(
            np.cumsum(n_of) - n_of, n_of)
        width = end - start + 1
        # a span with one word identity throughout, true boundaries at
        # both ends: the word itself
        change = np.concatenate(
            [[0], np.cumsum(word_of_landmark[1:] != word_of_landmark[:-1])])
        one_word = change[end] == change[start]
        before = np.concatenate([[True], bounds])[start]
        is_true_word = bounds[end] & before & one_word
        csum = np.concatenate([np.zeros((1, D)), np.cumsum(
            prototypes[word_of_landmark], axis=0)])
        mean = (csum[end + 1] - csum[start]) / width[:, None]
        scale = np.where(is_true_word, noise, 1.0)[:, None]
        rows = mean + scale * rng.randn(len(start), D)

        T = N * (N + 1) // 2
        slot = (end + 1) * end // 2 + start
        vec_ids = -1 * np.ones(T, dtype=int)
        vec_ids[slot] = np.arange(len(start))
        durations = np.full(T, np.nan)
        durations[slot] = width * frames_per_slice
        embedding_mats[utt] = rows.astype(np.float32)
        vec_ids_dict[utt] = vec_ids
        durations_dict[utt] = durations
        landmarks_dict[utt] = [(j + 1) * frames_per_slice for j in range(N)]

    return (embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
            true_boundaries)


def boundary_f_score(pred: Dict[str, np.ndarray],
                     truth: Dict[str, np.ndarray]
                     ) -> Tuple[float, float, float]:
    """Word-boundary precision, recall and F1, excluding the final
    (always-on) boundary, as in the segmentation literature."""
    n_pred = n_true = n_hit = 0
    for utt, t in truth.items():
        p = np.asarray(pred[utt], dtype=bool)[:len(t)]
        t = np.asarray(t, dtype=bool)
        p, t = p[:-1], t[:-1]
        n_pred += p.sum()
        n_true += t.sum()
        n_hit += (p & t).sum()
    precision = n_hit / max(n_pred, 1)
    recall = n_hit / max(n_true, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return precision, recall, f1
