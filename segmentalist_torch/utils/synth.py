"""Synthetic acoustic-word-embedding corpora.

The reference's feature extraction lives in an external recipe repo
(readme.md:12-15); for tests and benchmarks we generate corpora with known
ground truth: utterances are sequences of "words" drawn from K prototype
embeddings, candidate spans that exactly cover a true word get its prototype
(plus noise), other spans get smeared mixtures.  Recovering the true
boundaries / clusters is then measurable (word-boundary F-score), which is the
distributional acceptance criterion (BASELINE.md north star).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_corpus(
    n_utterances: int = 20,
    n_landmarks_max: int = 8,
    D: int = 10,
    K_true: int = 5,
    n_slices_max: int = 4,
    frames_per_slice: int = 10,
    noise: float = 0.05,
    seed: int = 0,
):
    """Build (embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
    true_boundaries) in the reference's input format
    (unigram_acoustic_wordseg.py:47-58)."""
    rng = np.random.RandomState(seed)
    prototypes = rng.randn(K_true, D) * 3.0

    embedding_mats: Dict[str, np.ndarray] = {}
    vec_ids_dict: Dict[str, np.ndarray] = {}
    durations_dict: Dict[str, list] = {}
    landmarks_dict: Dict[str, list] = {}
    true_boundaries: Dict[str, np.ndarray] = {}

    for u in range(n_utterances):
        utt = "utt%05d" % u
        N = rng.randint(2, n_landmarks_max + 1)

        # True segmentation: word lengths in [1, n_slices_max].
        bounds = np.zeros(N, dtype=bool)
        t = 0
        word_of_landmark = np.zeros(N, dtype=int)
        while t < N:
            w = min(rng.randint(1, n_slices_max + 1), N - t)
            word = rng.randint(0, K_true)
            word_of_landmark[t : t + w] = word
            t += w
            bounds[t - 1] = True
        true_boundaries[utt] = bounds

        # Candidate embeddings for spans up to n_slices_max.
        T = N * (N + 1) // 2
        vec_ids = -1 * np.ones(T, dtype=int)
        rows = []
        durations = []
        i_embed = 0
        for cur_start in range(N):
            for cur_end in range(cur_start, min(N, cur_start + n_slices_max)):
                t_excl = cur_end + 1
                i = t_excl * (t_excl - 1) // 2
                # Span = landmarks [cur_start .. cur_end].
                is_true_word = (
                    bounds[cur_end]
                    and (cur_start == 0 or bounds[cur_start - 1])
                    and len(set(word_of_landmark[cur_start : cur_end + 1])) == 1
                )
                if is_true_word:
                    word = word_of_landmark[cur_start]
                    emb = prototypes[word] + noise * rng.randn(D)
                else:
                    words = word_of_landmark[cur_start : cur_end + 1]
                    emb = prototypes[words].mean(axis=0) + 1.0 * rng.randn(D)
                vec_ids[i + cur_start] = i_embed
                rows.append(emb)
                durations.append((cur_end - cur_start + 1) * frames_per_slice)
                i_embed += 1
        embedding_mats[utt] = np.array(rows)
        vec_ids_dict[utt] = vec_ids
        durations_dict[utt] = durations
        landmarks_dict[utt] = [(j + 1) * frames_per_slice for j in range(N)]

    return (embedding_mats, vec_ids_dict, durations_dict, landmarks_dict,
            true_boundaries)


def boundary_f_score(pred: Dict[str, np.ndarray],
                     truth: Dict[str, np.ndarray]) -> Tuple[float, float, float]:
    """Word-boundary precision/recall/F1, excluding the final (always-on)
    boundary, as in the segmentation literature the reference cites."""
    n_pred = n_true = n_hit = 0
    for utt, t in truth.items():
        p = np.asarray(pred[utt], dtype=bool)[: len(t)]
        t = np.asarray(t, dtype=bool)
        # Exclude the final landmark boundary.
        p, t = p[:-1], t[:-1]
        n_pred += p.sum()
        n_true += t.sum()
        n_hit += (p & t).sum()
    precision = n_hit / max(n_pred, 1)
    recall = n_hit / max(n_true, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return precision, recall, f1
