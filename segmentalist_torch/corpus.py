"""Corpus / segmentation state (counterpart of ``segmentalist_tpu/corpus.py``).

Host-side triangular arrays (the reference's per-utterance packing,
``utterances.py:59-65, :91-102``) stay numpy.  The dense windowed tensors
the sweeps read live on the segmenter's device:

    seg_ids[u, t, w]       int32    embedding row of the span that ends at
                                    landmark ``t`` and covers ``w + 1``
                                    slices; -1 if out of range / missing.
    seg_durations[u, t, w] float32  its duration in frames; NaN if masked.
    lengths_dev[u]         int32    landmarks per utterance.
    boundaries[u, t]       bool     current segmentation.

Boundary initialisation, including the rejection resampling on
``n_slices_min/max`` (reference ``utterances.py:136-157``), is
data-dependent control flow and stays on the host.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from . import native
from .device import resolve_device

logger = logging.getLogger(__name__)


def tri_index(t_end_exclusive: int, start: int) -> int:
    """Index of span [start:t_end_exclusive) in a packed triangular row."""
    return t_end_exclusive * (t_end_exclusive - 1) // 2 + start


class Utterances:
    """A corpus of utterances for acoustic word segmentation (reference
    ``Utterances``, ``utterances.py:14-229``).

    ``rng`` is the ``np.random.RandomState`` of the random boundary
    initialisation (default: numpy's global RNG, like the reference);
    ``device`` holds the dense tensors: the CUDA card by default (raises
    when there is none), the CPU when the caller asks.
    """

    def __init__(self, lengths, vec_ids, durations, landmarks,
                 seed_boundaries=None, p_boundary_init: float = 0.5,
                 n_slices_min: int = 0, n_slices_max: int = 6,
                 min_duration: int = 0,
                 rng: Optional[np.random.RandomState] = None,
                 device="cuda"):
        rand = rng if rng is not None else np.random
        self.device = resolve_device(device)

        if list(lengths) != [len(i) for i in landmarks]:
            raise ValueError("lengths do not match the landmark lists")
        self.lengths = list(int(x) for x in lengths)
        self.D = len(self.lengths)
        if self.D != len(vec_ids):
            raise ValueError("one vec_ids row per utterance is required")
        self.N_max = max(self.lengths)
        self.landmarks = landmarks
        self.n_slices_min = int(n_slices_min)
        self.n_slices_max = int(n_slices_max)

        T = self.N_max * (self.N_max + 1) // 2
        self.vec_ids = -1 * np.ones((self.D, T), dtype=np.int64)
        for i_vec_id, vec_id in enumerate(vec_ids):
            self.vec_ids[i_vec_id, : len(vec_id)] = vec_id
        self.durations = np.full((self.D, T), np.nan, dtype=np.float64)
        for i_dur, duration_vec in enumerate(durations):
            duration_vec = np.asarray(duration_vec, dtype=np.float64)
            if not (min_duration == 0 or len(duration_vec) == 1):
                cur = duration_vec.copy()
                cur[cur < min_duration] = np.nan
                if np.all(np.isnan(cur)):
                    cur[np.argmax(duration_vec)] = np.max(duration_vec)
                duration_vec = cur
            self.durations[i_dur, : len(duration_vec)] = duration_vec

        bounds = np.zeros((self.D, self.N_max), dtype=bool)
        if seed_boundaries is not None:
            for i_utt, seed in enumerate(seed_boundaries):
                landmark = landmarks[i_utt]
                closest = [int(np.argmin([abs(b - lm) for lm in landmark]))
                           for b in seed]
                bounds[i_utt, closest] = True
        elif p_boundary_init == 0:
            for i in range(self.D):
                bounds[i, self.lengths[i] - 1] = True
        else:
            seed = int(rand.randint(1, 2 ** 31 - 1))
            nat = native.init_boundaries_random(
                np.asarray(self.lengths, np.int64), self.vec_ids,
                self.N_max, float(p_boundary_init), self.n_slices_min,
                self.n_slices_max, seed,
            )
            if nat is not None:
                bounds = nat
            else:  # numpy fallback (reference utterances.py:136-157)
                for i in range(self.D):
                    N = self.lengths[i]
                    while True:
                        bounds[i, 0:N] = rand.rand(N) < p_boundary_init
                        bounds[i, N - 1] = True
                        if np.all(np.asarray(
                                self.get_segmented_embeds_i(i, bounds)) == -1):
                            continue
                        spans = [
                            j[1] - j[0] for j in
                            self.get_segmented_landmark_indices(i, bounds)]
                        if (max(spans) <= n_slices_max
                                and min(spans) >= n_slices_min) \
                                or N <= n_slices_min:
                            break
        self.boundaries_dev = torch.as_tensor(bounds, device=self.device)

        self.W = self._compute_w_store()
        self._build_dense()

    # -- dense layout ---------------------------------------------------------

    def _compute_w_store(self) -> int:
        """Longest span for which any embedding id is provided."""
        if self.n_slices_max <= 0:
            return self.N_max
        w = max(1, self.n_slices_max)
        for t in range(self.N_max):
            base = tri_index(t + 1, 0)
            valid = self.vec_ids[:, base: base + t + 1] != -1
            if valid.any():
                starts = np.where(valid.any(axis=0))[0]
                w = max(w, int(t + 1 - starts.min()))
        return min(w, self.N_max)

    def _build_dense(self):
        D, N_max, W = self.D, self.N_max, self.W
        packed = native.pack_dense(self.vec_ids, self.durations,
                                   np.asarray(self.lengths, np.int64),
                                   N_max, W)
        if packed is not None:
            seg_ids, seg_durs = packed
        else:
            t_grid, w_grid = np.meshgrid(np.arange(N_max), np.arange(W),
                                         indexing="ij")
            valid = w_grid <= t_grid
            idx = np.where(valid, t_grid * (t_grid + 1) // 2 + t_grid - w_grid,
                           0)
            seg_ids = self.vec_ids[:, idx]
            seg_durs = self.durations[:, idx]
            seg_ids[:, ~valid] = -1
            seg_durs[:, ~valid] = np.nan
            beyond = (np.arange(N_max)[None, :]
                      >= np.asarray(self.lengths)[:, None])
            seg_ids[beyond] = -1
            seg_durs[beyond] = np.nan
        dev = self.device
        self.seg_ids = torch.as_tensor(seg_ids, dtype=torch.int32, device=dev)
        self.seg_durations = torch.as_tensor(seg_durs, dtype=torch.float32,
                                             device=dev)
        self.lengths_dev = torch.as_tensor(self.lengths, dtype=torch.int32,
                                           device=dev)

    # -- boundary state -------------------------------------------------------

    @property
    def boundaries(self) -> np.ndarray:
        """Host copy of the current boundary matrix [U, N_max] (without
        the dead rows a mesh pads the corpus with)."""
        return self.boundaries_dev[:self.D].cpu().numpy().copy()

    @boundaries.setter
    def boundaries(self, value):
        self.boundaries_dev = torch.as_tensor(
            np.asarray(value, dtype=bool), device=self.device)

    # -- segmentation queries (reference utterances.py:159-229) ---------------

    def all_segmented_embeds(self) -> np.ndarray:
        """[U, N_max] embedding ids of every utterance's current segments,
        padded with -2 (-1 is a legitimate 'missing embedding')."""
        bounds = self.boundaries
        out = native.segmented_embeds(bounds, self.vec_ids,
                                      np.asarray(self.lengths, np.int64))
        if out is not None:
            return out
        out = np.full((self.D, self.N_max), -2, dtype=np.int64)
        for i in range(self.D):
            embeds = self.get_segmented_embeds_i(i, bounds)
            out[i, : len(embeds)] = embeds
        return out

    def get_segmented_embeds_i(self, i: int, bounds=None) -> List[int]:
        """Embedding ids of utterance ``i``'s current segmentation
        (reference ``get_segmented_embeds_i``, utterances.py:159-174)."""
        row = (self.boundaries if bounds is None else bounds)[i]
        embed_ids = []
        j_prev = 0
        for j in range(self.lengths[i]):
            if row[j]:
                embed_ids.append(
                    int(self.vec_ids[i, tri_index(j + 1, j_prev)]))
                j_prev = j + 1
        return embed_ids

    def get_segmented_landmark_indices(self, i: int, bounds=None):
        indices = []
        j_prev = 0
        row = (self.boundaries if bounds is None else bounds)[i]
        for j in np.where(row[: self.lengths[i]])[0]:
            indices.append((j_prev, int(j) + 1))
            j_prev = int(j) + 1
        return indices

    def get_segmented_durations_i(self, i: int) -> List[float]:
        """Durations of utterance ``i``'s current segments (the JAX
        package's ``corpus.py:255-263``)."""
        row = self.boundaries[i]
        durations = []
        j_prev = 0
        for j in range(self.lengths[i]):
            if row[j]:
                durations.append(self.durations[i, tri_index(j + 1, j_prev)])
                j_prev = j + 1
        return durations

    def get_original_segmented_embeds_i(self, i: int) -> List[int]:
        """Utterance ``i``'s segment ids relative to its smallest embedding
        id (the JAX package's ``corpus.py:265-268``)."""
        vec_ids = self.vec_ids[i]
        vec_ids_min = np.min(vec_ids[vec_ids != -1])
        return [int(e - vec_ids_min) for e in self.get_segmented_embeds_i(i)]

    def get_segmented_landmarks(self, i: int):
        """(start, end) landmark values of utterance ``i``'s segments (the
        JAX package's ``corpus.py:278-283``)."""
        if self.landmarks is None:
            raise ValueError("the corpus has no landmarks")
        indices = []
        j_prev = 0
        for _, j in self.get_segmented_landmark_indices(i):
            indices.append((j_prev, self.landmarks[i][j - 1]))
            j_prev = self.landmarks[i][j - 1]
        return indices
