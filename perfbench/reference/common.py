"""Plain reference of the blocked Gibbs sampler's pieces that every
driver shares: the corpus tables, statistics rebuilt from an assignment
vector, the Dirichlet weights, the segmentation DP (forward filter,
backward Gumbel-max draws) and the cross-utterance decollision of new
components.

Plain PyTorch and numpy; imports nothing of the program and takes nothing
that it made: the tables come from the benchmark's own corpus, the
statistics from an assignment vector.  Semantics follow kamperh/segmentalist
(``unigram_acoustic_wordseg.py``, ``fbgmm.py``, ``utterances.py``) as the
program states them: scores ``log_marg * duration ** time_power_term +
wip``; the DP's window reversed, ``log_p_continue`` added at every inner
node, a node with no finite continuation falling back to the landmark
before it; Gumbel-max draws of ``logits / temp + g`` with ties to the
first index; a draw onto an empty component goes to the first empty slot.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = float("-inf")


class Tables:
    """The corpus in dense form: ``X`` [N, D] float32 (numpy), ``lengths``
    [U], ``seg_ids`` [U, N_max, W] the embedding id of the span that ends
    at landmark t and covers w + 1 landmarks (-1: none), ``seg_durs``
    [U, N_max, W] its duration (NaN: none), W = min(n_slices_max,
    N_max).  Utterances in sorted label order, embeddings numbered in that
    order."""

    def __init__(self, corpus, n_slices_max: int):
        em, vi, du, _lm, truth = corpus
        self.labels = sorted(em)
        self.truth = truth
        self.lengths = np.array([len(truth[k]) for k in self.labels])
        U, N_max = len(self.labels), int(self.lengths.max())
        W = min(n_slices_max, N_max) if n_slices_max > 0 else N_max
        self.U, self.N_max, self.W = U, N_max, W
        self.X = np.concatenate([em[k] for k in self.labels]).astype(
            np.float32)
        self.seg_ids = np.full((U, N_max, W), -1, dtype=np.int64)
        self.seg_durs = np.full((U, N_max, W), np.nan)
        off = 0
        for u, k in enumerate(self.labels):
            ids, durs, n = np.asarray(vi[k]), np.asarray(du[k], float), \
                self.lengths[u]
            for t in range(n):
                for w in range(min(W, t + 1)):
                    i = (t + 1) * t // 2 + t - w   # packed slot of the span
                    if i < len(ids) and ids[i] >= 0:
                        self.seg_ids[u, t, w] = ids[i] + off
                    if i < len(durs):
                        self.seg_durs[u, t, w] = durs[i]
            off += em[k].shape[0]
        self.N = off

    def segments(self, u: int, bounds_row) -> list:
        """(end landmark, width - 1) of utterance u's segments, in order."""
        out, start = [], 0
        for t in range(int(self.lengths[u])):
            if bounds_row[t]:
                out.append((t, t - start))
                start = t + 1
        return out

    def embeds(self, u: int, bounds_row) -> list:
        """Embedding ids of utterance u's segments, in order (-1 where a
        segment has no embedding)."""
        return [int(self.seg_ids[u, t, w]) if w < self.W else -1
                for t, w in self.segments(u, bounds_row)]


def one_hot_sums(X, a, K: int, second: bool):
    """(counts [K] int64, sum_x [K, D], sum_sq [K, D, D] or None) of the
    rows of X [N, D] assigned by a [N] (-1: none), as one-hot matrix
    products in X's dtype."""
    ok = a >= 0
    oh = torch.zeros((X.shape[0], K), dtype=X.dtype, device=X.device)
    oh[ok.nonzero()[:, 0], a[ok]] = 1.0
    counts = torch.bincount(a[ok], minlength=K)
    sum_x = oh.T @ X
    if not second:
        return counts, sum_x, None
    sum_sq = (oh.T @ (X[:, :, None] * X[:, None, :]).reshape(X.shape[0], -1)
              ).reshape(K, X.shape[1], X.shape[1])
    return counts, sum_x, sum_sq


def one_hot_sums_chunked(X, a, K: int, second: bool, chunk: int = 4096):
    """:func:`one_hot_sums` over row chunks (the second moments of every
    row at once would not fit), summed in chunk order."""
    out = None
    for i in range(0, X.shape[0], chunk):
        part = one_hot_sums(X[i:i + chunk], a[i:i + chunk], K, second)
        out = part if out is None else tuple(
            None if p is None else o + p for o, p in zip(out, part))
    return out


def log_weights(counts, alpha: float, K: int, lms: float, denominator: bool):
    """``lms (log(alpha / K + n_k) [- log(N + alpha)])`` over the last
    axis."""
    w = torch.log(alpha / K + counts)
    if denominator:
        w = w - torch.log(counts.sum(-1, keepdim=True) + alpha)
    return lms * w


def log_p_continue(n_tokens: float, U: int, beta: float) -> float:
    """Sentence-continue log probability (reference ``calc_p_continue``);
    0 for ``beta`` -1."""
    if beta == -1:
        return 0.0
    return math.log((n_tokens - (U - 1) + beta / 2.0) / (n_tokens + beta))


# ------------------------------------------------------------------- the DP

def _rev(scores, n_slices_min: int):
    W = scores.shape[-1]
    rev = scores.flip(-1)
    if n_slices_min > 1:
        lens = W - torch.arange(W, device=scores.device)
        rev = torch.where(lens >= n_slices_min, rev, NEG_INF)
    return rev


def node_logits(scores, lengths, lpc: float, n_slices_min: int):
    """``(nl, rev)``: [B, N, W] logits of every node's predecessor draw,
    ``nl[v-1, j] = rev[v-1, j] + alpha[v - W + j]``, node v = 1..N ending a
    segment of length W - j whose score is ``rev[v-1, j]``, from the
    forward filter over ``scores`` [B, N, W] (span ending at landmark t
    of w + 1 landmarks)."""
    B, N, W = scores.shape
    rev = _rev(scores, n_slices_min)
    ap = torch.full((B, W + N), NEG_INF, dtype=scores.dtype,
                    device=scores.device)
    ap[:, W] = 0.0
    lens = torch.as_tensor(lengths, device=scores.device)
    for t in range(1, N):
        lg = rev[:, t - 1] + ap[:, t:t + W]
        val = torch.logsumexp(lg, dim=-1) + lpc
        ap[:, W + t] = torch.where(t < lens, val, NEG_INF)
    return rev + ap.unfold(1, W, 1)[:, 1:N + 1], rev


def dp_gaps(nl, rev, noise, lengths, bounds, temp: float):
    """``(gaps [B], path scores [B], their magnitudes [B])``: per utterance
    the widest gap by which a draw of the segmentation ``bounds`` [B, N]
    falls below the best perturbed choice at its node, ``max_j (nl/temp +
    g) - (nl/temp + g)[pick]`` along the path that the boundaries trace
    back from the last landmark, the sum of the drawn segments' scores
    (the DP's log probability) and the sum of their absolute values.  A
    pick the window cannot make, or a masked one, reads inf; nodes with no
    finite choice fall back one landmark, as the sampler does, and add
    nothing."""
    nl = nl.double().cpu().numpy()
    rev = rev.double().cpu().numpy()
    g = noise.double().cpu().numpy()
    bounds = np.asarray(bounds, dtype=bool)
    B, N, W = nl.shape
    out, path, mag = np.zeros(B), np.zeros(B), np.zeros(B)
    for b in range(B):
        n = int(lengths[b])
        marks = set(np.nonzero(bounds[b, :n])[0] + 1) | {0}
        v = n
        while v > 0:
            row = nl[b, v - 1]
            fin = np.isfinite(row)
            if not fin.any():
                v -= 1
                continue
            u = max(m for m in marks if m < v)
            j = W - (v - u)
            pert = np.where(fin, row / temp + g[b, v - 1], -np.inf)
            if j < 0 or not fin[j]:
                out[b] = path[b] = np.inf
                break
            out[b] = max(out[b], pert.max() - pert[j])
            path[b] += rev[b, v - 1, j]
            mag[b] += abs(rev[b, v - 1, j])
            v = u
    return out, path, mag


def dp_sample(nl, noise, lengths, temp: float) -> np.ndarray:
    """[B, N] boundaries drawn by Gumbel-max from the node logits (the
    control's DP): the visited nodes marked where they were drawn, are
    the end, or start a drawn segment."""
    nl = nl.double().cpu().numpy()
    g = noise.double().cpu().numpy()
    B, N, W = nl.shape
    out = np.zeros((B, N), dtype=bool)
    for b in range(B):
        v = int(lengths[b])
        if v > 0:
            out[b, v - 1] = True
        while v > 0:
            row = nl[b, v - 1]
            fin = np.isfinite(row)
            if not fin.any():
                v -= 1
                continue
            j = int(np.argmax(np.where(fin, row / temp + g[b, v - 1],
                                       -np.inf)))
            out[b, v - 1] = True
            v = v - (W - j)
            if v > 0:
                out[b, v - 1] = True
    return out


# ------------------------------------------------------------ decollision

def decollide(ks, mask, lo_counts, counts0) -> np.ndarray:
    """Relabel cross-utterance collisions on new components (every chain
    of a block sees a slot with leave-out count 0 as new).  Per slot at
    most one creator keeps it, the first in row order, and none where some
    row joined the slot's old members; every other creator moves to the
    next fresh slot (empty at the block's start and untouched by the
    block), slot-major and row-minor; when fresh slots run out the rest
    stay.  ``ks`` [B, S] the chains' draws, ``mask`` [B, S] the live
    segments, ``lo_counts`` [B, K] and ``counts0`` [K]."""
    ks = np.array(ks, dtype=np.int64)
    mask = np.asarray(mask, dtype=bool) & (ks >= 0)
    lo = np.asarray(lo_counts)
    B, K = lo.shape
    touched = np.zeros((B, K), dtype=bool)
    for b in range(B):
        touched[b, ks[b][mask[b]]] = True
    creator = touched & (lo == 0)
    joiner = (touched & ~creator).any(0)
    fresh = [k for k in range(K)
             if counts0[k] == 0 and not touched[:, k].any()]
    target = {}
    i_fresh = 0
    for k in range(K):
        rows = np.nonzero(creator[:, k])[0]
        movers = rows if joiner[k] else rows[1:]
        for b in movers:
            if i_fresh < len(fresh):
                target[b, k] = fresh[i_fresh]
            i_fresh += 1
    out = ks.copy()
    for b in range(B):
        for s in np.nonzero(mask[b])[0]:
            out[b, s] = target.get((b, int(ks[b, s])), ks[b, s])
    return out
