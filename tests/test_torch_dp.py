"""Kernel K2 (DP forward filter) and the port's ``segment_dp`` against the
JAX package.

The plain forward filter is held against the Pallas kernel in interpret
mode and the XLA fallback to rtol 1e-12 at f64.  ``segment_dp`` runs on the
same scores and the same backward-draw noise -- the noise JAX draws from
its key at ``dp.py:196`` -- and must give exactly the same boundaries.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.ops import dp as jdp
from segmentalist_tpu.ops.pallas_dp import forward_alphas as j_forward

from segmentalist_torch.ops import cuda_dp
from segmentalist_torch.ops import dp as tdp


def _scores(rng, B, N_max, W, lengths):
    s = rng.randn(B, N_max, W) * 3.0
    t = np.arange(N_max)[None, :, None]
    w = np.arange(W)[None, None, :]
    s[(w > t) | (t >= lengths[:, None, None])] = -np.inf
    s[rng.rand(B, N_max, W) < 0.1] = -np.inf  # missing embeddings
    return s


def _case(seed, B=7, N_max=11, W=4):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, N_max + 1, B).astype(np.int32)
    lengths[0] = N_max
    return _scores(rng, B, N_max, W, lengths), lengths


@pytest.mark.parametrize("use_max", [False, True])
def test_forward_plain_matches_pallas_and_xla(use_max):
    scores, lengths = _case(0)
    rev = jdp._rev_mask_scores(jnp.asarray(scores), 0)
    lens = jnp.asarray(lengths)
    pal = np.asarray(j_forward(rev, lens, -0.1, use_max=use_max,
                               interpret=True))
    xla = np.asarray(jdp._forward_xla(rev, lens, jnp.float64(-0.1), use_max))
    got = cuda_dp.forward_alphas_plain(torch.as_tensor(np.array(rev)),
                                       torch.as_tensor(lengths), -0.1,
                                       use_max).numpy()
    for ref in (pal, xla):
        npt.assert_array_equal(np.isneginf(got), np.isneginf(ref))
        fin = np.isfinite(ref)
        npt.assert_allclose(got[fin], ref[fin], rtol=1e-12)


@pytest.mark.parametrize("mode,n_min,temp,shape", [
    pytest.param("sample", 0, 1.0, {}, id="sample-0-1.0"),
    pytest.param("sample", 2, 0.7, {}, id="sample-2-0.7"),
    pytest.param("viterbi", 0, 1.0, {}, id="viterbi-0-1.0"),
    pytest.param("viterbi", 2, 1.0, {}, id="viterbi-2-1.0"),
    # W = N_max > 32: the window wider than a warp's lanes
    pytest.param("sample", 0, 0.7, dict(B=5, N_max=40, W=40),
                 id="sample-0-0.7-wide"),
    pytest.param("viterbi", 3, 1.0, dict(B=5, N_max=40, W=40),
                 id="viterbi-3-1.0-wide")])
def test_segment_dp_matches_jax_on_shared_noise(mode, n_min, temp, shape):
    scores, lengths = _case(1, **shape)
    B, N, W = scores.shape
    key = jax.random.PRNGKey(4)
    lp_j, b_j = jdp.segment_dp(jnp.asarray(scores), jnp.asarray(lengths), key,
                               -0.05, temp, n_slices_min=n_min,
                               n_slices_max=W, mode=mode)
    noise = np.array(jax.random.gumbel(key, (B, N, W), jnp.float64))
    lp_t, b_t = tdp.segment_dp(torch.as_tensor(scores),
                               torch.as_tensor(lengths), -0.05, temp,
                               n_slices_min=n_min, n_slices_max=W, mode=mode,
                               noise=torch.as_tensor(noise))
    npt.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    npt.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10,
                        atol=1e-10)


def test_backtracking_fallback_matches_jax():
    """Every continuation of a node is -inf: the fallback force-inserts a
    boundary (reference unigram_acoustic_wordseg.py:718-730)."""
    scores = np.full((1, 3, 2), -np.inf)
    scores[0, 2, 0] = 0.5
    scores[0, 0, 0] = 0.2
    key = jax.random.PRNGKey(0)
    _, b_j = jdp.segment_dp(jnp.asarray(scores), jnp.asarray([3]), key,
                            n_slices_max=2)
    noise = np.array(jax.random.gumbel(key, (1, 3, 2), jnp.float64))
    _, b_t = tdp.segment_dp(torch.as_tensor(scores), torch.tensor([3]),
                            n_slices_max=2, noise=torch.as_tensor(noise))
    npt.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    assert b_t[0, 2]


def test_visited_closure_matches_jax():
    rng = np.random.RandomState(3)
    B, N = 6, 13
    v = np.arange(1, N + 1)
    p = np.concatenate([np.zeros((B, 1), np.int64),
                        np.maximum(v[None] - rng.randint(1, 4, (B, N)), 0)],
                       axis=1)
    lengths = rng.randint(0, N + 1, B)
    want = np.asarray(jdp._visited_closure(jnp.asarray(p),
                                           jnp.asarray(lengths)))
    got = tdp._visited_closure(torch.as_tensor(p), torch.as_tensor(lengths))
    npt.assert_array_equal(got.numpy(), want)


def test_generator_noise_is_reproducible():
    scores, lengths = _case(2)
    runs = [tdp.segment_dp(torch.as_tensor(scores), torch.as_tensor(lengths),
                           n_slices_max=scores.shape[-1],
                           generator=torch.Generator().manual_seed(8))[1]
            for _ in range(2)]
    assert torch.equal(*runs)


def test_segment_dp_on_cpu_takes_the_plain_composition():
    """A CPU tensor never reaches the kernel: ``segment_dp`` is
    ``segment_dp_plain`` there, and K2 counts no launch."""
    scores, lengths = _case(5)
    B, N, W = scores.shape
    noise = torch.as_tensor(np.random.RandomState(6).gumbel(size=(B, N, W)))
    before = cuda_dp.launches
    got = tdp.segment_dp(torch.as_tensor(scores), torch.as_tensor(lengths),
                         -0.05, 0.7, n_slices_min=2, n_slices_max=W,
                         noise=noise)
    want = tdp.segment_dp_plain(torch.as_tensor(scores),
                                torch.as_tensor(lengths), -0.05, 0.7, 2,
                                False, noise)
    assert cuda_dp.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_entry_takes_only_cuda_tensors():
    scores, lengths = _case(5)
    with pytest.raises(ValueError):
        cuda_dp.segment_dp(torch.as_tensor(scores, dtype=torch.float32),
                           torch.as_tensor(lengths), 0.0, 1.0, 0, True, None)


H100_SMEM_LIMIT = 232_448  # opt-in shared memory a block; no static


@pytest.mark.parametrize("N,W,noise,form,warps,smem", [
    # per warp: the rows 4 round4(N W) (twice with the noise), the padded
    # rows 4 N 8 (W <= 8), the alphas round4(W + N), the exps round4(W),
    # four [N + 1] arrays
    (20, 6, True, "smem", 4, 8_512),       # the flagship: 2,128 a warp
    (20, 6, False, "smem", 4, 6_592),      # Viterbi draws no noise
    (120, 6, True, "smem", 4, 48_512),     # the long shape
    (120, 120, True, "smem", 1, 118_624),  # W = N_max = 120
    (120, 120, False, "smem", 3, 183_072),  # 61,024 a warp
    (180, 180, True, "global", 4, 20_416),  # 264 KB of rows a warp
    (180, 180, False, "smem", 1, 134_704),
])
def test_dp_launch_plan(N, W, noise, form, warps, smem):
    plan = cuda_dp.launch_plan(N, W, noise, H100_SMEM_LIMIT)
    assert plan == (form, warps, smem)
    assert plan.smem == warps * cuda_dp.smem_bytes(N, W, form == "smem",
                                                   noise)
    assert plan.smem <= H100_SMEM_LIMIT


def test_dp_launch_plan_follows_the_limit_and_raises():
    need = cuda_dp.smem_bytes(120, 120, True, True)
    assert cuda_dp.launch_plan(120, 120, True, need).form == "smem"
    assert cuda_dp.launch_plan(120, 120, True, need - 4).form == "global"
    with pytest.raises(ValueError):  # not even the per-node arrays fit
        cuda_dp.launch_plan(20, 6, True, 512)
    with pytest.raises(ValueError):
        cuda_dp.launch_plan(0, 6, True, H100_SMEM_LIMIT)


# ------------------------------------------ oracles on the port's own path
# tests/test_dp.py's oracles, run on the port's ``segment_dp`` and its
# module-level API with the port's own noise (a ``torch.Generator``):
# shared-noise parity cannot see a fault in the port's own draws.

def oracle_viterbi(scores, length, n_min, n_max):
    """Max-product segmentation on dense scores[t, w], ties toward shorter
    segments; returns (score, bounds) (tests/test_dp.py)."""
    n_min = max(n_min, 1)
    alpha = np.full(length + 1, -np.inf)
    alpha[0] = 0.0
    back = np.zeros(length + 1, dtype=int)
    for t in range(1, length + 1):
        best, best_k = -np.inf, 0
        for k in range(n_min, min(n_max, t) + 1):
            v = scores[t - 1, k - 1] + alpha[t - k]
            if v > best:
                best, best_k = v, k
        alpha[t], back[t] = best, best_k
    bounds = np.zeros(scores.shape[0], dtype=bool)
    bounds[length - 1] = True
    t, total = length, 0.0
    while t > 0:
        k = back[t]
        total += scores[t - 1, k - 1]
        if t - k - 1 >= 0:
            bounds[t - k - 1] = True
        t -= k
    return total, bounds


def _oracle_scores(rng, B, N_max, W, lengths):
    s = rng.randn(B, N_max, W) * 3.0
    t = np.arange(N_max)[None, :, None]
    w = np.arange(W)[None, None, :]
    s[(w > t) | (t >= np.asarray(lengths)[:, None, None])] = -np.inf
    return s


@pytest.mark.parametrize("case", [
    pytest.param(dict(seed=0, W=4, n_min=0, lengths=[9, 7, 4, 1, 6]),
                 id="viterbi_matches_oracle"),
    pytest.param(dict(seed=1, W=5, n_min=2, lengths=[8, 8, 5, 3]),
                 id="viterbi_with_min_slices"),
    pytest.param(dict(seed=2, W=4, n_min=0, lengths=[9, 7, 4, 1, 6, 9],
                      ties=True), id="viterbi_tied_scores")])
def test_viterbi_matches_oracle(case):
    """tests/test_dp.py's Viterbi oracles (without and with n_slices_min)
    on the port; ``ties``: integer scores, half of them equal a slice
    across every window (every segmentation of those utterances ties), so
    the tie rule decides the path."""
    rng = np.random.RandomState(case["seed"])
    lengths, W, n_min = np.array(case["lengths"]), case["W"], case["n_min"]
    B, N_max = len(lengths), int(lengths.max())
    scores = _oracle_scores(rng, B, N_max, W, lengths)
    if case.get("ties"):
        per_slice = np.round(rng.randn(B, 1, 1) * 2.0)
        tied = per_slice * (np.arange(W) + 1)[None, None, :]
        scores = np.where(np.isfinite(scores), np.round(scores), scores)
        scores[::2] = np.where(np.isfinite(scores[::2]), tied[::2], -np.inf)
    lp, bounds = tdp.segment_dp(torch.as_tensor(scores),
                                torch.as_tensor(lengths), n_slices_min=n_min,
                                n_slices_max=W, mode="viterbi")
    lp_j, b_j = jdp.segment_dp(jnp.asarray(scores), jnp.asarray(lengths),
                               jax.random.PRNGKey(0), n_slices_min=n_min,
                               n_slices_max=W, mode="viterbi")
    npt.assert_array_equal(bounds.numpy(), np.asarray(b_j))
    for b in range(B):
        want_lp, want_b = oracle_viterbi(scores[b], lengths[b], n_min, W)
        npt.assert_allclose(float(lp[b]), want_lp, rtol=1e-12)
        npt.assert_array_equal(bounds[b].numpy(), want_b)
        idx = np.where(bounds[b].numpy()[:lengths[b]])[0]
        spans = np.diff(np.concatenate([[-1], idx]))
        assert np.all(spans[1:] >= max(n_min, 1))
        if case.get("ties") and b % 2 == 0:  # all one-slice segments
            assert bounds[b, :lengths[b]].all()


def test_ffbs_boundary_distribution():
    """tests/test_dp.py: two landmarks, the split's odds in closed form,
    4000 draws of the port's own noise; log_prob is the chosen path's
    score."""
    s01, s12, s02 = 1.0, 0.3, 1.5
    scores = np.full((1, 2, 2), -np.inf)
    scores[0, 0, 0], scores[0, 1, 0], scores[0, 1, 1] = s01, s12, s02
    p_split = np.exp(s01 + s12) / (np.exp(s01 + s12) + np.exp(s02))
    n = 4000
    lp, bounds = tdp.segment_dp(
        torch.as_tensor(np.repeat(scores, n, axis=0)),
        torch.full((n,), 2, dtype=torch.int32), n_slices_max=2,
        mode="sample", generator=torch.Generator().manual_seed(7))
    split = bounds[:, 0].numpy()
    assert abs(split.mean() - p_split) < 0.03, (split.mean(), p_split)
    npt.assert_allclose(lp.numpy(), np.where(split, s01 + s12, s02),
                        rtol=1e-12)


def test_ffbs_full_distribution_three_landmarks():
    """tests/test_dp.py: the sampled frequencies of all four segmentations
    of a 3-landmark utterance match the exact posterior."""
    rng = np.random.RandomState(5)
    N = W = 3
    scores = rng.randn(N, W)
    scores[np.arange(W)[None, :] > np.arange(N)[:, None]] = -np.inf
    logp = {}
    for b0, b1 in itertools.product((False, True), repeat=2):
        total, start = 0.0, 0
        for t, is_b in enumerate((b0, b1, True)):
            if is_b:
                total += scores[t, t - start]
                start = t + 1
        logp[(b0, b1)] = total
    Z = sum(np.exp(v) for v in logp.values())
    n = 8000
    _, bounds = tdp.segment_dp(
        torch.as_tensor(np.repeat(scores[None], n, axis=0)),
        torch.full((n,), N, dtype=torch.int32), n_slices_max=W,
        mode="sample", generator=torch.Generator().manual_seed(3))
    bounds = bounds.numpy()
    for (b0, b1), v in logp.items():
        frac = np.mean((bounds[:, 0] == b0) & (bounds[:, 1] == b1))
        assert abs(frac - np.exp(v) / Z) < 0.025, ((b0, b1), frac)


def test_module_level_forward_backward_triangular_api():
    """tests/test_dp.py: the packed-triangular module functions of the
    port (``segmenters.unigram.forward_backward`` /
    ``forward_backward_viterbi``, ``segmenters.kmeans_seg.
    forward_backward_kmeans_viterbi``) against brute-force enumeration;
    ``forward_backward`` draws 3000 times from the port's generator."""
    from segmentalist_torch.segmenters.kmeans_seg import (
        forward_backward_kmeans_viterbi)
    from segmentalist_torch.segmenters.unigram import (
        forward_backward, forward_backward_viterbi)

    rng = np.random.RandomState(0)
    N, W = 4, 3
    vec = rng.randn(N * (N + 1) // 2) * 2.0

    def seg_score(pattern):  # boundary bools, the last True
        total, j_prev, n_seg = 0.0, 0, 0
        for j, b in enumerate(pattern):
            if b:
                if j - j_prev + 1 > W:
                    return -np.inf, 0
                total += vec[(j + 1) * j // 2 + j_prev]
                j_prev, n_seg = j + 1, n_seg + 1
        return total, n_seg

    patterns = [p + (True,) for p in
                itertools.product([False, True], repeat=N - 1)]
    scored = {p: seg_score(p) for p in patterns}
    best = max(patterns, key=lambda p: scored[p][0])
    f64 = dict(device="cpu", dtype=torch.float64)
    lp, bounds = forward_backward_viterbi(vec, 0.0, N, n_slices_max=W, **f64)
    assert tuple(bounds[:N].tolist()) == best
    npt.assert_allclose(lp, scored[best][0], rtol=1e-12)
    obj, bounds = forward_backward_kmeans_viterbi(vec, N, n_slices_max=W,
                                                  **f64)
    assert tuple(bounds[:N].tolist()) == best
    npt.assert_allclose(obj, scored[best][0], rtol=1e-12)

    lpc = np.log(0.7)
    logp = np.array([scored[p][0] + scored[p][1] * lpc
                     if np.isfinite(scored[p][0]) else -np.inf
                     for p in patterns])
    target = np.exp(logp - logp.max())
    target /= target.sum()
    gen = torch.Generator().manual_seed(1)
    freq = dict.fromkeys(patterns, 0)
    n_draws = 3000
    for _ in range(n_draws):
        _, b = forward_backward(vec, lpc, N, n_slices_max=W, generator=gen,
                                **f64)
        freq[tuple(b[:N].tolist())] += 1
    emp = np.array([freq[p] / n_draws for p in patterns])
    assert 0.5 * np.abs(emp - target).sum() < 0.05, (emp, target)
