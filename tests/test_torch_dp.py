"""Kernel K2 (DP forward filter) and the port's ``segment_dp`` against the
JAX package.

The plain forward filter is held against the Pallas kernel in interpret
mode and the XLA fallback to rtol 1e-12 at f64.  ``segment_dp`` runs on the
same scores and the same backward-draw noise -- the noise JAX draws from
its key at ``dp.py:196`` -- and must give exactly the same boundaries.
"""

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
