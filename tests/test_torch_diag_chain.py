"""Kernels K6 and K7 (diagonal-covariance assignment chains): the port's
plain versions against the JAX package's Pallas kernels in interpret mode
(``stats_T`` layout) and against their XLA twins, on shared Gumbel noise.
The sampled components must be exactly equal, at float64 and float32, in
sample and (K6) argmax mode.

The bigram tables count every pair they are corrected for (each
utterance's own old pairs are part of the global table), as the segmenter
guarantees by reading the LM before merging a block."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.ops import pallas_chain as jpc

from segmentalist_torch.models.bigram_lm import transcript_pairs_batch
from segmentalist_torch.ops import cuda_diag_chain

PRIOR = dict(k_0=1.5, v_0=5.0)


def _case(seed, B=6, S=7, D=4, K=10, N=64, dtype=np.float64):
    """Leave-out statistics like a sweep's (sums from real members, some
    empty slots), segments with pads and lengths that differ across
    utterances, and LM tables that count every old pair."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    counts = rng.randint(0, 5, (B, K)).astype(np.int32)
    counts[:, [3, 7]] = 0                       # empty slots to be born
    Z = rng.randn(B, K, D)
    sum_x = counts[..., None] * Z * 0.4
    sum_sq = counts[..., None] * (Z * Z * 0.16 + 0.5)
    embeds = rng.randint(0, N, (B, S)).astype(np.int32)
    embeds[rng.rand(B, S) < 0.25] = -1          # pads and missing embeddings
    embeds[0, 4:] = -1
    embeds[1] = -1                              # an all-padding utterance
    Xe = X[np.maximum(embeds, 0)]
    lpe = -0.5 * (Xe ** 2).sum(-1) - 2.0
    gumb = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (B, S, K),
                                        jnp.float64))
    old = rng.randint(-1, K, (B, S)).astype(np.int32)
    pj, pi = (t.numpy() for t in transcript_pairs_batch(torch.as_tensor(old)))
    big = rng.randint(0, 5, (K, K)).astype(np.int32)
    np.add.at(big, (pj[pj >= 0], pi[pj >= 0]), 1)
    arrays = dict(
        embeds=embeds, Xe=Xe, lpe=lpe, gumbel=gumb, counts=counts,
        sum_xT=sum_x.transpose(0, 2, 1).copy(),
        sum_sqT=sum_sq.transpose(0, 2, 1).copy(), m_0=0.1 * rng.randn(D),
        S_0=0.4 + rng.rand(D), uni_lo=rng.randint(0, 8, (B, K)).astype(
            np.int32), big=big, corr_j=pj, corr_i=pi)
    return {k: (v.astype(dtype) if v.dtype == np.float64 else v)
            for k, v in arrays.items()}, K


def _args(c, mod):
    t = {k: mod(np.array(v)) for k, v in c.items()}
    return (t["embeds"], t["Xe"], t["lpe"], t["gumbel"], t["counts"],
            t["sum_xT"], t["sum_sqT"], t["m_0"], PRIOR["k_0"], PRIOR["v_0"],
            t["S_0"])


def _lm_args(c, mod):
    return tuple(mod(np.array(c[k]))
                 for k in ("uni_lo", "big", "corr_j", "corr_i"))


def _component_major(args):
    """The XLA twins take [B, K, D] statistics."""
    a = list(args)
    a[5], a[6] = jnp.swapaxes(a[5], 1, 2), jnp.swapaxes(a[6], 1, 2)
    return a


def _jax_k6(c, K, temp, lms, use_argmax, twin=False):
    args = _args(c, jnp.asarray)
    kw = dict(alpha=1.0, K=K, lms=lms, use_argmax=use_argmax)
    if twin:
        return np.asarray(jpc.diag_chain_xla(*_component_major(args), temp,
                                             **kw))
    return np.asarray(jpc.diag_chain(*args, temp, interpret=True,
                                     stats_T=True, **kw))


def _port_k6(c, K, temp, lms, use_argmax):
    return cuda_diag_chain.diag_chain(
        *_args(c, torch.as_tensor), temp, alpha=1.0, K=K, lms=lms,
        use_argmax=use_argmax).numpy()


def _jax_k7(c, K, temp, lam, lms, twin=False, a=1.0, b=1.5):
    args = _args(c, jnp.asarray)
    kw = dict(alpha_a=a, intrp_lambda=lam, b_smooth=b, K=K, lms=lms)
    if twin:
        return np.asarray(jpc.bigram_diag_chain_xla(
            *_component_major(args), temp, *_lm_args(c, jnp.asarray), **kw))
    return np.asarray(jpc.bigram_diag_chain(
        *args, temp, *_lm_args(c, jnp.asarray), interpret=True, stats_T=True,
        **kw))


def _port_k7(c, K, temp, lam, lms, a=1.0, b=1.5):
    return cuda_diag_chain.bigram_diag_chain(
        *_args(c, torch.as_tensor), temp, *_lm_args(c, torch.as_tensor),
        alpha_a=a, intrp_lambda=lam, b_smooth=b, K=K, lms=lms).numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,D", [(0, 4), (1, 13), (2, 6)])
@pytest.mark.parametrize("use_argmax", [False, True])
def test_k6_plain_matches_pallas_exactly(seed, D, use_argmax, dtype):
    c, K = _case(seed, D=D, dtype=dtype)
    lms = 1.0 if use_argmax else 1.3
    got = _port_k6(c, K, 0.7, lms, use_argmax)
    npt.assert_array_equal(got, _jax_k6(c, K, 0.7, lms, use_argmax))
    assert (got[c["embeds"] < 0] == -1).all()
    assert (got[1] == -1).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("use_argmax", [False, True])
def test_k6_plain_matches_xla_twin_exactly(use_argmax, dtype):
    c, K = _case(3, D=5, dtype=dtype)
    npt.assert_array_equal(_port_k6(c, K, 0.9, 1.1, use_argmax),
                           _jax_k6(c, K, 0.9, 1.1, use_argmax, twin=True))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,D,lam", [(4, 4, 0.0), (5, 13, 0.2),
                                        (6, 3, 0.1)])
def test_k7_plain_matches_pallas_exactly(seed, D, lam, dtype):
    c, K = _case(seed, D=D, dtype=dtype)
    got = _port_k7(c, K, 0.7, lam, 1.3)
    npt.assert_array_equal(got, _jax_k7(c, K, 0.7, lam, 1.3))
    assert (got[c["embeds"] < 0] == -1).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k7_plain_matches_xla_twin_exactly(dtype):
    c, K = _case(7, D=5, dtype=dtype)
    npt.assert_array_equal(_port_k7(c, K, 0.85, 0.25, 1.05, b=2.0),
                           _jax_k7(c, K, 0.85, 0.25, 1.05, twin=True, b=2.0))


def test_hot_chain_births_take_the_first_empty_slot():
    """A hot chain draws empty slots often: each birth takes the lowest
    then-empty slot, and the chains still equal the Pallas kernel's."""
    c, K = _case(8)
    ks = _port_k6(c, K, 5.0, 1.0, False)
    npt.assert_array_equal(ks, _jax_k6(c, K, 5.0, 1.0, False))
    n_born = 0
    for b in range(ks.shape[0]):
        cnt = c["counts"][b].copy()
        for k in ks[b]:
            if k < 0:
                continue
            if cnt[k] == 0:
                assert k == np.flatnonzero(cnt == 0)[0]
                n_born += 1
            cnt[k] += 1
    assert n_born > 3


def _own_pair_case():
    """Flat acoustics, so the LM decides: each utterance's old transcript
    alternates (j_b, i_b), the global table holds exactly the utterances'
    own pairs, and the first draw is pushed onto j_b."""
    B, S, D, K = 8, 6, 2, 10
    j_b, i_b = np.arange(B) % K, (np.arange(B) + 3) % K
    old = np.where(np.arange(S)[None, :] % 2 == 0, j_b[:, None],
                   i_b[:, None]).astype(np.int32)
    pj, pi = (t.numpy() for t in transcript_pairs_batch(torch.as_tensor(old)))
    big = np.zeros((K, K), np.int32)
    np.add.at(big, (pj[pj >= 0], pi[pj >= 0]), 1)
    uni_lo = np.ones((B, K), np.int32)
    uni_lo[np.arange(B), j_b] = 50
    c = dict(embeds=np.arange(B * S, dtype=np.int32).reshape(B, S),
             Xe=np.zeros((B, S, D)), lpe=np.zeros((B, S)),
             gumbel=np.asarray(jax.random.gumbel(jax.random.PRNGKey(9),
                                                 (B, S, K), jnp.float64)),
             counts=np.ones((B, K), np.int32), sum_xT=np.zeros((B, D, K)),
             sum_sqT=np.ones((B, D, K)), m_0=np.zeros(D), S_0=np.ones(D),
             uni_lo=uni_lo, big=big, corr_j=pj, corr_i=pi)
    return c, K


def test_k7_own_old_pairs_are_removed():
    """The chains equal the Pallas kernel's, and differ from chains that
    keep the utterance's own pairs in the table."""
    c, K = _own_pair_case()
    got = _port_k7(c, K, 1.0, 0.0, 2.0)
    npt.assert_array_equal(got, _jax_k7(c, K, 1.0, 0.0, 2.0))
    c["corr_j"] = np.full_like(c["corr_j"], -1)  # keep the own pairs
    assert (_port_k7(c, K, 1.0, 0.0, 2.0) != got).any()


def test_k7_own_pair_mutation_is_caught(monkeypatch):
    """A plain version whose LM weights forget the own-pair correction
    (the mutation) no longer matches the Pallas kernel on the crafted
    case: the test above would catch it."""
    from segmentalist_torch.ops import cuda_chain

    real = cuda_chain.bigram_lm_weights

    def dropped(uni_lo, big, corr_j, corr_i, *rest):
        return real(uni_lo, big, torch.full_like(corr_j, -1), corr_i, *rest)

    c, K = _own_pair_case()
    want = _jax_k7(c, K, 1.0, 0.0, 2.0)
    monkeypatch.setattr(cuda_diag_chain, "bigram_lm_weights", dropped)
    assert (_port_k7(c, K, 1.0, 0.0, 2.0) != want).any()


def test_k7_first_segment_uses_unigram_weights():
    """With one valid segment per utterance the bigram table is never read:
    a table that would give NaN weights changes nothing."""
    c, K = _case(10)
    c["embeds"][:, 1:] = -1
    want = _port_k7(c, K, 0.9, 0.2, 1.0)
    c["big"] = np.full_like(c["big"], -7)  # would give NaN weights if read
    npt.assert_array_equal(_port_k7(c, K, 0.9, 0.2, 1.0), want)
    npt.assert_array_equal(want, _jax_k7(c, K, 0.9, 0.2, 1.0))


# The H100's opt-in shared memory a block less the kernel's static arrays.
H100_SMEM_LIMIT = 232_448 - 1_024


@pytest.mark.parametrize("D,K,S,form,bytes_k6,bytes_k7", [
    # the flagship: 1024 threads, one column each; per column
    # 2 D + 7 (K7: 8) words, plus x and prior 3 (D + 1), prior terms, the
    # updated column's log variances and its sums sx, ssq 5 D, steps S (K7:
    # and the old pairs 2 S)
    (13, 1000, 20, "smem", 132_508, 136_668),
    (37, 200, 20, "smem", 66_076, 67_036),
    (130, 1000, 120, "global", 4_652, 5_612),  # 1 MB of tables: no column
    (13, 5000, 20, "global", 508, 668),
])
@pytest.mark.parametrize("bigram", [False, True])
def test_launch_plan_picks_a_form_that_fits(D, K, S, form, bytes_k6,
                                            bytes_k7, bigram):
    plan = cuda_diag_chain.launch_plan(D, K, S, bigram, H100_SMEM_LIMIT)
    assert plan.form == form
    assert plan.smem == (bytes_k7 if bigram else bytes_k6)
    assert plan.smem <= H100_SMEM_LIMIT
    assert plan.threads == min(1024, -(-K // 32) * 32)


@pytest.mark.parametrize("bigram", [False, True])
def test_launch_plan_follows_the_smem_limit(bigram):
    """The smem form exactly when its bytes fit the card's limit."""
    D, K, S = 13, 1000, 20
    need = cuda_diag_chain.smem_bytes(False, bigram, D, S, K)
    assert cuda_diag_chain.launch_plan(D, K, S, bigram, need).form == "smem"
    assert cuda_diag_chain.launch_plan(D, K, S, bigram,
                                       need - 4).form == "global"


def test_launch_plan_raises_where_no_form_fits():
    with pytest.raises(ValueError):  # not even the global form's arrays
        cuda_diag_chain.launch_plan(130, 1000, 20, False, 1_024)
    with pytest.raises(ValueError):
        cuda_diag_chain.launch_plan(13, 1000, 1 << 15, False,
                                    H100_SMEM_LIMIT)
