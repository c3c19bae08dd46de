"""Kernel K4 (bigram-conditioned fixed-variance assignment chain): the
port's plain version against the JAX package's Pallas kernel in interpret
mode (``stats_T`` layout), on shared Gumbel noise.  The sampled components
must be exactly equal, at float64 and float32.

The bigram tables count every pair they are corrected for (each
utterance's own old pairs are part of the global table), as the segmenter
guarantees by reading the LM before merging a block."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.ops.pallas_chain import bigram_fixedvar_chain as j_chain

from segmentalist_torch.models.bigram_lm import transcript_pairs_batch
from segmentalist_torch.ops import cuda_chain


def _case(seed, B=6, S=7, D=4, K=10, N=64, dtype=np.float64):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    var, var_0, mu_0 = 0.1 * np.ones(D), np.ones(D), np.zeros(D)
    counts = rng.randint(0, 4, (B, K)).astype(np.int32)
    counts[:, [3, 7]] = 0  # empty slots to be born
    sum_xT = counts[:, None, :] * rng.randn(B, D, K) * 0.5
    embeds = rng.randint(0, N, (B, S)).astype(np.int32)
    embeds[rng.rand(B, S) < 0.25] = -1   # pads and missing embeddings
    embeds[0, 5:] = -1
    embeds[1] = -1                       # an all-padding utterance
    Xe = X[np.maximum(embeds, 0)]
    lpe = -0.5 * ((Xe - mu_0) ** 2 / var_0).sum(-1) - 2.0
    gumb = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (B, S, K),
                                        jnp.float64))
    # The utterances' old transcripts and their (prev, cur) pairs; the
    # global table counts them all on top of the other utterances' pairs.
    old = rng.randint(-1, K, (B, S)).astype(np.int32)
    pj, pi = (t.numpy() for t in transcript_pairs_batch(torch.as_tensor(old)))
    big = rng.randint(0, 5, (K, K)).astype(np.int32)
    np.add.at(big, (pj[pj >= 0], pi[pj >= 0]), 1)
    uni_lo = rng.randint(0, 8, (B, K)).astype(np.int32)
    arrays = dict(embeds=embeds, Xe=Xe, lpe=lpe, gumbel=gumb, counts=counts,
                  sum_xT=sum_xT, var=var, var_0=var_0, mu_0=mu_0,
                  uni_lo=uni_lo, big=big, corr_j=pj, corr_i=pi)
    return {k: (v.astype(dtype) if v.dtype == np.float64 else v)
            for k, v in arrays.items()}, K


def _args(c, mod):
    t = {k: mod(np.array(v)) for k, v in c.items()}
    return (t["embeds"], t["Xe"], t["lpe"], t["gumbel"], t["counts"],
            t["sum_xT"], t["var"], t["var_0"], t["mu_0"])


def _lm_args(c, mod):
    return tuple(mod(np.array(c[k]))
                 for k in ("uni_lo", "big", "corr_j", "corr_i"))


def _jax(c, K, temp, lam, lms, a=1.0, b=1.5):
    return np.asarray(j_chain(
        *_args(c, jnp.asarray), temp, *_lm_args(c, jnp.asarray),
        alpha_a=a, intrp_lambda=lam, b_smooth=b, K=K, lms=lms,
        interpret=True, stats_T=True))


def _port(c, K, temp, lam, lms, a=1.0, b=1.5):
    return cuda_chain.bigram_fixedvar_chain(
        *_args(c, torch.as_tensor), temp, *_lm_args(c, torch.as_tensor),
        alpha_a=a, intrp_lambda=lam, b_smooth=b, K=K, lms=lms).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_plain_matches_pallas_exactly(seed, lam):
    c, K = _case(seed)
    want = _jax(c, K, 0.7, lam, 1.3)
    got = _port(c, K, 0.7, lam, 1.3)
    npt.assert_array_equal(got, want)
    assert (got[c["embeds"] < 0] == -1).all()
    assert (got[1] == -1).all()


@pytest.mark.parametrize("seed,lam", [(3, 0.1), (4, 0.2)])
def test_plain_matches_pallas_f32(seed, lam):
    c, K = _case(seed, dtype=np.float32)
    npt.assert_array_equal(_port(c, K, 1.0, lam, 1.0),
                           _jax(c, K, 1.0, lam, 1.0))


def test_hot_chain_births_and_matches():
    """A hot chain draws empty slots often: each birth takes the lowest
    then-empty slot, and the chains still equal the Pallas kernel's."""
    c, K = _case(5)
    ks = _port(c, K, 5.0, 0.2, 1.0)
    npt.assert_array_equal(ks, _jax(c, K, 5.0, 0.2, 1.0))
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


def test_own_old_pairs_are_removed():
    """Flat acoustic fits, so the LM decides: each utterance's old
    transcript alternates (j_b, i_b), the global table holds exactly the
    utterances' own pairs, and the first draw is pushed onto j_b.  The
    chains equal the Pallas kernel's, and differ from chains that keep the
    utterance's own pairs in the table."""
    B, S, D, K = 8, 6, 2, 10
    j_b, i_b = np.arange(B) % K, (np.arange(B) + 3) % K
    old = np.where(np.arange(S)[None, :] % 2 == 0, j_b[:, None],
                   i_b[:, None]).astype(np.int32)
    pj, pi = (t.numpy() for t in transcript_pairs_batch(torch.as_tensor(old)))
    big = np.zeros((K, K), np.int32)
    np.add.at(big, (pj[pj >= 0], pi[pj >= 0]), 1)
    uni_lo = np.ones((B, K), np.int32)
    uni_lo[np.arange(B), j_b] = 50
    Xe = np.zeros((B, S, D))
    c = dict(embeds=np.arange(B * S, dtype=np.int32).reshape(B, S), Xe=Xe,
             lpe=np.zeros((B, S)),
             gumbel=np.asarray(jax.random.gumbel(jax.random.PRNGKey(9),
                                                 (B, S, K), jnp.float64)),
             counts=np.ones((B, K), np.int32), sum_xT=np.zeros((B, D, K)),
             var=np.ones(D), var_0=np.ones(D), mu_0=np.zeros(D),
             uni_lo=uni_lo, big=big, corr_j=pj, corr_i=pi)
    got = _port(c, K, 1.0, 0.0, 2.0)
    npt.assert_array_equal(got, _jax(c, K, 1.0, 0.0, 2.0))
    c["corr_j"] = np.full_like(pj, -1)  # keep the own pairs in the table
    assert (_port(c, K, 1.0, 0.0, 2.0) != got).any()


def test_first_segment_uses_unigram_weights():
    """With one valid segment per utterance the bigram table is never read:
    a table that would give NaN weights changes nothing."""
    c, K = _case(6)
    c["embeds"][:, 1:] = -1
    want = _port(c, K, 0.9, 0.2, 1.0)
    c["big"] = np.full_like(c["big"], -7)  # would give NaN weights if read
    npt.assert_array_equal(_port(c, K, 0.9, 0.2, 1.0), want)
    npt.assert_array_equal(want, _jax(c, K, 0.9, 0.2, 1.0))


# The H100's opt-in shared memory a block less the kernel's static arrays.
H100_SMEM_LIMIT = 232_448 - 1_024


@pytest.mark.parametrize("D,K,form,smem", [
    # K3's bytes (tests/test_torch_chain.py) plus the old-pair range a
    # column (K words) and the old pairs (2 S words, S 20)
    (13, 200, "smem", 27_068),
    (13, 1000, "smem", 132_668),  # the bigram cell: one column a thread
    (13, 1500, "smem", 198_668),
    (37, 200, "smem", 66_236),
    (37, 1000, "global", 1_436),
    (37, 1500, "global", 1_436),
    (130, 200, "smem", 218_012),
    (130, 1000, "global", 4_412),
    (130, 1500, "global", 4_412),
])
def test_launch_plan_picks_a_form_that_fits(D, K, form, smem):
    plan = cuda_chain.launch_plan(D, K, 20, True, H100_SMEM_LIMIT)
    assert plan.form == form
    assert plan.smem == smem == cuda_chain.smem_bytes(form == "global",
                                                      True, D, 20, K)
    assert plan.smem <= H100_SMEM_LIMIT
    assert plan.threads == min(1024, -(-K // 32) * 32)


def test_launch_plan_follows_the_smem_limit():
    """The smem form exactly when its bytes fit the card's limit."""
    D, K, S = 13, 1000, 20
    need = cuda_chain.smem_bytes(False, True, D, S, K)
    assert cuda_chain.launch_plan(D, K, S, True, need).form == "smem"
    assert cuda_chain.launch_plan(D, K, S, True, need - 4).form == "global"
    with pytest.raises(ValueError):  # not even the global form's arrays
        cuda_chain.launch_plan(130, 1000, 20, True, 1_024)
