"""Kernel K3 (fixed-variance assignment chain): the port's plain version
against the JAX package's Pallas kernel in interpret mode (``stats_T``
layout), on shared Gumbel noise.  The sampled components must be exactly
equal, in sample and argmax modes."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.ops.pallas_chain import fixedvar_chain as j_chain

from segmentalist_torch.ops import cuda_chain


def _case(seed, B=5, S=7, D=4, K=10, N=64, full=False, dtype=np.float64):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    var, var_0, mu_0 = 0.1 * np.ones(D), np.ones(D), np.zeros(D)
    counts = rng.randint(0, 4, (B, K)).astype(np.int32)
    if full:
        counts = np.maximum(counts, 1)
    else:
        counts[:, [3, 7]] = 0  # empty slots to be born
    sum_xT = counts[:, None, :] * rng.randn(B, D, K) * 0.5
    embeds = rng.randint(0, N, (B, S)).astype(np.int32)
    embeds[rng.rand(B, S) < 0.25] = -1   # pads and missing embeddings
    embeds[0, 5:] = -1
    Xe = X[np.maximum(embeds, 0)]
    lpe = -0.5 * ((Xe - mu_0) ** 2 / var_0).sum(-1) - 2.0
    gumb = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (B, S, K),
                                        jnp.float64))
    arrays = dict(embeds=embeds, Xe=Xe, lpe=lpe, gumbel=gumb, counts=counts,
                  sum_xT=sum_xT, var=var, var_0=var_0, mu_0=mu_0)
    return {k: (v.astype(dtype) if v.dtype == np.float64 else v)
            for k, v in arrays.items()}, K


def _jax(c, K, temp, lms, use_argmax):
    j = {k: jnp.asarray(v) for k, v in c.items()}
    return np.asarray(j_chain(
        j["embeds"], j["Xe"], j["lpe"], j["gumbel"], j["counts"],
        j["sum_xT"], j["var"], j["var_0"], j["mu_0"], temp, alpha=1.0, K=K,
        lms=lms, use_argmax=use_argmax, interpret=True, stats_T=True))


def _port(c, K, temp, lms, use_argmax):
    t = {k: torch.as_tensor(np.array(v)) for k, v in c.items()}
    return cuda_chain.fixedvar_chain(
        t["embeds"], t["Xe"], t["lpe"], t["gumbel"], t["counts"],
        t["sum_xT"], t["var"], t["var_0"], t["mu_0"], temp, alpha=1.0, K=K,
        lms=lms, use_argmax=use_argmax)


@pytest.mark.parametrize("seed,full", [(0, False), (1, False), (2, True)])
@pytest.mark.parametrize("use_argmax", [False, True])
def test_plain_matches_pallas_exactly(seed, full, use_argmax):
    c, K = _case(seed, full=full)
    lms = 1.0 if use_argmax else 1.3
    want = _jax(c, K, 0.7, lms, use_argmax)
    got = _port(c, K, 0.7, lms, use_argmax).numpy()
    npt.assert_array_equal(got, want)
    assert (got[c["embeds"] < 0] == -1).all()


def test_births_take_the_first_empty_slot():
    """Replaying a hot chain (many draws on empty slots): every segment put
    on a then-empty slot went to the lowest empty slot.  With every slot
    occupied no draw can land on an empty one, so nothing is born (the
    ``K - 1`` clamp of ``canonicalize_new_component`` is for a full table,
    see test_torch_ops)."""
    for full in (False, True):
        c, K = _case(0, full=full)
        ks = _port(c, K, 5.0, 1.0, False).numpy()
        npt.assert_array_equal(ks, _jax(c, K, 5.0, 1.0, False))
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
        assert (n_born == 0) if full else (n_born > 3)


def test_plain_matches_pallas_f32():
    c, K = _case(3, dtype=np.float32)
    npt.assert_array_equal(_port(c, K, 1.0, 1.0, False).numpy(),
                           _jax(c, K, 1.0, 1.0, False))


# The H100's opt-in shared memory a block less the kernel's static arrays.
H100_SMEM_LIMIT = 232_448 - 1_024


@pytest.mark.parametrize("D,K,form,smem", [
    # per column mu and pp [D], cnt, the hoisted term, the weight, the
    # touched slot and two noise values: 2 D + 6 words; plus x and prior
    # 3 (D + 1), prec, prec0, p0m0, the updated column's logs and sums 5 D,
    # steps S (20)
    (13, 200, "smem", 26_108),
    (13, 1000, "smem", 128_508),  # the flagship, one column a thread
    (13, 1500, "smem", 192_508),
    (37, 200, "smem", 65_276),
    (37, 1000, "global", 1_276),  # 296 KB of tables: no column on chip
    (37, 1500, "global", 1_276),
    (130, 200, "smem", 217_052),
    (130, 1000, "global", 4_252),  # the long shape
    (130, 1500, "global", 4_252),
])
def test_launch_plan_picks_a_form_that_fits(D, K, form, smem):
    plan = cuda_chain.launch_plan(D, K, 20, False, H100_SMEM_LIMIT)
    assert plan.form == form
    assert plan.smem == smem == cuda_chain.smem_bytes(form == "global",
                                                      False, D, 20, K)
    assert plan.smem <= H100_SMEM_LIMIT
    assert plan.threads == min(1024, -(-K // 32) * 32)


def test_launch_plan_follows_the_smem_limit():
    """The smem form exactly when its bytes fit the card's limit."""
    D, K, S = 13, 1000, 20
    need = cuda_chain.smem_bytes(False, False, D, S, K)
    assert cuda_chain.launch_plan(D, K, S, False, need).form == "smem"
    assert cuda_chain.launch_plan(D, K, S, False, need - 4).form == "global"


def test_launch_plan_raises_where_no_form_fits():
    with pytest.raises(ValueError):  # not even the global form's arrays
        cuda_chain.launch_plan(130, 1000, 20, False, 1_024)
    with pytest.raises(ValueError):
        cuda_chain.launch_plan(13, 1000, 1 << 15, False, H100_SMEM_LIMIT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pp_recomputed_from_the_count_equals_the_table(dtype):
    """The global form of K3 / K4 recomputes a column's pp from its count
    alone (prec_n = prec0 + c prec; pp = prec_n prec / (prec_n + prec)),
    where the plain version and the smem form keep the table derived with
    the means: the same operations on the same values, so the same bits,
    for empty, small and large counts."""
    rng = np.random.RandomState(5)
    D, K = 13, 400
    var = torch.as_tensor(0.01 + rng.rand(D), dtype=dtype)
    var_0 = torch.as_tensor(0.5 + rng.rand(D), dtype=dtype)
    mu_0 = torch.as_tensor(rng.randn(D), dtype=dtype)
    prec, prec0 = 1.0 / var, 1.0 / var_0
    counts = rng.randint(0, 60, K) * (rng.rand(K) > 0.4)
    counts[:5] = [0, 1, 999, 10 ** 5, 10 ** 7]
    cnt = torch.as_tensor(counts, dtype=dtype)
    sx = cnt[None, :] * torch.as_tensor(rng.randn(D, K), dtype=dtype)
    for c in (cnt, cnt + 1.0):  # the init's counts and an update's
        _, table = cuda_chain._derive(prec[:, None], prec0[:, None],
                                      (prec0 * mu_0)[:, None], c[None, :],
                                      sx)
        for k in range(K):
            prec_n = prec0 + c[k] * prec
            assert torch.equal(table[:, k], prec_n * prec / (prec_n + prec))
