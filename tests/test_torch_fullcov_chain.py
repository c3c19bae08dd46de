"""Kernel K9 (the full-covariance touched-slot chain): the port's plain
versions against the JAX package's Pallas kernel in interpret mode
(``fullcov_chain_pallas``) and against its XLA twin
(``segmenters.fullcov.fullcov_chain``), on shared Gumbel noise.  The
sampled components must be exactly equal, at float64 and float32, in
sample and argmax mode and in the bigram mode.

The inputs are a sweep's: global statistics of real members, per-utterance
old segments (a touched set with a duplicate component), new segments with
pads, a mid-sequence missing embedding and an all-padding utterance, and
bigram tables that count every old pair."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import components_full as jcf
from segmentalist_tpu.models.bigram_lm import transcript_pairs_batch
from segmentalist_tpu.ops.pallas_chain import fullcov_chain_pallas
from segmentalist_tpu.ops.stats import suff_stats_from_assignments
from segmentalist_tpu.priors import NIW as JNIW
from segmentalist_tpu.segmenters import fullcov as jfull

import segmentalist_torch as pt
from segmentalist_torch.models import components_full as tcf
from segmentalist_torch.ops import cuda_fullcov_chain
from segmentalist_torch.ops.stats import SuffStats
from segmentalist_torch.segmenters import fullcov as tfull

LM = dict(a=1.0, lam=0.2, b=1.5)


def _case(seed, B=5, S=6, D=4, K=7, N=60):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    S_0 = np.eye(D) + 0.1 * np.ones((D, D))
    prior = JNIW.create(np.zeros(D), 1.0, D + 2.0, S_0)
    assign = rng.randint(-1, K - 2, N).astype(np.int32)  # 2 slots empty
    stats = suff_stats_from_assignments(jnp.asarray(X), jnp.asarray(assign),
                                        K, full_cov=True)
    members = rng.permutation(np.nonzero(assign >= 0)[0])
    old_embeds = np.full((B, S), -1, np.int32)
    n_old = rng.randint(1, S + 1, B)
    n_old[-1] = 0                                   # no old segments
    pos = 0
    for b in range(B):
        old_embeds[b, :n_old[b]] = members[pos:pos + n_old[b]]
        pos += n_old[b]
    old_ks = np.where(old_embeds >= 0, assign[np.maximum(old_embeds, 0)],
                      -1).astype(np.int32)
    new_embeds = rng.randint(0, N, (B, S)).astype(np.int32)
    new_embeds[rng.rand(B, S) < 0.2] = -1           # pads, missing embeds
    new_embeds[0, 2] = -1                           # a mid-sequence one
    new_embeds[1] = -1                              # an all-padding row
    new_embeds[2, :] = np.arange(S) % 3             # frequent repeats
    gumbel = jax.random.gumbel(jax.random.PRNGKey(seed), (B, S, K),
                               jnp.float64)
    params_g = jcf.predictive_params(prior, stats)
    touched = jfull.touched_leave_out(prior, stats, jnp.asarray(X),
                                      jnp.asarray(old_embeds),
                                      jnp.asarray(old_ks))
    lo_counts = stats.counts[None] - jfull.counts_contrib(
        jnp.asarray(old_ks), jnp.asarray(old_embeds >= 0), K)
    rows = jnp.asarray(np.maximum(new_embeds, 0))
    Xe = jnp.asarray(X)[rows]
    base = jcf.log_post_pred_batch(params_g, Xe.reshape(B * S, D)).reshape(
        B, S, K)
    lpv = jcf.log_prior_batch(prior, jnp.asarray(X))
    pj, pi = transcript_pairs_batch(jnp.asarray(old_ks))
    big = rng.randint(0, 4, (K, K)).astype(np.int32)
    pj_n, pi_n = np.asarray(pj), np.asarray(pi)
    np.add.at(big, (pj_n[pj_n >= 0], pi_n[pj_n >= 0]), 1)
    uni_lo = np.asarray(lo_counts) + rng.randint(0, 3, (B, K))
    return dict(X=X, prior=prior, stats=stats, params_g=params_g,
                touched=touched, lo_counts=lo_counts, new_embeds=new_embeds,
                old_embeds=old_embeds, old_ks=old_ks, gumbel=gumbel,
                base=base, Xe=Xe, lpe=lpv[rows], lpv=lpv, K=K,
                lm=(uni_lo.astype(np.int32), big, pj_n, pi_n))


def _inputs(c, dtype):
    """K9's inputs as numpy arrays (P-form tables from the JAX package)."""
    scnt, tm, tiP, tld, tk, g_m, g_iP, g_ld = jfull.pallas_chain_inputs(
        c["prior"], c["params_g"], c["stats"].counts, c["touched"])
    f = lambda a: np.asarray(a).astype(dtype)  # noqa: E731
    return dict(embeds=c["new_embeds"], Xe=f(c["Xe"]), lpe=f(c["lpe"]),
                gumbel=f(c["gumbel"]), base=f(c["base"]),
                counts=np.asarray(c["lo_counts"]), scnt=f(scnt), tm=f(tm),
                tiP=f(tiP), tld=f(tld), tk=np.asarray(tk, np.int32),
                g_m=f(g_m), g_iP=f(g_iP), g_ld=f(g_ld),
                k0=float(c["prior"].k_0), v0=float(c["prior"].v_0))


def _jax_pallas(c, dtype, temp, lms, use_argmax=False, bigram=False,
                lm_params=LM):
    a = _inputs(c, dtype)
    j = lambda k: jnp.asarray(a[k])  # noqa: E731
    kw = {}
    if bigram:
        kw = dict(uni_lo=jnp.asarray(c["lm"][0]),
                  big_table=jnp.asarray(c["lm"][1]),
                  corr_j=jnp.asarray(c["lm"][2]),
                  corr_i=jnp.asarray(c["lm"][3]),
                  lm_params=(lm_params["a"], lm_params["lam"],
                             lm_params["b"]))
    return np.asarray(fullcov_chain_pallas(
        j("embeds"), j("Xe"), j("lpe"), j("gumbel"), j("base"), j("counts"),
        j("scnt"), j("tm"), j("tiP"), j("tld"), j("tk"), j("g_m"), j("g_iP"),
        j("g_ld"), a["k0"], a["v0"], temp, alpha=0.0 if bigram else 1.0,
        K=c["K"], lms=lms, use_argmax=use_argmax, interpret=True, **kw))


def _port(c, dtype, temp, lms, use_argmax=False, bigram=False, lm=None,
          lm_params=LM):
    a = _inputs(c, dtype)
    t = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
         for k, v in a.items()}
    args = (t["embeds"], t["Xe"], t["lpe"], t["gumbel"], t["base"],
            t["counts"], t["tm"], t["tiP"], t["tld"], t["tk"], t["g_m"],
            t["g_iP"], t["g_ld"], t["k0"], t["v0"], temp)
    if bigram:
        lm = tuple(torch.from_numpy(np.array(x)) for x in (lm or c["lm"]))
        return cuda_fullcov_chain.bigram_fullcov_chain(
            *args, *lm, alpha_a=lm_params["a"],
            intrp_lambda=lm_params["lam"], b_smooth=lm_params["b"],
            K=c["K"], lms=lms).numpy()
    return cuda_fullcov_chain.fullcov_chain(
        *args, alpha=1.0, K=c["K"], lms=lms, use_argmax=use_argmax).numpy()


def _jax_twin(c, temp, lms, use_argmax=False, bigram=False):
    kw = {}
    K, dtype = c["K"], jnp.float64
    if bigram:
        uni_lo, big, pj, pi = (jnp.asarray(x) for x in c["lm"])
        uni_f = uni_lo.astype(dtype)
        den = jnp.sum(uni_f, -1, keepdims=True) + LM["a"]
        onehot_pi = (jax.nn.one_hot(jnp.maximum(pi, 0), K, dtype=dtype)
                     * (pi >= 0).astype(dtype)[..., None])

        def weight_fn(counts, j_prev, aux_b):  # the JAX driver's
            uni_w, uni_prob, uni_lo_b, big_corr_j, oh_pi = aux_b
            j_s = jnp.maximum(j_prev, 0)
            row = big[j_s].astype(dtype) - (
                (big_corr_j == j_s).astype(dtype) @ oh_pi)
            p = LM["lam"] * uni_prob + (1.0 - LM["lam"]) * (
                row + LM["b"] / K) / (uni_lo_b[j_s].astype(dtype) + LM["b"])
            return jnp.where(j_prev >= 0, lms * jnp.log(p), uni_w)

        kw = dict(weight_fn=weight_fn, aux_args=(
            lms * (jnp.log(uni_f + LM["a"] / K) - jnp.log(den)),
            (uni_f + LM["a"] / K) / den, uni_lo, pj, onehot_pi))
    return np.asarray(jfull.fullcov_chain(
        c["prior"], jnp.asarray(c["X"]), c["params_g"], c["stats"].counts,
        c["lo_counts"], c["touched"], jnp.asarray(c["new_embeds"]),
        c["base"], c["gumbel"], c["lpv"], 0.0 if bigram else 1.0, K, lms,
        temp, use_argmax=use_argmax, **kw))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,D,K", [(0, 4, 6), (1, 3, 7)])
@pytest.mark.parametrize("use_argmax", [False, True])
def test_plain_matches_pallas_exactly(seed, D, K, use_argmax, dtype):
    c = _case(seed, D=D, K=K)
    lms = 1.0 if use_argmax else 1.3
    got = _port(c, dtype, 0.8, lms, use_argmax)
    npt.assert_array_equal(got, _jax_pallas(c, dtype, 0.8, lms, use_argmax))
    assert (got[c["new_embeds"] < 0] == -1).all()
    assert (got[1] == -1).all()


@pytest.mark.parametrize("use_argmax", [False, True])
def test_plain_matches_xla_twin_exactly(use_argmax):
    c = _case(2, D=4, K=6)
    npt.assert_array_equal(_port(c, np.float64, 0.9, 1.1, use_argmax),
                           _jax_twin(c, 0.9, 1.1, use_argmax))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,D,K", [(3, 3, 7), (4, 4, 6)])
def test_bigram_plain_matches_pallas_exactly(seed, D, K, dtype):
    c = _case(seed, D=D, K=K)
    got = _port(c, dtype, 0.9, 1.1, bigram=True)
    npt.assert_array_equal(got, _jax_pallas(c, dtype, 0.9, 1.1, bigram=True))


def test_bigram_plain_matches_xla_twin_exactly():
    c = _case(5, D=3, K=7)
    npt.assert_array_equal(_port(c, np.float64, 0.9, 1.1, bigram=True),
                           _jax_twin(c, 0.9, 1.1, bigram=True))


def test_claims_births_and_slot_reuse_are_exercised():
    """A hot chain claims untouched components (global factors), births
    empty slots and reuses its own slots; the chains still equal the
    Pallas kernel's."""
    c = _case(6, D=3, K=7)
    got = _port(c, np.float64, 4.0, 1.0)
    npt.assert_array_equal(got, _jax_pallas(c, np.float64, 4.0, 1.0))
    tk0 = np.asarray(c["touched"].tk)
    counts = np.asarray(c["lo_counts"])
    claims = births = reuses = 0
    for b in range(got.shape[0]):
        live = set(tk0[b][tk0[b] >= 0].tolist())
        cnt = counts[b].copy()
        for k in got[b][got[b] >= 0]:
            births += cnt[k] == 0
            reuses += k in live
            claims += k not in live
            live.add(int(k))
            cnt[k] += 1
    assert claims > 0 and births > 0 and reuses > 0


def test_own_old_pairs_are_removed():
    """The LM decides (lms 20, no unigram interpolation): each utterance's
    old transcript alternates (j_b, i_b), the global table holds exactly
    the utterances' own pairs and the unigram counts push the first draw
    onto j_b.  The chains equal the Pallas kernel's and differ from chains
    that keep the own pairs in the table."""
    c = _case(7, D=3, K=7)
    B, S = c["new_embeds"].shape
    K = c["K"]
    j_b, i_b = np.arange(B) % K, (np.arange(B) + 3) % K
    old = np.where(np.arange(S)[None, :] % 2 == 0, j_b[:, None],
                   i_b[:, None]).astype(np.int32)
    pj, pi = (np.asarray(t) for t in transcript_pairs_batch(
        jnp.asarray(old)))
    big = np.zeros((K, K), np.int32)
    np.add.at(big, (pj[pj >= 0], pi[pj >= 0]), 1)
    uni = np.ones((B, K), np.int32)
    uni[np.arange(B), j_b] = 50
    c["lm"] = (uni, big, pj, pi)
    lm_params = dict(a=1.0, lam=0.0, b=1.0)
    got = _port(c, np.float64, 1.0, 20.0, bigram=True, lm_params=lm_params)
    npt.assert_array_equal(got, _jax_pallas(c, np.float64, 1.0, 20.0,
                                            bigram=True,
                                            lm_params=lm_params))
    kept = _port(c, np.float64, 1.0, 20.0, bigram=True, lm_params=lm_params,
                 lm=(uni, big, np.full_like(pj, -1), pi))
    assert (kept != got).any()


def test_port_pipeline_matches_xla_twin():
    """The port's own touched leave-outs, tables and base scores
    (``segmenters.fullcov``) drive the chain to the JAX twin's draws."""
    c = _case(8, D=4, K=6)
    prior = pt.NIW.create(*(np.array(a) for a in c["prior"]))
    stats = SuffStats(*(torch.from_numpy(np.array(a)) for a in c["stats"]))
    X = torch.as_tensor(c["X"])
    params_g = tcf.predictive_params(prior, stats)
    touched = tfull.touched_leave_out(prior, stats, X,
                                      torch.as_tensor(c["old_embeds"]),
                                      torch.as_tensor(c["old_ks"]))
    new = torch.as_tensor(c["new_embeds"])
    B, S = new.shape
    base = tcf.log_post_pred_batch(params_g, X[new.clamp_min(0).long()]
                                   .reshape(B * S, -1)).reshape(B, S, -1)
    for use_argmax in (False, True):
        got = tfull.fullcov_chain(
            prior, X, params_g, stats.counts,
            torch.from_numpy(np.array(c["lo_counts"])), touched, new, base,
            torch.from_numpy(np.array(c["gumbel"])),
            tcf.log_prior_batch(prior, X), 1.0, c["K"], 1.2, 0.9,
            use_argmax=use_argmax)
        npt.assert_array_equal(got.numpy(),
                               _jax_twin(c, 0.9, 1.2, use_argmax))


# The H100's opt-in shared memory a block (227 KB) and the default 48 KB.
LIMIT_227K, LIMIT_48K = 232448, 48 * 1024


@pytest.mark.parametrize("bigram", [False, True])
@pytest.mark.parametrize("D,N_max,limit,form,ring", [
    (13, 20, LIMIT_227K, "smem", 0),
    (13, 120, LIMIT_227K, "smem", 0),     # 225 / 230 KB: still on chip
    (130, 20, LIMIT_227K, "stream", 2),   # a 68 KB record a buffer
    (130, 120, LIMIT_227K, "stream", 2),
    (40, 20, LIMIT_227K, "stream", 3),
    (13, 20, LIMIT_48K, "stream", 3),
    (13, 120, LIMIT_48K, "stream", 3),
])
def test_launch_plan_picks_the_form(D, N_max, limit, form, ring, bigram):
    """K9's plan at the flagship and long shapes (K 1000, T0 = N_max)
    under the H100's opt-in limit and the default one: the tables stay on
    chip where they fit, else the ring takes as many record buffers as fit
    (at most 3)."""
    K = 1000
    c = cuda_fullcov_chain
    plan = c.launch_plan(D, K, N_max, N_max, bigram, limit)
    assert (plan.form, plan.ring) == (form, ring)
    assert plan.smem == c.smem_bytes(form, bigram, D, N_max, N_max, K,
                                     ring) <= limit
    assert plan.threads == 512
    if form == "stream":  # one more buffer would not fit, or is not taken
        assert ring == c.MAX_RING or c.smem_bytes(
            form, bigram, D, N_max, N_max, K, ring + 1) > limit
    else:
        assert 4 * D * D * 2 * N_max < plan.smem  # the tables


def test_launch_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no fullcov chain form"):
        cuda_fullcov_chain.launch_plan(130, 1000, 20, 20, False, LIMIT_48K)
    with pytest.raises(ValueError, match="32768"):
        cuda_fullcov_chain.launch_plan(13, 10, 1 << 15, 0, False, LIMIT_227K)


def test_stream_records_are_whole_16_byte_units():
    """A streamed record (m, then inv P, each padded to 4 words) is a
    multiple of 4 words, as bulk copies need, and holds both."""
    for D in (3, 13, 40, 130):
        w = cuda_fullcov_chain.rec_words(D)
        assert w % 4 == 0 and D * D + D <= w < D * D + D + 8
