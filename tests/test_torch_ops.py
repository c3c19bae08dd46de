"""The port's host-side and tensor ops against the JAX package, at f64.

Inputs are made from a seed with numpy and fed to both packages; the JAX
functions run on the CPU (x64 is enabled by ``conftest.py``).
"""

import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import components_fixedvar as jcfv
from segmentalist_tpu.models import fbgmm as jfbgmm
from segmentalist_tpu.ops import random as jrandom
from segmentalist_tpu.ops import stats as jstats
from segmentalist_tpu.priors import FixedVarPrior as JPrior
from segmentalist_tpu.segmenters import common as jcommon
from segmentalist_tpu.segmenters import fullcov as jfullcov
from segmentalist_tpu.utils.annealing import anneal_temperatures as j_anneal

from segmentalist_torch import native
from segmentalist_torch.models import components_fixedvar as tcfv
from segmentalist_torch.models import fbgmm as tfbgmm
from segmentalist_torch.ops import cuda_merge
from segmentalist_torch.ops import random as trandom
from segmentalist_torch.ops import stats as tstats
from segmentalist_torch.priors import FixedVarPrior as TPrior
from segmentalist_torch.segmenters import common as tcommon
from segmentalist_torch.utils.annealing import anneal_temperatures as t_anneal

RTOL = 1e-12
K, D = 9, 5


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return np.asarray(a.numpy() if torch.is_tensor(a) else a)


def _priors(rng):
    var = 0.1 + rng.rand(D)
    mu_0 = rng.randn(D)
    var_0 = 0.5 + rng.rand(D)
    return (JPrior.create(var, mu_0, var_0), TPrior.create(var, mu_0, var_0))


def _stats(rng, batch=()):
    counts = rng.randint(0, 4, batch + (K,)).astype(np.int32)
    counts[..., 2] = 0
    sum_x = counts[..., None] * rng.randn(*batch, K, D)
    sum_sq = counts[..., None] * (1 + rng.rand(*batch, K, D))
    return counts, sum_x, sum_sq


def test_import_pulls_in_no_jax():
    """Importing the port, its multi-device layer and the dry run (which
    spawned ranks import) adds no jax or segmentalist_tpu module."""
    code = ("import sys; before = set(sys.modules); "
            "import segmentalist_torch, segmentalist_torch.interop, "
            "segmentalist_torch.parallel, segmentalist_torch.parallel.dryrun; "
            "new = set(sys.modules) - before; "
            "bad = [m for m in new if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('jaxlib') or m.startswith('segmentalist_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_prior_containers():
    from segmentalist_tpu.priors import NIW as JNIW
    from segmentalist_torch.priors import NIW as TNIW

    rng = np.random.RandomState(10)
    m_0, S_0 = rng.randn(D), np.eye(D) * 0.5
    j, t = JNIW.create(m_0, 0.05, D + 3.0, S_0), TNIW.create(m_0, 0.05,
                                                             D + 3.0, S_0)
    for a, b in zip(t, j):
        npt.assert_array_equal(_n(a), np.asarray(b))
    with pytest.raises(ValueError):
        TNIW.create(m_0, 0.05, D - 1.0, S_0)
    jp, tp = _priors(rng)
    for a, b in zip(tp, jp):
        npt.assert_array_equal(_n(a), np.asarray(b))
    assert tp.to(dtype=torch.float32).var.dtype == torch.float32


def test_logsumexp_neg_inf_safe():
    rng = np.random.RandomState(0)
    a = rng.randn(6, 7) * 30
    a[1] = -np.inf
    a[2, :3] = -np.inf
    for axis in (0, 1):
        npt.assert_allclose(_n(trandom.logsumexp(_t(a), dim=axis)),
                            np.asarray(jrandom.logsumexp(jnp.asarray(a),
                                                         axis=axis)),
                            rtol=RTOL)


def test_gumbel_helper():
    g1 = trandom.gumbel((4000,), torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    g2 = trandom.gumbel((4000,), torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    assert torch.equal(g1, g2)
    assert torch.isfinite(g1).all()
    assert abs(float(g1.mean()) - 0.5772) < 0.1  # Euler-Mascheroni
    g32 = trandom.gumbel((5, 3), torch.Generator().manual_seed(0))
    assert g32.dtype == torch.float32 and g32.shape == (5, 3)


@pytest.mark.parametrize("temp", [1.0, 0.3])
def test_annealed_gumbel_max_matches_jax_formula(temp):
    rng = np.random.RandomState(1)
    logits = rng.randn(50, 8)
    logits[:, 3] = -np.inf
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (50, 8)))
    scaled = np.where(np.isneginf(logits), -np.inf, logits / temp)
    want = np.argmax(np.where(np.isneginf(scaled), -np.inf, scaled + noise),
                     -1)
    got = trandom.annealed_gumbel_max(_t(logits), _t(noise), temp)
    npt.assert_array_equal(_n(got), want)
    assert not (_n(got) == 3).any()


def test_suff_stats_from_assignments():
    rng = np.random.RandomState(2)
    X = rng.randn(40, D)
    z = rng.randint(-1, K, 40)
    j = jstats.suff_stats_from_assignments(jnp.asarray(X), jnp.asarray(z), K)
    t = tstats.suff_stats_from_assignments(_t(X), _t(z), K)
    npt.assert_array_equal(_n(t.counts), np.asarray(j.counts))
    for a, b in ((t.sum_x, j.sum_x), (t.sum_sq, j.sum_sq)):
        npt.assert_allclose(_n(a), np.asarray(b), rtol=RTOL, atol=1e-13)
    assert int(tstats.num_active(t)) == int(jstats.num_active(j))
    e = tstats.empty_suff_stats(K, D, torch.float64)
    assert e.counts.dtype == torch.int32 and e.sum_x.shape == (K, D)


@pytest.mark.parametrize("weight", [1, 0, -1])
def test_add_and_del_item(weight):
    """add_item / del_item against the JAX package: the one slot changes,
    exactly, and nothing else does."""
    rng = np.random.RandomState(4)
    counts, sum_x, sum_sq = _stats(rng)
    x = rng.randn(D)
    j0 = jstats.SuffStats(*(jnp.asarray(a) for a in (counts, sum_x, sum_sq)))
    t0 = tstats.SuffStats(*(_t(a) for a in (counts, sum_x, sum_sq)))
    for k in (0, 2, K - 1):
        j = jstats.add_item(j0, jnp.asarray(x), k, weight=weight)
        t = tstats.add_item(t0, _t(x), torch.tensor(k), weight=weight)
        for a, b in zip(t, j):
            npt.assert_array_equal(_n(a), np.asarray(b))
        j = jstats.del_item(j0, jnp.asarray(x), k, weight=weight)
        t = tstats.del_item(t0, _t(x), k, weight=weight)
        for a, b in zip(t, j):
            npt.assert_array_equal(_n(a), np.asarray(b))
    npt.assert_array_equal(_n(t0.counts), counts)  # inputs are not mutated


@pytest.mark.parametrize("full", [False, True])
def test_first_empty_and_canonicalize(full):
    rng = np.random.RandomState(3)
    counts = rng.randint(1, 5, (K,)).astype(np.int32)
    if not full:
        counts[[4, 6]] = 0
    for k in range(K):
        want = int(jstats.canonicalize_new_component(jnp.asarray(counts), k))
        got = int(tstats.canonicalize_new_component(_t(counts),
                                                    torch.tensor(k)))
        assert got == want
    assert int(tstats.first_empty_slot(_t(counts))) == \
        int(jstats.first_empty_slot(jnp.asarray(counts)))


def test_components_fixedvar_match_jax():
    rng = np.random.RandomState(4)
    jp, tp = _priors(rng)
    counts, sum_x, sum_sq = _stats(rng)
    js = jstats.SuffStats(jnp.asarray(counts), jnp.asarray(sum_x),
                          jnp.asarray(sum_sq))
    ts = tstats.SuffStats(_t(counts), _t(sum_x), _t(sum_sq))
    jpp = jcfv.predictive_params(jp, js)
    tpp = tcfv.predictive_params(tp, ts)
    for a, b in zip(tpp, jpp):
        npt.assert_allclose(_n(a), np.asarray(b), rtol=RTOL)
    muT, precT = tcfv.predictive_params_T(tp, _t(counts)[None],
                                          _t(sum_x.T)[None])
    jmuT, jprecT = jcfv.predictive_params_T(jp, jnp.asarray(counts)[None],
                                            jnp.asarray(sum_x.T)[None])
    npt.assert_allclose(_n(muT), np.asarray(jmuT), rtol=RTOL)
    npt.assert_allclose(_n(precT), np.asarray(jprecT), rtol=RTOL)

    x = rng.randn(D)
    X = rng.randn(7, D)
    npt.assert_allclose(_n(tcfv.log_post_pred(tpp, _t(x))),
                        np.asarray(jcfv.log_post_pred(jpp, jnp.asarray(x))),
                        rtol=RTOL)
    npt.assert_allclose(_n(tcfv.log_post_pred_batch(tpp, _t(X))),
                        np.asarray(jcfv.log_post_pred_batch(
                            jpp, jnp.asarray(X))), rtol=1e-10)
    npt.assert_allclose(_n(tcfv.log_prior_batch(tp, _t(X))),
                        np.asarray(jcfv.log_prior_batch(jp, jnp.asarray(X))),
                        rtol=RTOL)
    npt.assert_allclose(_n(tcfv.log_marg_k_vec(tp, ts)),
                        np.asarray(jcfv.log_marg_k_vec(jp, js)), rtol=RTOL)
    npt.assert_allclose(float(tcfv.log_marg(tp, ts)),
                        float(jcfv.log_marg(jp, js)), rtol=RTOL)

    counts2 = counts.copy()
    counts2[2] = 3
    sum_x2 = sum_x.copy()
    sum_x2[2] = rng.randn(D)
    js2 = js._replace(counts=jnp.asarray(counts2), sum_x=jnp.asarray(sum_x2))
    ts2 = ts._replace(counts=_t(counts2), sum_x=_t(sum_x2))
    for a, b in zip(tcfv.update_predictive_row(tp, ts2, tpp, 2),
                    jcfv.update_predictive_row(jp, js2, jpp, 2)):
        npt.assert_allclose(_n(a), np.asarray(b), rtol=RTOL)


@pytest.mark.parametrize("lms,denom", [(1.0, False), (1.3, True)])
def test_log_weights_and_log_prob_z(lms, denom):
    rng = np.random.RandomState(5)
    counts = rng.randint(0, 9, (3, K)).astype(np.int32)
    for b in range(3):
        npt.assert_allclose(
            _n(tfbgmm.log_weights(_t(counts[b]), 2.0, K, lms, denom,
                                  torch.float64)),
            np.asarray(jfbgmm.log_weights(jnp.asarray(counts[b]), 2.0, K,
                                          lms, denom, jnp.float64)),
            rtol=RTOL)
        npt.assert_allclose(
            float(tfbgmm.log_prob_z_dirichlet(_t(counts[b]), 2.0, K)),
            float(jfbgmm.log_prob_z_dirichlet(jnp.asarray(counts[b]), 2.0,
                                              K)), rtol=RTOL)
    batched = tfbgmm.log_weights(_t(counts), 2.0, K, lms, denom,
                                 torch.float64)
    npt.assert_allclose(
        _n(batched), np.stack([np.asarray(jfbgmm.log_weights(
            jnp.asarray(c), 2.0, K, lms, denom, jnp.float64))
            for c in counts]), rtol=RTOL)


def _block(rng, B=5, N_max=9, W=3, N=80):
    lengths = rng.randint(1, N_max + 1, B).astype(np.int32)
    bounds = rng.rand(B, N_max) < 0.4
    bounds[np.arange(B), lengths - 1] = True
    seg_ids = rng.randint(0, N, (B, N_max, W)).astype(np.int32)
    seg_ids[rng.rand(B, N_max, W) < 0.15] = -1
    return bounds, lengths, seg_ids


def test_segments_and_gathers():
    rng = np.random.RandomState(6)
    bounds, lengths, seg_ids = _block(rng)
    je, jsg = jcommon.gather_block_segments(
        jnp.asarray(bounds), jnp.asarray(lengths), jnp.asarray(seg_ids))
    te, tsg = tcommon.gather_block_segments(_t(bounds), _t(lengths),
                                            _t(seg_ids))
    npt.assert_array_equal(_n(te), np.asarray(je))
    for a, b in zip(tsg, jsg):
        npt.assert_array_equal(_n(a), np.asarray(b))


def test_statistic_contributions():
    rng = np.random.RandomState(7)
    B, S, N = 5, 9, 80
    X = rng.randn(N, D)
    embeds = rng.randint(-1, N, (B, S)).astype(np.int32)
    ks = np.where(embeds >= 0, rng.randint(-1, K, (B, S)), -1).astype(np.int32)
    valid = np.array([True, True, False, True, True])
    counts, sum_x, sum_sq = _stats(rng)
    js = jstats.SuffStats(jnp.asarray(counts), jnp.asarray(sum_x),
                          jnp.asarray(sum_sq))
    ts = tstats.SuffStats(_t(counts), _t(sum_x), _t(sum_sq))

    npt.assert_array_equal(
        _n(tcommon.counts_contrib(_t(ks), _t(embeds >= 0), K)),
        np.asarray(jfullcov.counts_contrib(jnp.asarray(ks),
                                           jnp.asarray(embeds >= 0), K)))
    jT, _ = jcommon.leave_out_moments_T(js, jnp.asarray(X),
                                        jnp.asarray(embeds), jnp.asarray(ks),
                                        K, with_sq=False)
    tT = tcommon.leave_out_moments_T(ts, _t(X), _t(embeds), _t(ks), K)
    npt.assert_allclose(_n(tT), np.asarray(jT), rtol=1e-10, atol=1e-12)

    jf = jcommon.flat_contrib(jnp.asarray(X), jnp.asarray(embeds),
                              jnp.asarray(ks), K, False, jnp.asarray(valid))
    tf = tcommon.flat_contrib(_t(X), _t(embeds), _t(ks), K, _t(valid))
    for a, b in zip(tf, jf):
        npt.assert_allclose(_n(a), np.asarray(b), rtol=1e-10, atol=1e-12)
    # the block's merge (the merge kernel's plain version) against the
    # JAX package's one-hot merge, with the new segments moved one slot on
    ks2 = np.where(ks >= 0, (ks + 1) % K, -1).astype(np.int32)
    jf2 = jcommon.flat_contrib(jnp.asarray(X), jnp.asarray(embeds),
                               jnp.asarray(ks2), K, False,
                               jnp.asarray(valid))
    rows = _t(X)[_t(embeds).clamp_min(0).long()]
    merged_t = cuda_merge.merge_stats_plain(
        ts, _t(valid), (rows, _t(embeds), _t(ks)),
        (rows, _t(embeds), _t(ks2)))
    merged_j = jcommon.merge_flat(js, jf, jf2)
    for a, b in zip(merged_t, merged_j):
        npt.assert_allclose(_n(a), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decollide_new_components(seed):
    """Random blocks with many simultaneous new-component creators."""
    rng = np.random.RandomState(seed)
    B, S, Kd = 6, 5, 12
    counts0 = rng.randint(0, 3, Kd).astype(np.int32)
    counts0[rng.rand(Kd) < 0.5] = 0
    lo = np.maximum(counts0[None] - rng.randint(0, 2, (B, Kd)), 0
                    ).astype(np.int32)
    empty = np.nonzero(counts0 == 0)[0]
    ks = rng.randint(0, Kd, (B, S))
    steer = rng.rand(B, S) < 0.6  # crowd onto a few empty slots
    ks[steer] = rng.choice(empty[:2], steer.sum())
    ks = ks.astype(np.int32)
    mask = rng.rand(B, S) < 0.85
    want = np.asarray(jcommon.decollide_new_components(
        jnp.asarray(ks), jnp.asarray(mask), jnp.asarray(lo),
        jnp.asarray(counts0)))
    got = _n(tcommon.decollide_new_components(_t(ks), _t(mask), _t(lo),
                                              _t(counts0)))
    npt.assert_array_equal(got, want)
    assert (got != ks).any() or seed == 3


def test_masked_candidate_scores_and_window():
    rng = np.random.RandomState(8)
    lm = rng.randn(3, 6, 4)
    lm[0, 1, 2] = -np.inf
    ids = rng.randint(-1, 20, (3, 6, 4)).astype(np.int32)
    durs = (rng.randint(1, 9, (3, 6, 4)) * 10.0).astype(np.float32)
    durs[rng.rand(3, 6, 4) < 0.2] = np.nan
    want = np.asarray(jcommon.masked_candidate_scores(
        jnp.asarray(lm), jnp.asarray(ids), jnp.asarray(durs), 0.8, -0.2))
    got = _n(tcommon.masked_candidate_scores(_t(lm), _t(ids), _t(durs), 0.8,
                                             -0.2))
    npt.assert_allclose(got, want, rtol=RTOL)
    padded = _n(tcommon.dp_window(_t(ids), 6))
    npt.assert_array_equal(padded[..., :4], ids)
    assert (padded[..., 4:] == -1).all()
    assert np.isnan(_n(tcommon.dp_window(_t(durs), 5))[..., 4]).all()


@pytest.mark.parametrize("schedule,steps", [(None, -1), ("linear", -1),
                                            ("linear", 3), ("step", 2)])
def test_annealing_copy(schedule, steps):
    npt.assert_array_equal(t_anneal(7, schedule, 0.2, 1.0, steps),
                           j_anneal(7, schedule, 0.2, 1.0, steps))


def test_native_corpus_ops_match_jax_library():
    from segmentalist_tpu import native as jnative

    rng = np.random.RandomState(9)
    U, N_max = 7, 6
    lengths = rng.randint(1, N_max + 1, U).astype(np.int64)
    T = N_max * (N_max + 1) // 2
    vec_ids = np.arange(U * T, dtype=np.int64).reshape(U, T)
    for mod in (native, jnative):
        assert mod.available()
    a = native.init_boundaries_random(lengths, vec_ids, N_max, 0.5, 0, 3, 17)
    b = jnative.init_boundaries_random(lengths, vec_ids, N_max, 0.5, 0, 3, 17)
    npt.assert_array_equal(a, b)
    npt.assert_array_equal(native.segmented_embeds(a, vec_ids, lengths),
                           jnative.segmented_embeds(a, vec_ids, lengths))
    durs = rng.rand(U, T)
    for x, y in zip(native.pack_dense(vec_ids, durs, lengths, N_max, 3),
                    jnative.pack_dense(vec_ids, durs, lengths, N_max, 3)):
        npt.assert_array_equal(x, y)
