"""Kernel K8 (full-covariance candidate scoring with touched-slot
corrections): the port's plain version against the JAX package's Pallas
kernel in interpret mode (``fullcov_log_margs``) and against its XLA
composition (``components_full.log_post_pred_batch`` +
``segmenters.fullcov.corrected_candidate_post`` + logsumexp), within
rtol 1e-8 at float64: the port whitens the candidate (|L x - L mu|^2)
where the JAX package expands the Mahalanobis form, its tables come from
another Cholesky implementation, and the composition divides by v where
the kernel multiplies by 1/v."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import components_full as jcf
from segmentalist_tpu.models.fbgmm import log_weights as jlog_weights
from segmentalist_tpu.ops.pallas_score import fullcov_log_margs
from segmentalist_tpu.ops.random import logsumexp as jlogsumexp
from segmentalist_tpu.ops.stats import suff_stats_from_assignments
from segmentalist_tpu.priors import NIW as JNIW
from segmentalist_tpu.segmenters import fullcov as jfull

from segmentalist_torch.models import components_full as tcf
from segmentalist_torch.models.fbgmm import log_weights
from segmentalist_torch.ops import cuda_fullcov_score
from segmentalist_torch.ops.stats import SuffStats
from segmentalist_torch.priors import NIW
from segmentalist_torch.segmenters import fullcov as tfull

RTOL = 1e-8


def _case(seed, D=4, K=6, N=40, B=3, M=7):
    """The JAX package's scorer test case (tests/test_pallas_score.py:135)
    with a duplicate touched component and an utterance without old
    segments, built in both packages from the same numpy arrays."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    m_0, k_0, v_0 = 0.1 * rng.randn(D), 1.0, D + 2.0
    S_0 = np.eye(D) + 0.1 * np.ones((D, D))
    assign = rng.randint(-1, K - 2, N).astype(np.int32)
    members = rng.permutation(np.nonzero(assign >= 0)[0])
    old_embeds = np.array([members[:4], members[4:8], [-1] * 4], np.int32)
    old_embeds[0, 3] = -1
    old_ks = np.where(old_embeds >= 0, assign[np.maximum(old_embeds, 0)],
                      -1).astype(np.int32)
    cand = rng.randint(0, N, (B, M))
    Xc = X[cand] + 0.2 * rng.randn(B, M, D)

    jp = JNIW.create(m_0, k_0, v_0, S_0)
    js = suff_stats_from_assignments(jnp.asarray(X), jnp.asarray(assign), K,
                                     full_cov=True)
    jtouched = jfull.touched_leave_out(jp, js, jnp.asarray(X),
                                       jnp.asarray(old_embeds),
                                       jnp.asarray(old_ks))
    jlo = js.counts[None] - jfull.counts_contrib(
        jnp.asarray(old_ks), jnp.asarray(old_embeds >= 0), K)
    jw = jax.vmap(lambda c: jlog_weights(c, 1.0, K, 1.0, True,
                                         jnp.float64))(jlo)
    jXc = jnp.asarray(Xc)
    jprior_c = jax.vmap(lambda x: jcf.log_prior_batch(jp, x))(jXc)
    jparams = jcf.predictive_params(jp, js)

    tp = NIW.create(m_0, k_0, v_0, S_0)
    ts = SuffStats(*(torch.from_numpy(np.array(a)) for a in js))
    ttouched = tfull.touched_leave_out(tp, ts, torch.as_tensor(X),
                                       torch.as_tensor(old_embeds),
                                       torch.as_tensor(old_ks))
    tlo = torch.from_numpy(np.array(jlo))
    tXc = torch.as_tensor(Xc)
    port = (tXc, tcf.log_prior_batch(tp, tXc),
            *tfull.fullcov_score_inputs(tcf.predictive_params(tp, ts),
                                        ttouched),
            log_weights(tlo, 1.0, K, 1.0, True, torch.float64), tlo)
    jax_ = dict(Xc=jXc, prior_c=jprior_c, params=jparams, touched=jtouched,
                w=jw, lo=jlo, K=K)
    return port, jax_


def _pallas(j, valid_m=None):
    g, t, oh, tmask = jfull.fullcov_score_inputs(j["params"], j["touched"])
    return np.asarray(fullcov_log_margs(
        j["Xc"], j["prior_c"], *g, *t, oh, tmask, j["w"], j["lo"], K=j["K"],
        interpret=True, valid_m=valid_m))


def _xla(j):
    B, M, D = j["Xc"].shape
    post = jcf.log_post_pred_batch(j["params"], j["Xc"].reshape(B * M, D))
    post = jfull.corrected_candidate_post(post.reshape(B, M, -1), j["Xc"],
                                          j["touched"], j["K"])
    logits = j["w"][:, None, :] + jnp.where(
        (j["lo"] > 0)[:, None, :], post, j["prior_c"][..., None])
    return np.asarray(jlogsumexp(logits, axis=-1))


@pytest.mark.parametrize("seed,D,K", [(5, 4, 6), (6, 3, 7)])
def test_plain_matches_pallas_and_xla_composition(seed, D, K):
    port, j = _case(seed, D=D, K=K)
    got = cuda_fullcov_score.fullcov_log_margs(*port).numpy()
    assert np.isfinite(got).all()
    npt.assert_allclose(got, _pallas(j), rtol=RTOL, atol=RTOL)
    npt.assert_allclose(got, _xla(j), rtol=RTOL, atol=RTOL)


def test_valid_prefix_rows_are_minus_inf():
    """Rows past an utterance's valid prefix come back -inf (the K1 / K5
    convention; the Pallas kernel skips only whole tiles past it, and the
    DP masks those rows either way); the others equal the Pallas kernel's
    prefix-skipping path."""
    port, j = _case(7)
    valid_m = np.array([7, 3, 0], np.int32)
    got = cuda_fullcov_score.fullcov_log_margs(
        *port, valid_m=torch.as_tensor(valid_m)).numpy()
    want = _pallas(j, jnp.asarray(valid_m))
    live = np.arange(got.shape[1])[None, :] < valid_m[:, None]
    npt.assert_array_equal(np.isneginf(got), ~live)
    npt.assert_allclose(got[live], want[live], rtol=RTOL, atol=RTOL)


def test_touched_columns_take_the_leave_out_scores():
    """Dropping the correction (every tslot -1) changes exactly the rows of
    utterances that touch components: the corrections are exercised."""
    port, j = _case(5)
    got = cuda_fullcov_score.fullcov_log_margs(*port).numpy()
    port = list(port)
    port[4] = torch.full_like(port[4], -1)
    uncorrected = cuda_fullcov_score.fullcov_log_margs(*port).numpy()
    differs = np.abs(got - uncorrected).max(1) > 1e-6
    npt.assert_array_equal(differs, [True, True, False])


def test_float32_plain_stays_close_to_float64():
    port, _ = _case(8)
    want = cuda_fullcov_score.fullcov_log_margs(*port).numpy()
    f32 = [a.float() if a.is_floating_point() else a
           for a in (port[0], port[1])]
    f32 += [tuple(t.float() for t in port[2]),
            tuple(t.float() for t in port[3])]
    f32 += [port[4], port[5].float(), port[6]]
    got = cuda_fullcov_score.fullcov_log_margs(*f32).numpy()
    npt.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("D,M,limit,rows,tiles", [
    (13, 120, 232448, 64, 2),        # flagship: 64 rows, 2 tiles
    (13, 100, 232448, 64, 2),        # a ragged last tile
    (130, 720, 232448, 64, 12),      # long: 64 rows a block
    (130, 720, 64 * 1024, 32, 23),   # 64 rows would not fit 64 KB
])
def test_launch_plan_tiles(D, M, limit, rows, tiles):
    """K8's row tiles (8 rows a warp) and their shared memory, K 1000."""
    plan = cuda_fullcov_score.launch_plan(D, 1000, M, limit)
    assert (plan.rows, plan.tiles) == (rows, tiles)
    assert plan.rows * plan.tiles >= M > plan.rows * (plan.tiles - 1)
    assert plan.smem == cuda_fullcov_score.smem_bytes(D, 1000, rows) <= limit


def test_plain_takes_no_touched_slots():
    """With S = 0 touched slot tables (and so no touched column), the plain
    version scores every column by the global tables."""
    Xc, prior_c, g, t, tslot, w, lo = _case(7)[0]
    tslot = torch.full_like(tslot, -1)
    got = cuda_fullcov_score.fullcov_scores_plain(
        Xc, prior_c, g, tuple(a[:, :0].contiguous() for a in t), tslot, w,
        lo)
    want = cuda_fullcov_score.fullcov_scores_plain(Xc, prior_c, g, t, tslot,
                                                   w, lo)
    npt.assert_array_equal(got.numpy(), want.numpy())


def test_launch_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="no fullcov scores tile"):
        cuda_fullcov_score.launch_plan(130, 10000, 720, 48 * 1024)
