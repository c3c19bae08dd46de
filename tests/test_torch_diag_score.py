"""Kernel K5 (fused diagonal-covariance scoring): the port's plain versions
against the JAX package.

The grouped composition (FFBS) is held against the Pallas kernel in
interpret mode, the exact composition (Viterbi) against
``components_diag.log_post_pred_batch`` plus the logsumexp.  The two
reduce over K in different orders and the constants come from different
``lgamma`` implementations, hence rtol 1e-10 at float64 and 1e-5 at
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import components_diag as jcd
from segmentalist_tpu.models.fbgmm import log_weights as j_log_weights
from segmentalist_tpu.ops.pallas_score import diag_log_margs_T
from segmentalist_tpu.ops.random import logsumexp as j_logsumexp
from segmentalist_tpu.ops.stats import SuffStats as JStats
from segmentalist_tpu.priors import NIW as JNIW

from segmentalist_torch.models import components_diag as tcd
from segmentalist_torch.models.fbgmm import log_weights
from segmentalist_torch.ops import cuda_score
from segmentalist_torch.priors import NIW as TNIW


def _inputs(seed, B=4, M=18, D=5, K=11, dtype=np.float64):
    rng = np.random.RandomState(seed)
    m_0, S_0 = 0.2 * rng.randn(D), 0.3 + rng.rand(D)
    k_0, v_0 = 0.5, D + 3.0
    counts = rng.randint(0, 4, (B, K)).astype(np.int32)
    Z = rng.randn(B, K, D)
    sum_x = counts[..., None] * Z
    sum_sq = counts[..., None] * (Z * Z + np.abs(rng.randn(B, K, D)))
    Xc = (rng.randn(B, M, D) * 1.5).astype(dtype)
    jp = JNIW.create(m_0.astype(dtype), k_0, v_0, S_0.astype(dtype))
    sum_xT = sum_x.transpose(0, 2, 1).astype(dtype)
    sum_sqT = sum_sq.transpose(0, 2, 1).astype(dtype)
    prior_c = np.asarray(jcd.log_prior_batch(jp, jnp.asarray(Xc)))
    muT, inv_varT, lpv, v = (np.asarray(a) for a in jcd.predictive_params_T(
        jp, jnp.asarray(counts), jnp.asarray(sum_xT), jnp.asarray(sum_sqT)))
    w = np.stack([np.asarray(j_log_weights(jnp.asarray(c), 1.0, K, 1.0, True,
                                           dtype)) for c in counts])
    valid_m = rng.randint(1, M + 1, B).astype(np.int32)
    return dict(Xc=Xc, prior_c=prior_c, muT=muT, inv_varT=inv_varT, lpv=lpv,
                v=v, w=w, counts=counts, K=K, valid_m=valid_m,
                prior=(m_0, k_0, v_0, S_0), sum_x=sum_x, sum_sq=sum_sq,
                sum_xT=sum_xT, sum_sqT=sum_sqT)


_TABLES = ("Xc", "prior_c", "muT", "inv_varT", "lpv", "v", "w", "counts")


def _pallas(d, valid_m=None):
    return np.asarray(diag_log_margs_T(
        *(jnp.asarray(d[k]) for k in _TABLES), K=d["K"], interpret=True,
        valid_m=None if valid_m is None else jnp.asarray(valid_m)))


def _port(d, valid_m=None, exact=False):
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return cuda_score.diag_log_margs_T(
        *(t(d[k]) for k in _TABLES),
        valid_m=None if valid_m is None else t(valid_m), exact=exact).numpy()


def _exact_reference(d):
    """components_diag.log_post_pred_batch per utterance, then the weighted
    logsumexp: the JAX driver's Viterbi scoring (unigram.py:886-897)."""
    m_0, k_0, v_0, S_0 = d["prior"]
    jp = JNIW.create(m_0, k_0, v_0, S_0)
    params = jax.vmap(lambda c, s, q: jcd.predictive_params(
        jp, JStats(c, s, q)))(jnp.asarray(d["counts"]),
                              jnp.asarray(d["sum_x"]),
                              jnp.asarray(d["sum_sq"]))
    post = jax.vmap(jcd.log_post_pred_batch)(params, jnp.asarray(d["Xc"]))
    logits = jnp.asarray(d["w"])[:, None, :] + jnp.where(
        (jnp.asarray(d["counts"]) > 0)[:, None, :], post,
        jnp.asarray(d["prior_c"])[..., None])
    return np.asarray(j_logsumexp(logits, axis=-1))


@pytest.mark.parametrize("seed,D", [(0, 5), (1, 13), (2, 8)])
def test_grouped_plain_matches_pallas_f64(seed, D):
    d = _inputs(seed, D=D)
    npt.assert_allclose(_port(d), _pallas(d), rtol=1e-10, atol=1e-10)


def test_grouped_plain_matches_pallas_f32():
    d = _inputs(3, D=13, dtype=np.float32)
    d = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
             and v.dtype == np.float64 else v) for k, v in d.items()}
    npt.assert_allclose(_port(d), _pallas(d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,D", [(4, 5), (5, 13)])
def test_exact_plain_matches_components_diag(seed, D):
    d = _inputs(seed, D=D)
    npt.assert_allclose(_port(d, exact=True), _exact_reference(d),
                        rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("D", [13, 6])
def test_valid_prefix(D):
    """Rows past each utterance's valid prefix come back -inf unscored; the
    rest equal the Pallas kernel's prefix-skip output, in both
    compositions."""
    d = _inputs(6, M=30, D=D)
    live = np.arange(30)[None, :] < d["valid_m"][:, None]
    want = _pallas(d, d["valid_m"])
    for exact in (False, True):
        got = _port(d, d["valid_m"], exact=exact)
        assert np.isneginf(got[~live]).all()
        npt.assert_allclose(got[live], want[live], rtol=1e-9 if exact
                            else 1e-10, atol=1e-9)


def test_tables_from_port_params():
    """The port's own predictive_params_T and log_weights feed the scorer
    the tables the JAX ones do."""
    d = _inputs(7, D=9)
    tp = TNIW.create(*d["prior"])
    counts = torch.as_tensor(d["counts"])
    muT, inv_varT, lpv, v = tcd.predictive_params_T(
        tp, counts, torch.as_tensor(d["sum_xT"]),
        torch.as_tensor(d["sum_sqT"]))
    w = log_weights(counts, 1.0, d["K"], 1.0, True, torch.float64)
    got = cuda_score.diag_log_margs_T(
        torch.as_tensor(np.array(d["Xc"])),
        torch.as_tensor(np.array(d["prior_c"])), muT, inv_varT, lpv, v, w,
        counts)
    npt.assert_allclose(got.numpy(), _pallas(d), rtol=1e-10, atol=1e-10)
