"""Kernel K1 (fused fixed-variance scoring): the port's plain version against
the JAX package's Pallas kernel in interpret mode, and the CUDA kernel
against the plain version on a card.

The reduction order over K differs (``pallas_score.py:20-23``), hence
rtol 1e-10 at f64 and rtol 1e-5 / atol 1e-4 at f32.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.models import components_fixedvar as jcfv
from segmentalist_tpu.models.fbgmm import log_weights as j_log_weights
from segmentalist_tpu.ops.pallas_score import fixedvar_log_margs_T
from segmentalist_tpu.priors import FixedVarPrior as JPrior

from segmentalist_torch.models import components_fixedvar as tcfv
from segmentalist_torch.models.fbgmm import log_weights
from segmentalist_torch.ops import cuda_score
from segmentalist_torch.priors import FixedVarPrior as TPrior


def _inputs(seed, B=4, M=18, D=5, K=11, empty=False, dtype=np.float64):
    rng = np.random.RandomState(seed)
    var, mu_0, var_0 = 0.1 + rng.rand(D), rng.randn(D), 1.0 + rng.rand(D)
    counts = np.zeros((B, K), np.int32) if empty else \
        rng.randint(0, 4, (B, K)).astype(np.int32)
    sum_xT = (counts[:, None, :] * rng.randn(B, D, K)).astype(dtype)
    Xc = rng.randn(B, M, D).astype(dtype)
    jp = JPrior.create(var.astype(dtype), mu_0.astype(dtype),
                       var_0.astype(dtype))
    prior_c = np.array(jcfv.log_prior_batch(jp, jnp.asarray(Xc)))
    muT, precT = jcfv.predictive_params_T(jp, jnp.asarray(counts),
                                          jnp.asarray(sum_xT))
    w = np.stack([np.asarray(j_log_weights(jnp.asarray(c), 1.0, K, 1.0, True,
                                           dtype)) for c in counts])
    valid_m = rng.randint(1, M + 1, B).astype(np.int32)
    return dict(Xc=Xc, prior_c=prior_c, muT=np.asarray(muT),
                precT=np.asarray(precT), w=w, counts=counts, K=K,
                valid_m=valid_m, prior=(var, mu_0, var_0), sum_xT=sum_xT)


def _jax(d, valid_m=None):
    return np.asarray(fixedvar_log_margs_T(
        jnp.asarray(d["Xc"]), jnp.asarray(d["prior_c"]), jnp.asarray(d["muT"]),
        jnp.asarray(d["precT"]), jnp.asarray(d["w"]), jnp.asarray(d["counts"]),
        K=d["K"], interpret=True,
        valid_m=None if valid_m is None else jnp.asarray(valid_m)))


def _port(d, valid_m=None):
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return cuda_score.fixedvar_log_margs_T(
        t(d["Xc"]), t(d["prior_c"]), t(d["muT"]), t(d["precT"]), t(d["w"]),
        t(d["counts"]), valid_m=None if valid_m is None else t(valid_m))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_f64(seed):
    d = _inputs(seed)
    npt.assert_allclose(_port(d).numpy(), _jax(d), rtol=1e-10, atol=1e-10)


def test_valid_prefix():
    d = _inputs(2, M=30)
    got = _port(d, d["valid_m"]).numpy()
    want = _jax(d, d["valid_m"])
    live = np.arange(30)[None, :] < d["valid_m"][:, None]
    npt.assert_allclose(got[live], want[live], rtol=1e-10, atol=1e-10)
    assert np.isneginf(got[~live]).all()


def test_all_empty_and_neg_inf_rows():
    d = _inputs(3, empty=True)
    d["prior_c"][1, 4] = -np.inf       # a masked candidate
    want = _jax(d)
    got = _port(d).numpy()
    npt.assert_allclose(got, want, rtol=1e-10)
    assert np.isneginf(got[1, 4])
    # all-empty: the weights sum to ~1, so the marginal is the prior density
    fin = np.isfinite(d["prior_c"])
    npt.assert_allclose(got[fin], d["prior_c"][fin], rtol=1e-9)


def test_plain_matches_pallas_f32():
    d = _inputs(4, dtype=np.float32)
    d = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
             and v.dtype == np.float64 else v) for k, v in d.items()}
    npt.assert_allclose(_port(d).numpy(), _jax(d), rtol=1e-5, atol=1e-4)


def test_feature_major_tables_from_port_params():
    """The port's own predictive_params_T / log_weights feed the scorer the
    same tables as the JAX ones."""
    d = _inputs(5)
    var, mu_0, var_0 = d["prior"]
    tp = TPrior.create(var, mu_0, var_0)
    counts = torch.as_tensor(d["counts"])
    muT, precT = tcfv.predictive_params_T(tp, counts,
                                          torch.as_tensor(d["sum_xT"]))
    w = log_weights(counts, 1.0, d["K"], 1.0, True, torch.float64)
    got = cuda_score.fixedvar_log_margs_T(
        torch.as_tensor(d["Xc"]), torch.as_tensor(d["prior_c"]), muT, precT,
        w, counts)
    npt.assert_allclose(got.numpy(), _jax(d), rtol=1e-10, atol=1e-10)


def test_cuda_tensor_never_takes_plain_path():
    """A CUDA tensor goes to the kernel or raises: the dispatch is by the
    tensor's device alone."""
    from segmentalist_torch.ops import cuda_lib

    class FakeCuda:
        is_cuda = True

    assert cuda_lib.use_kernel(FakeCuda())
    assert not cuda_lib.use_kernel(torch.zeros(1))


@pytest.mark.parametrize("D,limit,smem", [
    (13, 232448, 43232),     # flagship
    (13, 48 * 1024, 43232),  # fits the default 48 KB too
    (130, 232448, 73184),    # long
    (130, 73184, 73184),     # a limit of exactly the block's bytes
    (512, 232448, 170976),   # the widest rows
])
def test_launch_plan_tiles(D, limit, smem):
    """K1 / K5's row tiles (64 rows, 8 a warp) and their shared memory,
    K 1000, M 720: the table ring and the per-column constants (8,192 +
    768 words), the rows [D, 64], the column list and the warps'
    partials."""
    plan = cuda_score.launch_plan(D, 1000, 720, limit)
    assert (plan.rows, plan.tiles, plan.smem) == (64, 12, smem)
    assert cuda_score.smem_bytes(D, 1000) == smem <= limit


def test_launch_plan_list_is_one_window_of_columns():
    """The column list holds min(K, 8 columns a thread) entries."""
    assert (cuda_score.smem_bytes(13, 5000)
            - cuda_score.smem_bytes(13, 2000)) == 4 * 48
    assert (cuda_score.smem_bytes(13, 1000)
            - cuda_score.smem_bytes(13, 300)) == 4 * 700


@pytest.mark.parametrize("D,limit", [(130, 48 * 1024), (512, 48 * 1024),
                                     (130, 73180)])
def test_launch_plan_raises_where_no_tile_fits(D, limit):
    """Under 48 KB only rows of D 13 fit (D 130 takes 73,184 bytes), and a
    limit 4 bytes short of a block's refuses it."""
    with pytest.raises(ValueError, match="no candidate-score tile"):
        cuda_score.launch_plan(D, 1000, 720, limit)
