"""The port's Stirling lgamma against the JAX package's
(``pallas_chain._lgamma_stirling``) and against the exact ``lgamma``.

At float64 the two compositions agree to rtol 1e-12.  At float32 XLA's
CPU ``log`` is not libm's, so the bits may differ: a few ulp of the result
is the bound."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from segmentalist_tpu.ops.pallas_chain import _lgamma_stirling as j_stirling

from segmentalist_torch.ops.special import lgamma_ratio, lgamma_stirling


def _grid():
    rng = np.random.RandomState(0)
    return np.concatenate([np.arange(0.5, 600.0, 0.5),       # half-integers
                           rng.uniform(0.05, 5000.0, 500)])  # random z


def test_matches_jax_f64():
    z = _grid()
    got = lgamma_stirling(torch.as_tensor(z)).numpy()
    npt.assert_allclose(got, np.asarray(j_stirling(jnp.asarray(z))),
                        rtol=1e-12, atol=1e-12)


def test_matches_jax_f32_within_ulps():
    z = _grid().astype(np.float32)
    got = lgamma_stirling(torch.as_tensor(z)).numpy()
    want = np.asarray(j_stirling(jnp.asarray(z)))
    assert got.dtype == want.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 8 * ulp).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_close_to_exact_lgamma(dtype):
    z = torch.as_tensor(_grid(), dtype=torch.float64)
    want = torch.lgamma(z)
    got = lgamma_stirling(z.to(dtype)).to(torch.float64)
    tol = 1e-6 if dtype == torch.float32 else 1e-7
    npt.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_ratio_is_the_student_t_constant():
    v = torch.arange(1.0, 200.0, 1.0, dtype=torch.float64)
    want = torch.lgamma((v + 1.0) / 2.0) - torch.lgamma(v / 2.0)
    npt.assert_allclose(lgamma_ratio(v).numpy(), want.numpy(), rtol=1e-7,
                        atol=1e-7)
