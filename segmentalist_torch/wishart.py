"""Wishart and inverse-Wishart samplers (counterpart of
``segmentalist_tpu/wishart.py``; reference ``wishart.py:16-32``).

The Bartlett construction on an explicit ``torch.Generator``: the factor A
is lower triangular with ``A_ii ~ sqrt(chi2(v_0 - i))`` and ``A_ij ~ N(0,
1)`` below the diagonal, drawn in the JAX package's order (the chi-square
draws, then the normals).  ``components_full.rand_k`` builds the same factor
inline.
"""

from __future__ import annotations

import torch


def bartlett(generator: torch.Generator, D: int, v_0, dtype,
             device) -> torch.Tensor:
    """The lower-triangular Bartlett factor [D, D] of a Wishart with
    ``v_0`` degrees of freedom."""
    i = torch.arange(D, dtype=dtype, device=device)
    alpha = (torch.as_tensor(v_0, dtype=dtype, device=device) - i) / 2.0
    chi2 = 2.0 * torch._standard_gamma(alpha, generator=generator)
    normals = torch.randn((D, D), generator=generator, dtype=dtype,
                          device=device)
    return torch.tril(normals, -1) + torch.diag(torch.sqrt(chi2))


def wishrnd(generator: torch.Generator, sigma, v_0, C=None) -> torch.Tensor:
    """A draw from Wishart(``sigma``, ``v_0``): ``C A A^T C^T`` with ``C =
    chol(sigma)`` (reference ``wishart.py:16-26``); ``C`` may be passed to
    reuse a Cholesky factor."""
    sigma = torch.as_tensor(sigma)
    if C is None:
        C = torch.linalg.cholesky(sigma)
    A = bartlett(generator, sigma.shape[-1], v_0, sigma.dtype, sigma.device)
    CA = C @ A
    return CA @ CA.T


def iwishrnd(generator: torch.Generator, sigma, v_0, C=None) -> torch.Tensor:
    """The inverse of a ``wishrnd`` draw (reference ``wishart.py:29-32``),
    i.e. IW(``sigma``^-1, ``v_0``) as the reference parameterises it,
    solved from the triangular factor ``C A`` instead of inverting the
    draw."""
    sigma = torch.as_tensor(sigma)
    D = sigma.shape[-1]
    if C is None:
        C = torch.linalg.cholesky(sigma)
    A = bartlett(generator, D, v_0, sigma.dtype, sigma.device)
    eye = torch.eye(D, dtype=sigma.dtype, device=sigma.device)
    inv_CA = torch.linalg.solve_triangular(C @ A, eye, upper=False)
    return inv_CA.T @ inv_CA
