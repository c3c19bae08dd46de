"""Special functions shared by the port's plain versions and its kernels.

``lgamma_stirling`` is the recurrence-lifted Stirling series of the JAX
package's diagonal- and full-covariance chain kernels
(``segmentalist_tpu/ops/pallas_chain.py::_lgamma_stirling``).  The CUDA
kernels evaluate the same composition in ``csrc/special.cuh``; both keep
its operation order, so a kernel and its plain version round alike.
"""

from __future__ import annotations

import math

import torch

# The series constants as the JAX package forms them: Python doubles, each
# rounded once to the working precision of the tensor they meet.
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
INV_12 = 1.0 / 12.0
INV_360 = 1.0 / 360.0
INV_1260 = 1.0 / 1260.0


def lgamma_stirling(z: torch.Tensor) -> torch.Tensor:
    """log Gamma(z) for z > 0: lift z by 6 with ``shift = 0 + log z + log(z
    + 1) + ... + log(z + 5)`` (summed in that order), then the Stirling
    series at z + 6, summed left to right.  Accurate to ~1e-7 relative for
    the half-integer arguments of the Student-t degrees of freedom."""
    shift = torch.zeros_like(z)
    for i in range(6):
        shift = shift + torch.log(z + i)
    z6 = z + 6.0
    inv = 1.0 / z6
    inv2 = inv * inv
    series = ((z6 - 0.5) * torch.log(z6) - z6 + HALF_LOG_2PI
              + inv * INV_12
              - (inv * inv2) * INV_360
              + (inv * inv2 * inv2) * INV_1260)
    return series - shift


def lgamma_ratio(v: torch.Tensor, a=1.0) -> torch.Tensor:
    """``lgamma((v + a) / 2) - lgamma(v / 2)`` through
    :func:`lgamma_stirling`: the count-dependent Student-t constant of the
    diag chains (a = 1, kept per column) and of the full-covariance chain
    (a = D, per touched slot)."""
    return lgamma_stirling((v + a) / 2.0) - lgamma_stirling(v / 2.0)
