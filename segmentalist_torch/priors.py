"""Prior parameter containers for the Bayesian Gaussian component models.

PyTorch counterpart of ``segmentalist_tpu/priors.py``: immutable NamedTuples
of tensors.

* ``NIW``           -- normal-inverse-Wishart prior (reference
                       ``niw.py:7-15``).
* ``FixedVarPrior`` -- fixed diagonal covariance, conjugate normal prior on
                       the mean only (reference
                       ``gaussian_components_fixedvar.py:349-356``).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=device)


class NIW(NamedTuple):
    """Normal-inverse-Wishart prior (reference ``niw.py:7-15``).

    m_0 [D] prior mean; k_0 scalar pseudo-count; v_0 scalar degrees of
    freedom (>= D); S_0 [D, D] prior scatter (or [D] for the diagonal model).
    """

    m_0: torch.Tensor
    k_0: torch.Tensor
    v_0: torch.Tensor
    S_0: torch.Tensor

    @classmethod
    def create(cls, m_0, k_0, v_0, S_0, device=None) -> "NIW":
        m_0 = _tensor(m_0, device=device)
        D = m_0.shape[-1]
        if float(v_0) < D:
            raise ValueError(
                "v_0 must be larger or equal to dimension of data")
        return cls(
            m_0=m_0,
            k_0=_tensor(k_0, m_0.dtype, m_0.device),
            v_0=_tensor(v_0, m_0.dtype, m_0.device),
            S_0=_tensor(S_0, m_0.dtype, m_0.device),
        )

    def to(self, device=None, dtype=None) -> "NIW":
        return NIW(*(t.to(device=device, dtype=dtype) for t in self))


class FixedVarPrior(NamedTuple):
    """Fixed diagonal-covariance Gaussian prior: ``var`` [D] observation
    variance, ``mu_0`` [D] prior mean, ``var_0`` [D] prior variance of the
    mean."""

    var: torch.Tensor
    mu_0: torch.Tensor
    var_0: torch.Tensor

    @classmethod
    def create(cls, var, mu_0, var_0, device=None) -> "FixedVarPrior":
        mu_0 = _tensor(mu_0, device=device)
        return cls(
            var=_tensor(var, mu_0.dtype, mu_0.device),
            mu_0=mu_0,
            var_0=_tensor(var_0, mu_0.dtype, mu_0.device),
        )

    def to(self, device=None, dtype=None) -> "FixedVarPrior":
        return FixedVarPrior(*(t.to(device=device, dtype=dtype) for t in self))


Prior = Union[NIW, FixedVarPrior]
