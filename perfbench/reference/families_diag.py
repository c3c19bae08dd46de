"""The diagonal-covariance component family of the plain reference: a
normal-inverse-chi-squared prior on every dimension and a posterior
predictive that is a product of D univariate Student's t densities
(kamperh/segmentalist ``gaussian_components_diag.py``: the prior with a
[D] ``S_0``, :91-92; the posterior, :169-176 and :332-345; the predictive,
:237-259 and :347-360).

Plain PyTorch, no code of the program; every function works in the dtype
of its statistics.  For a component of n members with sums ``sx`` and
``ssq`` (per dimension):

    k_n = k_0 + n,   v_n = v_0 + n,   m_n = (k_0 m_0 + sx) / k_n
    var = (k_n + 1) / (k_n v_n) (S_0 + k_0 m_0^2 + ssq - k_n m_n^2)
    log p(x) = sum_d [ lgamma((v_n + 1) / 2) - lgamma(v_n / 2)
                       - log(v_n pi var_d) / 2
                       - (v_n + 1) / 2 log1p((x_d - m_nd)^2 / (v_n var_d)) ]

with an exact ``log1p`` per dimension and ``torch.lgamma`` (the program's
kernels group the dimensions' logs and take a Stirling series).

Departure, so that the unigram reference's slot tables work unchanged:
the family keeps [.., D, D] second moments, as the full family does, and
reads their diagonal; the off-diagonal sums are computed and never read.
"""

from __future__ import annotations

import math

import torch

LOG_PI = math.log(math.pi)


class Diag:
    """Diagonal-covariance family; ``prior`` = {"m_0" [D], "k_0", "v_0",
    "S_0" [D]} (scalars as floats)."""

    second_moments = True

    def __init__(self, prior: dict):
        self.m_0, self.k_0 = prior["m_0"], float(prior["k_0"])
        self.v_0, self.S_0 = float(prior["v_0"]), prior["S_0"]

    def params(self, n, sx, ssq):
        """(m_n [.., D], var [.., D], v_n [..]) of counts n [..], sums
        sx [.., D] and second moments ssq [.., D, D] (their diagonal)."""
        ssq = torch.diagonal(ssq, dim1=-2, dim2=-1)
        n = n.to(sx.dtype)
        k_n, v_n = self.k_0 + n, self.v_0 + n
        m_n = (self.k_0 * self.m_0 + sx) / k_n[..., None]
        s_n = (self.S_0 + self.k_0 * self.m_0 * self.m_0 + ssq
               - k_n[..., None] * m_n * m_n)
        var = ((k_n + 1.0) / (k_n * v_n))[..., None] * s_n
        return m_n, var, v_n

    @staticmethod
    def _t(sq, var, v):
        """sum_d of the univariate Student's t log densities of squared
        deviations sq [.., D] with scales var [.., D] and degrees of
        freedom v [..] (broadcast against each other)."""
        v_d = v[..., None]
        per_dim = (torch.lgamma((v_d + 1.0) / 2.0) - torch.lgamma(v_d / 2.0)
                   - 0.5 * torch.log(v_d * var) - 0.5 * LOG_PI
                   - (v_d + 1.0) / 2.0 * torch.log1p(sq / (v_d * var)))
        return per_dim.sum(-1)

    def logpdf(self, params, x):
        """log p(x | params) for x [.., D] broadcast against params."""
        mu, var, v = params
        d = x - mu
        return self._t(d * d, var, v)

    def logpdf_many(self, params, X, chunk: int = 64):
        """[P, M] log densities of rows X [P, M, D] under P components
        (params [P, ...]), component p for its own rows, ``chunk``
        components at a time."""
        mu, var, v = params
        out = [self.logpdf((mu[p:p + chunk, None], var[p:p + chunk, None],
                            v[p:p + chunk, None]), X[p:p + chunk])
               for p in range(0, X.shape[0], chunk)]
        return torch.cat(out) if out else X.new_zeros(X.shape[:2])

    def logpdf_rows(self, params, X, elements: int = 2 ** 25):
        """[R, C] log densities of rows X [R, D] under C components
        (params [C, ...]), in row chunks of at most ``elements`` [r, C, D]
        terms."""
        mu, var, v = params
        C, D = mu.shape[0], X.shape[-1]
        r = max(1, elements // max(1, C * D))
        out = [self.logpdf((mu, var, v), X[i:i + r, None, :])
               for i in range(0, X.shape[0], r)]
        return torch.cat(out) if out else X.new_zeros((0, C))

    def log_prior(self, x):
        """Log density under the prior predictive (n = 0)."""
        var = (self.k_0 + 1.0) / (self.k_0 * self.v_0) * self.S_0
        v = torch.tensor(self.v_0, dtype=x.dtype, device=x.device)
        d = x - self.m_0
        return self._t(d * d, var, v)
