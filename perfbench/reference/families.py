"""Component families of the plain reference: the posterior predictive of a
Gaussian component under its conjugate prior, from sufficient statistics.

Plain PyTorch, no code of the program.  Every function takes statistics
with leading batch axes and works in their dtype; matrix products go
through ``torch.matmul``, so that a float32 run with TF32 switched on
(the control) rounds them as TF32 would.

* ``fixed``: known diagonal variance ``var`` and a normal prior
  ``N(mu_0, var_0)`` on the mean (kamperh/segmentalist
  ``gaussian_components_fixedvar.py``); the prior density takes
  ``1 / var_0`` as its precision, as that reference does.
* ``full``: normal-inverse-Wishart prior ``(m_0, k_0, v_0, S_0)`` and a
  multivariate Student's t predictive (``gaussian_components.py``).
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
LOG_PI = math.log(math.pi)


class Fixed:
    """Fixed-variance family; ``prior`` = {"var", "mu_0", "var_0"} as [D]
    tensors."""

    second_moments = False

    def __init__(self, prior: dict):
        self.var, self.mu_0, self.var_0 = (prior["var"], prior["mu_0"],
                                           prior["var_0"])

    def params(self, n, sx, ssq=None):
        """(mu [.., D], pp [.., D], lpp [..]) of counts n [..] and sums
        sx [.., D]."""
        prec, prec0 = 1.0 / self.var, 1.0 / self.var_0
        prec_n = prec0 + n[..., None].to(sx.dtype) * prec
        mu = (prec0 * self.mu_0 + prec * sx) / prec_n
        pp = prec_n * prec / (prec_n + prec)
        return mu, pp, torch.log(pp).sum(-1)

    def logpdf(self, params, x):
        """log p(x | params) for x [.., D] broadcast against params."""
        mu, pp, lpp = params
        d = x - mu
        D = x.shape[-1]
        return -0.5 * D * LOG_2PI + 0.5 * lpp - 0.5 * (d * d * pp).sum(-1)

    def logpdf_many(self, params, X):
        """[P, M] log densities of rows X [P, M, D] under P components
        (params [P, ...]), component p for its own rows."""
        mu, pp, lpp = params
        return self.logpdf((mu[:, None], pp[:, None], lpp[:, None]), X)

    def logpdf_rows(self, params, X):
        """[R, C] log densities of rows X [R, D] under C components
        (params [C, ...]), in matrix-product form."""
        mu, pp, lpp = params
        D = X.shape[-1]
        maha = ((X * X) @ pp.T - 2.0 * (X @ (mu * pp).T)
                + (mu * mu * pp).sum(-1)[None, :])
        return -0.5 * D * LOG_2PI + 0.5 * lpp[None, :] - 0.5 * maha

    def log_prior(self, x):
        prec0 = 1.0 / self.var_0
        d = x - self.mu_0
        D = x.shape[-1]
        return (-0.5 * D * LOG_2PI + 0.5 * torch.log(prec0).sum()
                - 0.5 * (d * d * prec0).sum(-1))


class Full:
    """Full-covariance NIW family; ``prior`` = {"m_0" [D], "k_0", "v_0",
    "S_0" [D, D]} (scalars as floats)."""

    second_moments = True

    def __init__(self, prior: dict):
        self.m_0, self.k_0 = prior["m_0"], float(prior["k_0"])
        self.v_0, self.S_0 = float(prior["v_0"]), prior["S_0"]

    def _factor(self, covar, v):
        L = torch.linalg.cholesky(covar)
        eye = torch.eye(covar.shape[-1], dtype=covar.dtype,
                        device=covar.device).expand_as(covar)
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return L_inv, logdet

    def params(self, n, sx, ssq):
        """(mu [.., D], L_inv [.., D, D], logdet [..], v [..]): the
        predictive location, the inverse Cholesky factor and
        log-determinant of its scale matrix, and its degrees of freedom."""
        D = sx.shape[-1]
        n = n.to(sx.dtype)
        k_n, v_n = self.k_0 + n, self.v_0 + n
        m_n = (self.k_0 * self.m_0 + sx) / k_n[..., None]
        v = v_n - D + 1.0
        s_n = (self.S_0 + self.k_0 * torch.outer(self.m_0, self.m_0) + ssq
               - k_n[..., None, None]
               * (m_n[..., :, None] * m_n[..., None, :]))
        covar = ((k_n + 1.0) / (k_n * v))[..., None, None] * s_n
        L_inv, logdet = self._factor(covar, v)
        return m_n, L_inv, logdet, v

    @staticmethod
    def _t(maha, logdet, v, D):
        return (torch.lgamma((v + D) / 2.0) - torch.lgamma(v / 2.0)
                - D / 2.0 * torch.log(v) - D / 2.0 * LOG_PI - 0.5 * logdet
                - (v + D) / 2.0 * torch.log1p(maha / v))

    def logpdf(self, params, x):
        mu, L_inv, logdet, v = params
        z = (L_inv @ (x - mu)[..., None])[..., 0]
        return self._t((z * z).sum(-1), logdet, v, x.shape[-1])

    def logpdf_many(self, params, X):
        """[P, M] log densities of rows X [P, M, D] under P components
        (params [P, ...]), component p for its own rows."""
        mu, L_inv, logdet, v = params
        z = (X - mu[:, None]) @ L_inv.transpose(-1, -2)
        return self._t((z * z).sum(-1), logdet[:, None], v[:, None],
                       X.shape[-1])

    def logpdf_rows(self, params, X, chunk: int = 4096):
        """[R, C] log densities of rows X [R, D] under C components, the
        Mahalanobis form expanded into matrix products over the packed
        upper triangle, ``x^T A x - 2 x . A mu + mu . A mu`` with ``A =
        L^-T L^-1`` (the form the program's scorer computes), ``chunk``
        rows at a time."""
        mu, L_inv, logdet, v = params
        D = X.shape[-1]
        A = L_inv.transpose(-1, -2) @ L_inv                    # [C, D, D]
        iu = torch.triu_indices(D, D, device=X.device)
        dbl = torch.where(iu[0] == iu[1], 1.0, 2.0).to(X.dtype)
        A2 = A[:, iu[0], iu[1]] * dbl                          # [C, F]
        A1 = (A @ mu[..., None])[..., 0]                       # [C, D]
        a0 = (mu * A1).sum(-1)                                 # [C]
        out = []
        for r in range(0, X.shape[0], chunk):
            x = X[r:r + chunk]
            maha = ((x[:, iu[0]] * x[:, iu[1]]) @ A2.T - 2.0 * (x @ A1.T)
                    + a0[None, :])
            out.append(self._t(maha, logdet[None, :], v[None, :], D))
        return torch.cat(out) if out else X.new_zeros((0, mu.shape[0]))

    def log_prior(self, x):
        D = x.shape[-1]
        v = torch.tensor(self.v_0 - D + 1.0, dtype=x.dtype, device=x.device)
        covar = (self.k_0 + 1.0) / (self.k_0 * v) * self.S_0
        L_inv, logdet = self._factor(covar, v)
        z = (x - self.m_0) @ L_inv.T
        return self._t((z * z).sum(-1), logdet, v, D)


def make(family: str, prior: dict):
    if family == "fixed":
        return Fixed(prior)
    if family == "full":
        return Full(prior)
    raise ValueError("no reference for the %r family" % (family,))
