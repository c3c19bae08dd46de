"""Plotting helpers for mixture-model examples.

The port's own copy of the JAX package's ``examples/plot_utils.py`` (the
reference plotting layer, ``examples/plot_utils.py:16-39``): draw a
Gaussian's 1-sigma covariance ellipse and scatter a clustered data set
coloured by component assignment.  Works on host numpy arrays.  matplotlib
is imported inside the functions, so importing this module needs none.
"""

from __future__ import annotations

import numpy as np


def plot_ellipse(ax, mu, sigma, color="b"):
    """Draw the 1-standard-deviation ellipse of a 2-D Gaussian.

    ``sigma`` may be a full [2, 2] covariance, a length-2 diagonal, or a
    scalar (isotropic).
    """
    mu = np.asarray(mu, dtype=float)
    sigma = np.asarray(sigma, dtype=float)
    if sigma.ndim == 0:
        sigma = np.eye(2) * float(sigma)
    elif sigma.ndim == 1:
        sigma = np.diag(sigma)

    vals, vecs = np.linalg.eigh(sigma)
    order = np.argsort(vals)[::-1]
    vals, vecs = vals[order], vecs[:, order]

    theta = np.linspace(0.0, 2.0 * np.pi, 200)
    circle = np.stack([np.cos(theta), np.sin(theta)])
    ellipse = (vecs * np.sqrt(np.maximum(vals, 0.0))) @ circle
    ax.plot(mu[0] + ellipse[0], mu[1] + ellipse[1], color=color, linewidth=2)


def plot_mixture_model(ax, X, assignments, means=None, covars=None,
                       cmap="tab10"):
    """Scatter 2-D data coloured by component assignment; optionally
    overlay component means and covariance ellipses."""
    import matplotlib.pyplot as plt

    X = np.asarray(X)
    assignments = np.asarray(assignments)
    colors = plt.get_cmap(cmap)
    ks = sorted(int(k) for k in np.unique(assignments) if k >= 0)
    for pos, k in enumerate(ks):
        mask = assignments == k
        ax.scatter(X[mask, 0], X[mask, 1], s=12,
                   color=colors(pos % 10), label=f"component {k}")
    unassigned = assignments < 0
    if unassigned.any():
        ax.scatter(X[unassigned, 0], X[unassigned, 1], s=12, color="0.7",
                   label="unassigned")
    if means is not None:
        for pos, k in enumerate(ks):
            mu = np.asarray(means)[k]
            ax.plot(mu[0], mu[1], "x", color=colors(pos % 10),
                    markersize=12, markeredgewidth=3)
            if covars is not None:
                plot_ellipse(ax, mu, np.asarray(covars)[k],
                             color=colors(pos % 10))
    ax.set_aspect("equal", adjustable="datalim")
