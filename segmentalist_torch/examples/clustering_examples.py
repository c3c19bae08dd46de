"""FBGMM against k-means clustering on 2-D synthetic data.

Counterpart of the JAX package's ``examples/clustering_examples.py`` (the
reference's ``examples/clustering_examples.ipynb``): draw N = 100 points
from four 2-D Gaussians, cluster them with (a) a fixed-variance finite
Bayesian GMM under collapsed Gibbs sampling and (b) k-means, report the
record statistics, and save a side-by-side scatter plot to ``--out``.
The clustering runs on the card unless ``--device cpu``; the plot needs
matplotlib.

    python -m segmentalist_torch.examples.clustering_examples [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from segmentalist_torch import FBGMM, FixedVarPrior, KMeans

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_out", "clustering_examples.png")


def generate_data(seed=2, N=100, D=2, K_true=4, mu_scale=4.0,
                  covar_scale=0.7):
    rng = np.random.RandomState(seed)
    z_true = rng.randint(0, K_true, N)
    mu = rng.randn(D, K_true) * mu_scale
    X = mu[:, z_true] + rng.randn(D, N) * covar_scale
    return X.T.astype(np.float32), z_true, mu.T


def main(device="cuda", out=DEFAULT_OUT):
    """Cluster on the card (or ``device``), plot to ``out``; returns the
    two final records' last values."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from segmentalist_torch.examples.plot_utils import plot_mixture_model

    X, z_true, mu_true = generate_data()
    N, D = X.shape
    K = 4

    # --- FBGMM (fixed variance), collapsed Gibbs --------------------------
    covar_scale = 0.7
    prior = FixedVarPrior.create(
        covar_scale**2 * np.ones(D),
        np.zeros(D),
        (covar_scale**2 / 0.05) * np.ones(D),
    )
    np.random.seed(2)
    fbgmm = FBGMM(X, prior, alpha=1.0, K=K, assignments="rand",
                  covariance_type="fixed", seed=2, device=device)
    t0 = time.time()
    record = fbgmm.gibbs_sample(20)
    print("FBGMM: 20 sweeps in %.3fs, final log_marg %.3f, K=%d"
          % (time.time() - t0, record["log_marg"][-1],
             record["components"][-1]))

    # --- k-means -----------------------------------------------------------
    km = KMeans(X, K, assignments="rand", rng=np.random.RandomState(2),
                device=device)
    t0 = time.time()
    km_record = km.fit(20)
    print("KMeans: %d iterations in %.3fs, final sum_neg_sqrd_norm %.3f"
          % (len(km_record["sum_neg_sqrd_norm"]), time.time() - t0,
             km_record["sum_neg_sqrd_norm"][-1]))

    # --- plot --------------------------------------------------------------
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].scatter(X[:, 0], X[:, 1], c=z_true, s=12, cmap="tab10")
    axes[0].set_title("ground truth")
    plot_mixture_model(axes[1], X, fbgmm.assignments.cpu().numpy())
    axes[1].set_title("FBGMM (fixed var), 20 Gibbs sweeps")
    plot_mixture_model(axes[2], X, km.assignments.cpu().numpy(),
                       means=km.means().cpu().numpy())
    axes[2].set_title("k-means, 20 iterations")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)
    return record["log_marg"][-1], km_record["sum_neg_sqrd_norm"][-1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the figure goes (default %(default)s)")
    args = ap.parse_args()
    main(args.device, args.out)
