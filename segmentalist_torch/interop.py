"""Carry a segmenter's state across from the JAX package.

The JAX segmenter's state, fetched as numpy arrays, replaces the port's,
so both packages can continue from one state (the parity tests start a
block step of each from it).  Imports no JAX: the caller converts.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bigram_lm import BigramLMState
from .models.kmeans import KMeans, KMeansState
from .ops.stats import SuffStats
from .priors import NIW, FixedVarPrior

STATE_KEYS = ("X", "counts", "sum_x", "sum_sq", "assignments", "boundaries")
# a SegmentalKMeansWordseg's: no second moments and no prior
KMEANS_KEYS = ("X", "counts", "sum_x", "assignments", "random_means",
               "boundaries")
PRIOR_KEYS = {"fixed": ("var", "mu_0", "var_0"),   # FixedVarPrior
              "diag": ("m_0", "k_0", "v_0", "S_0"),  # NIW, S_0 a [D] vector
              "full": ("m_0", "k_0", "v_0", "S_0")}  # NIW, S_0 [D, D]
PRIOR_TYPES = {"fixed": FixedVarPrior, "diag": NIW, "full": NIW}
LM_KEYS = ("unigram_counts", "bigram_counts")


def load_state(seg, state: dict):
    """Replace the state of ``seg`` (a port ``UnigramAcousticWordseg``,
    ``BigramAcousticWordseg`` or ``SegmentalKMeansWordseg``) with
    ``state``: numpy arrays under ``STATE_KEYS`` -- data ``X`` [N, D],
    statistics ``counts`` [K] / ``sum_x`` [K, D] / ``sum_sq`` ([K, D], or
    [K, D, D] for "full"), the ``[N]`` assignments and the ``[U, N_max]``
    boundaries -- the prior under the family's ``PRIOR_KEYS`` (``var`` /
    ``mu_0`` / ``var_0`` [D] for "fixed"; ``m_0`` [D], scalars ``k_0`` /
    ``v_0`` and ``S_0`` -- [D] for "diag", [D, D] for "full" -- as the JAX
    ``NIW`` holds them) and, for a bigram segmenter, the LM tables under
    ``LM_KEYS`` (``unigram_counts`` [K], ``bigram_counts`` [K, K], the JAX
    segmenter's ``lm.state``).  A k-means segmenter takes ``KMEANS_KEYS``
    instead: no ``sum_sq`` and no prior, its ``random_means`` [K, D]."""
    am, dev = seg.acoustic_model, seg.device
    kmeans = isinstance(am, KMeans)
    if kmeans:
        keys = KMEANS_KEYS
    else:
        cov = am.covariance_type
        keys = (STATE_KEYS + PRIOR_KEYS[cov]
                + (LM_KEYS if hasattr(seg, "lm") else ()))
    missing = [k for k in keys if k not in state]
    if missing:
        raise KeyError("state lacks %s" % missing)

    def t(name, dtype=None):
        return torch.as_tensor(np.array(state[name]), dtype=dtype,
                               device=dev)

    X = t("X")
    am.X = X
    am.N, am.D = X.shape
    if kmeans:
        am.state = KMeansState(t("assignments", torch.int32),
                               t("counts", torch.int32), t("sum_x", X.dtype))
        am.K_max = int(am.state.counts.shape[0])
        am.random_means = t("random_means", X.dtype)
        seg.utterances.boundaries_dev = t("boundaries", torch.bool)
        seg.refresh_candidates()
        return
    am.prior = PRIOR_TYPES[cov](*(t(k, X.dtype) for k in PRIOR_KEYS[cov]))
    am.stats = SuffStats(t("counts", torch.int32), t("sum_x", X.dtype),
                         t("sum_sq", X.dtype))
    am.K_max = int(am.stats.counts.shape[0])
    am.assignments = t("assignments", torch.int32)
    am.log_prior_vec = am.cov.log_prior_batch(am.prior, X)
    seg.utterances.boundaries_dev = t("boundaries", torch.bool)
    if hasattr(seg, "lm"):
        seg.lm.state = BigramLMState(t("unigram_counts", torch.int32),
                                     t("bigram_counts", torch.int32))
    seg.refresh_candidates()
