"""Runnable per-module smoke demos.

Counterpart of ``segmentalist_tpu/demos.py``: the reference ships a
``main()`` demo in most modules (``gaussian_components.py:370-465``,
``fbgmm.py:505-546``, ``unigram_acoustic_wordseg.py:871-963``,
``kmeans_components.py:274-324``, ``bigram_lms.py:117-156``,
``kmeans.py:176-217``, ``bigram_acoustic_wordseg.py:765-857``,
``kmeans_acoustic_wordseg.py:558-658``), and each sibling module's
``__main__`` hook dispatches here, so ``python -m
segmentalist_torch.models.fbgmm`` works like the reference's ``python
fbgmm.py``.  Every demo runs on the CUDA card unless it is given
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np


def _toy_mixture(seed=1, N=40, D=2, K_true=4, mu_scale=4.0, covar_scale=0.7):
    rng = np.random.RandomState(seed)
    z = rng.randint(0, K_true, N)
    mu = rng.randn(K_true, D) * mu_scale
    X = (mu[z] + rng.randn(N, D) * covar_scale).astype(np.float32)
    return X, z


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def demo_components(covariance_type="full", device="cuda"):
    """Score, add and remove items against a component store (reference
    ``gaussian_components*.py`` main demos)."""
    import torch

    from .device import resolve_device
    from .ops import stats as stats_ops
    from .priors import NIW, FixedVarPrior

    dev = resolve_device(device)
    if covariance_type == "full":
        from .models import components_full as comp
        prior = NIW.create(np.full(3, 0.2, np.float32), 2.0, 5.0,
                           5.0 * np.eye(3, dtype=np.float32), device=dev)
    elif covariance_type == "diag":
        from .models import components_diag as comp
        prior = NIW.create(np.full(3, 0.2, np.float32), 2.0, 5.0,
                           5.0 * np.ones(3, np.float32), device=dev)
    else:
        from .models import components_fixedvar as comp
        prior = FixedVarPrior.create(0.5 * np.ones(3, np.float32),
                                     np.zeros(3, np.float32),
                                     np.ones(3, np.float32), device=dev)
    full = covariance_type == "full"
    X = torch.tensor([[1.2, 0.9, 0.2], [-0.1, 0.8, -0.2], [0.5, 0.4, 0.3]],
                     dtype=torch.float32, device=dev)
    assignments = torch.tensor([0, 0, -1], dtype=torch.int32, device=dev)
    st = stats_ops.suff_stats_from_assignments(X, assignments, K_max=4,
                                               full_cov=full)
    params = comp.predictive_params(prior, st)
    print("counts:", _host(st.counts))
    print("log prior of X[2]:     %.6f" % float(comp.log_prior(prior, X[2])))
    print("log post pred of X[2]:",
          _host(comp.log_post_pred(params, X[2]))[:2])
    print("log_marg_k:", _host(comp.log_marg_k_vec(prior, st))[:2])
    st2 = stats_ops.del_item(st, X[1], 0, full_cov=full)
    st2 = stats_ops.add_item(st2, X[1], 1, full_cov=full)
    print("after moving item 1 -> component 1, counts:", _host(st2.counts))


def demo_fbgmm(covariance_type="fixed", n_iter=10, device="cuda"):
    """Toy-mixture FBGMM Gibbs sampling (reference ``fbgmm.py:505-546``)."""
    from . import FBGMM, NIW, FixedVarPrior

    X, z_true = _toy_mixture()
    D = X.shape[1]
    if covariance_type == "fixed":
        prior = FixedVarPrior.create(0.7**2 * np.ones(D, np.float32),
                                     np.zeros(D, np.float32),
                                     4.0**2 * np.ones(D, np.float32))
    elif covariance_type == "diag":
        prior = NIW.create(np.zeros(D, np.float32), 0.05, D + 3.0,
                           0.7**2 * (D + 3.0) * np.ones(D, np.float32))
    else:
        prior = NIW.create(np.zeros(D, np.float32), 0.05, D + 3.0,
                           0.7**2 * (D + 3.0) * np.eye(D, dtype=np.float32))
    np.random.seed(1)
    model = FBGMM(X, prior, alpha=1.0, K=6, assignments="rand",
                  covariance_type=covariance_type, seed=1, device=device)
    print("initial log marginal prob: %.4f" % model.log_marg())
    record = model.gibbs_sample(n_iter)
    print("final   log marginal prob: %.4f" % record["log_marg"][-1])
    print("K used: %d of 6; assignments: %s"
          % (model.K, _host(model.assignments)))


def demo_kmeans(n_iter=10, device="cuda"):
    """Toy-mixture k-means (reference ``kmeans.py:176-217`` and the
    ``kmeans_components.py:274-324`` scoring demo)."""
    from . import KMeans

    X, _ = _toy_mixture(covar_scale=2.0)
    model = KMeans(X, K=4, assignments="rand",
                   rng=np.random.RandomState(1), device=device)
    comp = model.components
    print("initial objective: %.4f" % float(comp.sum_neg_sqrd_norm()))
    record = model.fit(n_iter)
    print("final   objective: %.4f" % record["sum_neg_sqrd_norm"][-1])
    print("counts:", _host(comp.counts))


def demo_bigram_lm(device="cuda"):
    """Count / probability identities (reference ``bigram_lms.py:117-156``)."""
    from . import BigramSmoothLM

    lm = BigramSmoothLM(intrp_lambda=0.1, a=1.0, b=1.0, K=5, device=device)
    lm.counts_from_utterance([0, 1, 1, 2, 4])
    lm.counts_from_utterance([2, 1, 0, 0, 1])
    print("unigram counts:", lm.unigram_counts)
    print("p(i=1):         %.6f" % lm.prob_i(1))
    print("p(i=1 | j=0):   %.6f" % lm.prob_i_given_j(1, 0))
    print("log p vec:", lm.log_prob_vec_i())


def _toy_corpus(seed=0, n_utterances=6):
    from .utils.synth import synthetic_corpus

    em, vi, du, lm, truth = synthetic_corpus(
        n_utterances=n_utterances, n_landmarks_max=8, D=4, K_true=3,
        n_slices_max=4, seed=seed)
    em = {k: v.astype(np.float32) for k, v in em.items()}
    return em, vi, du, lm


def _toy_prior(D=4):
    from . import FixedVarPrior

    return FixedVarPrior.create(0.05 * np.ones(D, np.float32),
                                np.zeros(D, np.float32),
                                np.ones(D, np.float32))


def demo_unigram_seg(n_iter=5, device="cuda"):
    """End-to-end unigram segmentation on a toy corpus (reference
    ``unigram_acoustic_wordseg.py:871-963``)."""
    from . import FBGMM, UnigramAcousticWordseg

    em, vi, du, lm = _toy_corpus()
    seg = UnigramAcousticWordseg(
        FBGMM, am_alpha=1.0, am_K=6, am_param_prior=_toy_prior(),
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=4,
        beta_sent_boundary=-1, batch_size=3, seed=1, device=device)
    record = seg.gibbs_sample(n_iter)
    print("log_marg trajectory:",
          ["%.2f" % v for v in record["log_marg"]])
    for i in range(2):
        print("utterance %d transcript: %s"
              % (i, seg.get_unsup_transcript_i(i)))


def demo_bigram_seg(n_iter=5, device="cuda"):
    """Bigram driver on the same toy corpus (reference
    ``bigram_acoustic_wordseg.py:765-857``)."""
    from . import BigramAcousticWordseg

    em, vi, du, lm = _toy_corpus()
    seg = BigramAcousticWordseg(
        am_K=6, am_param_prior=_toy_prior(), covariance_type="fixed",
        lm_params={"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0},
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=4,
        beta_sent_boundary=-1, fb_type="unigram", batch_size=3, seed=1,
        device=device)
    record = seg.gibbs_sample(n_iter)
    print("log_marg trajectory:",
          ["%.2f" % v for v in record["log_marg"]])
    print("utterance 0 transcript:", seg.get_unsup_transcript_i(0))


def demo_kmeans_seg(n_iter=5, device="cuda"):
    """Segmental k-means driver on the toy corpus (reference
    ``kmeans_acoustic_wordseg.py:558-658``)."""
    from . import SegmentalKMeansWordseg

    em, vi, du, lm = _toy_corpus()
    seg = SegmentalKMeansWordseg(
        am_K=6, embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=4,
        batch_size=3, seed=1, device=device)
    record = seg.segment(n_iter)
    print("sum_neg_len_sqrd_norm trajectory:",
          ["%.2f" % v for v in record["sum_neg_len_sqrd_norm"]])
    print("utterance 0 transcript:", seg.get_max_unsup_transcript_i(0))


DEMOS = {
    "components_fixed": lambda device: demo_components("fixed", device),
    "components_diag": lambda device: demo_components("diag", device),
    "components_full": lambda device: demo_components("full", device),
    "fbgmm": lambda device: demo_fbgmm(device=device),
    "kmeans": lambda device: demo_kmeans(device=device),
    "bigram_lm": lambda device: demo_bigram_lm(device=device),
    "unigram_seg": lambda device: demo_unigram_seg(device=device),
    "bigram_seg": lambda device: demo_bigram_seg(device=device),
    "kmeans_seg": lambda device: demo_kmeans_seg(device=device),
}


def run_demo(name: str, argv=None):
    """Run one demo of ``DEMOS`` from a module's ``__main__`` hook:
    ``python -m <module> [--device cpu]``."""
    import argparse

    ap = argparse.ArgumentParser(description="Run the %s demo." % name)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    DEMOS[name](ap.parse_args(argv).device)
