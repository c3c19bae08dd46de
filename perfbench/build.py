"""Build the system under test from a configuration and a traffic mix.

A configuration file (``configs/<name>.json``) names the driver
(``unigram``, ``bigram``, ``kmeans`` or ``fbgmm``), the component family
(``fixed``, ``diag`` or ``full``), its prior and the driver's settings; a
traffic file (``traffic/<mix>.json``) the corpus and how the run drives
it.  The builders follow ``segmentalist_torch/utils/profiling.py``'s
``bench_prior`` / ``bench_segmenter`` / ``bench_kmeans_segmenter``, of
which this is a copy that reads its numbers from those files.

Only this module and the benchmark's wrappers (``capture.py``,
``trace.py``) touch the program; the reference (``reference/``) never
does.
"""

from __future__ import annotations

import numpy as np

from . import synth

DRIVERS = ("unigram", "bigram", "kmeans", "fbgmm")
FAMILIES = ("fixed", "diag", "full")


def make_corpus(cfg: dict, traffic: dict, seed: int):
    """The run's corpus from the traffic mix and ``seed``: ``(embedding_mats,
    vec_ids_dict, durations_dict, landmarks_dict, true_boundaries)``."""
    plan = synth.utterance_plan(
        traffic["n_utterances"], traffic["n_landmarks_min"],
        traffic["n_landmarks_max"], cfg["n_slices_max"], seed)
    return synth.synthetic_corpus(
        plan, D=cfg["D"], K_true=traffic["K_true"],
        n_slices_max=cfg["n_slices_max"],
        frames_per_slice=traffic["frames_per_slice"],
        noise=traffic["noise"], seed=seed)


def make_prior(cfg: dict, device):
    """The configuration's prior: FixedVarPrior(var, mu_0, var_0) for
    "fixed"; NIW(m_0, k_0, v_0 = D + v_0_plus_D, S_0) with a [D] S_0 for
    "diag" and S_0 I_D for "full" (scalars broadcast over D)."""
    from segmentalist_torch.priors import NIW, FixedVarPrior

    D, p, f32 = cfg["D"], cfg["prior"], np.float32
    if cfg["family"] == "fixed":
        return FixedVarPrior.create(np.full(D, p["var"], f32),
                                    np.full(D, p["mu_0"], f32),
                                    np.full(D, p["var_0"], f32),
                                    device=device)
    S_0 = (np.full(D, p["S_0"], f32) if cfg["family"] == "diag"
           else p["S_0"] * np.eye(D, dtype=f32))
    return NIW.create(np.full(D, p["m_0"], f32), p["k_0"],
                      D + p["v_0_plus_D"], S_0, device=device)


def make_system(cfg: dict, traffic: dict, corpus, seed: int, device):
    """The driver of ``cfg`` on ``corpus``, seeded with ``seed``."""
    import segmentalist_torch as pt

    driver, family = cfg["driver"], cfg["family"]
    if driver not in DRIVERS or family not in FAMILIES:
        raise ValueError("unknown driver / family %r / %r"
                         % (driver, family))
    em, vi, du, lm, _ = corpus
    seed = int(seed) % 2 ** 32
    if driver == "fbgmm":
        X = np.concatenate([em[k] for k in sorted(em)], axis=0)
        return pt.FBGMM(X, make_prior(cfg, "cpu"), cfg["am_alpha"],
                        cfg["am_K"], assignments="rand",
                        covariance_type=family, lms=cfg["lms"], seed=seed,
                        device=device)
    common = dict(p_boundary_init=cfg["p_boundary_init"],
                  n_slices_min=cfg["n_slices_min"],
                  n_slices_max=cfg["n_slices_max"],
                  batch_size=cfg["batch_size"], seed=seed, device=device)
    if driver == "kmeans":
        return pt.SegmentalKMeansWordseg(cfg["am_K"], em, vi, du, lm,
                                         **common)
    common.update(am_K=cfg["am_K"],
                  am_param_prior=make_prior(cfg, "cpu"), embedding_mats=em,
                  vec_ids_dict=vi, durations_dict=du, landmarks_dict=lm,
                  covariance_type=family,
                  beta_sent_boundary=cfg["beta_sent_boundary"],
                  lms=cfg["lms"], wip=cfg["wip"],
                  time_power_term=cfg["time_power_term"],
                  init_am_assignments=traffic["init_am_assignments"])
    if driver == "bigram":
        return pt.BigramAcousticWordseg(lm_params=cfg["lm"],
                                        fb_type="unigram", **common)
    return pt.UnigramAcousticWordseg(pt.FBGMM, am_alpha=cfg["am_alpha"],
                                     **common)


def sweep(system, cfg: dict, traffic: dict) -> dict:
    """One sweep through the driver's own entry point; returns its record
    dict."""
    if cfg["driver"] == "kmeans":
        return system.segment(1)
    if cfg["driver"] == "fbgmm":
        return system.gibbs_sample(1)
    return system.gibbs_sample(1, am_n_iter=traffic["am_n_iter"])


def sweep_objective(record: dict, cfg: dict) -> float:
    """The sweep's objective, finite on a sound sweep."""
    key = ("sum_neg_len_sqrd_norm" if cfg["driver"] == "kmeans"
           else "log_marg")
    return float(record[key][-1])
