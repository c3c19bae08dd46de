"""Reference of the unigram driver with diagonal-covariance components (a
normal-inverse-chi-squared prior per dimension and a product of Student's
t predictives: kernels K5, K2 and K6 in the program).  The family is in
:mod:`.families_diag`; the block-level functions (:class:`.unigram.Block`,
``block_scores``, ``chain``, ``judge_block``, ``stats_readings``,
``item_steps``) are :mod:`.unigram`'s, unchanged.  Only the model that they
take and the top-level :func:`judge` / :func:`control` that construct it
are here.

Departures from the published description (``gaussian_components_diag.py``):

* the family keeps [D, D] second moments and reads their diagonal, so that
  ``chain``'s slot tables work as they are: in float64 at the ``long``
  traffic (B 125, K 1000, D 130) that is ~1.7 GB for the chain's slots
  (at about 100 a row), 0.14 GB for the [K, D, D] rebuild and 0.55 GB for
  a 4,096-row chunk of its outer products; beside them the scores' rows
  of the touched leave-outs, 0.75 MB a (row, component) pair at M 720;
* ``logpdf_rows`` runs in row chunks of at most 2^25 [row, component,
  dim] terms, ``logpdf_many`` 64 components at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from .families_diag import Diag
from .unigram import (READINGS, Block, _draws, _merge, _rel_err,
                      block_scores, chain, item_sample, item_steps,
                      judge_block, new_segments, stats_readings)
from .unigram import Model as _Model

CAPTURE = {
    # the DP: its input scores (K5's output, duration-scaled and masked)
    # and its draw
    "dp": "segmentalist_torch.segmenters.blocked:segment_dp",
    # the chains' (K6) draws, before the cross-utterance decollision
    "chain": "segmentalist_torch.segmenters.unigram:diag_chain",
}


class Model(_Model):
    """:class:`.unigram.Model` with the diagonal-covariance family: the
    configuration's prior ``m_0``, ``k_0``, ``v_0 = D + v_0_plus_D`` and a
    [D] ``S_0`` (scalars broadcast over D)."""

    def __init__(self, cfg: dict, tables: common.Tables, device, dtype):
        self.cfg, self.t = cfg, tables
        self.device, self.dtype = device, dtype
        D, p = cfg["D"], cfg["prior"]

        def vec(v):
            return torch.full((D,), float(v), dtype=dtype, device=device)

        self.fam = Diag({"m_0": vec(p["m_0"]), "k_0": p["k_0"],
                         "v_0": D + p["v_0_plus_D"], "S_0": vec(p["S_0"])})
        self.K, self.alpha, self.lms = cfg["am_K"], cfg["am_alpha"], cfg["lms"]
        self.X = torch.as_tensor(tables.X, device=device).to(dtype)


def judge(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The readings of a captured check sweep, in float64
    (:func:`.unigram.judge` with this model)."""
    m = Model(cfg, tables, device, torch.float64)
    out = {k: 0.0 for k in READINGS}
    out["mismatch"] = 0
    _merge(out, stats_readings(m, cap["window_end"]["stats"],
                               cap["window_end"]["assign"]))
    if cap.get("am_sweep"):
        am = cap["am_sweep"]
        _merge(out, stats_readings(m, am["stats_after"], am["assign_after"]))
        gaps, bad = item_steps(m, am, item_sample(am, cap["check_items"],
                                                  seed), am["temp"], False)
        out["mismatch"] += bad
        out["item_gap"] = max(gaps)
    for blk in cap["blocks"]:
        _merge(out, judge_block(m, blk, cap["temps"]))
    _merge(out, stats_readings(m, cap["sweep_end"]["stats"],
                               cap["sweep_end"]["assign"]))
    return _draws(out)


def control(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The same readings with the reference in the program's place,
    computed in float32 with TF32 matrix products (which reach only the
    statistics' rebuild: the diag scores hold no matrix product), and
    judged in float64 (:func:`.unigram.control` with this model)."""
    ref = Model(cfg, tables, device, torch.float64)
    low = Model(cfg, tables, device, torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = {k: 0.0 for k in READINGS}
        out["mismatch"] = 0
        a = cap["window_end"]["assign"]
        _merge(out, stats_readings(ref, low.stats(a, tf32=True), a))
        if cap.get("am_sweep"):
            am = cap["am_sweep"]
            sample = item_sample(am, cap["check_items"], seed)
            draws, _ = item_steps(low, am, sample, am["temp"], True)
            fake = dict(am, assign_after=np.asarray(am["assign_after"]).copy())
            ids = np.nonzero(np.asarray(am["assign_before"]) >= 0)[0]
            for p, (k, _) in zip(sample, draws):
                fake["assign_after"][ids[p]] = k
            gaps, _ = item_steps(ref, fake, sample, am["temp"], False)
            out["item_gap"] = max(gaps)
        temps = cap["temps"]
        for c in cap["blocks"]:
            blk_l = Block(low, c["idx"], c["assign_before"],
                          c["bounds_before"])
            blk_r = Block(ref, c["idx"], c["assign_before"],
                          c["bounds_before"])
            live = [i for i, u in enumerate(c["idx"]) if u >= 0]
            s_low = block_scores(low, blk_l)
            s_ref = block_scores(ref, blk_r)
            both = torch.isfinite(s_ref)
            err = ((s_low.double() - s_ref).abs()
                   / s_ref.abs().clamp_min(1.0))[both]
            out["score_err"] = max(out["score_err"], float(err.max()))
            out["score_med"] = max(out["score_med"], float(err.median()))
            lengths = tables.lengths[blk_r.idx]
            lpc = common.log_p_continue(float(blk_r.g[0].sum()), tables.U,
                                        cfg["beta_sent_boundary"])
            dp_noise = torch.as_tensor(c["dp_noise"], device=device)[live]
            nl_low, rev_low = common.node_logits(s_low, lengths, lpc,
                                                 cfg["n_slices_min"])
            b_low = common.dp_sample(nl_low, dp_noise, lengths, temps[0])
            nl_ref, rev_ref = common.node_logits(s_ref, lengths, lpc,
                                                 cfg["n_slices_min"])
            gaps, path, mag = common.dp_gaps(nl_ref, rev_ref, dp_noise,
                                             lengths, b_low, temps[0])
            lp_low = common.dp_gaps(nl_low, rev_low, dp_noise, lengths,
                                    b_low, temps[0])[1]
            out["dp_gap"] = max(out["dp_gap"], float(gaps.max()))
            out["path_err"] = max(out["path_err"],
                                  _rel_err(lp_low, path, mag))
            E = new_segments(ref, blk_r, b_low)
            c_noise = torch.as_tensor(c["chain_noise"], device=device)[live]
            _, ks_low, _ = chain(low, blk_l, E, c_noise, temps[1])
            gaps, _, _ = chain(ref, blk_r, E, c_noise, temps[1], ks=ks_low)
            out["chain_gap"] = max(out["chain_gap"], float(gaps.max()))
        return _draws(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
