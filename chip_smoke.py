#!/usr/bin/env python3
"""Check the PyTorch port (``segmentalist_torch``) on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) at the first
check that does not hold:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 must be off;
2. build: compile the hand-written kernels from ``segmentalist_torch/csrc``;
3. each kernel (K1-K12, both compositions of K5, both modes of K9) against
   its plain PyTorch version on the card, in float32, at the flagship
   shapes (B=125, N_max=20, W=6, K=1000, D=13) and a long/wide case
   (N_max=120, D=130); K8 and the reference's expanded Mahalanobis form in
   float32 against float64; K9's bigram mode on a crafted case where the
   own-pair correction decides draws; the launch plans of K1 / K5, K3 /
   K4, K6 / K7, K8 and K9, and K3 / K4 / K6 / K7's longest chain; K2 as
   the whole DP in one launch against the plain composition, identical
   alphas and boundaries in both modes, also at W = N_max = 120 and, in
   Viterbi mode, on tied scores (integer scores, half the utterances
   costing the same a slice in every window);
   K10, the FBGMM's item chain, in both families (fixed variance, exact
   diag) with the delete on and off, at every cluster size the card
   schedules, at the toy (N 100, K 4, D 2), the flagship's initial state
   (6,149 assigned items, K 1000, D 13), fbgmm_flagship's launch (51,972
   items) and D 130: ks, final counts and running sums identical to its
   plain version (run on the CPU in worker processes from the card's
   inputs), with its plan;
   K11, the full family's item chain, at the same three shapes with the
   delete on and off (at D 130 on its first 60 items), identical to its
   plain version, and at the flagship at every cluster size the card
   schedules (1 to 16 CTAs), with its plan (C, threads, form, shared
   bytes a CTA);
   K12, the merge kernel of a block's statistics, at D 130 with the
   flagship's and the long shape's blocks (B 125, K 1000, S 20 and 120),
   in the [K, D] and the [K, D, D] form on ``tests/merge_cases.py``'s
   edge cases: one launch a merge, identical to its plain version, and
   the one-hot composition it replaces within ``MERGE_RTOL``;
4. small-input references: the reference-pinned candidate scores of the
   one-utterance toy corpus, and block steps on the card against the same
   block steps on the CPU (plain versions) on shared noise, for the
   unigram and bigram segmenters of the three families (diag and full
   unigram also in Viterbi, diag's taking K5's exact composition), FBGMM
   sweeps of both modes and the three families (K10, K11) on the card
   against the CPU, three segmental
   k-means block steps (K2's Viterbi mode) on the bench corpus against
   the CPU from one state, and the module-level
   ``forward_backward_kmeans_viterbi`` on one utterance;
5. six paths at bench scale, on the 1000-utterance synthetic corpus, 137
   sweeps each: the unigram and the bigram segmenter with fixed-variance
   components (K1, K2, K3 / K4), diagonal-covariance components (K5, K2,
   K6 / K7) and full-covariance components (K8, K2, K9; the JAX package's
   `bench.py` unigram_full and `benchmarks/all_models.py` rows); for each,
   every kernel's launch count in that run, log_marg and boundary F1;
   K12 launched once a block step where the merge is eager (all but
   unigram_fixed and bigram, whose merges replay a CUDA graph and launch
   the kernel only where they run eagerly or capture).
   Then the FBGMM's own sampler (K10): the notebook toy of
   `bench.py:455-479` for 100 sweeps in each mode (purity >= 0.95) and 3
   full-family sequential sweeps on its points (K11), the FBGMM alone on
   the flagship corpus's 51,972 candidate spans at K 1000 (4 sequential
   and 4 blocked sweeps, log_marg rising), unigram_fixed and unigram_full
   with the one-by-one init and `am_n_iter=1` (one K10 / K11 launch for
   the init and one a sweep), and
   kmeans_wordseg, the segmental k-means segmenter of `bench.py:442-452`
   (K2 in its Viterbi mode, one launch a block) for 137 sweeps: its
   objective rising, boundary F1 >= 0.64.

6. auxiliary, at the flagship's full width (the same corpus and
   configurations): (a) resume: for the six Gibbs paths, unigram_fixed_am,
   unigram_full_am and kmeans_wordseg, a segmenter runs 2 sweeps, is saved
   (``utils/checkpoint.py``), runs 2 more; a fresh segmenter (another
   host RNG, another generator seed) restores and runs the same 2; the
   two must be identical in every array of the checkpoint (assignments,
   boundaries, statistics, LM tables, k-means state, the generator's
   state bytes), with each path's kernels launched; the checkpoint's
   bytes; (b) sweeps with ``validate=True, monitor_i=0`` on
   unigram_fixed, bigram and kmeans_wordseg, each path's kernels
   launched, and the monitor on the card against the CPU's from one state
   (scores within ``SCORE_TOL``); (c)
   ``debug_gibbs_only`` leaves the other boundary rows untouched, and a
   NaN in ``sum_x[0, 0]`` raises ``ValidationError`` naming sum_x with no
   fault of the card; (d) every demo of ``segmentalist_torch/demos.py``
   and ``examples/segmentation_example.py`` on the card.

7. multi-device (``segmentalist_torch/parallel``), ranks spawned by its
   launcher after the kernels are built: (a) one rank over NCCL, the
   exact and the per-shard mode, 8 sweeps of unigram_fixed each,
   identical to the unsharded run on the card; (b) two ranks sharing the
   card over gloo (CUDA tensors staged through host memory), the exact
   mode: Viterbi sweeps and the first sampling sweep agree with the
   unsharded run at the rounded batch (126) to ``AGREE_MIN``, 137
   sampling sweeps reach ``F1_MIN``; (c) two ranks, the per-shard mode on
   all seven paths (unigram_fixed 137 sweeps to ``F1_MIN``, the others
   4), after every sweep the statistics equal to their rebuild, the LM
   tables to the recount, the ranks' states identical, each path's
   kernels launched on each rank; (d) two ranks, the
   per-shard mode's corpus readers on unigram_fixed, bigram and
   kmeans_wordseg: ``gibbs_sample(2, monitor_i=0, validate=True)``
   (``segment`` for k-means) logs the same monitor lines on both ranks, a
   debug-only sweep of utterance 3 (not the bigram driver's: it has no
   such flag), then utterance 3's trace and every utterance's batch
   scores, the same on both ranks and within ``SCORE_TOL`` of an
   unsharded segmenter's on the card from the ranks' final state.

8. the exact-posterior oracles (``tests/torch_oracle.py``; the cases of
   ``tests/test_torch_exact_posterior*.py``,
   ``tests/test_torch_fbgmm_stationary.py`` and
   ``tests/test_torch_blocked_sweep_oracle.py``, whose CPU tests hold the
   plain versions to them) on the card, every draw through the kernels
   and the card's generator, at the CPU tests' trials and bounds: the
   unigram move of the fixed family at T 1, annealed (T 3) and Viterbi
   (K1, K2, K3), of the diag family sampled and Viterbi (K5 in its
   grouped and its exact composition, K2, K6), of the full family
   sampled and Viterbi (K8, K2, K9); the bigram move with fixed-variance,
   diag and full components (K1 / K5 / K8, K2, K4 / K7 / K9's bigram
   mode); the FBGMM's sequential stationary distribution in the three
   families (K10, K10's exact diag policy, K11) and its blocked sweep's
   exact product; each case's total variation within its bound and each
   of its kernels launched (:data:`P8_KERNELS`); the cases run in
   ``P8_WORKERS`` spawned processes side by side.

9. the papers' shapes end to end, at full width (1000 utterances, K 1000,
   ``batch_size=125``, the bench priors), each corpus built once and
   shared by its paths: ``unigram_fixed_long`` (``bench.py:414-441``:
   N_max 120, D 13, 359,813 candidate spans; 137 sweeps, K2 and K3
   launched, F1 >= 0.47) and nine paths on the bench corpus at D 130
   (the papers' embedding width): unigram_fixed, bigram, unigram_diag,
   bigram_diag, unigram_full and bigram_full for 73 sweeps, unigram_fixed
   and unigram_full with the one-by-one init and ``am_n_iter=1`` for 4
   (the statistics equal to their rebuild after the init and every
   sweep), kmeans_wordseg for 73 (its objective rising); each D 130 path's
   kernels launched in the forms D 130 selects (:data:`D130_FORMS`: K3 /
   K4 / K6 / K7 global, K9 stream in both modes, K10 at C 16, K11's CTA
   form with its tables in device memory; each wrapper counts its
   launches by form, ``cuda_lib.form_launches``), log_marg finite and F1
   risen by ``F1_RISE_MIN`` over sweep 0; then phase 4's card-vs-CPU block
   steps at D 130 with K 1000 (unigram fixed, bigram, both diag, both
   full, full Viterbi) and at N_max 120 (unigram fixed, bigram), and the
   FBGMM's sequential sweep at D 130 in the three families.

The script checks; it does not time (the benchmark, ``perfbench/``, is the
record of speed).  The sixth-to-last line is phase 9's JSON summary (each
path's sweeps, F1 at sweep 0 and at the end with its floor and the floor's
source, log_marg first and last, each kernel's launches and launches by
form, the candidate spans; the block steps' forms), the fifth-to-last
phase 8's (each case's total variation, bound, trials and launches; the
phase's processes), the fourth-to-last phase 7's, the third-to-last phase
6's, the second-to-last a JSON summary of the kernels (their errors
against the plain versions and plans; their launches by path include each
rank's of phase 7 and phase 9's paths; ``forms_by_path`` the forms phase
9's paths launched), the last line ``{"ok": true, "device": {...}}``.

To check some kernels alone (phases 1-3 of the named kernels, with their
kernels line and no result line):

    python3 chip_smoke.py --only K8,K9
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(B=125, N_max=20, W=6, K=1000, D=13)
LONG = dict(B=125, N_max=120, W=6, K=1000, D=130)
WIDE_DP = dict(B=125, N_max=120, W=120)  # K2 at W = N_max (n_slices_max 0)
# K10's chains: the flagship's initial state (its 6,149 initially assigned
# segments, the chain of an am_n_iter sweep), fbgmm_flagship's launch (its
# 51,972 spans), D 130, and the notebook toy
ITEMS = {"flagship": dict(N=6149, K=1000, D=13),
         "spans": dict(N=51972, K=1000, D=13),
         "long": dict(N=300, K=1000, D=130), "toy": dict(N=100, K=4, D=2)}
K10_SHAPES = {"flagship": ("toy", "flagship", "spans"), "long": ("long",)}
PURITY_MIN = 0.95       # the FBGMM toy (tests/test_fbgmm.py asks 0.95)
SCORE_TOL = 1e-4        # |kernel - plain| <= SCORE_TOL * max(1, |plain|)
MERGE_D = 130           # K12's width at both shapes (the benchmark's)
MERGE_RTOL = 1e-6       # K12 against the one-hot composition, of the
                        # table's largest value (cuBLAS sums in another order)
LP_TOL = 1e-6           # K2's log_prob: the plain version's card sum has no
                        # fixed order
AGREE_MIN = 0.999       # share of identical boundaries / assignments
KMEANS_OBJ_RTOL = 1e-5  # a k-means block's objective, card against CPU
                        # (float32 products and sums in another order)
F1_MIN = 0.67           # fixed-variance paths (JAX on a TPU: 0.696)
F1_MIN_DIAG = 0.72      # diag paths (JAX on a TPU: 0.750)
F1_MIN_FULL = 0.72      # full-covariance paths (JAX on a TPU: 0.751)
F1_MIN_KMEANS = 0.64    # segmental k-means (JAX on a TPU: 0.670)
DEVICE = "cuda"


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------- inputs

def leave_out_stats(rng, B, K, D, device):
    """Per-utterance leave-out counts / feature-major sums like a sweep's:
    ~40% empty slots, occupied slots centred on random prototypes."""
    import torch

    counts = rng.randint(1, 60, (B, K)) * (rng.rand(B, K) > 0.4)
    protos = rng.randn(K, D) * 3.0
    sum_x = counts[..., None] * protos[None] \
        + np.sqrt(np.maximum(counts, 1))[..., None] * rng.randn(B, K, D)
    return (torch.as_tensor(counts, dtype=torch.int32, device=device),
            torch.as_tensor(sum_x.transpose(0, 2, 1), dtype=torch.float32,
                            device=device).contiguous(), protos)


def score_inputs(shape, seed, device):
    import torch
    from segmentalist_torch.models import components_fixedvar as cfv
    from segmentalist_torch.models.fbgmm import log_weights
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, N_max, W, K, D = (shape[k] for k in ("B", "N_max", "W", "K", "D"))
    M = N_max * W
    counts, sum_xT, protos = leave_out_stats(rng, B, K, D, device)
    prior = bench_prior("fixed", D, device)
    Xc = protos[rng.randint(0, K, (B, M))] + 0.3 * rng.randn(B, M, D)
    Xc = torch.as_tensor(Xc, dtype=torch.float32, device=device)
    prior_c = cfv.log_prior_batch(prior, Xc)
    muT, precT = cfv.predictive_params_T(prior, counts, sum_xT)
    w = log_weights(counts, 1.0, K, 1.0, include_denominator=True,
                    dtype=torch.float32)
    lengths = rng.randint(2, N_max + 1, B)
    valid_m = torch.as_tensor(lengths * W, dtype=torch.int32, device=device)
    return Xc, prior_c, muT.contiguous(), precT.contiguous(), w, counts, \
        valid_m


def dp_inputs(shape, seed, device):
    """Candidate scores shaped like a sweep's: duration-scaled log marginals
    (~ -20 per slice), -inf for spans past the utterance start or end."""
    import torch

    rng = np.random.RandomState(seed)
    B, N, W = shape["B"], shape["N_max"], shape["W"]
    lengths = rng.randint(2, N + 1, B)
    dur = np.arange(1, W + 1)[None, None, :] * 10.0
    scores = (-2.0 + 0.5 * rng.randn(B, N, W)) * dur
    t = np.arange(N)[None, :, None]
    w = np.arange(W)[None, None, :]
    scores[(w > t) | (t >= lengths[:, None, None])] = -np.inf
    gumbel = -np.log(-np.log(rng.uniform(1e-30, 1.0, (B, N, W))))
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=device)
    return as_t(scores), as_t(lengths, torch.int32), as_t(gumbel)


def tied_dp_scores(shape, seed, device):
    """Integer-valued candidate scores, so windows tie exactly: the even
    utterances cost the same a slice in every window (every segmentation
    ties, the tie rule picks one-slice segments throughout), the odd ones
    take rounded random values; -inf past the utterance start or end."""
    import torch

    rng = np.random.RandomState(seed)
    B, N, W = shape["B"], shape["N_max"], shape["W"]
    lengths = rng.randint(2, N + 1, B)
    dur = np.arange(1, W + 1)[None, None, :]
    scores = np.round(rng.randn(B, N, W) * 2.0) - dur
    scores[::2] = np.round(rng.randn(B, 1, 1) * 2.0)[::2] * dur
    t = np.arange(N)[None, :, None]
    w = np.arange(W)[None, None, :]
    scores[(w > t) | (t >= lengths[:, None, None])] = -np.inf
    return (torch.as_tensor(scores, dtype=torch.float32, device=device),
            torch.as_tensor(lengths, dtype=torch.int32, device=device))


def chain_inputs(shape, seed, device):
    import torch
    from segmentalist_torch.models import components_fixedvar as cfv
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, S, K, D = shape["B"], shape["N_max"], shape["K"], shape["D"]
    counts, sum_xT, protos = leave_out_stats(rng, B, K, D, device)
    n_seg = rng.randint(1, S + 1, B)
    ok = np.arange(S)[None, :] < n_seg[:, None]
    embeds = np.where(ok, rng.randint(0, 10 ** 6, (B, S)), -1)
    Xe = protos[rng.randint(0, K, (B, S))] + 0.3 * rng.randn(B, S, D)
    Xe[rng.rand(B, S) < 0.1] = 5.0 * rng.randn(D)  # some far-off segments
    gumbel = -np.log(-np.log(rng.uniform(1e-30, 1.0, (B, S, K))))
    prior = bench_prior("fixed", D, device)
    Xe = torch.as_tensor(Xe, dtype=torch.float32, device=device)
    return (torch.as_tensor(embeds, dtype=torch.int32, device=device), Xe,
            cfv.log_prior_batch(prior, Xe),
            torch.as_tensor(gumbel, dtype=torch.float32, device=device),
            counts, sum_xT, prior)


def diag_leave_out_stats(rng, B, K, D, device):
    """K1's leave-out statistics with per-dimension sums of squares
    (members scattered around their mean with about unit variance); empty
    slots hold zero sums, as a sweep's do."""
    import torch

    counts, sum_xT, protos = leave_out_stats(rng, B, K, D, device)
    c = counts.cpu().numpy()[:, None, :].astype(np.float64)
    sx = sum_xT.cpu().numpy() * (c > 0)
    sq = sx * sx / np.maximum(c, 1) \
        + np.maximum(c - 1, 0) * (1.0 + 0.1 * np.abs(rng.randn(*sx.shape)))
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32, device=device).contiguous()
    return counts, as_t(sx), as_t(sq), protos


def diag_score_inputs(shape, seed, device):
    """K5's inputs: `cuda_score.diag_log_margs_T`'s arguments."""
    import torch
    from segmentalist_torch.models import components_diag as cdg
    from segmentalist_torch.models.fbgmm import log_weights
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, N_max, W, K, D = (shape[k] for k in ("B", "N_max", "W", "K", "D"))
    M = N_max * W
    counts, sum_xT, sum_sqT, protos = diag_leave_out_stats(rng, B, K, D,
                                                           device)
    prior = bench_prior("diag", D, device)
    Xc = protos[rng.randint(0, K, (B, M))] + 0.3 * rng.randn(B, M, D)
    Xc = torch.as_tensor(Xc, dtype=torch.float32, device=device)
    muT, inv_varT, lpv, v = cdg.predictive_params_T(prior, counts, sum_xT,
                                                    sum_sqT)
    w = log_weights(counts, 1.0, K, 1.0, include_denominator=True,
                    dtype=torch.float32)
    valid_m = torch.as_tensor(rng.randint(2, N_max + 1, B) * W,
                              dtype=torch.int32, device=device)
    return (Xc, cdg.log_prior_batch(prior, Xc), muT.contiguous(),
            inv_varT.contiguous(), lpv, v, w, counts, valid_m)


def diag_chain_inputs(shape, seed, device):
    """K6's inputs: `chain_inputs` with the diag statistics and prior."""
    import torch
    from segmentalist_torch.models import components_diag as cdg
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, S, K, D = shape["B"], shape["N_max"], shape["K"], shape["D"]
    counts, sum_xT, sum_sqT, protos = diag_leave_out_stats(rng, B, K, D,
                                                           device)
    n_seg = rng.randint(1, S + 1, B)
    ok = np.arange(S)[None, :] < n_seg[:, None]
    embeds = np.where(ok, rng.randint(0, 10 ** 6, (B, S)), -1)
    Xe = protos[rng.randint(0, K, (B, S))] + 0.3 * rng.randn(B, S, D)
    Xe[rng.rand(B, S) < 0.1] = 5.0 * rng.randn(D)  # some far-off segments
    gumbel = -np.log(-np.log(rng.uniform(1e-30, 1.0, (B, S, K))))
    prior = bench_prior("diag", D, device)
    Xe = torch.as_tensor(Xe, dtype=torch.float32, device=device)
    data = (torch.as_tensor(embeds, dtype=torch.int32, device=device), Xe,
            cdg.log_prior_batch(prior, Xe),
            torch.as_tensor(gumbel, dtype=torch.float32, device=device),
            counts, sum_xT, sum_sqT)
    return data, prior


def ks_agreement(kernel, name, ks_k, ks_p, embeds):
    """Log and check the share of identical ks of a chain kernel and its
    plain version; returns max |ks_k - ks_p|."""
    valid = embeds >= 0
    n_valid = int(valid.sum())
    n_same = int(((ks_k == ks_p) & valid).sum())
    check(bool((ks_k[~valid] == -1).all()), "%s %s: pads not -1"
          % (kernel, name))
    log("%s %s: identical ks %d/%d" % (kernel, name, n_same, n_valid))
    check(n_same >= AGREE_MIN * n_valid, "%s %s: ks agreement %d/%d"
          % (kernel, name, n_same, n_valid))
    return float((ks_k - ks_p).abs().max())


# ------------------------------------------------------------- phase 3

def score_plan(shape):
    """K1 / K5's launch plan at this shape, as a string."""
    from segmentalist_torch.ops import cuda_score

    plan = cuda_score.card_plan(shape["D"], shape["K"],
                                shape["N_max"] * shape["W"])
    return "%d rows x %d tiles" % (plan.rows, plan.tiles)


def compare_score(shape, name):
    import torch
    from segmentalist_torch.ops import cuda_score

    args = score_inputs(shape, 1, DEVICE)
    got = cuda_score.fixedvar_log_margs_T(*args)
    ref = cuda_score.fixedvar_scores_plain(*args)
    sync()
    fin = torch.isfinite(ref)
    check(bool((torch.isfinite(got) == fin).all()),
          "K1 %s: -inf pattern differs from the plain version" % name)
    err = (got - ref).abs()[fin]
    rel = (err / ref.abs()[fin].clamp_min(1.0)).max().item()
    max_abs = err.max().item()
    check(rel <= SCORE_TOL, "K1 %s: relative error %.3g > %g"
          % (name, rel, SCORE_TOL))
    out = dict(max_abs_err=max_abs, plan=score_plan(shape))
    log("K1 fixedvar_scores %s: plan %s, max|d|=%.3g max rel=%.3g" % (
        name, out["plan"], max_abs, rel))
    return out


def compare_dp(shape, name):
    """K2 at one shape: the fused kernel (the whole DP in one launch)
    against its plain version, the composition ``dp.segment_dp_plain``, in
    both modes on shared noise: identical alphas and boundaries, log_prob
    to ``LP_TOL``; Viterbi on tied scores breaks ties toward shorter
    segments, as the plain version does."""
    import torch
    from segmentalist_torch.ops import cuda_dp, dp

    scores, lengths, noise = dp_inputs(shape, 2, DEVICE)
    B = scores.shape[0]
    lpc = torch.full((), math.log(0.9), device=DEVICE)
    out = {"max_abs_err": 0.0}
    for use_max in (False, True):
        nz = None if use_max else noise
        lp_k, b_k, a_k = cuda_dp.segment_dp(scores, lengths, lpc, 1.0, 0,
                                            use_max, nz, with_alphas=True)
        lp_p, b_p, a_p = dp.segment_dp_plain(scores, lengths, lpc, 1.0, 0,
                                             use_max, nz, with_alphas=True)
        sync()
        err = (lp_k - lp_p).abs()
        rel = (err / lp_p.abs().clamp_min(1.0)).max().item()
        same_a = torch.equal(a_k, a_p)
        log("K2 segment_dp %s use_max=%s: alphas identical %s, identical "
            "boundary rows %d/%d, log_prob max|d|=%.3g max rel=%.3g" % (
                name, use_max, same_a,
                int((b_k == b_p).all(1).sum()), B, err.max().item(), rel))
        check(same_a, "K2 %s: alphas differ from the plain version" % name)
        check(torch.equal(b_k, b_p), "K2 %s: boundaries differ from the "
              "plain version" % name)
        check(rel <= LP_TOL, "K2 %s: log_prob relative error %.3g"
              % (name, rel))
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
    t_scores, t_lengths = tied_dp_scores(shape, 3, DEVICE)
    lp_k, b_k, a_k = cuda_dp.segment_dp(t_scores, t_lengths, lpc, 1.0, 0,
                                        True, None, with_alphas=True)
    lp_p, b_p, a_p = dp.segment_dp_plain(t_scores, t_lengths, lpc, 1.0, 0,
                                         True, None, with_alphas=True)
    sync()
    err = (lp_k - lp_p).abs().max().item()
    one_slice = bool(b_k[::2].sum(1).eq(t_lengths[::2]).all())
    log("K2 segment_dp %s Viterbi on tied scores: alphas identical %s, "
        "identical boundary rows %d/%d, log_prob max|d|=%.3g, the tied "
        "utterances all in one-slice segments %s" % (
            name, torch.equal(a_k, a_p), int((b_k == b_p).all(1).sum()), B,
            err, one_slice))
    check(torch.equal(a_k, a_p) and torch.equal(b_k, b_p) and err == 0.0,
          "K2 %s: Viterbi on tied scores differs from the plain version"
          % name)
    check(one_slice, "K2 %s: ties did not break toward shorter segments"
          % name)
    return out


def compare_chain(shape, name):
    import torch
    from segmentalist_torch.ops import cuda_chain

    embeds, Xe, lpe, gumbel, counts, sum_xT, prior = chain_inputs(
        shape, 3, DEVICE)
    K = shape["K"]
    prec = 1.0 / prior.var
    prec0 = 1.0 / prior.var_0
    data = (embeds, Xe, lpe, gumbel, counts, sum_xT)

    def kernel(use_argmax=False):
        return cuda_chain.fixedvar_chain(
            *data, prior.var, prior.var_0, prior.mu_0, 0.8, alpha=1.0, K=K,
            use_argmax=use_argmax)

    def plain(use_argmax=False):
        return cuda_chain.fixedvar_chain_plain(
            *data, prec, prec0, prec0 * prior.mu_0, 0.8, 1.0, K, 1.0,
            use_argmax)

    out = {"max_abs_err": 0.0}
    for use_argmax in (False, True):
        ks_k, ks_p = kernel(use_argmax), plain(use_argmax)
        sync()
        out["max_abs_err"] = max(out["max_abs_err"], ks_agreement(
            "K3 fixedvar_chain use_argmax=%s" % use_argmax, name, ks_k, ks_p,
            embeds))
    plan = cuda_chain.card_plan(shape["D"], K, shape["N_max"], False)
    out.update(chain_plan("K3 fixedvar_chain", name, plan, embeds))
    return out


def bigram_chain_inputs(shape, seed, device):
    """K3's inputs plus the LM's: leave-out unigram counts equal to the
    acoustic ones (as in the segmenter); as each utterance's old transcript,
    K3's argmax chain on the same segments, so that K4's draws often follow
    an old pair and its correction is exercised; and a sparse global table
    that counts every old pair of every utterance."""
    from segmentalist_torch.ops import cuda_chain

    embeds, Xe, lpe, gumbel, counts, sum_xT, prior = chain_inputs(
        shape, seed, device)
    K = shape["K"]
    old = cuda_chain.fixedvar_chain(
        embeds, Xe, lpe, gumbel, counts, sum_xT, prior.var, prior.var_0,
        prior.mu_0, 1.0, alpha=1.0, K=K, use_argmax=True)
    lm = (counts, *old_pair_table(old, K, seed + 100, device))
    return (embeds, Xe, lpe, gumbel, counts, sum_xT), lm, prior


def old_pair_table(old, K, seed, device):
    """(big [K, K] int32, corr_j, corr_i): the old transcripts' pairs and
    a sparse global bigram table that counts every one of them."""
    import torch
    from segmentalist_torch.models.bigram_lm import transcript_pairs_batch

    pj, pi = transcript_pairs_batch(old)
    rng = np.random.RandomState(seed)
    big = (rng.rand(K, K) < 0.003) * rng.randint(1, 5, (K, K))
    ok = (pj >= 0).cpu().numpy()
    np.add.at(big, (pj.cpu().numpy()[ok], pi.cpu().numpy()[ok]), 1)
    return torch.as_tensor(big, dtype=torch.int32, device=device), pj, pi


def compare_bigram_chain(shape, name):
    import torch
    from segmentalist_torch.ops import cuda_chain

    data, lm, prior = bigram_chain_inputs(shape, 4, DEVICE)
    K = shape["K"]
    consts = cuda_chain.bigram_constants(1.0, 1.0, 0.1, K)
    prec = 1.0 / prior.var
    prec0 = 1.0 / prior.var_0

    ks_k = cuda_chain.bigram_fixedvar_chain(
        *data, prior.var, prior.var_0, prior.mu_0, 0.8, *lm, alpha_a=1.0,
        intrp_lambda=0.1, b_smooth=1.0, K=K)
    ks_p = cuda_chain.bigram_fixedvar_chain_plain(
        *data, prec, prec0, prec0 * prior.mu_0, 0.8, *lm, consts, K, 1.0)
    # the same chains with the own old pairs kept in the table: how many
    # draws the correction changes (a sign that it is exercised)
    ks_keep = cuda_chain.bigram_fixedvar_chain(
        *data, prior.var, prior.var_0, prior.mu_0, 0.8, lm[0], lm[1],
        torch.full_like(lm[2], -1), lm[3], alpha_a=1.0, intrp_lambda=0.1,
        b_smooth=1.0, K=K)
    sync()
    log("K4 bigram_fixedvar_chain %s: without the own-pair correction %d ks "
        "would differ" % (name, int((ks_keep != ks_k).sum())))
    out = {"max_abs_err": ks_agreement("K4 bigram_fixedvar_chain", name,
                                       ks_k, ks_p, data[0])}
    plan = cuda_chain.card_plan(shape["D"], K, shape["N_max"], True)
    out.update(chain_plan("K4 bigram_fixedvar_chain", name, plan, data[0]))
    return out


def compare_diag_score(shape, name):
    """K5 in both compositions (grouped for FFBS, exact for Viterbi)."""
    import torch
    from segmentalist_torch.ops import cuda_score

    args = diag_score_inputs(shape, 5, DEVICE)
    out = {"max_abs_err": 0.0, "plan": score_plan(shape)}
    for exact in (False, True):
        label = "K5 diag_scores %s exact=%s" % (name, exact)
        got = cuda_score.diag_log_margs_T(*args, exact=exact)
        ref = cuda_score.diag_scores_plain(*args, exact=exact)
        sync()
        fin = torch.isfinite(ref)
        check(bool((torch.isfinite(got) == fin).all()),
              "%s: -inf pattern differs from the plain version" % label)
        err = (got - ref).abs()[fin]
        rel = (err / ref.abs()[fin].clamp_min(1.0)).max().item()
        check(rel <= SCORE_TOL, "%s: relative error %.3g > %g"
              % (label, rel, SCORE_TOL))
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        log("%s: max|d|=%.3g max rel=%.3g" % (label, err.max().item(), rel))
    log("K5 diag_scores %s: plan %s" % (name, out["plan"]))
    return out


def chain_steps(embeds):
    """Per utterance the chain's step count (one past its last segment)."""
    import torch

    S = embeds.shape[1]
    steps = torch.arange(1, S + 1, device=embeds.device)
    return torch.where(embeds >= 0, steps, 0).amax(1)


def chain_plan(kernel, name, plan, embeds):
    """A chain's (K3 / K4, K6 / K7) launch plan and each chain's longest
    step count."""
    out = {"form": plan.form, "steps_max": int(chain_steps(embeds).max())}
    log("%s %s: plan %s, longest chain %d steps" % (kernel, name, plan,
                                                   out["steps_max"]))
    return out


def compare_diag_chain(shape, name):
    """K6 in sample and argmax mode."""
    from segmentalist_torch.ops import cuda_diag_chain as cdc

    data, prior = diag_chain_inputs(shape, 6, DEVICE)
    K = shape["K"]
    k0, v0 = float(prior.k_0), float(prior.v_0)
    k0m0, snp0, _ = cdc.prior_terms(prior.m_0, k0, prior.S_0)

    def kernel(use_argmax=False):
        return cdc.diag_chain(*data, prior.m_0, k0, v0, prior.S_0, 0.8,
                              alpha=1.0, K=K, use_argmax=use_argmax)

    def plain(use_argmax=False):
        return cdc.diag_chain_plain(*data, k0m0, snp0, k0, v0, 0.8, 1.0, K,
                                    1.0, use_argmax)

    out = {"max_abs_err": 0.0}
    for use_argmax in (False, True):
        ks_k, ks_p = kernel(use_argmax), plain(use_argmax)
        sync()
        out["max_abs_err"] = max(out["max_abs_err"], ks_agreement(
            "K6 diag_chain use_argmax=%s" % use_argmax, name, ks_k, ks_p,
            data[0]))
    plan = cdc.card_plan(shape["D"], K, shape["N_max"], False)
    out.update(chain_plan("K6 diag_chain", name, plan, data[0]))
    return out


def compare_bigram_diag_chain(shape, name):
    """K7, with LM tables built as `bigram_chain_inputs` builds them: the
    old transcripts are K6's argmax chains on the same segments
    (`old_pair_table`)."""
    import torch
    from segmentalist_torch.ops import cuda_chain
    from segmentalist_torch.ops import cuda_diag_chain as cdc

    data, prior = diag_chain_inputs(shape, 7, DEVICE)
    K = shape["K"]
    k0, v0 = float(prior.k_0), float(prior.v_0)
    k0m0, snp0, _ = cdc.prior_terms(prior.m_0, k0, prior.S_0)
    old = cdc.diag_chain(*data, prior.m_0, k0, v0, prior.S_0, 1.0,
                         alpha=1.0, K=K, use_argmax=True)
    big, pj, pi = old_pair_table(old, K, 107, DEVICE)
    counts = data[4]
    consts = cuda_chain.bigram_constants(1.0, 1.0, 0.1, K)

    def kernel(corr_j=pj):
        return cdc.bigram_diag_chain(
            *data, prior.m_0, k0, v0, prior.S_0, 0.8, counts, big, corr_j,
            pi, alpha_a=1.0, intrp_lambda=0.1, b_smooth=1.0, K=K)

    ks_k = kernel()
    ks_p = cdc.bigram_diag_chain_plain(
        *data, k0m0, snp0, k0, v0, 0.8, counts, big, pj, pi, consts, K, 1.0)
    ks_keep = kernel(torch.full_like(pj, -1))  # own old pairs kept
    sync()
    log("K7 bigram_diag_chain %s: without the own-pair correction %d ks "
        "would differ" % (name, int((ks_keep != ks_k).sum())))
    out = {"max_abs_err": ks_agreement("K7 bigram_diag_chain", name, ks_k,
                                       ks_p, data[0])}
    plan = cdc.card_plan(shape["D"], K, shape["N_max"], True)
    out.update(chain_plan("K7 bigram_diag_chain", name, plan, data[0]))
    return out


def fullcov_block(shape, seed, device):
    """A full-covariance block like a sweep's: a corpus of member vectors
    around K prototypes (~40% of the slots empty), its global statistics,
    and per utterance 1..N_max old segments drawn from the members (the
    touched leave-outs), the K8 / K9 inputs the block step forms from them,
    candidates and new segments near random prototypes (10% of the new
    ones far off)."""
    import torch
    from segmentalist_torch.models import components_full as cf
    from segmentalist_torch.models.fbgmm import log_weights
    from segmentalist_torch.ops.stats import suff_stats_from_assignments
    from segmentalist_torch.segmenters.common import counts_contrib
    from segmentalist_torch.segmenters import fullcov
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, N_max, W, K, D = (shape[k] for k in ("B", "N_max", "W", "K", "D"))
    M, S = N_max * W, N_max
    protos = rng.randn(K, D) * 3.0
    sizes = rng.randint(1, 60, K) * (rng.rand(K) > 0.4)
    assign = np.repeat(np.arange(K), sizes)
    X = protos[assign] + 0.5 * rng.randn(assign.size, D)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=device)
    X, assign_t = as_t(X), as_t(assign, torch.int32)
    prior = bench_prior("full", D, device)
    stats = suff_stats_from_assignments(X, assign_t, K, full_cov=True)
    n_old = rng.randint(1, S + 1, B)
    old = np.full((B, S), -1)
    for b in range(B):
        old[b, :n_old[b]] = rng.choice(assign.size, n_old[b], replace=False)
    old_embeds = as_t(old, torch.int32)
    old_ks = torch.where(old_embeds >= 0,
                         assign_t[old_embeds.clamp_min(0).long()], -1)
    lo_counts = stats.counts[None] - counts_contrib(old_ks, old_embeds >= 0,
                                                    K)
    params_g = cf.predictive_params(prior, stats)
    touched = fullcov.touched_leave_out(prior, stats, X, old_embeds, old_ks)
    Xc = as_t(protos[rng.randint(0, K, (B, M))] + 0.3 * rng.randn(B, M, D))
    valid_m = as_t(rng.randint(2, N_max + 1, B) * W, torch.int32)
    score = (Xc, cf.log_prior_batch(prior, Xc),
             *fullcov.fullcov_score_inputs(params_g, touched),
             log_weights(lo_counts, 1.0, K, 1.0, include_denominator=True,
                         dtype=torch.float32), lo_counts, valid_m)
    n_seg = rng.randint(1, S + 1, B)
    ok = np.arange(S)[None, :] < n_seg[:, None]
    embeds = np.where(ok, rng.randint(0, 10 ** 6, (B, S)), -1)
    Xe = protos[rng.randint(0, K, (B, S))] + 0.3 * rng.randn(B, S, D)
    Xe[rng.rand(B, S) < 0.1] = 5.0 * rng.randn(D)  # some far-off segments
    Xe = as_t(Xe)
    base = cf.log_post_pred_batch(params_g, Xe.reshape(B * S, D)).reshape(
        B, S, K)
    gumbel = as_t(-np.log(-np.log(rng.uniform(1e-30, 1.0, (B, S, K)))))
    chain = (as_t(embeds, torch.int32), Xe, cf.log_prior_batch(prior, Xe),
             gumbel, base, lo_counts,
             *fullcov.chain_inputs(prior, params_g, stats.counts, touched),
             float(prior.k_0), float(prior.v_0))
    return dict(score=score, chain=chain, params_g=params_g,
                touched=touched)


def expanded_form32(args, params_g, touched):
    """K8's function through the reference's expanded Mahalanobis form,
    x^T A x - 2 x . A mu + mu . A mu, in float32: the XLA composition
    `log_post_pred_batch` + `corrected_candidate_post`, for the measurement
    of that form's rounding."""
    import torch
    from segmentalist_torch.models import components_full as cf
    from segmentalist_torch.ops.random import NEG_INF, logsumexp
    from segmentalist_torch.segmenters import fullcov

    Xc, prior_c, _, _, _, w, counts, valid_m = args
    B, M, D = Xc.shape
    post = cf.log_post_pred_batch(params_g, Xc.reshape(B * M, D))
    post = fullcov.corrected_candidate_post(post.reshape(B, M, -1), Xc,
                                            touched, w.shape[1])
    logits = w[:, None] + torch.where((counts > 0)[:, None], post,
                                      prior_c[..., None])
    live = torch.arange(M, device=Xc.device)[None, :] < valid_m[:, None]
    return torch.where(live, logsumexp(logits, dim=-1), NEG_INF)


def rel_err(got, ref, what):
    """Max |got - ref| / max(1, |ref|) over ref's finite entries, which must
    be got's; and max |got - ref|."""
    import torch

    fin = torch.isfinite(ref)
    check(bool((torch.isfinite(got) == fin).all()),
          "%s: -inf pattern differs" % what)
    err = (got.double() - ref.double()).abs()[fin]
    return ((err / ref.double().abs()[fin].clamp_min(1.0)).max().item(),
            err.max().item())


def compare_fullcov_score(shape, name):
    """K8 against its plain version, and against float64 (every input
    widened) beside the reference's expanded form in float32."""
    import torch
    from segmentalist_torch.ops import cuda_fullcov_score as cfs

    blk = fullcov_block(shape, 8, DEVICE)
    args = blk["score"]
    got = cfs.fullcov_log_margs(*args[:-1], valid_m=args[-1])
    ref = cfs.fullcov_scores_plain(*args[:-1], valid_m=args[-1])
    sync()
    rel, max_abs = rel_err(got, ref, "K8 %s" % name)
    check(rel <= SCORE_TOL, "K8 %s: relative error %.3g > %g"
          % (name, rel, SCORE_TOL))
    out = {"max_abs_err": max_abs}
    f64 = lambda a: (a.double() if torch.is_tensor(a)  # noqa: E731
                     and a.is_floating_point() else a)
    a64 = [tuple(f64(x) for x in a) if isinstance(a, tuple) else f64(a)
           for a in args]
    ref64 = cfs.fullcov_scores_plain(*a64[:-1], valid_m=a64[-1])
    del a64
    expanded = expanded_form32(args, blk["params_g"], blk["touched"])
    out["f64_rel_err"] = rel_err(got, ref64, "K8 vs f64")[0]
    out["expanded32_rel_err"] = rel_err(expanded, ref64, "f32 vs f64")[0]
    del expanded
    log("K8 %s against float64: kernel (whitened form, float32) max rel "
        "%.3g; float32 expanded form %.3g" % (
            name, out["f64_rel_err"], out["expanded32_rel_err"]))
    Xc = args[0]
    plan = cfs.card_plan(Xc.shape[-1], args[4].shape[-1], Xc.shape[1])
    out["plan"] = "%d rows x %d tiles" % (plan.rows, plan.tiles)
    log("K8 fullcov_scores %s: plan %s, max|d|=%.3g max rel=%.3g" % (
        name, plan, max_abs, rel))
    return out


def compare_fullcov_chain(shape, name):
    """K9 in sample and argmax mode and in its bigram mode (LM tables as
    `bigram_chain_inputs` builds them: the old transcripts are K9's argmax
    chains on the same segments), against its plain versions."""
    import torch
    from segmentalist_torch.ops import cuda_chain
    from segmentalist_torch.ops import cuda_fullcov_chain as cfc

    data = fullcov_block(shape, 9, DEVICE)["chain"]
    K = shape["K"]
    embeds = data[0]
    temp = 0.8

    def kernel(use_argmax=False):
        return cfc.fullcov_chain(*data, temp, alpha=1.0, K=K,
                                 use_argmax=use_argmax)

    def plain(use_argmax=False):
        return cfc.fullcov_chain_plain(*data, temp, 1.0, K, 1.0, use_argmax)

    out = {"max_abs_err": 0.0}
    for use_argmax in (False, True):
        ks_k, ks_p = kernel(use_argmax), plain(use_argmax)
        sync()
        out["max_abs_err"] = max(out["max_abs_err"], ks_agreement(
            "K9 fullcov_chain use_argmax=%s" % use_argmax, name, ks_k, ks_p,
            embeds))
    counts = data[5]
    big, pj, pi = old_pair_table(kernel(True), K, 109, DEVICE)
    consts = cuda_chain.bigram_constants(1.0, 1.0, 0.1, K)

    def kernel_bigram(corr_j=pj):
        return cfc.bigram_fullcov_chain(
            *data, temp, counts, big, corr_j, pi, alpha_a=1.0,
            intrp_lambda=0.1, b_smooth=1.0, K=K)

    ks_k = kernel_bigram()
    ks_p = cfc.bigram_fullcov_chain_plain(*data, temp, counts, big, pj, pi,
                                          consts, K, 1.0)
    ks_keep = kernel_bigram(torch.full_like(pj, -1))  # own old pairs kept
    sync()
    log("K9 bigram_fullcov_chain %s: without the own-pair correction %d ks "
        "would differ" % (name, int((ks_keep != ks_k).sum())))
    out["max_abs_err"] = max(out["max_abs_err"], ks_agreement(
        "K9 bigram_fullcov_chain", name, ks_k, ks_p, embeds))
    plan = cfc.card_plan(shape["D"], K, shape["N_max"], data[9].shape[1],
                         False)
    out["plan"] = "%s, %d threads, %d ring buffers" % (
        plan.form, plan.threads, plan.ring)
    log("K9 fullcov_chain %s: plan %s" % (name, plan))
    return out


def crafted_fullcov_own_pairs():
    """K9's bigram mode where the own-pair correction decides the draws:
    flat acoustics (one shared x, untouched components of equal global
    factors), each utterance's old transcript alternating (j_b, i_b), a
    table of exactly those pairs and unigram counts that push the first
    draw onto j_b.  The kernel equals its plain version, which differs from
    chains that keep the own pairs."""
    import torch
    from segmentalist_torch.ops import cuda_chain
    from segmentalist_torch.ops import cuda_fullcov_chain as cfc
    from segmentalist_torch.models.bigram_lm import transcript_pairs_batch

    B, S, D, K = 64, 12, 13, 200
    j_b, i_b = np.arange(B) % K, (np.arange(B) + 3) % K
    old = np.where(np.arange(S)[None, :] % 2 == 0, j_b[:, None],
                   i_b[:, None]).astype(np.int32)
    pj, pi = transcript_pairs_batch(torch.as_tensor(old, device=DEVICE))
    big = np.zeros((K, K), np.int32)
    ok = (pj >= 0).cpu().numpy()
    np.add.at(big, (pj.cpu().numpy()[ok], pi.cpu().numpy()[ok]), 1)
    uni = np.ones((B, K), np.int32)
    uni[np.arange(B), j_b] = 50
    f32, i32 = torch.float32, torch.int32
    z = lambda *s: torch.zeros(s, dtype=f32, device=DEVICE)  # noqa: E731
    eye = torch.eye(D, device=DEVICE)
    rng = np.random.RandomState(8)
    data = (torch.arange(B * S, dtype=i32, device=DEVICE).reshape(B, S),
            z(B, S, D), z(B, S),
            torch.as_tensor(-np.log(-np.log(rng.uniform(1e-30, 1, (B, S, K)))),
                            dtype=f32, device=DEVICE),
            z(B, S, K), torch.ones((B, K), dtype=i32, device=DEVICE),
            z(B, 1, D), eye.expand(B, 1, D, D).contiguous(), z(B, 1),
            torch.full((B, 1), -1, dtype=i32, device=DEVICE), z(K, D),
            eye.expand(K, D, D).contiguous(), z(K), 0.05, 16.0)
    lm = [torch.as_tensor(uni, device=DEVICE),
          torch.as_tensor(big, device=DEVICE)]
    consts = cuda_chain.bigram_constants(1.0, 1.0, 0.0, K)

    def run(corr_j):
        return cfc.bigram_fullcov_chain(*data, 1.0, *lm, corr_j, pi,
                                        alpha_a=1.0, intrp_lambda=0.0,
                                        b_smooth=1.0, K=K, lms=2.0)

    got = run(pj)
    want = cfc.bigram_fullcov_chain_plain(*data, 1.0, *lm, pj, pi, consts, K,
                                          2.0)
    keep = run(torch.full_like(pj, -1))
    sync()
    n_diff = int((keep != got).sum())
    log("K9 crafted own-pair case: identical ks %s, own-pair correction "
        "changes %d of %d draws" % (bool(torch.equal(got, want)), n_diff,
                                     B * S))
    check(torch.equal(got, want), "K9 crafted own-pair case: kernel and "
          "plain version disagree")
    check(n_diff > 0, "K9 crafted own-pair case: the correction decides "
          "no draw")


def item_arrays(shape, seed):
    """The numpy draws of :func:`item_inputs`: (X [N, D], old columns [N],
    noise [N, K])."""
    rng = np.random.RandomState(seed)
    N, K, D = shape["N"], shape["K"], shape["D"]
    protos = 3.0 * rng.randn(50, D)
    X = protos[rng.randint(0, 50, N)] + 0.3 * rng.randn(N, D)
    k_old = rng.randint(0, K, N)
    return X, k_old, -np.log(-np.log(rng.uniform(1e-30, 1.0, (N, K))))


def item_inputs(family, shape, seed, device):
    """K10's (K11's, family "full") inputs at ``shape`` (N, K, D): N items
    around 50 prototypes, each in a uniformly drawn old column (the "rand"
    init's state), the model's statistics from those columns, prior
    densities and noise."""
    import torch
    from segmentalist_torch.models import cov_module
    from segmentalist_torch.ops.stats import suff_stats_from_assignments
    from segmentalist_torch.utils.profiling import bench_prior

    X, k_old, noise = item_arrays(shape, seed)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=device)
    X = as_t(X)
    k_old = as_t(k_old, torch.int32)
    K = shape["K"]
    prior = bench_prior(family, shape["D"], device)
    return dict(X=X, log_prior=cov_module(family).log_prior_batch(prior, X),
                noise=as_t(noise), k_old=k_old,
                stats=suff_stats_from_assignments(
                    X, k_old, K, full_cov=family == "full"),
                prior=prior, K=K)


def _plain_item_job(family, shape, seed, inputs):
    """K10's plain version on the CPU, in a worker process, on the card's
    inputs (:func:`item_chain_inputs` there, as numpy; the noise, too large
    to ship, drawn again from ``seed``, the same float32 bits): its ks,
    counts and sums as numpy."""
    import torch
    from segmentalist_torch.ops import cuda_item_chain as cic

    torch.set_num_threads(1)
    noise = torch.as_tensor(item_arrays(shape, seed)[2], dtype=torch.float32)
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in inputs]
    args[3] = noise[None]
    args[8] = tuple(torch.as_tensor(t) if isinstance(t, np.ndarray) else t
                    for t in args[8])
    return [t.numpy() for t in cic.item_chain_plain(*args)]


def plain_item_pool(jobs):
    """K10's plain results for ``jobs``, {key: (family, shape, seed, the
    card's kernel inputs)}, on the CPU in worker processes (one a core, at
    most eight), all submitted at once: {key: future}.  The caller shuts
    the pool down."""
    import concurrent.futures
    import multiprocessing
    import torch

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.cpu().numpy()
        if isinstance(a, tuple):
            return tuple(host(t) for t in a)
        return a

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    futures = {}
    for key, (family, shape, seed, inputs) in jobs.items():
        sent = [host(a) for a in inputs]
        sent[3] = None  # the noise: drawn again in the worker
        futures[key] = pool.submit(_plain_item_job, family, shape, seed, sent)
    return pool, futures


def full_item_pair(d, delete=True, n=None):
    """(kernel, plain) callables of K11 on ``d`` (its first ``n`` items);
    each returns (ks, final stats)."""
    import torch
    from segmentalist_torch.ops import cuda_item_chain as cic

    n = d["X"].shape[0] if n is None else n
    k_old = d["k_old"][:n] if delete else torch.full_like(d["k_old"][:n],
                                                          -1)
    args = (d["X"][:n], d["log_prior"][:n], d["noise"][:n], k_old,
            d["stats"], d["prior"], 1.0, d["K"], 1.0, 1.0)

    def kernel():
        return cic.item_chain("full", *args)

    def plain():
        return cic.full_chain_plain(*cic.full_chain_inputs(*args))

    return kernel, plain


def same_items(what, got, want):
    """Check a K10 / K11 kernel result against its plain version:
    identical ks, counts and running sums; returns the largest absolute
    difference."""
    import torch

    (ks_k, st_k), (ks_p, st_p) = got, want
    n_same = int((ks_k == ks_p).sum())
    same_stats = all(torch.equal(a, b) for a, b in zip(st_k, st_p))
    log("%s: identical ks %d/%d, identical counts and sums %s"
        % (what, n_same, ks_p.numel(), same_stats))
    check(n_same == ks_p.numel() and same_stats,
          "%s: the kernel and its plain version disagree" % what)
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(st_k, st_p))


def compare_item_chain(shape, name):
    """K10 at the shapes of ``K10_SHAPES[name]`` (with the flagship: the
    toy, the flagship's 6,149 items and fbgmm_flagship's 51,972-item
    launch; with the long shape: D 130), both families, the delete on and
    off, at every cluster size the card schedules (1 to 16 CTAs, at most
    K): the kernel's ks, counts and sums identical to its plain version's
    (run once a case on the CPU, in worker processes, from the card's
    inputs).  At the flagship and long shapes its plan and the cluster
    sizes held."""
    import torch
    from segmentalist_torch.ops import cuda_item_chain as cic

    out = {"max_abs_err": 0.0}
    data, jobs = {}, {}
    for nm in K10_SHAPES[name]:
        for family in ("fixed", "diag"):
            d = data[nm, family] = item_inputs(family, ITEMS[nm], 10, DEVICE)
            for delete in (True, False):
                k_old = (d["k_old"] if delete
                         else torch.full_like(d["k_old"], -1))
                jobs[nm, family, delete] = (family, ITEMS[nm], 10,
                                            cic.item_chain_inputs(
                                                family, d["X"],
                                                d["log_prior"], d["noise"],
                                                k_old, d["stats"],
                                                d["prior"], 1.0, d["K"]))
    pool, futures = plain_item_pool(jobs)
    try:
        kernel_at = {}
        for (nm, family, delete), job in jobs.items():
            _, max_cluster = cic.item_card_limits(
                family, torch.cuda.current_device())
            K = ITEMS[nm]["K"]
            for C in cic.ITEM_CLUSTERS:
                if C <= min(K, max_cluster):
                    kernel_at[nm, family, delete, C] = [
                        t.cpu() for t in cic._launch(*job[3], cluster=C)]
        sizes = {}
        for key, fut in futures.items():
            want = cic.item_chain_result(*(torch.as_tensor(a)
                                           for a in fut.result()))
            cs = [C for (n2, f2, d2, C) in kernel_at if (n2, f2, d2) == key]
            for C in cs:
                got = cic.item_chain_result(*kernel_at[key + (C,)])
                err = same_items("K10 %s %s delete=%s at a cluster of %d"
                                 % (key[1], key[0], key[2], C), got, want)
                out["max_abs_err"] = max(out["max_abs_err"], err)
            sizes[key] = cs
    finally:
        pool.shutdown()
    for family in ("fixed", "diag"):
        d = data[name, family]
        N, D = d["X"].shape
        plan = cic.card_plan(family, D, d["K"])
        r = {"form": plan.tables, "plan": plan._asdict(), "steps_max": N,
             "clusters": sizes[name, family, True]}
        log("K10 %s %s: plan %s, %d steps, held at clusters %s"
            % (family, name, plan, N, r["clusters"]))
        pre = "" if family == "fixed" else "diag_"
        out.update({pre + k: v for k, v in r.items()})
    return out


FULL_PLAIN_ITEMS = {"toy": None, "flagship": None, "long": 60}


def compare_full_item_chain(shape, name):
    """K11 at ``ITEMS[name]`` (the toy too, with the flagship): the kernel
    against its plain version on the card, delete on and off (at D 130 on
    the first ``FULL_PLAIN_ITEMS["long"]`` items: the plain version's D
    vector steps a factorisation are slow there); at the flagship, with
    the delete on, also at every cluster size the card schedules, each
    held to the same plain result, with its plan; at the flagship and long
    shapes the plan (C, threads, form, where the tables and work area
    live, shared bytes a CTA)."""
    import torch
    from segmentalist_torch.ops import cuda_item_chain as cic

    out = {"max_abs_err": 0.0}
    names = [name] + (["toy"] if name == "flagship" else [])
    for nm in names:
        d = item_inputs("full", ITEMS[nm], 10, DEVICE)
        n = FULL_PLAIN_ITEMS[nm]
        N, D = d["X"].shape
        for delete in (True, False):
            kernel, plain = full_item_pair(d, delete, n)
            want = plain()
            err = same_items("K11 %s delete=%s%s" % (
                nm, delete, "" if n is None else " (first %d items)" % n),
                kernel(), want)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if nm != "flagship" or not delete:
                continue
            _, max_cluster = cic.full_card_limits(torch.cuda.current_device())
            by_c = {}
            for C in cic.FULL_CLUSTERS:
                if C > min(max_cluster, d["K"]):
                    continue
                args = cic.full_chain_inputs(
                    d["X"], d["log_prior"], d["noise"], d["k_old"],
                    d["stats"], d["prior"], 1.0, d["K"])

                def forced(args=args, C=C):
                    return cic._launch_full(*args, cluster=C)

                err = same_items("K11 flagship at a cluster of %d" % C,
                                 forced(), want)
                out["max_abs_err"] = max(out["max_abs_err"], err)
                by_c[C] = cic.card_plan("full", D, d["K"], C)._asdict()
            out["clusters"] = by_c
        if nm != name:
            continue
        plan = cic.card_plan("full", D, d["K"])
        log("K11 %s: plan %s, %d steps" % (name, plan, N))
        out.update(form=plan.form, plan=plan._asdict(), steps_max=N)
    return out


# ------------------------------------------------------------- phase 4

def compare_merge(shape, name):
    """K12 at ``MERGE_D`` with the shape's B, K and N_max segments a row,
    in the [K, D] (fixed, diag) and the [K, D, D] (full) form, on
    ``tests/merge_cases.py``'s edge cases (padding, -1 ids, a component
    the block empties, one it creates, one with more members than a staged
    chunk): one launch a merge, identical to the plain version on the
    card, counts equal to the one-hot composition's and the sums within
    ``MERGE_RTOL`` of the table's largest value, the full second moments
    symmetric."""
    import torch
    from segmentalist_torch.ops import cuda_merge

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from merge_cases import merge_case, one_hot_merge

    out = dict(max_abs_err=0.0, one_hot_rel_err={})
    for family in ("fixed", "full"):
        what = "K12 %s %s" % (name, family)
        stats, valid, old, new = merge_case(
            family, shape["B"], shape["N_max"], MERGE_D, K=shape["K"],
            seed=1, device=DEVICE)
        before = cuda_merge.launches
        got = cuda_merge.merge_stats(stats, valid, old, new)
        check(cuda_merge.launches == before + 1, "%s: %d launches for one "
              "merge" % (what, cuda_merge.launches - before))
        want = cuda_merge.merge_stats_plain(stats, valid, old, new)
        hot = one_hot_merge(stats, valid, old, new)
        sync()
        err = max((g.double() - w.double()).abs().max().item()
                  for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "%s: differs from the plain version (max|d| %.3g)"
              % (what, err))
        check(torch.equal(got.counts, hot.counts),
              "%s: counts differ from the one-hot composition" % what)
        rel = max(((g.double() - h.double()).abs().max()
                   / h.double().abs().max()).item()
                  for g, h in zip(got[1:], hot[1:]))
        check(rel <= MERGE_RTOL, "%s: %.3g of the table's largest value "
              "from the one-hot composition > %g" % (what, rel, MERGE_RTOL))
        if family == "full":
            check(torch.equal(got.sum_sq, got.sum_sq.transpose(1, 2)),
                  "%s: sum_sq is not symmetric" % what)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["one_hot_rel_err"][family] = rel
    log("K12 merge_stats %s: identical to the plain version, against the "
        "one-hot composition %s" % (name, out["one_hot_rel_err"]))
    return out


def toy_reference():
    """Reference-pinned candidate scores of the one-utterance toy corpus
    (tests/test_unigram_wordseg.py:69), computed on the card."""
    import segmentalist_torch as pt

    emb = np.array([
        [-0.2702691, -0.12348549, -0.20069546, -0.10067126, -0.32822475,
         -0.24878924, -0.17988801, -0.13201745, 0.66409844, -0.44816282],
        [-0.27186683, -0.12384345, -0.20049213, -0.10272419, -0.32618827,
         -0.24660945, -0.17784701, -0.13362537, 0.66524321, -0.44805479],
        [-0.2465426, -0.06354388, -0.22458388, 0.79060942, 0.48230717,
         -0.11888564, 0.06724239, -0.04977163, 0.06908087, 0.03395205]])
    S_0 = 0.002 * np.ones(10)
    seg = pt.UnigramAcousticWordseg(
        pt.FBGMM, 10.0, 2, pt.FixedVarPrior.create(S_0, np.zeros(10),
                                                   S_0 / 0.05),
        {"test": emb}, {"test": np.array([0, 1, 2])}, {"test": [1, 2, 1]},
        {"test": [1, 2]}, seed_boundaries_dict={"test": [2]},
        beta_sent_boundary=-1, n_slices_max=20, batch_size=1, device=DEVICE)
    seg.acoustic_model.setup_components(2, np.array([0, -1, 1]))
    got = seg.get_vec_embed_log_probs(seg.utterances.vec_ids[0],
                                      seg.utterances.durations[0])
    want = np.array([17.5548998, 35.103967, 17.5548998])
    log("toy reference scores on the card: %s (pinned %s)"
        % (got.tolist(), want.tolist()))
    check(np.allclose(got, want, atol=1e-5), "toy reference scores differ")


def block_steps_vs_cpu(name, build, exact=True, D=13, n_landmarks_max=12):
    """Three block steps on the card (kernels) and on the CPU (plain
    versions), float32, from one initial state on shared numpy noise, on a
    24-utterance corpus of ``D`` dims and up to ``n_landmarks_max``
    landmarks.  ``build(corpus, device)`` makes the segmenter.  Boundaries
    and assignments (and a bigram segmenter's LM tables) must be
    identical, or with ``exact=False`` agree to ``AGREE_MIN``."""
    import torch
    from segmentalist_torch.utils.synth import synthetic_corpus

    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=24, n_landmarks_max=n_landmarks_max, D=D, K_true=6,
        n_slices_max=6, seed=4)
    corpus = ({k: v.astype(np.float32) for k, v in em.items()}, vi, du, lm)
    segs = {dev: build(corpus, dev) for dev in ("cpu", DEVICE)}
    rng = np.random.RandomState(5)
    cpu, card = segs["cpu"], segs[DEVICE]
    N_max, W_dp = cpu.utterances.N_max, cpu.W_dp
    K = cpu.acoustic_model.K_max
    for block in np.arange(24).reshape(3, 8):
        dp_noise = -np.log(-np.log(rng.uniform(1e-30, 1, (8, N_max, W_dp))))
        ch_noise = -np.log(-np.log(rng.uniform(1e-30, 1, (8, N_max, K))))
        for dev, seg in segs.items():
            as_t = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=torch.float32, device=dev)
            seg.block_step(block, 1.0, 1.0, dp_noise=as_t(dp_noise),
                           chain_noise=as_t(ch_noise))
    b_c, b_d = cpu.utterances.boundaries, card.utterances.boundaries
    a_c = cpu.acoustic_model.assignments.numpy()
    a_d = card.acoustic_model.assignments.cpu().numpy()
    same_b, same_a = int((b_c == b_d).all(1).sum()), int((a_c == a_d).sum())
    msg = ("%s block steps, card vs CPU: identical boundary rows %d/%d, "
           "identical assignments %d/%d" % (name, same_b, b_c.shape[0],
                                            same_a, a_c.size))
    same = same_b == b_c.shape[0] and same_a == a_c.size
    if hasattr(cpu, "lm"):
        same_lm = (np.array_equal(cpu.lm.unigram_counts,
                                  card.lm.unigram_counts)
                   and np.array_equal(cpu.lm.bigram_counts,
                                      card.lm.bigram_counts))
        msg += ", identical LM tables %s" % same_lm
        same = same and same_lm
    log(msg)
    if exact:
        check(same, "card and CPU %s block steps disagree" % name)
    else:
        check(same_b >= AGREE_MIN * b_c.shape[0]
              and same_a >= AGREE_MIN * a_c.size,
              "card and CPU %s block steps disagree" % name)
    stats = card.acoustic_model.stats
    check(bool(torch.isfinite(stats.sum_x).all()
               and torch.isfinite(stats.sum_sq).all()),
          "%s: non-finite statistics" % name)


def block_segmenters(K):
    """``(unigram, bigram)``: ``unigram(prior, **kw)`` and ``bigram(prior,
    **kw)`` give the ``build(corpus, device)`` of
    :func:`block_steps_vs_cpu` for a segmenter of K components."""
    import segmentalist_torch as pt
    from segmentalist_torch.utils.profiling import BENCH_LM

    def unigram(prior, **kw):
        return lambda c, dev: pt.UnigramAcousticWordseg(
            pt.FBGMM, 1.0, K, prior, *c, p_boundary_init=0.5,
            beta_sent_boundary=2.0, n_slices_max=6, batch_size=8, seed=4,
            device=dev, **kw)

    def bigram(prior, **kw):
        return lambda c, dev: pt.BigramAcousticWordseg(
            K, prior, BENCH_LM, *c, p_boundary_init=0.5,
            beta_sent_boundary=-1, n_slices_max=6, fb_type="unigram",
            batch_size=8, seed=4, device=dev, **kw)

    return unigram, bigram


def small_block_steps():
    """The small card-vs-CPU block steps of both segmenters and both
    families; the diag Viterbi steps must take K5's exact composition."""
    from segmentalist_torch.ops import cuda_score
    from segmentalist_torch.utils.profiling import bench_prior

    unigram, bigram = block_segmenters(40)

    fixed = bench_prior("fixed", 13, "cpu")
    diag = bench_prior("diag", 13, "cpu")
    block_steps_vs_cpu("small unigram", unigram(fixed), exact=False)
    block_steps_vs_cpu("small bigram", bigram(fixed))
    block_steps_vs_cpu("small unigram diag", unigram(
        diag, covariance_type="diag"))
    before = (cuda_score.diag_launches, cuda_score.diag_exact_launches)
    block_steps_vs_cpu("small unigram diag viterbi", unigram(
        diag, covariance_type="diag", fb_type="viterbi"))
    check((cuda_score.diag_launches, cuda_score.diag_exact_launches)
          == (before[0], before[1] + 3),
          "the diag Viterbi block steps did not take K5's exact composition")
    block_steps_vs_cpu("small bigram diag", bigram(
        diag, covariance_type="diag"))
    full = bench_prior("full", 13, "cpu")
    block_steps_vs_cpu("small unigram full", unigram(
        full, covariance_type="full"))
    block_steps_vs_cpu("small unigram full viterbi", unigram(
        full, covariance_type="full", fb_type="viterbi"))
    block_steps_vs_cpu("small bigram full", bigram(
        full, covariance_type="full"))


def fbgmm_vs_cpu(D=13, modes=("sequential", "blocked"), sweeps=3):
    """FBGMM sweeps on the card against the same sweeps on the CPU, on
    shared noise, float32, in the three families (N 300, K 24, ``D``
    dims): ``sweeps`` sequential sweeps (one K10 launch each, K11 for the
    full family; the plain version on the CPU) must leave identical
    assignments and statistics, ``sweeps`` blocked sweeps (float32
    products in another order on each device) agree to ``AGREE_MIN``."""
    import torch
    import segmentalist_torch as pt
    from segmentalist_torch.ops import cuda_item_chain
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(8)
    N, K = 300, 24
    X = ((3.0 * rng.randn(6, D))[rng.randint(0, 6, N)]
         + rng.randn(N, D)).astype(np.float32)
    asg = rng.randint(-1, 10, N)
    for family in ("fixed", "diag", "full"):
        prior = bench_prior(family, D, "cpu")
        models = {dev: pt.FBGMM(X, prior, 1.0, K, asg, covariance_type=family,
                                device=dev) for dev in ("cpu", DEVICE)}
        counter = "full_launches" if family == "full" else "launches"
        before = getattr(cuda_item_chain, counter)
        for mode in modes:
            for i in range(sweeps):
                noise = -np.log(-np.log(rng.uniform(1e-30, 1.0, (N, K))))
                for dev, am in models.items():
                    sweep = getattr(am, mode + "_sweep")
                    sweep(1.0, i != 1, noise=torch.as_tensor(
                        noise, dtype=torch.float32, device=dev))
            a_c = models["cpu"].assignments.numpy()
            a_d = models[DEVICE].assignments.cpu().numpy()
            same = int((a_c == a_d).sum())
            log("FBGMM %s %s sweeps at D %d, card vs CPU: identical "
                "assignments %d/%d" % (family, mode, D, same, N))
            if mode == "sequential":
                check(same == N and all(
                    torch.equal(a.cpu(), b) for a, b in zip(
                        models[DEVICE].stats, models["cpu"].stats)),
                      "card and CPU FBGMM %s sequential sweeps disagree"
                      % family)
            else:
                check(same >= AGREE_MIN * N, "card and CPU FBGMM %s blocked "
                      "sweeps disagree" % family)
            models["cpu"].setup_components(K, a_d)  # resume from one state
            models[DEVICE].setup_components(K, a_d)
        check(getattr(cuda_item_chain, counter) == before + sweeps,
              "the %s sequential sweeps did not run one item-chain launch "
              "each" % family)


def kmeans_block_steps_vs_cpu():
    """Three segmental k-means block steps on the card (one K2 launch
    each, its Viterbi mode) against the same steps on the CPU (the plain
    DP), float32, from one state: the bench corpus and configuration, the
    first three blocks of a sweep's order.  Boundaries and assignments
    agree to ``AGREE_MIN``, each block's objective to
    ``KMEANS_OBJ_RTOL``.  Then ``forward_backward_kmeans_viterbi`` on the
    longest utterance, card against CPU: identical boundaries."""
    import torch
    from segmentalist_torch.models.kmeans import KMeansState
    from segmentalist_torch.ops import cuda_dp
    from segmentalist_torch.segmenters.common import pad_utterance_order
    from segmentalist_torch.segmenters.kmeans_seg import (
        forward_backward_kmeans_viterbi)
    from segmentalist_torch.utils.profiling import bench_kmeans_segmenter

    segs = {dev: bench_kmeans_segmenter(device=dev)[0]
            for dev in ("cpu", DEVICE)}
    cpu, card = segs["cpu"], segs[DEVICE]
    card.acoustic_model.state = KMeansState(
        *(t.to(DEVICE) for t in cpu.acoustic_model.state))
    U = cpu.utterances.D
    blocks = pad_utterance_order(np.random.RandomState(0).permutation(U),
                                 cpu.batch_size)[:3]
    before = cuda_dp.launches
    rel = []
    for blk in blocks:
        obj_c = float(cpu.block_step(blk))
        obj_d = float(card.block_step(blk))
        rel.append(abs(obj_d - obj_c) / max(1.0, abs(obj_c)))
    b_c, b_d = cpu.utterances.boundaries, card.utterances.boundaries
    a_c = cpu.acoustic_model.assignments.numpy()
    a_d = card.acoustic_model.assignments.cpu().numpy()
    same_b, same_a = int((b_c == b_d).all(1).sum()), int((a_c == a_d).sum())
    log("kmeans block steps, card vs CPU (bench corpus, 3 blocks of %d): "
        "identical boundary rows %d/%d, identical assignments %d/%d, "
        "objective rel. diff a block %s, K2 launches %d" % (
            cpu.batch_size, same_b, U, same_a, a_c.size,
            ["%.3g" % r for r in rel], cuda_dp.launches - before))
    check(cuda_dp.launches == before + 3,
          "the k-means block steps did not run one K2 launch each")
    check(same_b >= AGREE_MIN * U and same_a >= AGREE_MIN * a_c.size
          and max(rel) <= KMEANS_OBJ_RTOL,
          "card and CPU k-means block steps disagree")
    utt = cpu.utterances
    i = int(np.argmax(utt.lengths))  # the longest utterance
    N = utt.lengths[i]
    T = N * (N + 1) // 2
    vec = cpu.get_vec_embed_neg_len_sqrd_norms(utt.vec_ids[i, :T],
                                               utt.durations[i, :T])
    got = forward_backward_kmeans_viterbi(vec, N, n_slices_max=6,
                                          device=DEVICE)
    want = forward_backward_kmeans_viterbi(vec, N, n_slices_max=6,
                                           device="cpu")
    log("forward_backward_kmeans_viterbi, utterance %d (N %d), card vs CPU: "
        "boundaries identical %s, objective %.9g / %.9g" % (
            i, N, np.array_equal(got[1], want[1]), got[0], want[0]))
    check(np.array_equal(got[1], want[1])
          and abs(got[0] - want[0]) <= KMEANS_OBJ_RTOL * max(1.0,
                                                            abs(want[0])),
          "forward_backward_kmeans_viterbi: card and CPU disagree")


# ------------------------------------------------------------- phase 5

def reset_launches():
    from segmentalist_torch.ops import (cuda_chain, cuda_diag_chain, cuda_dp,
                                        cuda_fullcov_chain,
                                        cuda_fullcov_score, cuda_item_chain,
                                        cuda_lib, cuda_merge, cuda_score)

    cuda_item_chain.launches = cuda_item_chain.full_launches = 0
    cuda_merge.launches = 0
    cuda_score.launches = cuda_score.diag_launches = 0
    cuda_score.diag_exact_launches = cuda_dp.launches = 0
    cuda_chain.launches = cuda_chain.bigram_launches = 0
    cuda_diag_chain.launches = cuda_diag_chain.bigram_launches = 0
    cuda_fullcov_score.launches = 0
    cuda_fullcov_chain.launches = cuda_fullcov_chain.bigram_launches = 0
    cuda_lib.form_launches.clear()


def read_launches():
    """Each kernel's launches since `reset_launches` (K5: both
    compositions; K9: both weight modes; K10: the fixed and diag
    families; K11: the full family's item chain; K12: the merge)."""
    from segmentalist_torch.ops import (cuda_chain, cuda_diag_chain, cuda_dp,
                                        cuda_fullcov_chain,
                                        cuda_fullcov_score, cuda_item_chain,
                                        cuda_merge, cuda_score)

    return {"K1": cuda_score.launches,
            "K2": cuda_dp.launches, "K3": cuda_chain.launches,
            "K4": cuda_chain.bigram_launches,
            "K5": cuda_score.diag_launches + cuda_score.diag_exact_launches,
            "K6": cuda_diag_chain.launches,
            "K7": cuda_diag_chain.bigram_launches,
            "K8": cuda_fullcov_score.launches,
            "K9": (cuda_fullcov_chain.launches
                   + cuda_fullcov_chain.bigram_launches),
            "K10": cuda_item_chain.launches,
            "K11": cuda_item_chain.full_launches,
            "K12": cuda_merge.launches}


def read_forms():
    """Each kernel's launches by form since `reset_launches`."""
    from segmentalist_torch.ops import cuda_lib

    return {k: dict(v) for k, v in sorted(cuda_lib.form_launches.items())}


PATH_KERNELS = {"unigram_fixed": ("K1", "K2", "K3"),
                "bigram": ("K1", "K2", "K4"),
                "unigram_diag": ("K5", "K2", "K6"),
                "bigram_diag": ("K5", "K2", "K7"),
                "unigram_full": ("K8", "K2", "K9"),
                "bigram_full": ("K8", "K2", "K9"),
                "fbgmm_toy": ("K10", "K11"), "fbgmm_flagship": ("K10",),
                "unigram_fixed_am": ("K1", "K2", "K3", "K10"),
                "unigram_full_am": ("K8", "K2", "K9", "K11"),
                "kmeans_wordseg": ("K2",)}


def run_slice(n_utterances=1000, sweeps=(1, 8, 64, 64), bigram=False,
              cov="fixed"):
    """One path at bench scale (the `bench.py` corpus and config): the
    unigram segmenter, or the bigram one (`bench.py`'s `bigram` row), with
    fixed-variance, diag or full components (the NIW priors and keywords
    of `bench.py:379-395` and `benchmarks/all_models.py:124-171`).  Returns
    the launches of the path's own kernels in this run, which must be > 0,
    and of K12, which must be one a block step where the merge is eager
    (every path but unigram_fixed and bigram, whose merges replay a CUDA
    graph: a replay does not call the wrapper)."""
    from segmentalist_torch.utils.profiling import bench_segmenter
    from segmentalist_torch.utils.synth import boundary_f_score

    name = ("bigram" if bigram else "unigram") + (
        "_" + cov if cov != "fixed" else ("" if bigram else "_fixed"))
    seg, truth = bench_segmenter(cov, bigram, n_utterances, DEVICE)
    n_cand = int((seg.utterances.seg_ids >= 0).sum())
    log("%s slice: %d utterances, %d candidate spans"
        % (name, n_utterances, n_cand))

    def f1():
        pred = {u: seg.utterances.boundaries[i]
                for i, u in enumerate(seg.ids_to_utterance_labels)}
        return boundary_f_score(pred, truth)[2]

    f1_0 = f1()
    steps = []
    step = seg.block_step
    seg.block_step = lambda *a, **k: steps.append(1) or step(*a, **k)
    reset_launches()
    # bench.py's sequence of calls: 1 + 8 + 64 + 64 sweeps
    records = [seg.gibbs_sample(n) for n in sweeps]
    launches = read_launches()
    log_marg = [v for r in records for v in r["log_marg"]]
    comps = [v for r in records for v in r["components"]]
    f1_end = f1()
    log("%s slice: %d sweeps, log_marg first %.6g last %.6g, F1 sweep 0 "
        "%.4f -> end %.4f, active components first %d last %d of %d, "
        "launches %s, by form %s, block steps %d" % (
            name, len(log_marg), log_marg[0], log_marg[-1], f1_0, f1_end,
            comps[0], comps[-1], seg.acoustic_model.K_max, launches,
            read_forms(), len(steps)))
    check(len(log_marg) == sum(sweeps), "expected %d sweeps" % sum(sweeps))
    check(all(math.isfinite(v) for v in log_marg), "non-finite log_marg")
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, "kernel %s was not launched on the %s path"
              % (k, name))
    if cov == "fixed":
        check(0 < launches["K12"] < len(steps), "%s: %d merge kernel "
              "launches for %d block steps, most of them graph replays"
              % (name, launches["K12"], len(steps)))
    else:
        check(launches["K12"] == len(steps), "%s: %d merge kernel launches "
              "for %d block steps" % (name, launches["K12"], len(steps)))
    if bigram:
        check(np.array_equal(seg.lm.unigram_counts,
                             seg.acoustic_model.stats.counts.cpu().numpy()),
              "LM unigram counts differ from the acoustic counts")
    f1_min = {"fixed": F1_MIN, "diag": F1_MIN_DIAG, "full": F1_MIN_FULL}[cov]
    check(f1_end >= f1_min, "%s: final F1 %.4f < %.2f"
          % (name, f1_end, f1_min))
    return {k: launches[k] for k in PATH_KERNELS[name] + ("K12",)}


def purity(assignments, z_true):
    """Share of items whose cluster's majority true label is their own."""
    return sum(np.bincount(z_true[assignments == k]).max()
               for k in np.unique(assignments)) / len(z_true)


def run_fbgmm_toy(sweeps=100):
    """The notebook toy (`bench.py:455-479`: 100 2-D points around four
    centres, K 4, FixedVarPrior(0.5, 0, 1)) for ``sweeps`` sweeps in each
    mode; log_marg finite, purity >= ``PURITY_MIN``; then 3 sequential
    sweeps of the full family on the same points (one K11 launch each).
    Returns the K10 and K11 launches and each mode's purity."""
    import segmentalist_torch as pt

    rng = np.random.RandomState(1)
    X = np.vstack([rng.randn(25, 2) + c for c in
                   ([0, 0], [4, 4], [-4, 4], [4, -4])]).astype(np.float32)
    z_true = np.repeat(np.arange(4), 25)
    prior = pt.FixedVarPrior.create(0.5 * np.ones(2, np.float32),
                                    np.zeros(2, np.float32),
                                    np.ones(2, np.float32))
    reset_launches()
    out = {}
    for mode in ("sequential", "blocked"):
        np.random.seed(1)
        am = pt.FBGMM(X, prior, 1.0, 4, "rand", covariance_type="fixed",
                      seed=1, device=DEVICE)
        rec = am.gibbs_sample(sweeps, mode=mode)
        p = purity(am.assignments.cpu().numpy(), z_true)
        log("fbgmm_toy %s: %d sweeps, log_marg %.6g -> %.6g, purity %.3f, "
            "components %d" % (mode, sweeps, rec["log_marg"][0],
                               rec["log_marg"][-1], p,
                               rec["components"][-1]))
        check(all(math.isfinite(v) for v in rec["log_marg"]),
              "fbgmm_toy %s: non-finite log_marg" % mode)
        check(p >= PURITY_MIN, "fbgmm_toy %s: purity %.3f < %.2f"
              % (mode, p, PURITY_MIN))
        out[mode + "_purity"] = p
    # the full family's sequential sweep (K11), on the same data
    np.random.seed(1)
    am = pt.FBGMM(X, pt.NIW.create(np.zeros(2), 1.0 / 16, 5.0,
                                   5.0 * np.eye(2)), 1.0, 4, "rand",
                  covariance_type="full", seed=1, device=DEVICE)
    rec = am.gibbs_sample(3)
    launches = read_launches()
    log("fbgmm_toy full (one K11 launch a sweep): log_marg %.6g -> %.6g"
        % (rec["log_marg"][0], rec["log_marg"][-1]))
    check(all(math.isfinite(v) for v in rec["log_marg"]),
          "fbgmm_toy full: non-finite log_marg")
    check(launches["K11"] == 3, "fbgmm_toy full: %d K11 launches for 3 "
          "sequential sweeps" % launches["K11"])
    check(launches["K10"] > 0, "K10 was not launched on the fbgmm_toy path")
    return {k: launches[k] for k in PATH_KERNELS["fbgmm_toy"]}, out


def fbgmm_flagship_vs_cpu(X, sweeps):
    """The flagship FBGMM on the card against its twin on the CPU, each
    from the path's "rand" assignments and the card's statistics and prior
    densities (bit for bit), on noise drawn on the card and copied:
    one sequential sweep over all the items (the longest K10 launch of any
    path, on its own data; the plain version on the CPU) must leave
    identical assignments, counts and sums; ``sweeps`` blocked sweeps run
    on both, their assignments agree to ``AGREE_MIN`` after each, and the
    CPU's log_marg trajectory (the semantics that
    tests/test_torch_fbgmm_sampler.py holds to the JAX package's) is
    logged beside the card's.  Returns the CPU's blocked trajectory."""
    import torch
    import segmentalist_torch as pt
    from segmentalist_torch.ops.stats import SuffStats
    from segmentalist_torch.utils.profiling import bench_prior

    def twins():
        np.random.seed(0)
        card = pt.FBGMM(X, bench_prior("fixed", 13, "cpu"), 1.0, 1000,
                        "rand", covariance_type="fixed", seed=0,
                        device=DEVICE)
        cpu = pt.FBGMM(X, bench_prior("fixed", 13, "cpu"), 1.0, 1000,
                       card.assignments.cpu().numpy(),
                       covariance_type="fixed", device="cpu")
        cpu.stats = SuffStats(*(t.cpu() for t in card.stats))
        cpu.log_prior_vec = card.log_prior_vec.cpu()
        return card, cpu

    N = X.shape[0]
    card, cpu = twins()
    noise = card.draw_noise(N)
    card.sequential_sweep(noise=noise)
    cpu.sequential_sweep(noise=noise.cpu())
    same_stats = all(torch.equal(a.cpu(), b)
                     for a, b in zip(card.stats, cpu.stats))
    n_same = int((card.assignments.cpu() == cpu.assignments).sum())
    log("fbgmm_flagship sequential sweep, card (one K10 launch over %d "
        "items) vs CPU (the plain version): identical assignments %d/%d, "
        "identical counts and sums %s" % (N, n_same, N, same_stats))
    check(n_same == N and same_stats, "fbgmm_flagship: K10 and its plain "
          "version disagree on the flagship sequential sweep")

    card, cpu = twins()
    traj = {"card": [card.log_marg()], "cpu": [cpu.log_marg()]}
    agree = []
    for _ in range(sweeps):
        noise = card.draw_noise(N)
        card.blocked_sweep(noise=noise)
        cpu.blocked_sweep(noise=noise.cpu())
        agree.append(int((card.assignments.cpu() == cpu.assignments).sum()))
        for dev, am in (("card", card), ("cpu", cpu)):
            traj[dev].append(am.log_marg())
    log("fbgmm_flagship blocked sweeps on shared noise: log_marg (init "
        "first) card %s, CPU %s, identical assignments %s of %d"
        % ([round(v, 1) for v in traj["card"]],
           [round(v, 1) for v in traj["cpu"]], agree, N))
    check(min(agree) >= AGREE_MIN * N, "fbgmm_flagship: card and CPU "
          "blocked sweeps disagree")
    return traj["cpu"]


def run_fbgmm_flagship(sweeps=4):
    """The FBGMM alone on the flagship corpus's 51,972 candidate spans
    (every span an item), K 1000, ``sweeps`` sequential and ``sweeps``
    blocked sweeps, each mode from the same "rand" assignments, after
    :func:`fbgmm_flagship_vs_cpu`; log_marg finite, the sequential one
    rising from sweep to sweep, the blocked one above the init (it
    oscillates after its first sweep, as the CPU's trajectory on shared
    noise does).  Returns the K10 launches and each mode's log_marg."""
    import segmentalist_torch as pt
    from segmentalist_torch.segmenters.blocked import process_embeddings
    from segmentalist_torch.utils.profiling import bench_prior
    from segmentalist_torch.utils.synth import synthetic_corpus

    em, vi, _, _, _ = synthetic_corpus(
        n_utterances=1000, n_landmarks_max=20, D=13, K_true=50,
        n_slices_max=6, seed=0)
    X = process_embeddings({k: v.astype(np.float32) for k, v in em.items()},
                           vi)[0]
    cpu_blocked = fbgmm_flagship_vs_cpu(X, sweeps)
    reset_launches()
    out = {"items": int(X.shape[0]), "cpu_blocked_log_marg": cpu_blocked}
    for mode in ("sequential", "blocked"):  # each from the same "rand" init
        np.random.seed(0)
        am = pt.FBGMM(X, bench_prior("fixed", 13, "cpu"), 1.0, 1000, "rand",
                      covariance_type="fixed", seed=0, device=DEVICE)
        lm0 = am.log_marg()
        rec = am.gibbs_sample(sweeps, mode=mode)
        lm = rec["log_marg"]
        log("fbgmm_flagship %s: %d items, K 1000, %d sweeps, log_marg %.1f "
            "(init) -> %s, components %d" % (
                mode, X.shape[0], sweeps, lm0, [round(v, 1) for v in lm],
                rec["components"][-1]))
        # the blocked sweep at K 1000 oscillates after its first sweep, as
        # the reference does (the CPU's trajectory above; the JAX
        # package's on the corpus's first 300 spans,
        # tests/test_torch_fbgmm_sampler.py), so each mode is held to
        # rising from the init: every sweep above it, the sequential one
        # rising from sweep to sweep as well
        rising = all(v > lm0 for v in lm) and (
            mode == "blocked" or all(b > a for a, b in zip(lm, lm[1:])))
        check(all(math.isfinite(v) for v in lm) and rising,
              "fbgmm_flagship %s: log_marg not finite and rising" % mode)
        out[mode + "_log_marg"] = [lm0] + lm
    launches = read_launches()
    check(launches["K10"] == sweeps,
          "fbgmm_flagship: %d K10 launches for %d sequential sweeps"
          % (launches["K10"], sweeps))
    return {"K10": launches["K10"]}, out


def run_am_slice(sweeps=(1, 3), cov="fixed", n_utterances=1000):
    """unigram_fixed (``cov`` "full": unigram_full) at bench scale with the
    one-by-one init (one item-chain launch over the initial segments: K10,
    or K11 for the full family) and ``am_n_iter=1`` (one launch an
    acoustic-model sweep before each sweep).  Returns the launches of the
    path's kernels, the initial items and F1."""
    from segmentalist_torch.utils.profiling import bench_segmenter
    from segmentalist_torch.utils.synth import boundary_f_score

    name = "unigram_%s_am" % cov
    item = "K11" if cov == "full" else "K10"
    reset_launches()
    seg, truth = bench_segmenter(cov, False, n_utterances, DEVICE,
                                 init_am_assignments="one-by-one")
    n_init = int((seg.acoustic_model.assignments >= 0).sum())
    check(read_launches()[item] == 1,
          "the one-by-one init did not run one %s launch" % item)
    log("%s: one-by-one init of %d segments" % (name, n_init))
    reset_launches()
    records = [seg.gibbs_sample(n, am_n_iter=1) for n in sweeps]
    launches = read_launches()
    lm = [v for r in records for v in r["log_marg"]]
    pred = {u: seg.utterances.boundaries[i]
            for i, u in enumerate(seg.ids_to_utterance_labels)}
    f1 = boundary_f_score(pred, truth)[2]
    log("%s: %d sweeps with am_n_iter=1, log_marg %s, F1 %.4f, launches "
        "%s, by form %s" % (name, len(lm), [round(v, 1) for v in lm], f1,
                            launches, read_forms()))
    check(all(math.isfinite(v) for v in lm), "non-finite log_marg")
    check(launches[item] == len(lm), "%s: %d %s launches for %d sweeps"
          % (name, launches[item], item, len(lm)))
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, "kernel %s was not launched on the %s path"
              % (k, name))
    return ({k: launches[k] for k in PATH_KERNELS[name]},
            {"init_items": n_init, "f1": f1})


def run_kmeans_slice(n_utterances=1000, sweeps=(1, 8, 64, 64)):
    """kmeans_wordseg at bench scale: the segmental k-means segmenter of
    `bench.py:442-452` on the `bench.py` corpus, run as `run_slice` runs
    its paths.  The record must be finite every sweep, the last
    sweep's objective above the first's, F1 >= ``F1_MIN_KMEANS``, and K2
    launched once a block (8 a sweep).  Returns K2's launches and the
    path's numbers."""
    from segmentalist_torch.utils.profiling import bench_kmeans_segmenter
    from segmentalist_torch.utils.synth import boundary_f_score

    seg, truth = bench_kmeans_segmenter(n_utterances, DEVICE)
    log("kmeans_wordseg slice: %d utterances, %d candidate spans"
        % (n_utterances, int((seg.utterances.seg_ids >= 0).sum())))

    def f1():
        pred = {u: seg.utterances.boundaries[i]
                for i, u in enumerate(seg.ids_to_utterance_labels)}
        return boundary_f_score(pred, truth)[2]

    f1_0 = f1()
    reset_launches()
    # bench.py's sequence of calls: 1 + 8 + 64 + 64 sweeps
    records = [seg.segment(n) for n in sweeps]
    launches = read_launches()
    rec = {k: [v for r in records for v in r[k]] for k in records[0]}
    obj, comps = rec["sum_neg_len_sqrd_norm"], rec["components"]
    f1_end = f1()
    blocks = -(-seg.utterances.D // seg.batch_size)
    log("kmeans_wordseg slice: %d sweeps, sum_neg_len_sqrd_norm first %.9g "
        "last %.9g, sum_neg_sqrd_norm first %.9g last %.9g, components "
        "first %d last %d of %d, F1 sweep 0 %.4f -> end %.4f, launches %s, "
        "by form %s" % (
            len(obj), obj[0], obj[-1], rec["sum_neg_sqrd_norm"][0],
            rec["sum_neg_sqrd_norm"][-1], comps[0], comps[-1],
            seg.acoustic_model.K_max, f1_0, f1_end, launches, read_forms()))
    check(len(obj) == sum(sweeps), "expected %d sweeps" % sum(sweeps))
    check(all(math.isfinite(v) for v in obj + rec["sum_neg_sqrd_norm"]),
          "kmeans_wordseg: a non-finite record")
    check(obj[-1] > obj[0], "kmeans_wordseg: the objective did not rise")
    check(launches["K2"] == blocks * len(obj),
          "kmeans_wordseg: %d K2 launches for %d sweeps of %d blocks"
          % (launches["K2"], len(obj), blocks))
    check(f1_end >= F1_MIN_KMEANS, "kmeans_wordseg: final F1 %.4f < %.2f"
          % (f1_end, F1_MIN_KMEANS))
    return ({"K2": launches["K2"]},
            {"f1": f1_end,
             "objective_first": obj[0], "objective_last": obj[-1],
             "components_first": comps[0], "components_last": comps[-1]})


# ------------------------------------------------------------- phase 6

AUX_SWEEPS = 2          # phase 6: sweeps before and after the save


def aux_builders(n_utterances=1000):
    """Phase 6's segmenters at the flagship's full width (the bench corpus,
    1000 utterances, K 1000, D 13, batch_size 125): name -> (build on a
    device, run n sweeps with keywords)."""
    from segmentalist_torch.utils.profiling import (bench_kmeans_segmenter,
                                                    bench_segmenter)

    def gibbs(cov, bigram, **kw):
        return (lambda dev: bench_segmenter(cov, bigram, n_utterances, dev,
                                            **kw)[0],
                lambda seg, n, **k: seg.gibbs_sample(n, **k))

    out = {name: gibbs(cov, bigram) for name, cov, bigram in (
        ("unigram_fixed", "fixed", False), ("bigram", "fixed", True),
        ("unigram_diag", "diag", False), ("bigram_diag", "diag", True),
        ("unigram_full", "full", False), ("bigram_full", "full", True))}
    for cov in ("fixed", "full"):
        build_am, _ = gibbs(cov, False, init_am_assignments="one-by-one")
        out["unigram_%s_am" % cov] = (
            build_am,
            lambda seg, n, **k: seg.gibbs_sample(n, am_n_iter=1, **k))
    out["kmeans_wordseg"] = (
        lambda dev: bench_kmeans_segmenter(n_utterances, dev)[0],
        lambda seg, n, **k: seg.segment(n, **k))
    return out


def ckpt_dir(name):
    return os.path.join(ROOT, "segmentalist_torch", "_build",
                        "chip_smoke_checkpoints", name)


def resume_path(name, build, sweep):
    """Segmenter B runs AUX_SWEEPS sweeps, is saved, and runs AUX_SWEEPS
    more; a fresh segmenter C (another host RNG, another generator seed)
    restores the checkpoint and runs the same sweeps.  B and C must end
    identical in every array of the checkpoint: assignments, boundaries,
    counts, sum_x, sum_sq, the LM tables, the k-means state and the
    generator's state bytes.  Returns the launches of the path's kernels
    and the checkpoint's bytes."""
    import shutil

    from segmentalist_torch.utils import checkpoint as ckpt

    reset_launches()
    seg_b = build(DEVICE)
    sweep(seg_b, AUX_SWEEPS)
    path = ckpt_dir(name)
    ckpt.save_checkpoint(path, seg_b, AUX_SWEEPS)
    n_bytes = os.path.getsize(ckpt.checkpoint_file(path, AUX_SWEEPS))
    sweep(seg_b, AUX_SWEEPS)
    seg_c = build(DEVICE)
    seg_c._rng = np.random.RandomState(999)
    if hasattr(seg_c, "_gen"):
        seg_c._gen.manual_seed(999)
    ckpt.restore_checkpoint(path, seg_c, AUX_SWEEPS)
    shutil.rmtree(path)
    sweep(seg_c, AUX_SWEEPS)
    launches = read_launches()
    want = ckpt._flatten(ckpt.segmenter_state(seg_b))
    got = ckpt._flatten(ckpt.segmenter_state(seg_c))
    differ = [k for k in want if k not in got
              or not np.array_equal(got[k], want[k])]
    log("resume %s: %d + save + %d sweeps against a fresh segmenter "
        "restored after %d, %d arrays compared, differing %s, launches %s, "
        "%d bytes" % (name, AUX_SWEEPS, AUX_SWEEPS, AUX_SWEEPS, len(want),
                      differ, launches, n_bytes))
    check(got.keys() == want.keys() and not differ,
          "resume %s: the restored segmenter left the chain in %s"
          % (name, differ))
    if hasattr(seg_b, "_gen"):
        check("torch_generator/state" in want,
              "resume %s: no generator state saved" % name)
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, "kernel %s was not launched on the resumed "
              "%s path" % (k, name))
    return {k: launches[k] for k in PATH_KERNELS[name]}, n_bytes


def monitored_path(name, build, sweep):
    """``3 * AUX_SWEEPS`` sweeps with ``validate=True, monitor_i=0``; the
    flags must pass and the path's kernels launch.  Then the monitor on the
    card against the same computation on the CPU from one state: scores
    within SCORE_TOL, boundary row and components identical.  Returns the
    launches of the monitored sweeps, the monitor's error and the
    segmenter."""
    from segmentalist_torch.utils import checkpoint as ckpt

    seg = build(DEVICE)
    reset_launches()
    sweep(seg, 3 * AUX_SWEEPS, validate=True, monitor_i=0)
    launches = {k: read_launches()[k] for k in PATH_KERNELS[name]}
    cpu = build("cpu")
    state = ckpt.segmenter_state(seg)
    state.pop("torch_generator", None)  # a CUDA generator's, not the CPU's
    ckpt.load_segmenter_state(cpu, state)
    got = [t.cpu().numpy() for t in seg._monitor_device(0)]
    want = [t.numpy() for t in cpu._monitor_device(0)]
    fin = np.isfinite(want[0])
    err = float((np.abs(got[0][fin] - want[0][fin])
                 / np.maximum(1.0, np.abs(want[0][fin]))).max())
    same = (np.array_equal(np.isinf(got[0]), np.isinf(want[0]))
            and np.array_equal(got[1], want[1])
            and np.array_equal(got[2], want[2]))
    log("%s validate and monitor: monitor utterance 0, card vs CPU: score "
        "rel. err %.3g, masks, boundaries and components identical %s; "
        "launches %s" % (name, err, same, launches))
    check(same and err <= SCORE_TOL,
          "%s: the monitor on the card differs from the CPU's" % name)
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, "kernel %s was not launched on the "
              "monitored %s path" % (k, name))
    return launches, {"monitor_rel_err": err}, seg


def poisoned_state(seg):
    """``debug_gibbs_only`` leaves every boundary row but the monitored
    one untouched; then a NaN in ``sum_x[0, 0]`` raises ValidationError
    naming sum_x after a sweep through K1, K2 and K3, and the card has no
    fault (the next synchronize passes)."""
    from segmentalist_torch.utils.debug import ValidationError

    before = seg.utterances.boundaries
    seg.gibbs_sample(2, monitor_i=0, debug_gibbs_only=True)
    after = seg.utterances.boundaries
    check(np.array_equal(after[1:], before[1:]),
          "debug_gibbs_only changed another utterance's boundaries")
    am = seg.acoustic_model
    sum_x = am.stats.sum_x.clone()
    sum_x[0, 0] = float("nan")
    am.stats = am.stats._replace(sum_x=sum_x)
    try:
        seg.gibbs_sample(1, validate=True)
    except ValidationError as e:
        msg = str(e)
    else:
        msg = None
    sync()  # a fault of the card would surface here
    log("poisoned state (NaN in sum_x[0, 0]): %s; debug_gibbs_only kept "
        "the other %d boundary rows" % (msg, len(before) - 1))
    check(msg is not None and "sum_x" in msg,
          "the poisoned state did not raise ValidationError naming sum_x")
    return msg


def run_demos():
    """Every demo and the segmentation example on the card, their output
    captured: it must hold no NaN, and every example F1 be above 0.3."""
    import contextlib
    import io

    from segmentalist_torch import demos
    from segmentalist_torch.examples import segmentation_example

    lines = {}
    for name, demo in demos.DEMOS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            demo(DEVICE)
        lines[name] = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        f1s = segmentation_example.main(device=DEVICE)
    lines["segmentation_example"] = buf.getvalue()
    log("demos on the card: %s; segmentation_example F1 %s" % (
        {k: len(v.splitlines()) for k, v in lines.items()},
        {k: round(v, 4) for k, v in f1s.items()}))
    bad = [k for k, v in lines.items() if "nan" in v or not v.strip()]
    check(not bad, "demos with NaN or no output: %s" % bad)
    check(all(f > 0.3 for f in f1s.values()),
          "segmentation_example: F1 %s" % f1s)
    return f1s


def run_auxiliary(n_utterances=1000):
    """Phase 6 at the flagship's width: resume (a), validate and monitor
    (b), the poisoned state (c), the demos (d).  Returns each path's
    launches and the phase's numbers."""
    paths, out = {}, {"resume": {}}
    builders = aux_builders(n_utterances)
    for name, (build, sweep) in builders.items():
        paths["resume_" + name], n_bytes = resume_path(name, build, sweep)
        out["resume"][name] = {"bytes": n_bytes}
    monitored = {}
    for name in ("unigram_fixed", "bigram", "kmeans_wordseg"):
        paths["monitor_" + name], out[name], monitored[name] = \
            monitored_path(name, *builders[name])
    out["demo_f1"] = run_demos()
    out["poisoned"] = poisoned_state(monitored["unigram_fixed"])
    return paths, out


# ------------------------------------------------------------- phase 7

P7_SWEEPS = 8        # (a), (b) Viterbi: sweeps held against the unsharded run
P7_LONG = 137        # (b), (c): unigram_fixed to F1 (bench.py's 1 + 8 + 64 + 64)
P7_SHORT = 4         # (c): the six other paths
P7_SUM_RTOL = 1e-5   # max |sum - rebuild| / max |rebuild|, sum_x and sum_sq
P7_PATHS = ("unigram_fixed", "unigram_diag", "unigram_full", "bigram",
            "bigram_diag", "bigram_full", "kmeans_wordseg")


def p7_build(path, device, n_utterances):
    """(segmenter, true boundaries) of a phase-5 path at the bench
    configuration."""
    from segmentalist_torch.utils.profiling import (bench_kmeans_segmenter,
                                                    bench_segmenter)

    if path == "kmeans_wordseg":
        return bench_kmeans_segmenter(n_utterances, device)
    cov = path.split("_")[1] if "_" in path else "fixed"
    return bench_segmenter(cov, path.startswith("bigram"), n_utterances,
                           device)


def p7_state(seg, per_shard):
    from segmentalist_torch.parallel.shard_sweep import gather_boundaries

    # a copy: on the CPU .numpy() would share the live assignment vector
    return {"assignments": seg.acoustic_model.assignments.cpu().numpy().copy(),
            "boundaries": (gather_boundaries(seg) if per_shard
                           else seg.utterances.boundaries)}


P7_SURFACE = ("unigram_fixed", "bigram", "kmeans_wordseg")
P7_MONITOR = 3  # (d): the monitored utterance of the debug-only sweep


def p7_interop_state(seg, per_shard):
    """The segmenter's state under ``interop.load_state``'s keys (the
    per-shard mode's boundaries gathered from the ranks), as numpy."""
    am = seg.acoustic_model
    out = {"X": am.X, "boundaries": p7_state(seg, per_shard)["boundaries"]}
    if hasattr(am, "state"):  # k-means
        out.update(am.state._asdict(), random_means=am.random_means)
    else:
        out.update(am.stats._asdict(), assignments=am.assignments,
                   **am.prior._asdict())
        if hasattr(seg, "lm"):
            out.update(seg.lm.state._asdict())
    return {k: (v.cpu().numpy().copy() if hasattr(v, "cpu")
                else np.array(v)) for k, v in out.items()}


def p7_surface(mesh, path, n_utterances):
    """Phase 7 (d), this rank's part: after ``use_shard_map_sweep``,
    ``gibbs_sample(2, monitor_i=0, validate=True)`` (``segment`` for
    k-means) with the monitor lines it logs, a debug-only sweep of
    utterance ``P7_MONITOR`` (the bigram driver has no such flag), then
    that utterance's monitor trace, the batch scores of every utterance
    (unigram, bigram) and the final state under interop's keys."""
    import logging

    from segmentalist_torch.parallel.dryrun import mesh_device
    from segmentalist_torch.parallel.mesh import shard_segmenter
    from segmentalist_torch.parallel.shard_sweep import use_shard_map_sweep

    dev = mesh_device(mesh)
    seg, _ = p7_build(path, dev, n_utterances)
    use_shard_map_sweep(shard_segmenter(seg, mesh), mesh)
    kmeans = path == "kmeans_wordseg"
    gibbs = seg.segment if kmeans else seg.gibbs_sample
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log_ = logging.getLogger("segmentalist_torch")
    handler, level = Keep(level=logging.DEBUG), log_.level
    log_.addHandler(handler)
    log_.setLevel(logging.DEBUG)
    try:
        rec = gibbs(2, monitor_i=0, validate=True)
    finally:
        log_.removeHandler(handler)
        log_.setLevel(level)
    flag = ("segment_debug_only" if kmeans else
            None if hasattr(seg, "lm") else "debug_gibbs_only")
    if flag is not None:
        gibbs(1, monitor_i=P7_MONITOR, **{flag: True})
    out = {"records": rec,
           "log": [ln for ln in lines if "monitor" in ln],
           "trace": tuple(t.cpu().numpy() for t in seg._monitor(P7_MONITOR)),
           "state": p7_interop_state(seg, True)}
    if not kmeans:
        out["scores"] = (seg.get_vec_embed_log_probs_unigram_all
                         if hasattr(seg, "lm")
                         else seg.get_vec_embed_log_probs_all)()
    return out


def p7_surface_check(two, n_utterances):
    """Phase 7 (d), held: on both ranks the records finite and the same
    four monitor lines; the trace and the batch scores the same on both
    ranks and, to ``SCORE_TOL``, what an unsharded segmenter on the card
    gives from the ranks' final state.  Returns the numbers."""
    from segmentalist_torch.interop import load_state

    out = {}
    for path in P7_SURFACE:
        r0, r1 = (two[r]["surface"][path] for r in (0, 1))
        for rank, r in enumerate((r0, r1)):
            rec = r["records"]
            vals = rec.get("log_marg", rec.get("sum_neg_sqrd_norm"))
            check(len(vals) == 2 and all(math.isfinite(v) for v in vals),
                  "phase 7 (d) %s rank %d: records %s" % (path, rank, vals))
        check(len(r0["log"]) == 4 and r0["log"] == r1["log"],
              "phase 7 (d) %s: the ranks logged different monitor lines"
              % path)
        check(all(np.array_equal(a, b) for a, b in zip(r0["trace"],
                                                       r1["trace"])),
              "phase 7 (d) %s: the ranks' traces differ" % path)
        seg, _ = p7_build(path, DEVICE, n_utterances)
        load_state(seg, r0["state"])
        want = [t.cpu().numpy() for t in seg._monitor_device(P7_MONITOR)]
        errs = [score_err(r0["trace"][0], want[0])]
        check(all(np.array_equal(a, b) for a, b in zip(r0["trace"][1:],
                                                       want[1:])),
              "phase 7 (d) %s: the trace's boundaries or components differ "
              "from the unsharded segmenter's" % path)
        if "scores" in r0:
            check(all(np.array_equal(a, b) for a, b in zip(r0["scores"],
                                                           r1["scores"])),
                  "phase 7 (d) %s: the ranks' batch scores differ" % path)
            full = (seg.get_vec_embed_log_probs_unigram_all
                    if hasattr(seg, "lm") else seg.get_vec_embed_log_probs_all)()
            check(len(full) == len(r0["scores"]) == n_utterances,
                  "phase 7 (d) %s: %d batch scores" % (path,
                                                       len(r0["scores"])))
            errs += [score_err(a, b) for a, b in zip(r0["scores"], full)]
        err = max(errs)
        check(err <= SCORE_TOL, "phase 7 (d) %s: the per-shard surface is "
              "%.3g off the unsharded segmenter's" % (path, err))
        out[path] = {"max_rel_err_vs_unsharded": err}
    return out


def score_err(got, want):
    """max |got - want| / max(1, |want|) over the finite entries; inf if
    the -inf masks differ."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.array_equal(np.isneginf(got), np.isneginf(want)):
        return math.inf
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin])
                        / np.maximum(1.0, np.abs(want[fin]))))


def p7_run(mesh, path, mode, sweeps, n_utterances, fb_type=None,
           check_each=False, snap_after=None):
    """This rank's part of ``sweeps`` sweeps of ``path`` on ``mesh``, in
    the exact mode or the per-shard one ("exact" / "per_shard"); the
    kernels' launches over those sweeps; with ``check_each``, after every
    sweep the statistics against their rebuild, the LM tables against the
    recount and every rank's state digest; the state after sweep
    ``snap_after`` and at the end."""
    from segmentalist_torch.parallel.dryrun import (consistency, mesh_device,
                                                    sweep_once)
    from segmentalist_torch.parallel.mesh import (gather_digests,
                                                  shard_segmenter)
    from segmentalist_torch.parallel.shard_sweep import use_shard_map_sweep

    seg, _ = p7_build(path, mesh_device(mesh), n_utterances)
    if fb_type is not None:
        seg.set_fb_type(fb_type)
    shard_segmenter(seg, mesh)
    per_shard = mode == "per_shard"
    if per_shard:
        use_shard_map_sweep(seg, mesh)
    out = {"log": [], "checks": [], "snap": None}
    reset_launches()
    for i in range(sweeps):
        rec = sweep_once(seg)
        out["log"].append(rec.get("log_marg", rec.get("sum_neg_sqrd_norm"))[0])
        if check_each:
            c = consistency(seg)
            c["same_state"] = len(set(gather_digests(seg, seg._shard))) == 1
            out["checks"].append(c)
        if snap_after == i + 1:
            out["snap"] = p7_state(seg, per_shard)
    out["launches"] = read_launches()
    out.update(p7_state(seg, per_shard))
    return out


def p7_one_rank(mesh, n_utterances):
    """Phase 7 (a): unigram_fixed on one rank, the exact mode and then the
    per-shard one."""
    return {mode: p7_run(mesh, "unigram_fixed", mode, P7_SWEEPS,
                         n_utterances)
            for mode in ("exact", "per_shard")}


def p7_two_ranks(mesh, n_utterances, long_sweeps):
    """Phase 7 (b), (c) and (d) on two ranks: the exact mode in Viterbi
    and in sampling (``long_sweeps`` sweeps), then the per-shard mode on
    every path (unigram_fixed for ``long_sweeps``, the others
    ``P7_SHORT``), then what reads the corpus in the per-shard mode
    (:func:`p7_surface`)."""
    out = {"viterbi": p7_run(mesh, "unigram_fixed", "exact", P7_SWEEPS,
                             n_utterances, fb_type="viterbi"),
           "exact": p7_run(mesh, "unigram_fixed", "exact", long_sweeps,
                           n_utterances, snap_after=1)}
    for path in P7_PATHS:
        out[path] = p7_run(mesh, path, "per_shard",
                           long_sweeps if path == "unigram_fixed"
                           else P7_SHORT, n_utterances, check_each=True)
    out["surface"] = {path: p7_surface(mesh, path, n_utterances)
                      for path in P7_SURFACE}
    return out


def p7_agree(got, want):
    """Shares of identical assignments and boundary entries."""
    return (float(np.mean(got["assignments"] == want["assignments"])),
            float(np.mean(got["boundaries"] == want["boundaries"])))


def run_multichip(n_utterances=1000, long_sweeps=P7_LONG):
    """Phase 7: the multi-device layer (``segmentalist_torch/parallel``)
    on the card, its ranks spawned by ``parallel.dryrun.launch`` after the
    kernels are built here.  (a) One rank over NCCL, the exact and the
    per-shard mode, 8 sweeps of unigram_fixed each: assignments and
    boundaries identical to the unsharded run on the card from the same
    seeds.  (b) Two ranks sharing the card over gloo (CUDA tensors staged
    through host memory), the exact mode: Viterbi sweeps and the first
    sampling sweep agree with the unsharded run to ``AGREE_MIN``, and
    ``long_sweeps`` sampling sweeps reach ``F1_MIN``.  (c) Two ranks, the
    per-shard mode on all seven paths (unigram_fixed for ``long_sweeps``
    sweeps, to ``F1_MIN``; the others ``P7_SHORT``): after every sweep the
    statistics equal their rebuild (counts exactly, sums to
    ``P7_SUM_RTOL``), the LM tables the recount, the ranks' states the
    same bits, and each path's kernels launched on each rank.  (d) Two
    ranks, the per-shard mode's monitor,
    validate, debug-only sweeps and batch scores on unigram_fixed, bigram
    and kmeans_wordseg (:func:`p7_surface_check`).  Returns each rank's
    launches by path and the phase's numbers."""
    from segmentalist_torch.parallel.dryrun import launch
    from segmentalist_torch.utils.synth import boundary_f_score

    seg, truth = p7_build("unigram_fixed", DEVICE, n_utterances)
    labels = seg.ids_to_utterance_labels

    def f1(boundaries):
        return boundary_f_score({u: boundaries[i]
                                 for i, u in enumerate(labels)}, truth)[2]

    ref = {}
    for _ in range(P7_SWEEPS):  # the unsharded run on the card, a sweep a call
        seg.gibbs_sample(1)
    ref["last"] = p7_state(seg, False)
    # two ranks round the batch up to a multiple of 2 (125 -> 126): the
    # unsharded runs that (b) is held to take that batch too
    b2 = -(-seg.batch_size // 2) * 2
    for fb_type, sweeps in (("standard", 1), ("viterbi", P7_SWEEPS)):
        seg, _ = p7_build("unigram_fixed", DEVICE, n_utterances)
        seg.batch_size = b2
        seg.set_fb_type(fb_type)
        seg.gibbs_sample(sweeps)
        ref[fb_type] = p7_state(seg, False)
    cpu = DEVICE != "cuda"
    one = launch(p7_one_rank, 1, args=(n_utterances,),
                 device="cpu" if cpu else "cuda", timeout=300.0)[0]
    two = launch(p7_two_ranks, 2, args=(n_utterances, long_sweeps),
                 device="cpu" if cpu else "cuda:0", timeout=600.0)
    paths, out = {}, {"two_ranks": {}}

    def launched(name, res, path):
        ks = PATH_KERNELS[path]
        paths[name] = {k: res["launches"][k] for k in ks}
        for k in ks:
            check(res["launches"][k] > 0, "phase 7 %s: kernel %s was not "
                  "launched" % (name, k))

    for mode in ("exact", "per_shard"):  # (a)
        r = one[mode]
        check(np.array_equal(r["assignments"], ref["last"]["assignments"])
              and np.array_equal(r["boundaries"], ref["last"]["boundaries"]),
              "phase 7 (a): one rank, %s mode, differs from the unsharded "
              "run: agreement %s" % (mode, p7_agree(r, ref["last"])))
        launched("p7_a_%s" % mode, r, "unigram_fixed")
    for rank, res in enumerate(two):  # (b)
        for what, got, want in (("viterbi", res["viterbi"], ref["viterbi"]),
                                ("first sweep", res["exact"]["snap"],
                                 ref["standard"])):
            agree = p7_agree(got, want)
            check(min(agree) >= AGREE_MIN, "phase 7 (b) rank %d, %s: "
                  "agreement %s < %s" % (rank, what, agree, AGREE_MIN))
            out["two_ranks"].setdefault("agree_" + what.replace(" ", "_"),
                                        []).append(agree)
        f = f1(res["exact"]["boundaries"])
        check(f >= F1_MIN, "phase 7 (b) rank %d: F1 %.4f < %.2f after %d "
              "sweeps" % (rank, f, F1_MIN, long_sweeps))
        out["two_ranks"].setdefault("exact_f1", []).append(f)
        launched("p7_b_exact_rank%d" % rank, res["exact"], "unigram_fixed")
        launched("p7_b_viterbi_rank%d" % rank, res["viterbi"],
                 "unigram_fixed")
    check(all(np.array_equal(two[0]["exact"][k], two[1]["exact"][k])
              for k in ("assignments", "boundaries")),
          "phase 7 (b): the two ranks' final states differ")
    per_path = {}
    for path in P7_PATHS:  # (c)
        for rank, res in enumerate(two):
            r = res[path]
            check(all(math.isfinite(v) for v in r["log"]),
                  "phase 7 (c) %s: a non-finite record" % path)
            for i, c in enumerate(r["checks"]):
                check(c["counts_equal"] and c["sum_rel_err"] <= P7_SUM_RTOL
                      and c.get("lm_equal", True) and c["same_state"],
                      "phase 7 (c) %s rank %d sweep %d: %s"
                      % (path, rank, i, c))
            launched("p7_c_%s_rank%d" % (path, rank), r, path)
        r = two[0][path]
        per_path[path] = {
            "sweeps": len(r["log"]),
            "max_sum_rel_err": max(c["sum_rel_err"] for c in r["checks"]),
            "log_first": r["log"][0], "log_last": r["log"][-1]}
        if path == "unigram_fixed":
            f = f1(r["boundaries"])
            check(f >= F1_MIN, "phase 7 (c) unigram_fixed: F1 %.4f < %.2f "
                  "after %d sweeps" % (f, F1_MIN, long_sweeps))
            per_path[path]["f1"] = f
    out["two_ranks"]["per_shard"] = per_path
    out["two_ranks"]["surface"] = p7_surface_check(two, n_utterances)  # (d)
    log("phase 7 (multi-device): %s" % json.dumps(out))
    return paths, out


# Phase 8: the exact-posterior oracles of the CPU tests, their cases run on
# the card (tests/torch_oracle.py; each module's CARD_CASES)
P8_MODULES = ("test_torch_exact_posterior", "test_torch_exact_posterior_diag",
              "test_torch_exact_posterior_bigram_fullcov",
              "test_torch_exact_posterior_bigram_diag",
              "test_torch_exact_posterior_bigram_full",
              "test_torch_fbgmm_stationary", "test_torch_blocked_sweep_oracle")
# each case's kernels, by their wrappers' counters
# (utils/profiling.launch_counts); every one must launch in the case
_K2 = {"K2": "cuda_dp.launches"}
_FIXED = {"K1": "cuda_score.launches", **_K2, "K3": "cuda_chain.launches"}
_DIAG = {"K5": "cuda_score.diag_launches", **_K2,  # grouped composition
         "K6": "cuda_diag_chain.launches"}
_FULL = {"K8": "cuda_fullcov_score.launches", **_K2,
         "K9": "cuda_fullcov_chain.launches"}
P8_KERNELS = {
    "unigram_fixed": _FIXED, "unigram_fixed_annealed": _FIXED,
    "unigram_fixed_viterbi": _FIXED,
    "unigram_diag": _DIAG,
    # the Viterbi DP takes K5's exact composition
    "unigram_diag_viterbi": {**_DIAG,
                             "K5": "cuda_score.diag_exact_launches"},
    "unigram_full": _FULL, "unigram_full_viterbi": _FULL,
    "bigram": {"K1": "cuda_score.launches", **_K2,
               "K4": "cuda_chain.bigram_launches"},
    "bigram_diag": {"K5": "cuda_score.diag_launches", **_K2,
                    "K7": "cuda_diag_chain.bigram_launches"},
    "bigram_full": {**_FULL, "K9": "cuda_fullcov_chain.bigram_launches"},
    "fbgmm_stationary_fixed": {"K10": "cuda_item_chain.launches"},
    "fbgmm_stationary_diag": {"K10": "cuda_item_chain.launches"},
    "fbgmm_stationary_full": {"K11": "cuda_item_chain.full_launches"},
    "fbgmm_blocked": {},  # plain tensor code on the card too
}


P8_WORKERS = 4  # processes that run the cases side by side: a move is
                # host-bound (~5 ms of Python and ~300 launches)


def p8_cases() -> dict:
    """Phase 8's cases: name -> run(device), from the oracle modules."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    cases = {}
    for mod in P8_MODULES:
        cases.update(importlib.import_module(mod).CARD_CASES)
    return cases


def p8_case(job):
    """Phase 8's worker: run the case ``job = (name, device)``; returns
    (name, its summary with the launches of its kernels in this process
    and without its seconds, the failed check's message or None)."""
    import torch

    from segmentalist_torch.utils.profiling import launch_counts

    name, device = job
    run = p8_cases()[name]
    before = launch_counts()
    try:
        res = run(device)
    except AssertionError as e:
        return name, None, str(e)
    if device == "cuda":
        torch.cuda.synchronize()
    after = launch_counts()
    res.pop("seconds", None)
    res["launches"] = {k: after[c] - before[c]
                       for k, c in P8_KERNELS[name].items()}
    return name, res, None


def run_oracles(workers=P8_WORKERS):
    """Phase 8: every exact-posterior oracle of the CPU tests
    (``tests/test_torch_exact_posterior*.py``,
    ``tests/test_torch_fbgmm_stationary.py``,
    ``tests/test_torch_blocked_sweep_oracle.py``) with its segmenter or
    model on the card, so that every draw goes through the hand-written
    kernels and the card's generator: the same trials and bounds as on the
    CPU, the oracle computed from the card's state.  The cases run in
    ``workers`` spawned processes (each builds nothing: the parent has
    built the kernels).  Each case must hold its bound and launch each of
    its kernels (:data:`P8_KERNELS`).  Returns (each kernel's launches in
    the phase, each case's total variation, bound, trials and
    launches)."""
    import multiprocessing

    cases = list(p8_cases())
    check(set(cases) == set(P8_KERNELS),
          "phase 8's cases %s, kernels listed for %s"
          % (sorted(cases), sorted(P8_KERNELS)))
    out, launches = {}, {}
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for name, res, err in pool.imap_unordered(
                p8_case, [(name, DEVICE) for name in cases]):
            check(err is None, "phase 8 %s: %s" % (name, err))
            log("phase 8 %s: %s" % (name, json.dumps(res)))
            idle = sorted(k for k, n in res["launches"].items() if n == 0)
            check(not idle, "phase 8 %s: no launch of %s" % (name, idle))
            out[name] = res
            for k, n in res["launches"].items():
                launches[k] = launches.get(k, 0) + n
    log("phase 8: %d oracle cases on %d processes" % (len(out), workers))
    return launches, {"cases": {name: out[name] for name in cases},
                      "workers": workers}

# ------------------------------------------------------------- phase 9

P9_LONG_SWEEPS = (1, 8, 64, 64)  # unigram_fixed_long: bench.py's 137 sweeps
P9_SWEEPS = (1, 8, 64)   # the D 130 Gibbs and k-means paths: 73 sweeps
P9_AM_SWEEPS = 4         # the D 130 am paths: sweeps, one call each
P9_SUM_RTOL = P7_SUM_RTOL  # the am paths' statistics against their rebuild
F1_MIN_LONG = 0.47       # unigram_fixed_long (JAX on a TPU: 0.499)
F1_RISE_MIN = 0.05       # a D 130 path's F1 over its sweep-0 F1: no JAX
                         # floor was taken at this width (PERF.md §6)
# the forms that D 130 and K 1000 select: each launch of these kernels on
# a D 130 path takes a form whose name starts so (cuda_lib.form_launches)
D130_FORMS = {"K3": "global", "K4": "global", "K6": "global",
              "K7": "global", "K9": "stream", "K10": "C16 ",
              "K11": "cta C16 tables global"}
# phase 9's paths on the D 130 corpus: (family, bigram, kind); the kind
# "gibbs" runs gibbs_sample, "am" adds the one-by-one init and
# am_n_iter=1, "kmeans" is the segmental k-means segmenter
P9_PATHS = {
    "unigram_fixed_d130": ("fixed", False, "gibbs"),
    "bigram_d130": ("fixed", True, "gibbs"),
    "unigram_diag_d130": ("diag", False, "gibbs"),
    "bigram_diag_d130": ("diag", True, "gibbs"),
    "unigram_full_d130": ("full", False, "gibbs"),
    "bigram_full_d130": ("full", True, "gibbs"),
    "unigram_fixed_am_d130": ("fixed", False, "am"),
    "unigram_full_am_d130": ("full", False, "am"),
    "kmeans_wordseg_d130": (None, False, "kmeans"),
}


def check_d130_forms(name, forms):
    """Every launch of a kernel of :data:`D130_FORMS` in ``forms`` took
    the form that D 130 selects."""
    for k, want in D130_FORMS.items():
        other = sorted(f for f in forms.get(k, {}) if not f.startswith(want))
        check(not other, "%s: %s took the form %s, not %r" % (
            name, k, other, want.strip()))


def p9_path(name, corpus, sweeps, kind="gibbs", family="fixed",
            bigram=False):
    """One path of phase 9 at full width on ``corpus`` (built once a
    shape): ``sweeps`` calls of ``gibbs_sample`` (``segment`` for k-means;
    with ``am_n_iter=1`` after the one-by-one init for the am paths, whose
    statistics must equal their rebuild after the init and every sweep).
    Checks the path's kernels' launches, the record finite (k-means: its
    objective rising); F1 is checked by the caller.  Returns the path's
    summary."""
    from segmentalist_torch.parallel.dryrun import consistency
    from segmentalist_torch.utils.profiling import (bench_kmeans_segmenter,
                                                    bench_segmenter)
    from segmentalist_torch.utils.synth import boundary_f_score

    kernels = PATH_KERNELS[name.rsplit("_", 1)[0]]
    reset_launches()
    if kind == "kmeans":
        seg, truth = bench_kmeans_segmenter(device=DEVICE, corpus=corpus)
    else:
        kw = {"init_am_assignments": "one-by-one"} if kind == "am" else {}
        seg, truth = bench_segmenter(family, bigram, device=DEVICE,
                                     corpus=corpus, **kw)
    init, forms = read_launches(), read_forms()

    def f1():
        pred = {u: seg.utterances.boundaries[i]
                for i, u in enumerate(seg.ids_to_utterance_labels)}
        return boundary_f_score(pred, truth)[2]

    def consistent(when):
        c = consistency(seg)
        check(c["counts_equal"] and c["sum_rel_err"] <= P9_SUM_RTOL,
              "%s: the statistics differ from their rebuild %s (%s)"
              % (name, when, c))
        return c["sum_rel_err"]

    out = {"candidate_spans": int((seg.utterances.seg_ids >= 0).sum()),
           "f1_0": f1()}
    if kind == "am":
        item = kernels[-1]
        check(init[item] == 1, "%s: the one-by-one init ran %d %s launches"
              % (name, init[item], item))
        out.update(init_items=int((seg.acoustic_model.assignments >= 0)
                                  .sum()), sum_rel_err=[consistent(
                                      "after the init")])
    reset_launches()
    records = []
    for i, n in enumerate(sweeps):
        if kind == "kmeans":
            records.append(seg.segment(n))
        elif kind == "am":
            records.append(seg.gibbs_sample(n, am_n_iter=1))
        else:
            records.append(seg.gibbs_sample(n))
        if kind == "am":
            out["sum_rel_err"].append(consistent("after sweep %d" % (i + 1)))
    launches = read_launches()
    for k, v in read_forms().items():
        for f, n in v.items():
            forms.setdefault(k, {})[f] = forms.get(k, {}).get(f, 0) + n
    if kind == "am":
        launches[kernels[-1]] += 1  # the init's
    key = "sum_neg_len_sqrd_norm" if kind == "kmeans" else "log_marg"
    trace = [v for r in records for v in r[key]]
    out.update(sweeps=len(trace), f1=f1(), first=trace[0], last=trace[-1],
               record=key, launches={k: launches[k] for k in kernels},
               forms=forms)
    log("%s: %s" % (name, json.dumps(out)))
    check(len(trace) == sum(sweeps), "%s: expected %d sweeps"
          % (name, sum(sweeps)))
    check(all(math.isfinite(v) for v in trace), "%s: non-finite %s"
          % (name, key))
    if kind == "kmeans":
        check(trace[-1] > trace[0], "%s: the objective did not rise" % name)
    idle = [k for k in kernels if out["launches"][k] == 0]
    check(not idle, "%s: no launch of %s" % (name, idle))
    return out


def p9_block_steps():
    """Card against CPU at the papers' shapes (phase 4's checks): three
    block steps of 8 utterances at D 130 with K 1000, so that the card
    takes the global and stream forms (unigram fixed, bigram, both diag,
    both full, full Viterbi), and at N_max 120 (unigram fixed, bigram);
    then the FBGMM's sequential sweep at D 130 in the three families (N
    300, K 24).  Returns each block steps' forms."""
    from segmentalist_torch.utils.profiling import bench_prior

    unigram, bigram = block_segmenters(1000)
    p = {f: bench_prior(f, 130, "cpu") for f in ("fixed", "diag", "full")}
    fixed13 = bench_prior("fixed", 13, "cpu")
    cases = {  # name: (build, exact, shape); exact as in phase 4
        "D 130 unigram": (unigram(p["fixed"]), False, dict(D=130)),
        "D 130 bigram": (bigram(p["fixed"]), True, dict(D=130)),
        "D 130 unigram diag": (unigram(p["diag"], covariance_type="diag"),
                               True, dict(D=130)),
        "D 130 bigram diag": (bigram(p["diag"], covariance_type="diag"),
                              True, dict(D=130)),
        "D 130 unigram full": (unigram(p["full"], covariance_type="full"),
                               True, dict(D=130)),
        "D 130 unigram full viterbi": (unigram(
            p["full"], covariance_type="full", fb_type="viterbi"), True,
            dict(D=130)),
        "D 130 bigram full": (bigram(p["full"], covariance_type="full"),
                              True, dict(D=130)),
        "N_max 120 unigram": (unigram(fixed13), False,
                              dict(n_landmarks_max=120)),
        "N_max 120 bigram": (bigram(fixed13), True,
                             dict(n_landmarks_max=120)),
    }
    forms = {}
    for name, (build, exact, shape) in cases.items():
        reset_launches()
        block_steps_vs_cpu(name, build, exact, **shape)
        forms[name] = read_forms()
        if "D" in shape:
            check_d130_forms(name + " block steps", forms[name])
    fbgmm_vs_cpu(D=130, modes=("sequential",), sweeps=1)
    return forms


def run_paper_shapes(n_utterances=1000):
    """Phase 9: the papers' shapes end to end at full width, each corpus
    built once and shared by its paths: ``unigram_fixed_long``
    (``bench.py:414-441``: N_max 120, D 13; 137 sweeps, F1 >=
    ``F1_MIN_LONG``) and the nine paths of :data:`P9_PATHS` on the bench
    corpus at D 130 (73 sweeps; the am paths 4), each of whose kernels
    must take the form D 130 selects (:data:`D130_FORMS`) and whose F1
    must rise by ``F1_RISE_MIN``; then :func:`p9_block_steps`.  Returns
    (each path's kernel launches, the phase's summary)."""
    from segmentalist_torch.utils.profiling import bench_corpus

    paths = {}
    corpus = bench_corpus(n_utterances, n_landmarks_max=120)
    paths["unigram_fixed_long"] = p9_path(
        "unigram_fixed_long", corpus, P9_LONG_SWEEPS)
    paths["unigram_fixed_long"].update(
        floor=F1_MIN_LONG, floor_source="JAX on a TPU: 0.499 "
        "(BENCH_r05.json), less 0.03")
    check(paths["unigram_fixed_long"]["f1"] >= F1_MIN_LONG,
          "unigram_fixed_long: final F1 %.4f < %.2f"
          % (paths["unigram_fixed_long"]["f1"], F1_MIN_LONG))
    corpus = bench_corpus(n_utterances, D=130)
    for name, (family, bigram, kind) in P9_PATHS.items():
        sweeps = ((1,) * P9_AM_SWEEPS if kind == "am" else P9_SWEEPS)
        out = p9_path(name, corpus, sweeps, kind, family, bigram)
        check_d130_forms(name, out["forms"])
        out.update(floor=None, floor_source="none: F1 must rise by %.2f "
                   "over sweep 0 (PERF.md §6)" % F1_RISE_MIN)
        check(out["f1"] - out["f1_0"] >= F1_RISE_MIN,
              "%s: F1 %.4f -> %.4f rose by less than %.2f"
              % (name, out["f1_0"], out["f1"], F1_RISE_MIN))
        paths[name] = out
    del corpus
    block_forms = p9_block_steps()
    return ({name: p["launches"] for name, p in paths.items()},
            {"paths": paths, "block_steps_forms": block_forms})


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Check the PyTorch port on one CUDA card.")
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels (e.g. K6,K7): check the "
                    "named kernels alone (phases 1-3) and print their "
                    "kernels line, with no result line")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from segmentalist_torch.device import resolve_device
    from segmentalist_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    cuda_lib.library()

    compare = {"K1": compare_score, "K2": compare_dp, "K3": compare_chain,
               "K4": compare_bigram_chain, "K5": compare_diag_score,
               "K6": compare_diag_chain, "K7": compare_bigram_diag_chain,
               "K8": compare_fullcov_score, "K9": compare_fullcov_chain,
               "K10": compare_item_chain, "K11": compare_full_item_chain,
               "K12": compare_merge}
    if args.only:
        compare = {k: compare[k] for k in args.only.split(",")}
    results = {(k, name): fn(shape, name)
               for name, shape in (("flagship", FLAGSHIP), ("long", LONG))
               for k, fn in compare.items()}
    if "K2" in compare:
        results[("K2", "wide")] = compare_dp(WIDE_DP, "wide")
    if args.only:
        print(json.dumps({"kernels": {k: {name: r for (k2, name), r
                                          in results.items() if k2 == k}
                                      for k in compare}}))
        return 0
    crafted_fullcov_own_pairs()

    toy_reference()
    small_block_steps()
    fbgmm_vs_cpu()
    kmeans_block_steps_vs_cpu()
    paths = {"unigram_fixed": run_slice(),
             "bigram": run_slice(bigram=True),
             "unigram_diag": run_slice(cov="diag"),
             "bigram_diag": run_slice(bigram=True, cov="diag"),
             "unigram_full": run_slice(cov="full"),
             "bigram_full": run_slice(bigram=True, cov="full")}
    fbgmm = {}
    for name, run in (("fbgmm_toy", run_fbgmm_toy),
                      ("fbgmm_flagship", run_fbgmm_flagship),
                      ("unigram_fixed_am", run_am_slice),
                      ("unigram_full_am", lambda: run_am_slice(cov="full"))):
        paths[name], fbgmm[name] = run()
    paths["kmeans_wordseg"], kmeans = run_kmeans_slice()
    aux_paths, aux = run_auxiliary()
    paths.update(aux_paths)
    p7_paths, multichip = run_multichip()
    paths.update(p7_paths)
    paths["oracles"], oracles = run_oracles()
    p9_paths, papers = run_paper_shapes()
    paths.update(p9_paths)

    meta = {
        "K1": ("fixedvar_scores", "segmentalist_torch/csrc/fixedvar_score.cu",
               "segmentalist_tpu/ops/pallas_score.py:185"),
        "K2": ("segment_dp", "segmentalist_torch/csrc/forward_dp.cu",
               "segmentalist_tpu/ops/pallas_dp.py:122"),
        "K3": ("fixedvar_chain", "segmentalist_torch/csrc/fixedvar_chain.cu",
               "segmentalist_tpu/ops/pallas_chain.py:327"),
        "K4": ("bigram_fixedvar_chain",
               "segmentalist_torch/csrc/fixedvar_chain.cu",
               "segmentalist_tpu/ops/pallas_chain.py:571"),
        "K5": ("diag_scores", "segmentalist_torch/csrc/diag_score.cu",
               "segmentalist_tpu/ops/pallas_score.py:352"),
        "K6": ("diag_chain", "segmentalist_torch/csrc/diag_chain.cu",
               "segmentalist_tpu/ops/pallas_chain.py:825"),
        "K7": ("bigram_diag_chain", "segmentalist_torch/csrc/diag_chain.cu",
               "segmentalist_tpu/ops/pallas_chain.py:1284"),
        "K8": ("fullcov_scores", "segmentalist_torch/csrc/fullcov_score.cu",
               "segmentalist_tpu/ops/pallas_score.py:630"),
        "K9": ("fullcov_chain", "segmentalist_torch/csrc/fullcov_chain.cu",
               "segmentalist_tpu/ops/pallas_chain.py:1725"),
        "K10": ("gibbs_items", "segmentalist_torch/csrc/item_chain.cuh",
                "segmentalist_tpu/models/fbgmm.py:517-570 (lax.scan)"),
        "K11": ("fullcov_items",
                "segmentalist_torch/csrc/fullcov_item_chain.cu",
                "segmentalist_tpu/models/fbgmm.py:517-570 (lax.scan, "
                "components_full)"),
        "K12": ("merge_stats", "segmentalist_torch/csrc/merge_stats.cu",
                "segmentalist_tpu/segmenters/common.py:268,310 (XLA one-hot "
                "dots of flat_contrib, merge_flat)"),
    }
    kernels = []
    for k, (fn, src, tpu) in meta.items():
        fl, lo = results[(k, "flagship")], results[(k, "long")]
        by_path = {p: n[k] for p, n in paths.items() if k in n}
        entry = {
            "name": fn, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(fl["max_abs_err"], lo["max_abs_err"]),
        }
        # the launch plan (K1, K5, K8 - K11), the form and the longest
        # chain (K3, K4, K6, K7, K10, K11) at each shape
        for f in ("plan", "form", "steps_max"):
            if f in fl:
                entry.update({f: fl[f], "long_" + f: lo[f]})
        if k == "K2":  # the W = N_max shape; k-means' path
            entry.update(wide_max_abs_err=results[("K2", "wide")][
                "max_abs_err"], paths={"kmeans_wordseg": kmeans})
        if "f64_rel_err" in fl:  # K8 and the expanded form vs float64
            entry.update({pre + k: r[k] for pre, r in (("", fl),
                                                       ("long_", lo))
                          for k in ("f64_rel_err", "expanded32_rel_err")})
        if k == "K10":  # the exact diag policy, the cluster sizes held, the
            # FBGMM paths
            entry.update({pre + "diag_" + f: r["diag_" + f] for pre, r in (
                ("", fl), ("long_", lo)) for f in ("form", "plan",
                                                   "clusters")})
            entry.update(clusters=fl["clusters"], long_clusters=lo["clusters"],
                         paths=fbgmm)
        if k == "K11":  # the flagship's plan at every cluster size
            entry["clusters"] = fl["clusters"]
        if k == "K12":  # against the one-hot composition, by form
            entry.update(one_hot_rel_err=fl["one_hot_rel_err"],
                         long_one_hot_rel_err=lo["one_hot_rel_err"])
        entry["forms_by_path"] = {
            p: v["forms"][k] for p, v in papers["paths"].items()
            if k in v["forms"]}
        kernels.append(entry)
    print(json.dumps({"paper_shapes": papers}))
    print(json.dumps({"oracles": oracles}))
    print(json.dumps({"multichip": multichip}))
    print(json.dumps({"auxiliary": aux}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
