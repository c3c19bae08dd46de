#!/usr/bin/env python3
"""Drive the PyTorch port (``segmentalist_torch``) once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) at the first
check that does not hold:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 must be off;
2. build: compile the hand-written kernels from ``segmentalist_torch/csrc``;
3. each kernel (K1-K9, both compositions of K5, both modes of K9) against
   its plain PyTorch version on the card, in float32, at the flagship
   shapes (B=125, N_max=20, W=6, K=1000, D=13) and a long/wide case
   (N_max=120, D=130), with CUDA-event timings and each kernel's bound
   (the larger of its bytes over the memory rate and its flops over the
   float32 peak, counted from the inputs); K8 and the reference's
   expanded Mahalanobis form in float32 against float64; K9's bigram
   mode on a crafted case where the own-pair correction decides draws;
   K6 / K7's launch plan (form, threads, shared bytes), longest chain,
   device time (profiler) and device time a dependent step;
4. small-input references: the reference-pinned candidate scores of the
   one-utterance toy corpus, and block steps on the card against the same
   block steps on the CPU (plain versions) on shared noise, for the
   unigram and bigram segmenters of the three families (diag and full
   unigram also in Viterbi, diag's taking K5's exact composition);
5. six paths at bench scale, on the 1000-utterance synthetic corpus, 137
   sweeps each: the unigram and the bigram segmenter with fixed-variance
   components (K1, K2, K3 / K4), diagonal-covariance components (K5, K2,
   K6 / K7) and full-covariance components (K8, K2, K9; the JAX package's
   `bench.py` unigram_full and `benchmarks/all_models.py` rows); for each,
   every kernel's launch count in that run, ms/sweep, log_marg and
   boundary F1.

The second-to-last line is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``.

To time some kernels alone (phases 1-3 of the named kernels, with their
kernels line and no result line):

    python3 chip_smoke.py --only K6,K7
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(B=125, N_max=20, W=6, K=1000, D=13)
LONG = dict(B=125, N_max=120, W=6, K=1000, D=130)
SCORE_TOL = 1e-4        # |kernel - plain| <= SCORE_TOL * max(1, |plain|)
AGREE_MIN = 0.999       # share of identical boundaries / assignments
F1_MIN = 0.67           # fixed-variance paths (JAX on a TPU: 0.696)
F1_MIN_DIAG = 0.72      # diag paths (JAX on a TPU: 0.750)
F1_MIN_FULL = 0.72      # full-covariance paths (JAX on a TPU: 0.751)
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


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    """K5's inputs, with the tables `cuda_score.diag_log_margs_T` forms."""
    import torch
    from segmentalist_torch.models import components_diag as cdg
    from segmentalist_torch.models.fbgmm import log_weights
    from segmentalist_torch.ops import cuda_score
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
            *cuda_score.diag_score_tables(inv_varT, lpv, v, D), w, counts,
            valid_m)


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

def compare_score(shape, name):
    import torch
    from segmentalist_torch.ops import cuda_score

    Xc, prior_c, muT, precT, w, counts, valid_m = score_inputs(shape, 1,
                                                               DEVICE)
    args = (Xc, prior_c, muT, precT, torch.log(precT).sum(-2), w, counts,
            valid_m)
    got = cuda_score.fixedvar_scores(*args)
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
    ms = cuda_ms(lambda: cuda_score.fixedvar_scores(*args), 50)
    plain_ms = cuda_ms(lambda: cuda_score.fixedvar_scores_plain(*args), 20)
    out = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
               **score_bound(args, 4 * Xc.shape[-1] + 5))
    log("K1 fixedvar_scores %s: max|d|=%.3g max rel=%.3g  kernel %.4f ms  "
        "plain %.4f ms  bound %.4f ms (%s)" % (
            name, max_abs, rel, ms, plain_ms, out["bound_ms"],
            out["bound_by"]))
    return out


def compare_dp(shape, name):
    import torch
    from segmentalist_torch.ops import cuda_dp, dp

    scores, lengths, noise = dp_inputs(shape, 2, DEVICE)
    rev = dp._rev_mask_scores(scores, 0)
    lpc = torch.full((), math.log(0.9), device=DEVICE)
    out = {}
    for use_max in (False, True):
        a_k = cuda_dp.forward_alphas(rev, lengths, lpc, use_max)
        a_p = cuda_dp.forward_alphas_plain(rev, lengths, lpc, use_max)
        sync()
        fin = torch.isfinite(a_p)
        check(bool((torch.isfinite(a_k) == fin).all()),
              "K2 %s: -inf pattern differs" % name)
        err = (a_k - a_p).abs()[fin]
        rel = (err / a_p.abs()[fin].clamp_min(1.0)).max().item()
        check(rel <= SCORE_TOL, "K2 %s: relative error %.3g" % (name, rel))
        _, b_k = dp.backward_sample(rev, a_k, lengths, 1.0, use_max, noise)
        _, b_p = dp.backward_sample(rev, a_p, lengths, 1.0, use_max, noise)
        same = (b_k == b_p).all(1).float().mean().item()
        log("K2 forward_alphas %s use_max=%s: max|d|=%.3g max rel=%.3g  "
            "identical boundaries %d/%d" % (
                name, use_max, err.max().item(), rel,
                int((b_k == b_p).all(1).sum()), b_k.shape[0]))
        check(same >= AGREE_MIN, "K2 %s: boundary agreement %.4f"
              % (name, same))
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0),
                                 err.max().item())
    out["ms"] = cuda_ms(lambda: cuda_dp.forward_alphas(rev, lengths, lpc),
                        50)
    out["plain_ms"] = cuda_ms(
        lambda: cuda_dp.forward_alphas_plain(rev, lengths, lpc), 10)
    B, N, W = rev.shape
    out.update(bound(nbytes(rev, lengths) + B * (N + W) * 4,
                     int(lengths.sum()) * (4 * W + 2)))
    log("K2 forward_alphas %s: kernel %.4f ms  plain %.4f ms  bound %.4f ms "
        "(%s)" % (name, out["ms"], out["plain_ms"], out["bound_ms"],
                  out["bound_by"]))
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
    out["ms"] = cuda_ms(kernel, 20)
    out["plain_ms"] = cuda_ms(plain, 3)
    out.update(chain_bound(data, 4 * Xe.shape[-1] + 8))
    log("K3 fixedvar_chain %s: kernel %.4f ms  plain %.4f ms  bound %.4f ms "
        "(%s)" % (name, out["ms"], out["plain_ms"], out["bound_ms"],
                  out["bound_by"]))
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

    def kernel():
        return cuda_chain.bigram_fixedvar_chain(
            *data, prior.var, prior.var_0, prior.mu_0, 0.8, *lm, alpha_a=1.0,
            intrp_lambda=0.1, b_smooth=1.0, K=K)

    def plain():
        return cuda_chain.bigram_fixedvar_chain_plain(
            *data, prec, prec0, prec0 * prior.mu_0, 0.8, *lm, consts, K, 1.0)

    ks_k = kernel()
    ks_p = plain()
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
    out["ms"] = cuda_ms(kernel, 20)
    out["plain_ms"] = cuda_ms(plain, 3)
    out.update(chain_bound(data, 4 * data[1].shape[-1] + 18, lm))
    log("K4 bigram_fixedvar_chain %s: kernel %.4f ms  plain %.4f ms  bound "
        "%.4f ms (%s)" % (name, out["ms"], out["plain_ms"], out["bound_ms"],
                          out["bound_by"]))
    return out


def compare_diag_score(shape, name):
    """K5 in both compositions (grouped for FFBS, exact for Viterbi)."""
    import torch
    from segmentalist_torch.ops import cuda_score

    args = diag_score_inputs(shape, 5, DEVICE)
    out = {"max_abs_err": 0.0}
    for exact in (False, True):
        label = "K5 diag_scores %s exact=%s" % (name, exact)
        got = cuda_score.diag_scores(*args, exact=exact)
        ref = cuda_score.diag_scores_plain(*args, exact=exact)
        sync()
        fin = torch.isfinite(ref)
        check(bool((torch.isfinite(got) == fin).all()),
              "%s: -inf pattern differs from the plain version" % label)
        err = (got - ref).abs()[fin]
        rel = (err / ref.abs()[fin].clamp_min(1.0)).max().item()
        check(rel <= SCORE_TOL, "%s: relative error %.3g > %g"
              % (label, rel, SCORE_TOL))
        pre = "exact_" if exact else ""
        out[pre + "ms"] = cuda_ms(
            lambda: cuda_score.diag_scores(*args, exact=exact), 50)
        out[pre + "plain_ms"] = cuda_ms(
            lambda: cuda_score.diag_scores_plain(*args, exact=exact), 5)
        out["max_abs_err"] = max(out["max_abs_err"], err.max().item())
        log("%s: max|d|=%.3g max rel=%.3g  kernel %.4f ms  plain %.4f ms"
            % (label, err.max().item(), rel, out[pre + "ms"],
               out[pre + "plain_ms"]))
    D = args[0].shape[-1]
    out.update(score_bound(args, 5 * D + (D + 3) // 4 + 4))
    log("K5 diag_scores %s: bound %.4f ms (%s)"
        % (name, out["bound_ms"], out["bound_by"]))
    return out


def device_ms(fn, kernel_name, reps=10):
    """Mean device milliseconds a launch of the kernels whose name holds
    ``kernel_name``, from ``torch.profiler`` (CUPTI) over ``reps`` calls:
    the kernel alone, without the host's launch cost that `cuda_ms` sees
    when the card waits for the host.  The mean is over the launches the
    profiler recorded (it may drop a record)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    hits = [e for e in prof.key_averages() if kernel_name in e.key]
    n = sum(e.count for e in hits)
    check(n > reps // 2, "the profiler saw %d of %d launches of %s"
          % (n, reps, kernel_name))
    return sum(e.self_device_time_total for e in hits) / n / 1e3


def diag_chain_plan(kernel, name, shape, bigram, run, embeds):
    """K6 / K7's launch plan at this shape, each chain's longest step
    count, the kernel's device time (profiler) over ``run()`` and that
    time a dependent step of the longest chain."""
    from segmentalist_torch.ops import cuda_diag_chain as cdc

    plan = cdc.card_plan(shape["D"], shape["K"], shape["N_max"], bigram)
    out = {"form": plan.form, "steps_max": int(chain_steps(embeds).max()),
           "device_ms": device_ms(run, "diag_chain_kernel")}
    out["us_per_step"] = out["device_ms"] * 1e3 / out["steps_max"]
    log("%s %s: plan %s, longest chain %d steps, device %.4f ms (%.2f us a "
        "step)" % (kernel, name, plan, out["steps_max"], out["device_ms"],
                   out["us_per_step"]))
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
    out.update(diag_chain_plan("K6 diag_chain", name, shape, False, kernel,
                               data[0]))
    out["ms"] = cuda_ms(kernel, 20)
    out["plain_ms"] = cuda_ms(plain, 2)
    out.update(chain_bound(data, 6 * data[1].shape[-1] + 12))
    log("K6 diag_chain %s: kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)"
        % (name, out["ms"], out["plain_ms"], out["bound_ms"],
           out["bound_by"]))
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

    def plain():
        return cdc.bigram_diag_chain_plain(
            *data, k0m0, snp0, k0, v0, 0.8, counts, big, pj, pi, consts, K,
            1.0)

    ks_k, ks_p = kernel(), plain()
    ks_keep = kernel(torch.full_like(pj, -1))  # own old pairs kept
    sync()
    log("K7 bigram_diag_chain %s: without the own-pair correction %d ks "
        "would differ" % (name, int((ks_keep != ks_k).sum())))
    out = {"max_abs_err": ks_agreement("K7 bigram_diag_chain", name, ks_k,
                                       ks_p, data[0])}
    out.update(diag_chain_plan("K7 bigram_diag_chain", name, shape, True,
                               kernel, data[0]))
    out["ms"] = cuda_ms(kernel, 20)
    out["plain_ms"] = cuda_ms(plain, 2)
    out.update(chain_bound(data, 6 * data[1].shape[-1] + 22,
                           (counts, big, pj, pi)))
    log("K7 bigram_diag_chain %s: kernel %.4f ms  plain %.4f ms  bound %.4f "
        "ms (%s)" % (name, out["ms"], out["plain_ms"], out["bound_ms"],
                     out["bound_by"]))
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
    out["ms"] = cuda_ms(lambda: cfs.fullcov_log_margs(
        *args[:-1], valid_m=args[-1]), 20)
    out["plain_ms"] = cuda_ms(lambda: cfs.fullcov_scores_plain(
        *args[:-1], valid_m=args[-1]), 3)
    out.update(fullcov_score_bound(args))
    log("K8 fullcov_scores %s: max|d|=%.3g max rel=%.3g  kernel %.4f ms  "
        "plain %.4f ms  bound %.4f ms (%s)" % (
            name, max_abs, rel, out["ms"], out["plain_ms"], out["bound_ms"],
            out["bound_by"]))
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
    out["ms"] = cuda_ms(kernel, 20)
    out["bigram_ms"] = cuda_ms(kernel_bigram, 20)
    out["plain_ms"] = cuda_ms(plain, 2)
    out.update(fullcov_chain_bound(data, kernel(), K))
    log("K9 fullcov_chain %s: kernel %.4f ms (bigram %.4f)  plain %.4f ms  "
        "bound %.4f ms (%s)" % (name, out["ms"], out["bigram_ms"],
                                out["plain_ms"], out["bound_ms"],
                                out["bound_by"]))
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


# ------------------------------------------------------------- bounds

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12     # float32 outside the tensor cores, flop/s


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def live_rows(valid_m, M):
    return int(valid_m.clamp(0, M).sum())


def chain_steps(embeds):
    """Per utterance the chain's step count (one past its last segment)."""
    import torch

    S = embeds.shape[1]
    steps = torch.arange(1, S + 1, device=embeds.device)
    return torch.where(embeds >= 0, steps, 0).amax(1)


def score_bound(args, per_term):
    """K1 / K5: every input once, the output once; per live row
    ``per_term`` flops for each active component and 4 for each
    component's share of the logsumexp."""
    Xc, counts, valid_m = args[0], args[-2], args[-1]
    M = Xc.shape[1]
    vm = valid_m.clamp(0, M).float()
    n_ops = (float(((counts > 0).sum(1).float() * vm).sum()) * per_term
             + live_rows(valid_m, M) * counts.shape[1] * 4)
    return bound(nbytes(*args) + Xc.shape[0] * M * 4, n_ops)


def chain_bound(data, per_k, lm=()):
    """K3 / K4 / K6 / K7: the noise rows of the steps that run, the other
    inputs once, ks once; ``per_k`` flops a component a step (the update's
    O(D) work is below the rounding of that)."""
    embeds, gumbel = data[0], data[3]
    K = gumbel.shape[-1]
    steps = int(chain_steps(embeds).sum())
    rest = [t for i, t in enumerate(data) if i != 3]
    return bound(steps * K * 4 + nbytes(*rest, *lm) + embeds.numel() * 4,
                 steps * K * per_k)


def fullcov_score_bound(args):
    """K8: every input once, the output once; per live row 2 (F + D) + D +
    8 flops for each active component (its global form, or its touched
    slot's: pad and duplicate slots and those of empty components feed no
    output), 4 for each component's share of the logsumexp (F =
    D(D+1)/2)."""
    Xc, prior_c, g, t, tslot, w, counts, valid_m = args
    B, M, D = Xc.shape
    F = D * (D + 1) // 2
    rows = live_rows(valid_m, M)
    K = w.shape[1]
    per_row = (counts > 0).sum(1).float()
    n_ops = (float((per_row * valid_m.clamp(0, M).float()).sum())
             * (2 * (F + D) + D + 8) + rows * 4 * K)
    return bound(nbytes(Xc, prior_c, *g, *t, tslot, w, counts, valid_m)
                 + rows * 4, n_ops)


def fullcov_chain_bound(data, ks, K):
    """K9: the base and noise rows of the steps that run, the touched and
    claimed slots' tables, the per-utterance inputs once, ks once; per step
    each live slot's 2 D^2 + 3 D + 30 flops, 8 flops a component, and the
    rank-1 update's 4 D^2 + 6 D (live slots counted from this run's
    draws)."""
    embeds, Xe, lpe, gumbel, base, counts, tm, tiP, tld, tk = data[:10]
    B, S, D = Xe.shape
    n = chain_steps(embeds)
    steps = int(n.sum())
    ks_c, tk_c = ks.cpu().numpy(), tk.cpu().numpy()
    slot_steps = claimed = 0
    for b in range(B):
        live = set(tk_c[b][tk_c[b] >= 0].tolist())
        for s in range(int(n[b])):
            slot_steps += len(live)
            k = int(ks_c[b, s])
            if k >= 0 and k not in live:
                live.add(k)
                claimed += 1
    n_ops = (slot_steps * (2 * D * D + 3 * D + 30) + steps * 8 * K
             + steps * (4 * D * D + 6 * D))
    n_bytes = (2 * steps * K * 4 + nbytes(embeds, Xe, lpe, counts, tm, tiP,
                                          tld, tk, ks)
               + claimed * (D * D + D + 1) * 4)
    return bound(n_bytes, n_ops)


# ------------------------------------------------------------- phase 4

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


def block_steps_vs_cpu(name, build, exact=True):
    """Three block steps on the card (kernels) and on the CPU (plain
    versions), float32, from one initial state on shared numpy noise.
    ``build(corpus, device)`` makes the segmenter.  Boundaries and
    assignments (and a bigram segmenter's LM tables) must be identical, or
    with ``exact=False`` agree to ``AGREE_MIN``."""
    import torch
    from segmentalist_torch.utils.synth import synthetic_corpus

    em, vi, du, lm, _ = synthetic_corpus(n_utterances=24, n_landmarks_max=12,
                                         D=13, K_true=6, n_slices_max=6,
                                         seed=4)
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


def small_block_steps():
    """The small card-vs-CPU block steps of both segmenters and both
    families; the diag Viterbi steps must take K5's exact composition."""
    import segmentalist_torch as pt
    from segmentalist_torch.ops import cuda_score
    from segmentalist_torch.utils.profiling import BENCH_LM, bench_prior

    def unigram(prior, **kw):
        return lambda c, dev: pt.UnigramAcousticWordseg(
            pt.FBGMM, 1.0, 40, prior, *c, p_boundary_init=0.5,
            beta_sent_boundary=2.0, n_slices_max=6, batch_size=8, seed=4,
            device=dev, **kw)

    def bigram(prior, **kw):
        return lambda c, dev: pt.BigramAcousticWordseg(
            40, prior, BENCH_LM, *c, p_boundary_init=0.5,
            beta_sent_boundary=-1, n_slices_max=6, fb_type="unigram",
            batch_size=8, seed=4, device=dev, **kw)

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


# ------------------------------------------------------------- phase 5

def reset_launches():
    from segmentalist_torch.ops import (cuda_chain, cuda_diag_chain, cuda_dp,
                                        cuda_fullcov_chain,
                                        cuda_fullcov_score, cuda_score)

    cuda_score.launches = cuda_score.diag_launches = 0
    cuda_score.diag_exact_launches = cuda_dp.launches = 0
    cuda_chain.launches = cuda_chain.bigram_launches = 0
    cuda_diag_chain.launches = cuda_diag_chain.bigram_launches = 0
    cuda_fullcov_score.launches = 0
    cuda_fullcov_chain.launches = cuda_fullcov_chain.bigram_launches = 0


def read_launches():
    """Each kernel's launches since `reset_launches` (K5: both
    compositions; K9: both weight modes)."""
    from segmentalist_torch.ops import (cuda_chain, cuda_diag_chain, cuda_dp,
                                        cuda_fullcov_chain,
                                        cuda_fullcov_score, cuda_score)

    return {"K1": cuda_score.launches,
            "K2": cuda_dp.launches, "K3": cuda_chain.launches,
            "K4": cuda_chain.bigram_launches,
            "K5": cuda_score.diag_launches + cuda_score.diag_exact_launches,
            "K6": cuda_diag_chain.launches,
            "K7": cuda_diag_chain.bigram_launches,
            "K8": cuda_fullcov_score.launches,
            "K9": (cuda_fullcov_chain.launches
                   + cuda_fullcov_chain.bigram_launches)}


PATH_KERNELS = {"unigram_fixed": ("K1", "K2", "K3"),
                "bigram": ("K1", "K2", "K4"),
                "unigram_diag": ("K5", "K2", "K6"),
                "bigram_diag": ("K5", "K2", "K7"),
                "unigram_full": ("K8", "K2", "K9"),
                "bigram_full": ("K8", "K2", "K9")}


def run_slice(n_utterances=1000, sweeps=(1, 8, 64, 64), bigram=False,
              cov="fixed"):
    """One path at bench scale (the `bench.py` corpus and config): the
    unigram segmenter, or the bigram one (`bench.py`'s `bigram` row), with
    fixed-variance, diag or full components (the NIW priors and keywords
    of `bench.py:379-395` and `benchmarks/all_models.py:124-171`).  Returns
    the launches of every kernel in this run; those of the path's own
    kernels must be > 0."""
    from segmentalist_torch.utils.profiling import bench_segmenter
    from segmentalist_torch.utils.synth import boundary_f_score

    name = ("bigram" if bigram else "unigram") + (
        "_" + cov if cov != "fixed" else ("" if bigram else "_fixed"))
    t0 = time.time()
    seg, truth = bench_segmenter(cov, bigram, n_utterances, DEVICE)
    n_cand = int((seg.utterances.seg_ids >= 0).sum())
    log("%s slice: %d utterances, %d candidate spans, setup %.1f s"
        % (name, n_utterances, n_cand, time.time() - t0))

    def f1():
        pred = {u: seg.utterances.boundaries[i]
                for i, u in enumerate(seg.ids_to_utterance_labels)}
        return boundary_f_score(pred, truth)[2]

    f1_0 = f1()
    reset_launches()
    records, sweep_ms = [], []
    for n in sweeps:  # bench.py's sequence: warm-up 1 + 8, timed 2 x 64
        sync()
        t = time.time()
        records.append(seg.gibbs_sample(n))
        sync()
        sweep_ms.append((time.time() - t) / n * 1e3)
    launches = read_launches()
    log_marg = [v for r in records for v in r["log_marg"]]
    f1_end = f1()
    log("%s slice: %d sweeps, ms/sweep per call %s (timed %s, best %.3f), "
        "log_marg first %.6g last %.6g, F1 sweep 0 %.4f -> end %.4f, "
        "launches %s" % (
            name, len(log_marg), [round(v, 3) for v in sweep_ms],
            [round(v, 3) for v in sweep_ms[2:]], min(sweep_ms[2:]),
            log_marg[0], log_marg[-1], f1_0, f1_end, launches))
    check(len(log_marg) == sum(sweeps), "expected %d sweeps" % sum(sweeps))
    check(all(math.isfinite(v) for v in log_marg), "non-finite log_marg")
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, "kernel %s was not launched on the %s path"
              % (k, name))
    if bigram:
        check(np.array_equal(seg.lm.unigram_counts,
                             seg.acoustic_model.stats.counts.cpu().numpy()),
              "LM unigram counts differ from the acoustic counts")
    f1_min = {"fixed": F1_MIN, "diag": F1_MIN_DIAG, "full": F1_MIN_FULL}[cov]
    check(f1_end >= f1_min, "%s: final F1 %.4f < %.2f"
          % (name, f1_end, f1_min))
    return {k: launches[k] for k in PATH_KERNELS[name]}


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card.")
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels (e.g. K6,K7): run phases "
                    "1-3 for these only and print their kernels line, with "
                    "no result line")
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

    t0 = time.time()
    cuda_lib.library()
    log("kernel library built/loaded in %.1f s (nvcc %s s)"
        % (time.time() - t0, cuda_lib.build_seconds))

    compare = {"K1": compare_score, "K2": compare_dp, "K3": compare_chain,
               "K4": compare_bigram_chain, "K5": compare_diag_score,
               "K6": compare_diag_chain, "K7": compare_bigram_diag_chain,
               "K8": compare_fullcov_score, "K9": compare_fullcov_chain}
    if args.only:
        compare = {k: compare[k] for k in args.only.split(",")}
    results = {(k, name): fn(shape, name)
               for name, shape in (("flagship", FLAGSHIP), ("long", LONG))
               for k, fn in compare.items()}
    if args.only:
        print(json.dumps({"kernels": {k: {name: r for (k2, name), r
                                          in results.items() if k2 == k}
                                      for k in compare}}))
        return 0
    crafted_fullcov_own_pairs()

    toy_reference()
    small_block_steps()
    paths = {"unigram_fixed": run_slice(),
             "bigram": run_slice(bigram=True),
             "unigram_diag": run_slice(cov="diag"),
             "bigram_diag": run_slice(bigram=True, cov="diag"),
             "unigram_full": run_slice(cov="full"),
             "bigram_full": run_slice(bigram=True, cov="full")}

    meta = {
        "K1": ("fixedvar_scores", "segmentalist_torch/csrc/fixedvar_score.cu",
               "segmentalist_tpu/ops/pallas_score.py:185"),
        "K2": ("forward_alphas", "segmentalist_torch/csrc/forward_dp.cu",
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
    }
    kernels = []
    for k, (fn, src, tpu) in meta.items():
        fl, lo = results[(k, "flagship")], results[(k, "long")]
        by_path = {p: n[k] for p, n in paths.items() if k in n}
        entry = {
            "name": fn, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(fl["max_abs_err"], lo["max_abs_err"]),
            "ms": fl["ms"], "plain_ms": fl["plain_ms"],
            "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "long_ms": lo["ms"], "long_plain_ms": lo["plain_ms"],
            "long_bound_ms": lo["bound_ms"],
        }
        if "exact_ms" in fl:  # K5's exact composition (diag Viterbi)
            entry.update(exact_ms=fl["exact_ms"],
                         exact_plain_ms=fl["exact_plain_ms"],
                         exact_long_ms=lo["exact_ms"],
                         exact_long_plain_ms=lo["exact_plain_ms"])
        if "bigram_ms" in fl:  # K9's bigram mode
            entry.update(bigram_ms=fl["bigram_ms"],
                         bigram_long_ms=lo["bigram_ms"])
        if "f64_rel_err" in fl:  # K8 and the expanded form vs float64
            entry.update({pre + k: r[k] for pre, r in (("", fl),
                                                       ("long_", lo))
                          for k in ("f64_rel_err", "expanded32_rel_err")})
        if "us_per_step" in fl:  # K6 / K7: form, longest chain, per step
            entry.update({pre + k: r[k] for pre, r in (("", fl),
                                                       ("long_", lo))
                          for k in ("form", "steps_max", "us_per_step",
                                    "device_ms")})
        kernels.append(entry)
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
