"""Where a segmenter's sweeps spend their time on the card.

Builds a segmenter at the bench configuration (``bench_segmenter``: the
JAX package's ``bench.py`` corpus, 1000 synthetic utterances with N_max 20,
D 13 and 50 true words, ``am_K=1000``, ``batch_size=125``, and the priors of
``bench.py:379-411`` and ``benchmarks/all_models.py:124-171``; with
``--kmeans`` the segmental k-means segmenter of ``bench.py:442-452``,
``bench_kmeans_segmenter``), runs
warm-up sweeps, times sweeps without the profiler, then profiles sweeps
with ``torch.profiler`` and prints one JSON line: ms/sweep, device time and
kernel launches per sweep, the active components, the batched
``torch.linalg`` factorisations', the scorer's, the DP stage's and the
chain's device time, and the operators and kernels that take the most
device time.

    python -m segmentalist_torch.utils.profiling --cov {fixed,diag,full} [--bigram] [--am-n-iter N]
    python -m segmentalist_torch.utils.profiling --kmeans
    python -m segmentalist_torch.utils.profiling --cov full --D 130
    python -m segmentalist_torch.utils.profiling --cov fixed --n-landmarks-max 120

``--D`` and ``--n-landmarks-max`` build the corpus at another embedding
width (130: the papers') or longest utterance (120: ``bench.py``'s
``unigram_fixed_long``).  The line also holds the device's idle share
of a sweep (1 - device ms / ms a sweep, the latter without the profiler)
and each kernel's launches a sweep by the form its launch plan chose.

The DP stage is every kernel launched inside the segmenters'
``segment_dp`` call (the noise draw and the DP; in a tree whose DP is not
fused, also its eager backward pass), which the profiled sweeps wrap in a
profiler range.  ``--am-n-iter N`` runs N acoustic-model sweeps before
each sweep (the unigram segmenter's ``am_n_iter``, the item-chain kernel:
K10, or K11 with ``--cov full``; its device time and launches a sweep).
Each path's own kernels (the scorer, K2 in the DP range, the chain, and
the item chain with ``--am-n-iter``; for k-means K2 alone)
must show launches in the profiled sweeps, by the profiler and by the
wrappers' launch counters, or the run raises: a stage that the profiler no
longer finds would read 0.
``--root DIR`` imports ``segmentalist_torch`` from another checkout (a
parent tree unpacked beside this one), so that two trees are measured the
same way; run the file by its path then (``python
segmentalist_torch/utils/profiling.py --root DIR ...``).

Needs a CUDA card (the profile is of the card's time).

The hooks of the JAX package's ``utils/profiling.py`` (``trace``,
``annotate``, ``device_timer``) are here too, for any code of the port:
:func:`trace` captures a host and device profile of a block into a
directory (a Chrome trace, for TensorBoard or Perfetto), :func:`annotate`
names a host span inside it, and :func:`device_timer` times a call with
one synchronisation of its tensors' card before and one after.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

BENCH_LM = {"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0}
WARMUP, SWEEPS = 9, 5  # warm-up sweeps, then sweeps timed and profiled
# the batched factorisations of the full-covariance family
LINALG_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular")
DP_RANGE = "segment_dp (profiled stage)"  # the profiler range of the DP
# kernel K2: the whole DP, or the forward filter alone in a tree from
# before the fusion
K2_KERNELS = ("segment_dp_kernel", "forward_alphas_kernel")
ITEM_KERNEL = "item_chain::items_kernel"  # K10, the FBGMM's item chain
FULL_ITEM_KERNEL = "fullcov_items_kernel"  # K11, the full family's


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile of the enclosed block (host ops and, with a card,
    its kernels) into ``logdir`` as a Chrome trace
    (``torch.profiler.tensorboard_trace_handler``); yields the
    ``torch.profiler.profile`` (its ``key_averages()`` are there once the
    block has closed)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named host span inside a :func:`trace` (a context manager)."""
    return torch.profiler.record_function(name)


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*map(_cuda_devices, tree))
    return set()


def device_timer(fn, *args, n_iter: int = 10, **kwargs):
    """``(result, seconds a call)`` of ``fn(*args, **kwargs)``: one call
    to warm up, then ``n_iter`` calls queued back to back, with the card
    of the arguments' and results' tensors synchronised once before them
    and once after (a one-off measurement: a synchronisation in the
    sampling loops would stall them)."""
    out = fn(*args, **kwargs)
    devices = _cuda_devices((args, kwargs, out))
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args, **kwargs)
    for d in devices | _cuda_devices(out):
        torch.cuda.synchronize(d)
    return out, (time.perf_counter() - t0) / n_iter


def bench_prior(cov: str, D: int, device):
    """The bench priors: FixedVarPrior(var 0.05, mu_0 0, var_0 1) for
    "fixed"; NIW(m_0 0, k_0 0.05, v_0 D + 3, S_0 0.05) with a [D] S_0 for
    "diag" and 0.05 I_D for "full"."""
    from segmentalist_torch.priors import NIW, FixedVarPrior

    f32 = np.float32
    if cov == "fixed":
        return FixedVarPrior.create(np.full(D, 0.05, f32), np.zeros(D, f32),
                                    np.ones(D, f32), device=device)
    S_0 = (np.full(D, 0.05, f32) if cov == "diag"
           else 0.05 * np.eye(D, dtype=f32))
    return NIW.create(np.zeros(D, f32), 0.05, D + 3.0, S_0, device=device)


def bench_corpus(n_utterances: int = 1000, D: int = 13,
                 n_landmarks_max: int = 20):
    """The ``bench.py`` corpus (float32 embeddings): ``(embedding_mats,
    vec_ids_dict, durations_dict, landmarks_dict, true boundaries)``.
    ``D`` 130 gives the papers' embedding width, ``n_landmarks_max`` 120
    the corpus of ``bench.py``'s ``unigram_fixed_long`` row."""
    from segmentalist_torch.utils.synth import synthetic_corpus

    em, vi, du, lm, truth = synthetic_corpus(
        n_utterances=n_utterances, n_landmarks_max=n_landmarks_max, D=D,
        K_true=50, n_slices_max=6, seed=0)
    em = {k: v.astype(np.float32) for k, v in em.items()}
    return em, vi, du, lm, truth


def bench_kmeans_segmenter(n_utterances: int = 1000, device="cuda",
                           D: int = 13, n_landmarks_max: int = 20,
                           corpus=None):
    """(segmenter, ground-truth boundaries): the segmental k-means
    segmenter of ``bench.py:442-452`` (``am_K=1000``,
    ``p_boundary_init=0.5``, ``n_slices_max=6``, ``batch_size=125``,
    ``seed=0``: the initial draws the JAX package makes after
    ``np.random.seed(0)``) on the bench corpus (:func:`bench_corpus` at
    ``D`` and ``n_landmarks_max``, or ``corpus``, one it built)."""
    from segmentalist_torch import SegmentalKMeansWordseg

    em, vi, du, lm, truth = corpus or bench_corpus(n_utterances, D,
                                                   n_landmarks_max)
    return SegmentalKMeansWordseg(
        1000, em, vi, du, lm, p_boundary_init=0.5, n_slices_max=6,
        batch_size=125, seed=0, device=device), truth


def bench_segmenter(cov: str = "fixed", bigram: bool = False,
                    n_utterances: int = 1000, device="cuda", D: int = 13,
                    n_landmarks_max: int = 20, corpus=None, **kw):
    """(segmenter, ground-truth boundaries) at the bench configuration,
    on :func:`bench_corpus` at ``D`` and ``n_landmarks_max`` (or
    ``corpus``, one it built) with :func:`bench_prior` at the corpus's
    D; ``kw`` go to the segmenter (e.g. ``init_am_assignments``) and
    override the configuration's keywords."""
    from segmentalist_torch import (BigramAcousticWordseg, FBGMM,
                                    UnigramAcousticWordseg)

    em, vi, du, lm, truth = corpus or bench_corpus(n_utterances, D,
                                                   n_landmarks_max)
    D = next(iter(em.values())).shape[1]
    common = dict(
        am_K=1000, am_param_prior=bench_prior(cov, D, "cpu"),
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, covariance_type=cov, p_boundary_init=0.5,
        beta_sent_boundary=-1, n_slices_max=6, batch_size=125, seed=0,
        device=device)
    common.update(kw)
    if bigram:
        seg = BigramAcousticWordseg(lm_params=BENCH_LM, fb_type="unigram",
                                    **common)
    else:
        seg = UnigramAcousticWordseg(FBGMM, am_alpha=1.0, **common)
    return seg, truth


@contextlib.contextmanager
def dp_range():
    """Run the segmenters' ``segment_dp`` (``segmenters/blocked.py``, and
    ``segmenters/kmeans_seg.py`` where the tree has it) inside the profiler
    range ``DP_RANGE`` while the block is open."""
    mods = []
    for name in ("blocked", "kmeans_seg"):
        try:
            mods.append(importlib.import_module(
                "segmentalist_torch.segmenters." + name))
        except ImportError:
            continue
    inner = mods[0].segment_dp

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(DP_RANGE):
            return inner(*args, **kwargs)

    for mod in mods:
        mod.segment_dp = wrapped
    try:
        yield
    finally:
        for mod in mods:
            mod.segment_dp = inner


def dp_stage_events(events) -> list:
    """The device events (kernels, copies, fills) of the DP stage: those
    whose launch call on the host (a CUDA API event such as
    cudaLaunchKernel, matched by its correlation id) falls inside a
    ``DP_RANGE`` range.  Matching by the launch's time also catches the
    kernels launched by ctypes, which the profiler does not attach to the
    range as it attaches aten ops'."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == DP_RANGE and e.device_type.name == "CPU")
    starts = [a for a, _ in spans]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    launched = {e.id for e in events
                if e.device_type.name == "CPU" and e.name.startswith("cu")
                and inside(e.time_range.start)}
    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)
            and e.name != DP_RANGE and e.id in launched]


def launch_counts() -> dict:
    """The wrappers' launch counters of the scorers, K2, the chains, K10
    and K11 (a module or counter a tree lacks is skipped or reads 0)."""
    counts = {}
    for mod, names in (("cuda_score", ("launches", "diag_launches",
                                       "diag_exact_launches")),
                       ("cuda_fullcov_score", ("launches",)),
                       ("cuda_dp", ("launches",)),
                       ("cuda_chain", ("launches", "bigram_launches")),
                       ("cuda_diag_chain", ("launches", "bigram_launches")),
                       ("cuda_fullcov_chain", ("launches",
                                               "bigram_launches")),
                       ("cuda_item_chain", ("launches", "full_launches"))):
        try:
            m = importlib.import_module("segmentalist_torch.ops." + mod)
        except ImportError:
            continue
        for n in names:
            counts["%s.%s" % (mod, n)] = getattr(m, n, 0)
    return counts


def profile_sweeps(seg, am_n_iter: int = 0) -> dict:
    """Warm up, time ``SWEEPS`` sweeps, then profile as many (each after
    ``am_n_iter`` acoustic-model sweeps; a k-means segmenter's
    ``segment``)."""
    from torch.profiler import ProfilerActivity, profile

    from segmentalist_torch.ops import cuda_lib

    kmeans = not hasattr(seg, "gibbs_sample")
    if kmeans:
        def sweeps(n):
            return seg.segment(n)
    else:
        def sweeps(n):
            return seg.gibbs_sample(n, am_n_iter)
    warm = sweeps(WARMUP)
    torch.cuda.synchronize()
    t0 = time.time()
    sweeps(SWEEPS)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / SWEEPS * 1e3
    t0 = time.time()
    counted = launch_counts()
    forms = getattr(cuda_lib, "form_launches", {})  # {} in an older tree
    forms.clear()
    with dp_range(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        last = sweeps(SWEEPS)
        torch.cuda.synchronize()
    ms_prof = (time.time() - t0) / SWEEPS * 1e3
    counted = {k: v - counted.get(k, 0) for k, v in launch_counts().items()}
    events = prof.key_averages()
    # device kernels (the range's own span on the device timeline is not one)
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)
               and e.key != DP_RANGE]
    dp = dp_stage_events(prof.events())
    k2 = [e for e in kernels if any(n in e.key for n in K2_KERNELS)]

    def per_sweep_ms(us):
        return us / 1e3 / SWEEPS

    def launches(pred):
        return sum(e.count for e in kernels if pred(e.key)) / SWEEPS

    full = getattr(getattr(seg, "acoustic_model", None), "covariance_type",
                   None) == "full"
    item, item_kernel, item_counter = (
        ("K11", FULL_ITEM_KERNEL, "cuda_item_chain.full_launches") if full
        else ("K10", ITEM_KERNEL, "cuda_item_chain.launches"))
    items = [e for e in kernels if item_kernel in e.key]
    seen = {"K2 in the DP range": sum(any(n in e.name for n in K2_KERNELS)
                                      for e in dp) / SWEEPS}
    if not kmeans:  # k-means runs no scorer kernel and no chain
        seen["scorer"] = launches(lambda k: "scores_kernel" in k)
        seen["chain"] = launches(lambda k: "chain_kernel" in k
                                 and ITEM_KERNEL not in k)
    if am_n_iter > 0:
        seen[item] = launches(lambda k: item_kernel in k)
    by_counter = {
        "scorer": sum(v for k, v in counted.items() if "score." in k),
        "K2 in the DP range": counted.get("cuda_dp.launches", 0),
        "chain": sum(v for k, v in counted.items() if "chain." in k
                     and not k.startswith("cuda_item_chain")),
        item: counted.get(item_counter, 0)}
    missing = sorted(k for k, v in seen.items()
                     if v == 0 or by_counter[k] == 0)
    if missing:
        raise RuntimeError("profiling: no launch of %s in the profiled "
                           "sweeps (profiler %s, counters %s)"
                           % (missing, seen, by_counter))

    utt = seg.utterances
    blocks = -(-utt.D // seg.batch_size)  # block steps a sweep
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ops = sorted((e for e in events if e.device_type.name == "CPU"
                  and e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:12]
    device_ms = per_sweep_ms(sum(e.self_device_time_total for e in kernels))
    return {
        "ms_per_sweep": ms, "ms_per_sweep_profiled": ms_prof,
        "device_ms_per_sweep": device_ms,
        # the share of a sweep's wall time (unprofiled) that no kernel ran
        "idle_share": 1.0 - device_ms / ms,
        # each kernel's launches a sweep by the form its plan chose
        "form_launches_per_sweep": {
            k: {f: n / SWEEPS for f, n in v.items()}
            for k, v in sorted(forms.items())},
        "kernels_per_sweep": sum(e.count for e in kernels) / SWEEPS,
        "blocks_per_sweep": blocks,
        # active components (the scorers' active columns) of K_max
        "components": {"after_warmup": warm["components"][-1],
                       "last": last["components"][-1],
                       "K_max": seg.acoustic_model.K_max},
        "linalg_ms_per_sweep": {
            e.key: per_sweep_ms(e.device_time_total) for e in events
            if e.key in LINALG_OPS},
        "linalg_launches_per_sweep": {
            e.key: e.count / SWEEPS for e in events if e.key in LINALG_OPS},
        # the candidate scorer's (K1, K5 or K8) device time
        "scorer_ms_per_sweep": per_sweep_ms(sum(
            e.self_device_time_total for e in kernels
            if "scores_kernel" in e.key)),
        # the DP stage's device time and launches (noise draw, K2 and, in
        # an unfused tree, the eager backward pass; K2's among them), and
        # K2's own
        "dp_ms_per_sweep": per_sweep_ms(sum(
            e.time_range.end - e.time_range.start for e in dp)),
        "dp_launches_per_sweep": len(dp) / SWEEPS,
        "dp_k2_launches_per_sweep": sum(
            any(n in e.name for n in K2_KERNELS) for e in dp) / SWEEPS,
        "k2_ms_per_sweep": per_sweep_ms(sum(e.self_device_time_total
                                            for e in k2)),
        # the assignment chain's (K3 / K4, K6 / K7 or K9) device time and
        # launches
        "chain_ms_per_sweep": per_sweep_ms(sum(
            e.self_device_time_total for e in kernels
            if "chain_kernel" in e.key and ITEM_KERNEL not in e.key)),
        "chain_launches_per_sweep": seen.get("chain", 0),
        # K10 / K11, the acoustic-model sweeps' item chain (am_n_iter > 0)
        "item_chain_ms_per_sweep": per_sweep_ms(sum(
            e.self_device_time_total for e in items)),
        "item_chain_launches_per_sweep": sum(e.count for e in items)
        / SWEEPS,
        "item_kernel": item, "am_n_iter": am_n_iter,
        "top_kernels_ms_per_sweep": {
            e.key[:80]: per_sweep_ms(e.self_device_time_total) for e in top},
        "top_ops_ms_per_sweep": {
            e.key: per_sweep_ms(e.device_time_total) for e in ops},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cov", default="full", choices=("fixed", "diag",
                                                     "full"))
    ap.add_argument("--bigram", action="store_true")
    ap.add_argument("--am-n-iter", type=int, default=0,
                    help="acoustic-model sweeps before each sweep (K10; "
                    "K11 with --cov full)")
    ap.add_argument("--kmeans", action="store_true",
                    help="the segmental k-means segmenter (K2, Viterbi)")
    ap.add_argument("--D", type=int, default=13,
                    help="the corpus's embedding width (130: the papers')")
    ap.add_argument("--n-landmarks-max", type=int, default=20,
                    help="the corpus's longest utterance (120: bench.py's "
                    "unigram_fixed_long)")
    ap.add_argument("--root", default=None,
                    help="import segmentalist_torch from this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
    import segmentalist_torch

    here = os.path.realpath(segmentalist_torch.__file__)
    if args.root and not here.startswith(os.path.realpath(args.root)):
        raise SystemExit("profiling: --root takes the script run by its "
                         "path (python segmentalist_torch/utils/"
                         "profiling.py --root DIR): %s was imported already"
                         % here)
    shape = dict(D=args.D, n_landmarks_max=args.n_landmarks_max)
    if args.kmeans:
        seg, _ = bench_kmeans_segmenter(**shape)
    else:
        seg, _ = bench_segmenter(args.cov, args.bigram, **shape)
    out = profile_sweeps(seg, args.am_n_iter)
    out.update(cov=None if args.kmeans else args.cov, bigram=args.bigram,
               kmeans=args.kmeans, **shape,
               device=torch.cuda.get_device_name(0),
               package=os.path.dirname(here))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
