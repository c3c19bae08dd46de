"""The profiling hooks of the port, the bench builders and the launch
counters' reader.

The hooks of the JAX package's ``utils/profiling.py`` (``trace``,
``annotate``, ``device_timer``) are here, for any code of the port:
:func:`trace` captures a host and device profile of a block into a
directory (a Chrome trace, for TensorBoard or Perfetto), :func:`annotate`
(``utils/tracing.py``) names a host span inside it, and
:func:`device_timer` times a call with one synchronisation of its tensors'
card before and one after.  An operator captures the program's own spans
(``seg.sweep``, ``seg.block`` and its five stages, ``seg.sync.*``; the
tree in ``utils/tracing.py``) the same way:

    with profiling.trace("logdir"):
        seg.gibbs_sample(3)

gives one Chrome trace with the ``seg.*`` spans on the host's timeline,
above the kernels they launched.  A benchmark cell's breakdown by those
spans comes from ``python3 perfbench/run.py --workload <cell> --trace 1``.

The bench builders (:func:`bench_prior`, :func:`bench_corpus`,
:func:`bench_segmenter`, :func:`bench_kmeans_segmenter`) build the JAX
package's ``bench.py`` corpus and segmenters (1000 synthetic utterances
with N_max 20, D 13 and 50 true words, ``am_K=1000``, ``batch_size=125``,
and the priors of ``bench.py:379-411`` and
``benchmarks/all_models.py:124-171``), at another width or longest
utterance on request; tests, the kernel probes and ``chip_smoke.py`` build
from them.  :func:`launch_counts` reads the kernel wrappers' launch
counters.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

BENCH_LM = {"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0}


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
    """A named host span inside a :func:`trace`: ``utils/tracing.py``'s
    :func:`~segmentalist_torch.utils.tracing.annotate`, the program's own."""
    from segmentalist_torch.utils.tracing import annotate as span

    return span(name)


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


def launch_counts() -> dict:
    """The wrappers' launch counters of the scorers, K2, the chains, K10,
    K11 and the merge kernel."""
    counts = {}
    for mod, names in (("cuda_score", ("launches", "diag_launches",
                                       "diag_exact_launches")),
                       ("cuda_fullcov_score", ("launches",)),
                       ("cuda_dp", ("launches",)),
                       ("cuda_chain", ("launches", "bigram_launches")),
                       ("cuda_diag_chain", ("launches", "bigram_launches")),
                       ("cuda_fullcov_chain", ("launches",
                                               "bigram_launches")),
                       ("cuda_item_chain", ("launches", "full_launches")),
                       ("cuda_merge", ("launches",))):
        m = importlib.import_module("segmentalist_torch.ops." + mod)
        for n in names:
            counts["%s.%s" % (mod, n)] = getattr(m, n)
    return counts
