"""The multi-device dry run, and the launcher of its ranks (the JAX
package's ``__graft_entry__.dryrun_multichip``, ``__graft_entry__.py:58-180``).

    python -m segmentalist_torch.parallel.dryrun --ranks 2 --device cpu

:func:`launch` runs a function on every rank of a new process group, one
spawned process a rank, and fails when any rank fails.
:func:`dryrun_multichip` runs on it the JAX package's scenarios on an
uneven corpus of 2n + 3 utterances: the exact mode with the unigram
segmenter (fixed variance); the per-shard mode with the unigram segmenter
(fixed variance, full covariance), the bigram one (fixed variance) and
segmental k-means.  After every sweep each rank checks that the
statistics equal a rebuild from the assignments, the LM tables a recount
of the transcripts, and that every rank holds the same replicated state.

Spawned ranks import this module: it imports torch and numpy only.  Under
``torchrun`` a program initialises the process group itself and calls
``mesh.make_mesh`` (NCCL, one card a rank).
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import gc
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from .mesh import gather_digests, make_mesh, shard_segmenter
from .shard_sweep import gather_boundaries, use_shard_map_sweep

FAMILIES = ("unigram_fixed", "unigram_diag", "unigram_full", "bigram",
            "bigram_diag", "bigram_full", "kmeans")


# ------------------------------------------------------------- launcher

def launch(fn, world_size: int, args=(), device="cuda",
           timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks and return each
    rank's return value, in rank order.

    One spawned process a rank, in a process group over a file in a
    temporary directory, with a 1-D mesh over it (``mesh.make_mesh``).
    ``device``: "cuda" (the default), one card a rank (NCCL); one card
    "cuda:<i>" that every rank shares (gloo: NCCL refuses two ranks on one
    device); or, when the caller asks for it, "cpu" (gloo; one intra-op
    thread a rank).  Without a card a CUDA device raises, before any rank
    starts.  ``fn`` must be importable (a
    module-level function of a module that spawned processes import) and
    its value picklable.

    Raises when a rank fails (with its traceback) or when the ranks have
    not all ended ``timeout`` seconds after the start; every collective of
    the group fails after ``timeout`` too.  Every process it started has
    ended when it returns or raises.  On CUDA the kernels are built here,
    before any rank starts, so that no two ranks build them at once."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None and world_size > torch.cuda.device_count():
            raise ValueError(
                "%d ranks, %d cards: name one card (e.g. cuda:0) for the "
                "ranks to share" % (world_size, torch.cuda.device_count()))
        from ..ops import cuda_lib

        cuda_lib.library()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="segtorch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, tmp, str(dev), timeout,
                                   args))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            waiting = {p.sentinel: r for r, p in enumerate(procs)}
            while waiting:
                left = deadline - time.monotonic()
                ready = multiprocessing.connection.wait(list(waiting),
                                                        timeout=max(left, 0))
                if not ready:
                    raise TimeoutError("ranks %s did not end within %.0f s"
                                       % (sorted(waiting.values()), timeout))
                for s in ready:
                    r = waiting.pop(s)
                    procs[r].join()
                    if procs[r].exitcode != 0:
                        raise RuntimeError("rank %d of %d failed (exit code "
                                           "%s):\n%s" % (
                                               r, world_size,
                                               procs[r].exitcode,
                                               _read(tmp, r, "err")))
            out = []
            for r in range(world_size):
                with open(os.path.join(tmp, "rank%d.pkl" % r), "rb") as f:
                    out.append(pickle.load(f))  # written by our own rank
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _read(tmp, rank, ext):
    path = os.path.join(tmp, "rank%d.%s" % (rank, ext))
    text = ""
    if os.path.exists(path):
        with open(path, errors="replace") as f:
            text = f.read()
    return text or "(nothing on stderr: the process ended before writing)"


def _rank_main(fn, rank, world_size, tmp, device, timeout, args):
    # The rank's stderr, file descriptor 2 itself, goes to rank<r>.err:
    # an abort in C++ (a backend's own threads) leaves its message there,
    # and faulthandler the Python stacks at the signal.
    err = open(os.path.join(tmp, "rank%d.err" % rank), "a")
    os.dup2(err.fileno(), 2)
    faulthandler.enable(err, all_threads=True)
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    backend = "nccl" if dev.type == "cuda" and dev.index is None else "gloo"
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "init"),
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    failed, mesh, value = False, None, None
    try:
        mesh = make_mesh(world_size, device=device)
        # Every rank is connected before any runs, and has run before any
        # closes its connections: a rank that tears its group down while a
        # peer still connects or reads makes the peer fail ("Connection
        # closed by peer").
        _barrier()
        value = fn(mesh, *args)
        with open(os.path.join(tmp, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(value, f)
        _barrier()
    except BaseException:
        err.write(traceback.format_exc())
        err.flush()
        failed = True
    mesh = value = None
    # The segmenters fn built hold the group in reference cycles (their
    # Shard, their closures).  Freed here, they leave the group to
    # destroy_process_group, which joins its threads; left to the
    # interpreter's exit, the group's destructor ran there and aborted
    # ("terminate called without an active exception").
    gc.collect()
    dist.destroy_process_group()
    if failed:
        raise SystemExit(1)  # the traceback is written once


def _barrier():
    """A barrier of the default group (NCCL: on this rank's card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def mesh_device(mesh) -> torch.device:
    """The device of this rank of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ------------------------------------------------------------ scenarios

def build_segmenter(family: str = "unigram_fixed", n_utterances: int = 16,
                    batch_size: int = 8, seed: int = 0, device="cpu"):
    """A toy segmenter (D 10, K 8, spans of up to 3 slices) of ``family``
    (:data:`FAMILIES`): the JAX package's ``_build_segmenter``
    (``__graft_entry__.py:13-37``, "unigram_fixed") and
    ``tests/test_parallel.py``'s ``_build_family`` (the others;
    "unigram_diag" takes the bigram diag family's prior).  The embeddings
    are float64 on the CPU, float32 (what the kernels take) on a card."""
    from .. import (FBGMM, NIW, BigramAcousticWordseg, FixedVarPrior,
                    SegmentalKMeansWordseg, UnigramAcousticWordseg)
    from ..utils.synth import synthetic_corpus

    if family not in FAMILIES:
        raise ValueError("unknown family %r" % (family,))
    D = 10
    mats, vec_ids, durs, lms = synthetic_corpus(
        n_utterances=n_utterances, n_landmarks_max=6, D=D, K_true=4,
        n_slices_max=3, seed=seed)[:4]
    if torch.device(device).type == "cuda":
        mats = {k: v.astype(np.float32) for k, v in mats.items()}
    corpus = dict(embedding_mats=mats, vec_ids_dict=vec_ids,
                  durations_dict=durs, landmarks_dict=lms,
                  p_boundary_init=0.5, n_slices_max=3,
                  batch_size=batch_size, seed=seed, device=device)
    if family == "kmeans":
        return SegmentalKMeansWordseg(am_K=8, **corpus)
    cov = family.split("_")[1] if "_" in family else "fixed"
    if cov == "fixed":
        prior = FixedVarPrior.create(0.05 * np.ones(D), np.zeros(D),
                                     np.ones(D))
    elif cov == "diag":
        prior = NIW.create(np.zeros(D), 1.0, D + 3, 0.5 * np.ones(D))
    else:
        prior = NIW.create(np.zeros(D), 1.0, D + 3,
                           0.5 * np.eye(D) + 0.05 * np.ones((D, D)))
    if family.startswith("bigram"):
        return BigramAcousticWordseg(
            am_K=8, am_param_prior=prior, covariance_type=cov,
            lm_params={"type": "smooth", "intrp_lambda": 0.1, "a": 1.0,
                       "b": 1.0},
            fb_type="unigram", beta_sent_boundary=-1, **corpus)
    return UnigramAcousticWordseg(
        FBGMM, am_alpha=1.0, am_K=8, am_param_prior=prior,
        covariance_type=cov,
        beta_sent_boundary=2.0 if cov == "full" else -1, **corpus)


def consistency(seg) -> dict:
    """The replicated state against a rebuild: ``counts_equal`` (the
    counts equal the assignments' exactly), ``sum_rel_err`` (the largest
    |sum - rebuilt| over the largest |rebuilt|, sum_x and sum_sq) and, for
    a bigram segmenter, ``lm_equal`` (the LM tables equal a recount of the
    transcripts: a collective in the per-shard mode)."""
    from ..models.bigram_lm import add_block_counts, empty_lm_state
    from ..models.kmeans import kmeans_state_from_assignments
    from ..ops.stats import suff_stats_from_assignments

    am = seg.acoustic_model
    if hasattr(am, "stats"):
        st = am.stats
        rebuilt = suff_stats_from_assignments(am.X, am.assignments, am.K_max,
                                              am.full_cov)
        pairs = [(st.sum_x, rebuilt.sum_x), (st.sum_sq, rebuilt.sum_sq)]
    else:
        st = am.state
        rebuilt = kmeans_state_from_assignments(am.X, st.assignments,
                                                am.K_max)
        pairs = [(st.sum_x, rebuilt.sum_x)]
    out = {"counts_equal": bool(torch.equal(st.counts, rebuilt.counts)),
           "sum_rel_err": max(
               float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in pairs)}
    if hasattr(seg, "lm"):
        ts = seg._all_transcripts()
        fresh = add_block_counts(
            empty_lm_state(seg.lm.K, seg.device), ts,
            torch.ones(ts.shape[0], dtype=torch.bool, device=seg.device))
        out["lm_equal"] = all(bool(torch.equal(a, b))
                              for a, b in zip(seg.lm.state, fresh))
    return out


def sweep_once(seg) -> dict:
    """One sweep (``segment`` for k-means, ``gibbs_sample`` else)."""
    if hasattr(seg.acoustic_model, "stats"):
        return seg.gibbs_sample(1)
    return seg.segment(1)


def run_sweeps(mesh, family: str, n_utterances: int, batch_size: int,
               seed: int, sweeps: int, mode: str = "exact",
               fb_type=None) -> dict:
    """A rank's part of ``sweeps`` sweeps of a toy segmenter
    (:func:`build_segmenter`) on ``mesh``, in the exact mode or, with
    ``mode="per_shard"``, the per-shard one.  Returns the records, the
    final assignments and whole boundaries, the padded corpus size and
    rounded batch size, and after every sweep :func:`consistency` and
    every rank's state digest."""
    if mode not in ("exact", "per_shard"):
        raise ValueError(mode)
    seg = build_segmenter(family, n_utterances, batch_size, seed,
                          mesh_device(mesh))
    if fb_type is not None:
        seg.set_fb_type(fb_type)
    shard_segmenter(seg, mesh)
    u_pad = int(seg.utterances.seg_ids.shape[0])
    if mode == "per_shard":
        use_shard_map_sweep(seg, mesh)
    out = {"u_pad": u_pad, "batch_size": seg.batch_size, "records": [],
           "consistency": [], "digests": []}
    for _ in range(sweeps):
        out["records"].append(sweep_once(seg))
        out["consistency"].append(consistency(seg))
        out["digests"].append(gather_digests(seg, seg._shard))
    utt = seg.utterances
    out["assignments"] = seg.acoustic_model.assignments.cpu().numpy().copy()
    out["boundaries"] = (gather_boundaries(seg) if mode == "per_shard"
                         else utt.boundaries)
    out["rows"] = int(utt.seg_ids.shape[0])          # corpus rows held here
    out["rows_live"] = int((utt.lengths_dev > 0).sum())  # of them real
    return out


def check_run(out: dict, what: str):
    """Raise unless a :func:`run_sweeps` result holds: finite records,
    statistics equal to their rebuild (counts exactly, sums to 1e-5
    relative), LM tables equal to the recount, every rank's state the
    same after every sweep."""
    for i, (rec, c, d) in enumerate(zip(out["records"], out["consistency"],
                                        out["digests"])):
        vals = rec.get("log_marg", rec.get("sum_neg_sqrd_norm"))
        if not np.all(np.isfinite(vals)):
            raise RuntimeError("%s sweep %d: non-finite record" % (what, i))
        if not c["counts_equal"] or c["sum_rel_err"] > 1e-5:
            raise RuntimeError("%s sweep %d: statistics differ from their "
                               "rebuild: %s" % (what, i, c))
        if not c.get("lm_equal", True):
            raise RuntimeError("%s sweep %d: the LM tables differ from the "
                               "recount" % (what, i))
        if len(set(d)) != 1:
            raise RuntimeError("%s sweep %d: the ranks' states differ"
                               % (what, i))


def shard_sweep_from_state(mesh, family: str, n_utterances: int,
                           batch_size: int, seed: int, state: dict, blocks,
                           noise, temps) -> dict:
    """One per-shard sweep of given blocks and noise from a given state,
    on this rank: a toy segmenter (:func:`build_segmenter`) takes ``state``
    (``interop.load_state``), is sharded and switched to the per-shard
    sweep, which then runs this rank's ``blocks[:, rank]`` of the
    [n_blocks, n, B/n] layout with this rank's ``noise[rank]`` (a
    (dp_noise, chain_noise) pair of numpy arrays a block) at ``temps``
    (anneal, assign).  Returns the assignments, this rank's boundary rows,
    the statistics and the log probability."""
    from ..interop import load_state
    from .shard_sweep import (build_bigram_shard_sweep,
                              build_unigram_shard_sweep)

    dev, r = mesh_device(mesh), mesh.get_rank()
    seg = build_segmenter(family, n_utterances, batch_size, seed, dev)
    load_state(seg, state)
    use_shard_map_sweep(shard_segmenter(seg, mesh), mesh)
    sweep = (build_bigram_shard_sweep(seg, mesh, False)
             if hasattr(seg, "lm") else build_unigram_shard_sweep(seg, mesh))[0]
    lp = sweep(np.asarray(blocks)[:, r], *temps, noise=[
        tuple(torch.as_tensor(a, device=dev) for a in pair)
        for pair in noise[r]])
    am = seg.acoustic_model
    return {"assignments": am.assignments.cpu().numpy(),
            "boundaries": seg.utterances.boundaries_dev.cpu().numpy(),
            "stats": [t.cpu().numpy() for t in am.stats],
            "log_prob": float(lp)}


def shard_surface(mesh, family: str, n_utterances: int, batch_size: int,
                  seed: int, state: dict, monitored, poisoned: int,
                  noise=None) -> dict:
    """What the per-shard mode reads of the corpus, on this rank: a toy
    segmenter (:func:`build_segmenter`) takes ``state``
    (``interop.load_state``), is sharded and switched to the per-shard
    sweep, then gives (collectives all):

    - ``traces``: the monitor traces of the utterances ``monitored``;
    - ``flags``: the validate flags, and ``poisoned_flags`` with utterance
      ``poisoned``'s final boundary cleared on its owner;
    - ``scores`` (unigram and bigram): the batch scores of every
      utterance, and ``scores_order`` those of a shuffled order;
    - ``debug`` (the unigram driver and k-means, the drivers with a
      debug-only flag; else None): the state after one debug-only sweep of
      utterance ``monitored[-1]`` (``gibbs_sample(1, monitor_i,
      debug_gibbs_only)`` on this rank's ``noise[rank]``, a list of (dp,
      chain) numpy pairs, when given; ``segment(1, monitor_i,
      segment_debug_only)`` for k-means);
    - ``records`` and ``log``: ``gibbs_sample(2, monitor_i=0,
      validate=True)`` (``segment`` for k-means) and the monitor lines it
      logs;
    - ``raised`` (the drivers with a debug-only flag): the error of a
      validated debug-only sweep of ``monitored[-1]`` with ``poisoned``
      poisoned again (its owner's rows only)."""
    import logging

    from ..interop import load_state
    from ..utils.debug import ValidationError

    dev = mesh_device(mesh)
    seg = build_segmenter(family, n_utterances, batch_size, seed, dev)
    load_state(seg, state)
    use_shard_map_sweep(shard_segmenter(seg, mesh), mesh)
    sh, utt = seg._shard, seg.utterances
    kmeans = family == "kmeans"
    gibbs = (seg.segment if kmeans else seg.gibbs_sample)
    debug_flag = ("segment_debug_only" if kmeans else
                  None if hasattr(seg, "lm") else "debug_gibbs_only")
    out = {"traces": [tuple(t.cpu().numpy() for t in seg._monitor(i))
                      for i in monitored],
           "flags": seg._validate().cpu().numpy()}
    if not kmeans:
        score = (seg.get_vec_embed_log_probs_unigram_all if hasattr(seg, "lm")
                 else seg.get_vec_embed_log_probs_all)
        out["scores"] = score()
        out["scores_order"] = score(np.random.RandomState(seed).permutation(
            n_utterances))

    def poison():
        src, row = sh.owner(poisoned)
        if src == sh.rank:
            utt.boundaries_dev[row, int(utt.lengths_dev[row]) - 1] = False

    saved = utt.boundaries_dev.clone()
    poison()
    out["poisoned_flags"] = seg._validate().cpu().numpy()
    utt.boundaries_dev = saved.clone()

    out["debug"] = out["raised"] = None
    if debug_flag is not None:
        run = seg._run_blocks
        if noise is not None:
            mine = [tuple(torch.as_tensor(a, device=dev) for a in pair)
                    for pair in noise[sh.rank]]
            seg._run_blocks = lambda blocks, *a, **k: run(blocks, *a,
                                                         noise=mine, **k)
        gibbs(1, monitor_i=monitored[-1], **{debug_flag: True})
        seg._run_blocks = run
        am = seg.acoustic_model
        st = am.state if kmeans else am.stats
        out["debug"] = {"assignments": (st.assignments if kmeans
                                        else am.assignments).cpu().numpy(),
                        "stats": [t.cpu().numpy() for t in (
                            (st.counts, st.sum_x) if kmeans else st)],
                        "boundaries": gather_boundaries(seg)}

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("segmentalist_torch")
    handler, level = Keep(level=logging.DEBUG), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        out["records"] = gibbs(2, monitor_i=0, validate=True)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    out["log"] = [ln for ln in lines if "monitor" in ln]
    if debug_flag is not None:
        poison()
        try:
            gibbs(1, monitor_i=monitored[-1], validate=True,
                  **{debug_flag: True})
        except ValidationError as e:
            out["raised"] = str(e)
    return out


def decollide_rows(mesh, new_ks, new_mask, lo_counts, counts0):
    """This rank's rows of the gathered decollision of a block whose [B, S]
    / [B, K] rows the ranks hold in order, B/n each: the rank's rows of
    ``decollide_new_components(..., comm=shard)``."""
    from ..segmenters.common import decollide_new_components
    from .mesh import Shard

    dev = mesh_device(mesh)
    sh = Shard(mesh, dev)
    b = np.asarray(new_ks).shape[0] // sh.size
    rows = slice(sh.rank * b, (sh.rank + 1) * b)
    return decollide_new_components(
        *(torch.as_tensor(np.asarray(a)[rows], device=dev)
          for a in (new_ks, new_mask, lo_counts)),
        torch.as_tensor(counts0, device=dev), comm=sh).cpu().numpy()


def shard_checks(mesh, n_utterances: int = 13, batch_size: int = 5) -> dict:
    """What ``shard_segmenter`` does besides the sweeps, on this rank: the
    rounded batch size, the rows of the corpus tables it derives anew
    (stale ones dropped first), the rows of the host boundary view; the
    error it raises when the ranks' segmenters differ (each rank's built
    with its rank as the seed); the error ``make_mesh`` raises when asked
    for CUDA without a card (None where there is one)."""
    dev = mesh_device(mesh)
    seg = build_segmenter("unigram_fixed", n_utterances, batch_size, 0, dev)
    tables = ("_seg_ids_dp", "_seg_durs_dp", "_cand_X", "_cand_lp")
    for name in tables:
        setattr(seg, name, None)
    shard_segmenter(seg, mesh)
    out = {"batch_size": seg.batch_size,
           "rows": {name: int(getattr(seg, name).shape[0])
                    for name in tables},
           "host_boundary_rows": int(seg.utterances.boundaries.shape[0]),
           "mismatch": None, "cuda_mesh": None}
    other = build_segmenter("unigram_fixed", n_utterances, batch_size,
                            mesh.get_rank(), dev)
    try:
        shard_segmenter(other, mesh)
    except ValueError as e:
        out["mismatch"] = str(e)
    if not torch.cuda.is_available():
        try:
            make_mesh(device="cuda")
        except RuntimeError as e:
            out["cuda_mesh"] = str(e)
    return out


def abort_rank(mesh, text: str) -> None:
    """Write ``text`` (and this rank) to file descriptor 2 below Python,
    then abort: a rank that dies in C, whose message the launcher must
    keep."""
    os.write(2, ("%s (rank %d)\n" % (text, mesh.get_rank())).encode())
    os.abort()


def collective_on(mesh, ranks) -> None:
    """An all-reduce that only ``ranks`` enter, the others returning at
    once: the group must fail it (a peer gone, or its timeout), not
    hang."""
    if mesh.get_rank() in ranks:
        t = torch.ones(1, device=mesh_device(mesh))
        dist.all_reduce(t, group=mesh.get_group())


def run_jobs(mesh, jobs) -> list:
    """Several rank functions of this module in one spawn: ``jobs`` lists
    (name, args) pairs; returns their values in order."""
    allowed = {f.__name__: f for f in (run_sweeps, shard_sweep_from_state,
                                       shard_surface, decollide_rows,
                                       shard_checks)}
    return [allowed[name](mesh, *args) for name, args in jobs]


DRYRUN_SCENARIOS = (("unigram_fixed", "exact", 0),
                    ("unigram_fixed", "per_shard", 0),
                    ("unigram_full", "per_shard", 1),
                    ("bigram", "per_shard", 2),
                    ("kmeans", "per_shard", 3))


def _dryrun_rank(mesh):
    n = mesh.size()
    out = {}
    for family, mode, seed in DRYRUN_SCENARIOS:
        what = "%s (%s mode)" % (family, mode)
        res = run_sweeps(mesh, family, 2 * n + 3, n, seed, 1, mode)
        check_run(res, what)
        out[what] = res
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> list:
    """The dry run on ``n_devices`` ranks (see the module docstring), on
    the card unless ``device`` is "cpu" or one shared "cuda:<i>": each
    rank's results, in rank order; raises when a check fails on any rank,
    and without a card when ``device`` is a CUDA one."""
    return launch(_dryrun_rank, n_devices, device=device, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (a card a rank; the default), "cuda:<i>" '
                    '(one card the ranks share) or "cpu"')
    args = ap.parse_args(argv)
    t0 = time.time()
    res = dryrun_multichip(args.ranks, args.device)
    for what, r in res[0].items():
        print("%s: %d utterances (padded to %d), batch %d, record %s" % (
            what, 2 * args.ranks + 3, r["u_pad"], r["batch_size"],
            {k: v for k, v in r["records"][-1].items()
             if k in ("log_marg", "sum_neg_sqrd_norm", "components")}))
    print("dry run on %d ranks (%s): ok in %.1f s"
          % (args.ranks, args.device, time.time() - t0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
