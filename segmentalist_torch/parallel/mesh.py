"""Multi-device scale-out over the corpus axis, on ``torch.distributed``.

Counterpart of ``segmentalist_tpu/parallel/mesh.py``.  One process runs
each rank, and every rank builds the same segmenter from the same
arguments and seed; :func:`shard_segmenter` checks that they agree.  The
model state (X, the statistics, ``log_prior_vec``, the assignments, the LM
tables, the k-means state) is replicated: every rank holds it whole and
ends every block with the same bits.  The corpus is split by utterance.

Two modes, the JAX package's:

* the exact mode (:func:`shard_segmenter` alone, the JAX package's GSPMD
  mode): every block's B utterances are split by position, B/n rows a
  rank.  A rank resamples its rows against the replicated state.  The
  block's noise is drawn whole on the replicated generator and each rank
  takes its own rows of it.  Decollision sees the whole block through an
  all-gathered code matrix in block row order.  The block's segments,
  components, boundary rows and DP log probabilities are all-gathered and
  every rank merges the whole block itself, as one device would.  The
  chain is the single-device chain, bit for bit.  Each rank keeps the
  read-only corpus whole (a few MB at the flagship size).
* the per-shard mode (``shard_sweep.use_shard_map_sweep``): each rank
  keeps only its own U/n utterances and resamples them in blocks of B/n;
  the ranks meet in a few reductions a block and one assignment merge a
  sweep.

The utterance axis is padded to a multiple of the mesh size with dead
rows, and ``batch_size`` is rounded up to one, as the JAX package does.

A reduction of floats sums the ranks' contributions in rank order on every
rank (all-gather, then add), never in a backend's own order: every rank
must end with the same bits, on every backend.  Integer reductions use
``all_reduce``, exact in any order.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device="cuda"):
    """A 1-D ``DeviceMesh`` over the default process group, which the
    caller has initialised (one process a rank).

    ``device``: "cuda" takes ``cuda:<local rank>`` (``LOCAL_RANK`` as
    ``torchrun`` sets it, else the global rank); an explicit "cuda:<i>"
    puts the rank on that card (ranks that share one card name it, on a
    gloo group: NCCL refuses two ranks on one device); "cpu" when the
    caller asks for it.  Raises when asked for CUDA without a card.
    ``n_devices``, when given, must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError("n_devices=%d, but the process group has %d ranks"
                         % (n_devices, world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        if index >= torch.cuda.device_count():
            raise RuntimeError("rank %d asks for cuda:%d, but there are %d "
                               "cards" % (dist.get_rank(), index,
                                          torch.cuda.device_count()))
        # set before the mesh, which then keeps it
        torch.cuda.set_device(index)
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


class Shard:
    """A segmenter's rank on the mesh: its collectives, and the state of
    the per-shard mode (off until ``shard_sweep.use_shard_map_sweep``).

    gloo moves CPU tensors only; a CUDA tensor on a gloo group (ranks that
    share one card) is staged through host memory here, explicitly, and
    the kernels still run on the card."""

    def __init__(self, mesh, device: torch.device):
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()
        self.size = mesh.size()
        self.device = device
        self._stage = (device.type == "cuda"
                       and dist.get_backend(self.group) == "gloo")
        self.per_shard = False
        self.gen = None      # per-shard mode: the rank's block-noise generator
        self.updates = []    # per-shard mode: this sweep's assignment updates
        self.u_local = None  # per-shard mode: the utterance rows a rank owns

    # --------------------------------------------------------- collectives

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t``, in rank order."""
        src = t.cpu() if self._stage else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(t.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's integer ``t`` (exact in any order)."""
        if t.is_floating_point():
            raise TypeError("float sums go through sum_ranks")
        buf = (t.cpu() if self._stage else t).clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def sum_ranks(self, tensors) -> list:
        """Each tensor of ``tensors`` summed over the ranks, the same bits
        on every rank: one collective a dtype, an ``all_reduce`` for the
        integer ones, an all-gather added in rank order for the floating
        ones."""
        tensors = list(tensors)
        out = list(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            ids = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = torch.cat([tensors[i].reshape(-1) for i in ids])
            if dtype.is_floating_point:
                parts = self.all_gather(flat)
                total = parts[0]
                for r in range(1, self.size):
                    total = total + parts[r]
            else:
                total = self.all_reduce(flat)
            for i, piece in zip(ids, total.split(
                    [tensors[i].numel() for i in ids])):
                out[i] = piece.reshape(tensors[i].shape)
        return out

    def broadcast(self, tensors, src: int) -> list:
        """``tensors`` as rank ``src`` holds them, on every rank (the others
        pass tensors of the same shapes and dtypes): integer and boolean
        tensors travel together as int32, floating ones together in their
        dtype."""
        tensors = list(tensors)
        out = list(tensors)
        for floating in (False, True):
            ids = [i for i, t in enumerate(tensors)
                   if t.is_floating_point() == floating]
            if not ids:
                continue
            dtype = tensors[ids[0]].dtype if floating else torch.int32
            flat = torch.cat([tensors[i].reshape(-1).to(dtype) for i in ids])
            buf = flat.cpu() if self._stage else flat
            dist.broadcast(buf, src=dist.get_global_rank(self.group, src),
                           group=self.group)
            buf = buf.to(flat.device)
            for i, piece in zip(ids, buf.split(
                    [tensors[i].numel() for i in ids])):
                out[i] = piece.reshape(tensors[i].shape).to(tensors[i].dtype)
        return out

    # ------------------------------------------------------ per-shard mode

    def owner(self, i: int) -> tuple:
        """(rank, local row) of global utterance ``i``."""
        if not 0 <= int(i) < self.u_local * self.size:
            raise IndexError("utterance %d is not in the corpus of %d rows"
                             % (i, self.u_local * self.size))
        return divmod(int(i), self.u_local)

    def monitor(self, seg, i: int) -> tuple:
        """``seg._monitor_device`` of global utterance ``i`` on every rank:
        its owner traces it on its rows and broadcasts the trace (a
        collective: every rank calls it)."""
        src, row = self.owner(i)
        if src == self.rank:
            trace = seg._monitor_device(row)
        else:  # the trace's shapes and dtypes
            N, dev = seg.utterances.N_max, seg.device
            trace = (seg.acoustic_model.X.new_zeros((N, seg.W_dp)),
                     torch.zeros(N, dtype=torch.bool, device=dev),
                     torch.zeros(N, dtype=torch.int32, device=dev))
        return tuple(self.broadcast(trace, src))

    def all_ok(self, flags: torch.Tensor) -> torch.Tensor:
        """Invariant flags (True = OK) that each rank took on its own rows,
        a violation on any rank made one on every rank (a collective)."""
        return self.all_reduce((~flags).to(torch.int32)) == 0

    def gather_utterances(self, utt_ids, compute, blank) -> torch.Tensor:
        """``compute(local rows)`` of the global utterances ``utt_ids``, a
        [len(utt_ids), ...] tensor in their order on every rank: each rank
        computes the ones it owns, and the ranks' rows are gathered (a
        collective).  ``blank(m)`` gives m rows of the same trailing shape
        and dtype (a rank with none computes nothing)."""
        ids = np.asarray(utt_ids, dtype=np.int64)
        if ids.size and not (0 <= ids.min() and ids.max() < self.u_local
                             * self.size):
            raise IndexError("utterance ids outside the corpus of %d rows"
                             % (self.u_local * self.size))
        owner, local = np.divmod(ids, self.u_local)
        per = [np.flatnonzero(owner == r) for r in range(self.size)]
        m = max(len(p) for p in per)
        mine = per[self.rank]
        rows = compute(local[mine]) if len(mine) else blank(0)
        whole = self.all_gather(torch.cat([rows, blank(m - len(mine))]))
        out = blank(len(owner))
        for r, sel in enumerate(per):
            out[torch.as_tensor(sel, device=out.device)] = whole[r, :len(sel)]
        return out

    # --------------------------------------------------------- exact mode

    def own_rows(self, idx_blk: np.ndarray):
        """The exact mode's split of a block: ``(the block padded with -1
        to a multiple of the mesh size, the slice of this rank's rows)``."""
        idx = np.asarray(idx_blk, dtype=np.int64)
        B = -(-idx.shape[0] // self.size) * self.size
        idx = np.concatenate([idx, np.full(B - idx.shape[0], -1, np.int64)])
        b = B // self.size
        return idx, slice(self.rank * b, (self.rank + 1) * b)

    def gather_rows(self, *tensors) -> list:
        """The exact mode's gather of a block: each [B/n, ...] tensor of
        this rank's rows -> the whole block's [B, ...], rows in block order
        (rank r holds rows r B/n ..).  Integer and boolean tensors travel
        together as int32, floating ones together in their dtype."""
        out = list(tensors)
        b = tensors[0].shape[0]
        for floating in (False, True):
            ids = [i for i, t in enumerate(tensors)
                   if t.is_floating_point() == floating]
            if not ids:
                continue
            dtype = tensors[ids[0]].dtype if floating else torch.int32
            packed = torch.cat([tensors[i].reshape(b, -1).to(dtype)
                                for i in ids], dim=1)
            whole = self.all_gather(packed).reshape(-1, packed.shape[1])
            widths = [tensors[i][0].numel() if tensors[i].dim() > 1 else 1
                      for i in ids]
            for i, piece in zip(ids, whole.split(widths, dim=1)):
                t = tensors[i]
                out[i] = piece.reshape((-1,) + tuple(t.shape[1:])).to(t.dtype)
        return out


def _pad_rows(a: torch.Tensor, pad: int, value) -> torch.Tensor:
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), value)])


def rebuild_tables(seg):
    """Re-derive a segmenter's corpus tables from its (padded or local)
    corpus tensors: the DP windows and the candidate tables."""
    from ..segmenters.common import dp_window

    utt = seg.utterances
    seg._seg_ids_dp = dp_window(utt.seg_ids, seg.W_dp)
    seg._seg_durs_dp = dp_window(utt.seg_durations, seg.W_dp)
    seg.refresh_candidates()


def replicated_state(seg) -> dict:
    """The tensors every rank must hold with the same bits: the model
    state, the LM tables, and the replicated generators' states (the
    device generator and the host RNG of the utterance order)."""
    am = seg.acoustic_model
    out = {}
    if hasattr(am, "stats"):
        out.update(counts=am.stats.counts, sum_x=am.stats.sum_x,
                   sum_sq=am.stats.sum_sq, assignments=am.assignments,
                   log_prior_vec=am.log_prior_vec,
                   generator=am.generator.get_state())
    else:  # k-means: the assignments live in the state
        out.update(assignments=am.state.assignments, counts=am.state.counts,
                   sum_x=am.state.sum_x, random_means=am.random_means)
    if hasattr(seg, "lm"):
        out.update(unigram_counts=seg.lm.state.unigram_counts,
                   bigram_counts=seg.lm.state.bigram_counts)
    _, keys, pos, has_gauss, gauss = seg._rng.get_state()
    out["rng"] = torch.from_numpy(np.concatenate(
        [keys.astype(np.float64), [pos, has_gauss, gauss]]))
    return out


def state_digest(seg, corpus: bool = False) -> bytes:
    """SHA-256 of :func:`replicated_state` (and, with ``corpus``, of X and
    the corpus tensors every rank reads)."""
    state = replicated_state(seg)
    if corpus:
        utt = seg.utterances
        state.update(X=seg.acoustic_model.X, seg_ids=utt.seg_ids,
                     seg_durations=utt.seg_durations,
                     lengths=utt.lengths_dev, boundaries=utt.boundaries_dev)
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return h.digest()


def gather_digests(seg, shard: Shard, corpus: bool = False) -> list:
    """Every rank's :func:`state_digest`, in rank order."""
    d = torch.frombuffer(bytearray(state_digest(seg, corpus)),
                         dtype=torch.uint8).to(shard.device)
    return [bytes(r.cpu().numpy()) for r in shard.all_gather(d)]


def shard_segmenter(seg, mesh):
    """Put a segmenter on the mesh in the exact mode (the JAX package's
    ``shard_segmenter``): mutates ``seg`` and returns it.

    Works for ``UnigramAcousticWordseg``, ``BigramAcousticWordseg`` and
    ``SegmentalKMeansWordseg``, built on every rank from the same
    arguments on the mesh's device type; raises unless every rank holds
    the same model state and corpus.  The utterance axis is padded to a
    multiple of the mesh size with dead utterances (``seg_ids`` -1,
    durations NaN, length 0, no boundaries): they are in no block, since
    blocks permute the real ``utterances.D`` ids, and the host boundary
    view slices them off.  ``batch_size`` is rounded up to a multiple of
    the mesh size.  The corpus tables (DP windows, candidate tables) are
    derived anew from the padded corpus."""
    n = mesh.size()
    if seg._shard is not None:
        raise ValueError("the segmenter is on a mesh already")
    if seg.device.type != mesh.device_type:
        raise ValueError("the segmenter lives on %s, the mesh on %s"
                         % (seg.device.type, mesh.device_type))
    if mesh.ndim != 1:
        raise ValueError("a 1-D mesh over the corpus axis is needed, not "
                         "%d-D" % mesh.ndim)
    shard = Shard(mesh, seg.device)
    digests = gather_digests(seg, shard, corpus=True)
    if len(set(digests)) != 1:
        raise ValueError("the ranks' segmenters differ: build every rank's "
                         "from the same arguments and seed")
    if seg.batch_size % n:
        seg.batch_size = -(-seg.batch_size // n) * n
    utt = seg.utterances
    pad = (-utt.seg_ids.shape[0]) % n
    if pad:
        utt.seg_ids = _pad_rows(utt.seg_ids, pad, -1)
        utt.seg_durations = _pad_rows(utt.seg_durations, pad, float("nan"))
        utt.lengths_dev = _pad_rows(utt.lengths_dev, pad, 0)
        utt.boundaries_dev = _pad_rows(utt.boundaries_dev, pad, False)
    rebuild_tables(seg)
    seg._shard = shard
    return seg
