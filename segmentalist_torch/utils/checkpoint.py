"""Checkpoint and resume of a segmenter's sampler state.

Counterpart of ``segmentalist_tpu/utils/checkpoint.py`` in its ``.npz``
layout (``step_%08d.npz`` with ``/``-joined keys, the JAX package's own
fallback when orbax is missing): a checkpoint holds the sampler state, not
the data or the prior, which the segmenter it is restored into already
has.  The keys are the JAX package's

    boundaries, stats/{counts,sum_x,sum_sq}, assignments,
    kmeans_state/{assignments,counts,sum_x}, random_means,
    lm/{unigram_counts,bigram_counts}, host_rng/{keys,pos,has_gauss,cached}

and two that only the port writes, because bit-exact resume needs them:
``torch_generator/{state,device_type}``, the state of the device generator
that draws every sampling noise (``seg._gen``), and
``sweeps_since_resync``, the k-means segmenter's count of sweeps since its
statistics were last rebuilt.  A JAX checkpoint loads too: its threefry
``key`` is ignored, the generator keeps its state, and the k-means counter
starts at 0, where the JAX package's own restore leaves it.

Resume semantics: every sweep draws its utterance order from the host
``RandomState`` and its noise from the device generator, and both are in
the checkpoint, so a segmenter restored onto the same device type
continues the uninterrupted chain bit for bit.  Restored onto another
device type, it gets the state but not the noise stream: a CPU generator
and a CUDA generator are different generators, so the saved generator
state is not restored there (a warning says so).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import interop

logger = logging.getLogger(__name__)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def segmenter_state(seg) -> Dict[str, Any]:
    """The sampler state of any of the three segmenters, as a tree of
    numpy arrays."""
    am = seg.acoustic_model
    state: Dict[str, Any] = {"boundaries": _host(seg.utterances.boundaries_dev)}
    if hasattr(am, "stats"):  # FBGMM-backed segmenters
        state["stats"] = {k: _host(v) for k, v in am.stats._asdict().items()}
        state["assignments"] = _host(am.assignments)
    if hasattr(am, "state"):  # k-means
        state["kmeans_state"] = {k: _host(v)
                                 for k, v in am.state._asdict().items()}
        state["random_means"] = _host(am.random_means)
        state["sweeps_since_resync"] = np.asarray(seg._sweeps_since_resync,
                                                  np.int64)
    if hasattr(seg, "lm"):
        state["lm"] = {k: _host(v) for k, v in seg.lm.state._asdict().items()}
    if hasattr(seg, "_gen"):
        state["torch_generator"] = {
            "state": _host(seg._gen.get_state()),
            "device_type": np.asarray(seg._gen.device.type),
        }
    name, keys, pos, has_gauss, cached = seg._rng.get_state()
    assert name == "MT19937"
    state["host_rng"] = {
        "keys": np.asarray(keys, np.uint32),
        "pos": np.asarray(pos, np.int64),
        "has_gauss": np.asarray(has_gauss, np.int64),
        "cached": np.asarray(cached, np.float64),
    }
    return state


def load_segmenter_state(seg, state: Dict[str, Any]) -> None:
    """Restore a state tree of :func:`segmenter_state` (the port's or the
    JAX package's) into ``seg``, on ``seg``'s device.

    The arrays go through ``interop.load_state`` beside ``seg``'s own data
    and prior, which converts their dtypes and rebuilds what derives from
    them (the prior densities, the candidate tables, the padded assignment
    vector).  The device generator's state is set in place on ``seg._gen``,
    the object the acoustic model draws from too."""
    am = seg.acoustic_model
    arrays = {"X": _host(am.X), "boundaries": state["boundaries"]}
    if "kmeans_state" in state:
        arrays.update(state["kmeans_state"])
        arrays["random_means"] = state["random_means"]
    else:
        arrays.update(state["stats"])
        arrays["assignments"] = state["assignments"]
        arrays.update({k: _host(getattr(am.prior, k))
                       for k in interop.PRIOR_KEYS[am.covariance_type]})
        if "lm" in state:
            arrays.update(state["lm"])
    interop.load_state(seg, arrays)
    if hasattr(seg, "_sweeps_since_resync"):
        seg._sweeps_since_resync = int(state.get("sweeps_since_resync", 0))
    gen = state.get("torch_generator")
    if gen is not None and hasattr(seg, "_gen"):
        saved = str(gen["device_type"])
        if saved == seg._gen.device.type:
            seg._gen.set_state(torch.as_tensor(np.asarray(gen["state"]),
                                               dtype=torch.uint8))
        else:
            logger.warning(
                "the checkpoint's %s generator state is not restored into "
                "a %s generator: the state resumes, its noise stream does "
                "not", saved, seg._gen.device.type)
    if "host_rng" in state:
        h = state["host_rng"]
        seg._rng.set_state((
            "MT19937", np.asarray(h["keys"], np.uint32), int(h["pos"]),
            int(h["has_gauss"]), float(h["cached"]),
        ))


def checkpoint_file(path: str, step: int = 0) -> str:
    """The ``.npz`` file of ``step`` under the checkpoint directory."""
    return os.path.join(os.path.abspath(path), "step_%08d.npz" % step)


def save_checkpoint(path: str, seg, step: int = 0) -> None:
    """Write ``seg``'s state to ``path/step_%08d.npz``."""
    os.makedirs(path, exist_ok=True)
    np.savez(checkpoint_file(path, step), **_flatten(segmenter_state(seg)))


def restore_checkpoint(path: str, seg, step: int = 0) -> None:
    """Restore ``seg`` from ``path/step_%08d.npz`` (written by the port's
    :func:`save_checkpoint` or in the JAX package's npz layout)."""
    with np.load(checkpoint_file(path, step)) as data:
        state = _unflatten(dict(data.items()))
    load_segmenter_state(seg, state)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def _unflatten(flat):
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
