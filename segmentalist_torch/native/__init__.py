"""ctypes bindings for the native host-side corpus operations.

Compiles the port's own ``corpus_ops.cpp`` (beside this module; a byte-for-
byte copy of the JAX package's ``segmentalist_tpu/native/corpus_ops.cpp``)
with ``g++`` into the port's git-ignored build directory, keyed by a hash of
the source.  Every entry point returns None when no toolchain is available,
and the callers then take their numpy fallbacks, as in
``segmentalist_tpu/native/__init__.py``.

The random boundary initialisation draws from the library's own xorshift
RNG, so with the same C++ source the same seed gives the same initial
segmentation in both packages (the numpy fallback draws other boundaries).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "corpus_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# The Makefile's flags without -march=native, so a built library runs on any
# x86-64 host (the integer RNG and copies give the same results either way).
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        with open(SOURCE, "rb") as f:
            src = f.read()
    except OSError as e:
        logger.info("native corpus_ops source unavailable (%s); "
                    "using numpy fallbacks", e)
        return None
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, "libcorpus_ops_%s.so" % tag)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, SOURCE], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            logger.info("native corpus_ops build unavailable (%s); "
                        "using numpy fallbacks", e)
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.init_boundaries_random.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, u8p,
    ]
    lib.init_boundaries_random.restype = None
    lib.segmented_embeds.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    lib.segmented_embeds.restype = None
    lib.pack_dense.argtypes = [
        i64p, f64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, f64p,
    ]
    lib.pack_dense.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def init_boundaries_random(lengths: np.ndarray, vec_ids: np.ndarray,
                           n_max: int, p_boundary_init: float,
                           n_slices_min: int, n_slices_max: int,
                           seed: int) -> Optional[np.ndarray]:
    """Native rejection-resampled random boundary init; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    lengths = np.ascontiguousarray(lengths, np.int64)
    vec_ids = np.ascontiguousarray(vec_ids, np.int64)
    n_utt = lengths.shape[0]
    out = np.zeros((n_utt, n_max), np.uint8)
    lib.init_boundaries_random(
        lengths, vec_ids, n_utt, n_max, float(p_boundary_init),
        int(n_slices_min), int(n_slices_max), int(seed) or 1, out,
    )
    return out.astype(bool)


def segmented_embeds(boundaries: np.ndarray, vec_ids: np.ndarray,
                     lengths: np.ndarray) -> Optional[np.ndarray]:
    """[U, N_max] ids of every utterance's current segments, -2 padded."""
    lib = _load()
    if lib is None:
        return None
    boundaries = np.ascontiguousarray(boundaries, np.uint8)
    vec_ids = np.ascontiguousarray(vec_ids, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n_utt, n_max = boundaries.shape
    out = np.empty((n_utt, n_max), np.int64)
    lib.segmented_embeds(boundaries, vec_ids, lengths, n_utt, n_max, out)
    return out


def pack_dense(vec_ids: np.ndarray, durations: np.ndarray,
               lengths: np.ndarray, n_max: int, W: int):
    """Dense windowed ``(seg_ids, seg_durs)`` [U, N_max, W]; None if
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    vec_ids = np.ascontiguousarray(vec_ids, np.int64)
    durations = np.ascontiguousarray(durations, np.float64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n_utt = lengths.shape[0]
    seg_ids = np.empty((n_utt, n_max, W), np.int64)
    seg_durs = np.empty((n_utt, n_max, W), np.float64)
    lib.pack_dense(vec_ids, durations, lengths, n_utt, n_max, W,
                   seg_ids, seg_durs)
    return seg_ids, seg_durs
