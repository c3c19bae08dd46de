"""Build and load the port's hand-written CUDA kernels.

All sources under ``segmentalist_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ctypes: one ``nvcc -c``
per ``.cu`` file, all started together, then one link.  The build runs at
first use into the git-ignored ``segmentalist_torch/_build/``, named by a
hash of the sources and flags, so a fresh checkout builds everything on its
first call and later calls reuse the library.

``-fmad=false`` keeps every ``a * b + c`` as two rounded operations, the
same arithmetic as the plain PyTorch versions' separate elementwise kernels,
so a kernel and its plain version can agree bit for bit where their
operation orders match.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but success.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer, and the stream, as c_void_p.
_SIGNATURES = {
    # Xc, prior_c, muT, precT, w, counts, valid_m, out, B, M, D, K, c0,
    # stream
    "fixedvar_scores_launch": [_P] * 8 + [_I] * 4 + [_F, _P],
    # Xc, prior_c, muT, inv_varT, log_prod_var, v, w, counts, valid_m, out,
    # B, M, D, K, exact, stream
    "diag_scores_launch": [_P] * 10 + [_I] * 5 + [_P],
    # K1 / K5 (one template): D, K -> bytes; -> bytes (or minus a CUDA
    # error code)
    "diag_family_smem_bytes": [_I] * 2,
    "diag_family_smem_limit": [],
    # scores, noise, lengths, lpc, alphas, log_prob, bounds, B, N, W, n_min,
    # use_max, temp, staged, warps, stream
    "segment_dp_launch": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    # N, W, staged, noise -> bytes a warp
    "segment_dp_smem_bytes": [_I] * 4,
    # -> bytes (or minus a CUDA error code)
    "segment_dp_smem_limit": [],
    # embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0, p0m0,
    # touched, tab_g, col_g, ks, B, S, D, K, form, threads, alpha_over_K,
    # lms, temp, c0, use_argmax, stream
    "fixedvar_chain_launch": [_P] * 13 + [_I] * 6 + [_F] * 4 + [_I, _P],
    # embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0, p0m0,
    # uni, big, corr_j, corr_i, touched, tab_g, col_g, ks, B, S, D, K, form,
    # threads, a_over_K, a, b_over_K, b, lam, one_minus_lam, lms, temp, c0,
    # stream
    "bigram_fixedvar_chain_launch": [_P] * 17 + [_I] * 6 + [_F] * 9 + [_P],
    # form, bigram, D, S, K -> bytes
    "fixedvar_chain_smem_bytes": [_I] * 5,
    # -> bytes (or minus a CUDA error code)
    "fixedvar_chain_smem_limit": [],
    # embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0, snp0,
    # k0, v0, touched, tab_g, col_g, ks, B, S, D, K, global, threads,
    # alpha_over_K, lms, temp, half_log_pi, use_argmax, stream
    "diag_chain_launch": [_P] * 9 + [_F] * 2 + [_P] * 4 + [_I] * 6
                         + [_F] * 4 + [_I, _P],
    # embeds, Xe, log_prior_e, gumbel, counts, sum_xT, sum_sqT, k0m0, snp0,
    # k0, v0, uni, big, corr_j, corr_i, touched, tab_g, col_g, ks, B, S, D,
    # K, global, threads, a_over_K, a, b_over_K, b, lam, one_minus_lam, lms,
    # temp, half_log_pi, stream
    "bigram_diag_chain_launch": [_P] * 9 + [_F] * 2 + [_P] * 8 + [_I] * 6
                                + [_F] * 9 + [_P],
    # global, bigram, D, S, K -> bytes
    "diag_chain_smem_bytes": [_I] * 5,
    # -> bytes (or minus a CUDA error code)
    "diag_chain_smem_limit": [],
    # X, log_prior, gumbel, k_old, counts, sum_xT, sum_sqT, prec, prec0,
    # p0m0, tab_g, ks, cnt_out, sums_out, probe, n, D, K, cluster,
    # tab_global, threads, alpha_over_K, lms, temp, c0, use_argmax, stream
    "fixedvar_items_launch": [_P] * 15 + [_I] * 6 + [_F] * 4 + [_I, _P],
    # X, log_prior, gumbel, k_old, counts, sum_xT, sum_sqT, k0m0, snp0, gr,
    # k0, v0, tab_g, ks, cnt_out, sums_out, probe, n, D, K, cluster,
    # tab_global, threads, alpha_over_K, lms, temp, half_log_pi,
    # use_argmax, stream
    "diag_items_launch": [_P] * 10 + [_F] * 2 + [_P] * 5 + [_I] * 6
                         + [_F] * 4 + [_I, _P],
    # D, K, cluster, tab_global -> bytes; D, K, cluster -> threads; ->
    # bytes, or the largest cluster (or minus a CUDA error code)
    "fixedvar_items_smem_bytes": [_I] * 4,
    "diag_items_smem_bytes": [_I] * 4,
    "fixedvar_items_threads": [_I] * 3,
    "diag_items_threads": [_I] * 3,
    "fixedvar_items_smem_limit": [],
    "fixedvar_items_max_cluster": [],
    "diag_items_smem_limit": [],
    "diag_items_max_cluster": [],
    # X, log_prior, gumbel, k_old, counts, k0m0, snp0, cterms, k0, v0,
    # sum_x, sum_sq, tab_g, work_g, ks, cnt_out, probe, n, D, K, cluster,
    # tab_global, work_global, threads, alpha_over_K, lms, temp, use_argmax,
    # stream
    "fullcov_items_launch": [_P] * 8 + [_F] * 2 + [_P] * 7 + [_I] * 7
                            + [_F] * 3 + [_I, _P],
    # D, K, cluster, tab_global, work_global -> bytes; D, K, cluster ->
    # threads; -> bytes, or the largest cluster (or minus a CUDA error code)
    "fullcov_items_smem_bytes": [_I] * 5,
    "fullcov_items_threads": [_I] * 3,
    "fullcov_items_smem_limit": [],
    "fullcov_items_max_cluster": [],
    # bad (uint64 count), stream
    "fullcov_items_sqrt_mismatches": [_P, _P],
    # Xc, prior_c, g_{LT, LmuT, ck, vinv, vh}, t_{L, Lmu, ck, vinv, vh},
    # tslot, w, counts, valid_m, out, B, M, D, K, S, rows, stream
    "fullcov_scores_launch": [_P] * 17 + [_I] * 6 + [_P],
    # D, K, rows -> bytes
    "fullcov_scores_smem_bytes": [_I] * 3,
    # -> bytes (or minus a CUDA error code)
    "fullcov_scores_smem_limit": [],
    # embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_invP0, t_ldP0,
    # tk0, g_m, g_invP, g_ldP, k0, v0, half_D, log_pi, recs, Ug, ks, B, S,
    # D, K, T0, stream_form, threads, ring, alpha_over_K, lms, temp,
    # use_argmax, stream
    "fullcov_chain_launch": [_P] * 13 + [_F] * 4 + [_P] * 3 + [_I] * 8
                            + [_F] * 3 + [_I, _P],
    # the same to tk0 .. log_pi, then uni, big, corr_j, corr_i, recs, Ug,
    # ks, B .. ring, a_over_K, a, b_over_K, b, lam, one_minus_lam, lms,
    # temp, stream
    "bigram_fullcov_chain_launch": [_P] * 13 + [_F] * 4 + [_P] * 7
                                   + [_I] * 8 + [_F] * 8 + [_P],
    # stream_form, bigram, D, S, T0, K, ring -> bytes
    "fullcov_chain_smem_bytes": [_I] * 7,
    # -> bytes (or minus a CUDA error code)
    "fullcov_chain_smem_limit": [],
}

# entry points that return something other than a CUDA error code
_RESTYPES = {"diag_family_smem_bytes": ctypes.c_longlong,
             "diag_chain_smem_bytes": ctypes.c_longlong,
             "fixedvar_chain_smem_bytes": ctypes.c_longlong,
             "fixedvar_items_smem_bytes": ctypes.c_longlong,
             "diag_items_smem_bytes": ctypes.c_longlong,
             "fullcov_items_smem_bytes": ctypes.c_longlong,
             "fullcov_chain_smem_bytes": ctypes.c_longlong,
             "fullcov_scores_smem_bytes": ctypes.c_longlong,
             "segment_dp_smem_bytes": ctypes.c_longlong}

build_seconds = None  # wall time of the last nvcc build in this process
# each kernel's launches by the form its launch plan chose, since the last
# reset (``form_launches.clear()``): {"K3": {"global": 8}, ...}; the
# wrappers' own counters count the launches, this says which form ran them
form_launches: dict = {}


def count_form(kernel: str, form: str) -> None:
    """Count one launch of ``kernel`` ("K1" to "K11") in ``form``."""
    by_form = form_launches.setdefault(kernel, {})
    by_form[form] = by_form.get(form, 0) + 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    so = os.path.join(BUILD_DIR, "libsegkernels_%s.so" % h.hexdigest()[:16])
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        t0 = time.time()
        objs = _compile_all(tmp)
        _run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        for o in objs:
            os.remove(o)
        build_seconds = time.time() - t0
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stderr)


def _compile_all(prefix: str) -> list:
    """Compile every ``.cu`` source to an object, all in parallel; returns
    the object paths (removed again if any compile fails)."""
    cu = [p for p in sources() if p.endswith(".cu")]
    objs = ["%s.%s.o" % (prefix, os.path.basename(p)[:-3]) for p in cu]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p, o in zip(cu, objs)]
    stderr = [proc.communicate()[1] for proc in procs]
    failed = ["%s:\n%s" % (os.path.basename(p), err)
              for p, proc, err in zip(cu, procs, stderr) if proc.returncode]
    if failed:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return objs


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError("%s: CUDA error %d" % (name, err))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the kernels take)."""
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s" % (name, t.dtype,
                                                          dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (take the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("no kernel or plain version for device %s" % t.device)
