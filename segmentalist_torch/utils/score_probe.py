"""Probe the candidate scorers K1 / K5 on the card: what the compiler made
of them and where their time goes.

    python -m segmentalist_torch.utils.score_probe

Prints, one JSON line each:

- ``ptxas``: registers, spills and static shared memory of every kernel of
  ``fixedvar_score.cu`` / ``diag_score.cu`` (``nvcc -Xptxas -v``);
- ``sass``: each kernel's instruction mix (``cuobjdump -sass``): loads from
  global and shared memory, float operations, special-function (MUFU)
  calls, barriers, shuffles, branches;
- ``active_share``: K1 and K5 (both compositions) at the flagship and long
  shapes with 5 %, 20 %, 60 % and 100 % of the columns active.

Times are CUDA events around 20 back-to-back launches through the C entry
points, per launch (the card stays busy, so they are device time up to the
gaps between launches).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from ..ops import cuda_lib, cuda_score

SHAPES = {"flagship": dict(B=125, N_max=20, W=6, K=1000, D=13),
          "long": dict(B=125, N_max=120, W=6, K=1000, D=130)}
SHARES = (0.05, 0.2, 0.6, 1.0)
# SASS opcodes by class
CLASSES = {"ldg": ("LDG",), "lds": ("LDS",), "sts": ("STS",),
           "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL"),
           "mufu": ("MUFU",), "bar": ("BAR",), "shfl": ("SHFL",),
           "bra": ("BRA",)}


def _nvcc(args):
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *args],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed:\n" + proc.stderr)
    return proc.stderr


def ptxas(src, obj):
    """Per kernel (mangled name): registers, spill bytes, shared memory."""
    err = _nvcc(["-Xptxas", "-v", "-c", "-o", obj, src])
    out, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                 int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def sass_mix(obj):
    """Per kernel: instruction count by class (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(["total", *CLASSES], 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and name:
            op = m.group(1).split(".")[0]
            out[name]["total"] += 1
            for cls, ops in CLASSES.items():
                if op in ops:
                    out[name][cls] += 1
    return out


def events_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def with_share(counts, share, seed):
    """``counts`` with each column kept active with probability ``share``
    (active columns get a count from 1 to 59)."""
    rng = np.random.RandomState(seed)
    c = rng.randint(1, 60, tuple(counts.shape)) \
        * (rng.rand(*counts.shape) < share)
    return torch.as_tensor(c, dtype=torch.int32, device=counts.device)


def scorer(args, diag, exact):
    """K1 (or K5) launched straight through its C entry point."""
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    if diag:
        Xc, prior_c, muT, iv, lpv, v, w, counts, valid_m = args
    else:
        Xc, prior_c, muT, precT, w, counts, valid_m = args
    B, M, D = Xc.shape
    K = w.shape[1]
    out = torch.empty((B, M), device=Xc.device)

    def run():
        if diag:
            err = lib.diag_scores_launch(
                p(Xc), p(prior_c), p(muT), p(iv), p(lpv), p(v), p(w),
                p(counts), p(valid_m), p(out), B, M, D, K, int(exact),
                cuda_lib.stream_of(Xc))
        else:
            err = lib.fixedvar_scores_launch(
                p(Xc), p(prior_c), p(muT), p(precT), p(w), p(counts),
                p(valid_m), p(out), B, M, D, K,
                -0.5 * D * math.log(2 * math.pi), cuda_lib.stream_of(Xc))
        cuda_lib.check(err, "scores")
    return run


def inputs(shape, diag, seed, device="cuda"):
    """K1's (or K5's) arguments at ``shape``: K prototypes, leave-out
    statistics around them and candidates near them, under the profiled
    corpus's prior (:func:`profiling.bench_prior`)."""
    from ..models import components_diag as cdg
    from ..models import components_fixedvar as cfv
    from ..models.fbgmm import log_weights
    from .profiling import bench_prior

    rng = np.random.RandomState(seed)
    B, N_max, W, K, D = (shape[k] for k in ("B", "N_max", "W", "K", "D"))
    dev, f32 = device, torch.float32
    protos = 2.0 * rng.randn(K, D)
    counts = torch.as_tensor(rng.randint(1, 60, (B, K)), dtype=torch.int32,
                             device=dev)
    n = counts.to(f32)[:, None, :]
    mean = torch.as_tensor(protos.T[None] + 0.1 * rng.randn(B, D, K),
                           dtype=f32, device=dev)
    Xc = torch.as_tensor(protos[rng.randint(0, K, (B, N_max * W))]
                         + 0.3 * rng.randn(B, N_max * W, D), dtype=f32,
                         device=dev)
    w = log_weights(counts, 1.0, K, 1.0, include_denominator=True, dtype=f32)
    valid_m = torch.as_tensor(rng.randint(2, N_max + 1, B) * W,
                              dtype=torch.int32, device=dev)
    prior = bench_prior("diag" if diag else "fixed", D, dev)
    if diag:
        muT, iv, lpv, v = cdg.predictive_params_T(
            prior, counts, n * mean, n * (mean * mean + 0.25))
        return [Xc, cdg.log_prior_batch(prior, Xc), muT.contiguous(),
                iv.contiguous(), lpv, v, w, counts, valid_m]
    muT, precT = cfv.predictive_params_T(prior, counts, n * mean)
    return [Xc, cfv.log_prior_batch(prior, Xc), muT.contiguous(),
            precT.contiguous(), w, counts, valid_m]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("score_probe: needs a CUDA card")
    mix = {}
    with tempfile.TemporaryDirectory(prefix="score_probe_") as tmp:
        for src in ("fixedvar_score.cu", "diag_score.cu"):
            obj = os.path.join(tmp, src[:-3] + ".o")
            print(json.dumps({"ptxas": {src: ptxas(
                os.path.join(cuda_lib.CSRC, src), obj)}}), flush=True)
            mix[src] = sass_mix(obj)
    print(json.dumps({"sass": mix}))

    shares = {}
    for name, shape in SHAPES.items():
        fixed, diag = inputs(shape, False, 1), inputs(shape, True, 5)
        for share in SHARES:
            fixed[5] = with_share(fixed[5], share, 3)
            diag[7] = with_share(diag[7], share, 3)
            row = {"K1": events_ms(scorer(fixed, False, False))}
            for exact in (False, True):
                row["K5_exact" if exact else "K5"] = events_ms(
                    scorer(diag, True, exact))
            shares["%s/%.2f" % (name, share)] = row
    print(json.dumps({"active_share": shares,
                      "plan": {n: cuda_score.card_plan(
                          s["D"], s["K"], s["N_max"] * s["W"])._asdict()
                          for n, s in SHAPES.items()},
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
