"""Probe the assignment chains K3 / K4 / K6 / K7 and the segmentation DP
K2 on the card: where a launch's time goes, as a function of the chain
length.

    python -m segmentalist_torch.utils.chain_probe [--kernels K2,K3,K4] [--root DIR] [--ptxas]

Every utterance of a launch gets exactly n valid segments (n = 1, 2, 5,
10, 20), at the flagship shape (B 125, S 20, K 1000, D 13) and at D 130
(S 120), with leave-out statistics like a sweep's (~60 % of the columns
occupied) and, for K4 / K7, an LM table that counts each utterance's old
pairs.  For each (kernel, shape) it prints one JSON line: the device ms a
launch at each n (``torch.profiler``, the kernel's records alone, mean
over 10 launches), and the least-squares line through them: the slope is
the time of one dependent step, the intercept the init and launch.

K2 (the whole DP in one launch; the forward filter alone in a tree from
before the fusion) runs B 125 utterances with a window of W 6, every
utterance as long as the launch (N = 10, 20, 40, 80, 120 nodes), scores
shaped like a sweep's; its slope is the time of a dependent forward step.
Each of its launches is followed by a kernel that spins a known number of
cycles (``torch.cuda._sleep``), whose device time gives the SM clock the
launches ran at, so a step's time converts to cycles.

``--root DIR`` imports ``segmentalist_torch`` from another checkout (a
parent tree unpacked beside this one), whose chain wrappers take the same
arguments, so two versions can be probed in one call; run the file by its
path then (``python segmentalist_torch/utils/chain_probe.py --root DIR``),
since ``-m`` imports this checkout's package first.  ``--ptxas`` first
prints, for each kernel of ``fixedvar_chain.cu``, ``diag_chain.cu`` and
``forward_dp.cu``, its registers, spills and static shared memory
(``nvcc -Xptxas -v``) and its SASS instruction mix (``cuobjdump -sass``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SHAPES = {"flagship": dict(B=125, S=20, K=1000, D=13),
          "long": dict(B=125, S=120, K=1000, D=130)}
LENGTHS = (1, 2, 5, 10, 20)
REPS = 10
DP_B, DP_W = 125, 6
DP_LENGTHS = (10, 20, 40, 80, 120)
SPIN_CYCLES = 20_000


def _inputs(rng, B, S, K, D, n, diag, dev):
    """Chain inputs with n valid segments an utterance: (data, prior, lm)
    for the wrappers of K3 / K4 (``diag`` False) or K6 / K7."""
    import torch
    from segmentalist_torch.models import components_diag as cdg
    from segmentalist_torch.models import components_fixedvar as cfv
    from segmentalist_torch.models.bigram_lm import transcript_pairs_batch
    from segmentalist_torch.utils.profiling import bench_prior

    counts = rng.randint(1, 60, (B, K)) * (rng.rand(B, K) > 0.4)
    protos = rng.randn(K, D) * 3.0
    c = counts[..., None].astype(np.float64)
    sx = c * protos[None] + np.sqrt(np.maximum(c, 1)) * rng.randn(B, K, D)
    sx *= c > 0
    embeds = np.where(np.arange(S)[None, :] < n,
                      np.arange(B * S).reshape(B, S), -1)
    Xe = protos[rng.randint(0, K, (B, S))] + 0.3 * rng.randn(B, S, D)
    Xe[rng.rand(B, S) < 0.1] = 5.0 * rng.randn(D)  # some far-off segments
    gumbel = -np.log(-np.log(rng.uniform(1e-30, 1.0, (B, S, K))))
    old = np.where(embeds >= 0, rng.randint(0, K, (B, S)), -1)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=dev).contiguous()
    prior = bench_prior("diag" if diag else "fixed", D, dev)
    Xe_t = as_t(Xe)
    cnt = as_t(counts, torch.int32)
    lpe = (cdg if diag else cfv).log_prior_batch(prior, Xe_t)
    data = [as_t(embeds, torch.int32), Xe_t, lpe, as_t(gumbel), cnt,
            as_t(sx.transpose(0, 2, 1))]
    if diag:
        sq = sx * sx / np.maximum(c, 1) + np.maximum(c - 1, 0) * (
            1.0 + 0.1 * np.abs(rng.randn(B, K, D)))
        data.append(as_t(sq.transpose(0, 2, 1)))
    pj, pi = transcript_pairs_batch(as_t(old, torch.int32))
    big = (rng.rand(K, K) < 0.003) * rng.randint(1, 5, (K, K))
    ok = (pj >= 0).cpu().numpy()
    np.add.at(big, (pj.cpu().numpy()[ok], pi.cpu().numpy()[ok]), 1)
    return data, prior, (cnt, as_t(big, torch.int32), pj, pi)


def _runner(kernel, data, prior, lm, K):
    """A call of the kernel's wrapper on these inputs."""
    from segmentalist_torch.ops import cuda_chain, cuda_diag_chain

    lm_kw = dict(alpha_a=1.0, intrp_lambda=0.1, b_smooth=1.0, K=K)
    if kernel in ("K3", "K4"):
        pr = (prior.var, prior.var_0, prior.mu_0, 0.8)
        if kernel == "K3":
            return lambda: cuda_chain.fixedvar_chain(*data, *pr, alpha=1.0,
                                                     K=K)
        return lambda: cuda_chain.bigram_fixedvar_chain(*data, *pr, *lm,
                                                        **lm_kw)
    pr = (prior.m_0, float(prior.k_0), float(prior.v_0), prior.S_0, 0.8)
    if kernel == "K6":
        return lambda: cuda_diag_chain.diag_chain(*data, *pr, alpha=1.0,
                                                  K=K)
    return lambda: cuda_diag_chain.bigram_diag_chain(*data, *pr, *lm,
                                                     **lm_kw)


def _dp_runner(N, dev):
    """A call of K2's wrapper at length N, and the kernel's name: the whole
    DP where the imported tree has it, else the forward filter alone.
    Scores: duration-scaled log marginals (~ -20 a slice), -inf past the
    utterance start, 5 % missing; standard Gumbel noise."""
    import torch
    from segmentalist_torch.ops import cuda_dp, dp

    rng = np.random.RandomState(N)
    B, W = DP_B, DP_W
    dur = np.arange(1, W + 1)[None, None, :] * 10.0
    s = (-2.0 + 0.5 * rng.randn(B, N, W)) * dur
    t, w = np.arange(N)[None, :, None], np.arange(W)[None, None, :]
    s[(w > t) | (rng.rand(B, N, W) < 0.05)] = -np.inf
    f32 = torch.float32
    scores = torch.as_tensor(s, dtype=f32, device=dev)
    noise = torch.as_tensor(-np.log(-np.log(rng.uniform(1e-30, 1, s.shape))),
                            dtype=f32, device=dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    lpc = torch.full((), np.log(0.9), dtype=f32, device=dev)
    if hasattr(cuda_dp, "segment_dp"):
        return (lambda: cuda_dp.segment_dp(scores, lengths, lpc, 1.0, 0,
                                           False, noise), "segment_dp_kernel")
    rev = dp._rev_mask_scores(scores, 0)
    return (lambda: cuda_dp.forward_alphas(rev, lengths, lpc),
            "forward_alphas_kernel")


def device_ms(fn, kernel="chain_kernel", spin=False):
    """Mean device ms a launch of the kernel whose records' names hold
    ``kernel`` (K9's left out) over REPS calls of ``fn``; with ``spin``,
    each call followed by a spin of SPIN_CYCLES cycles, and (ms, the
    spin's ms) returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        fn()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)

    call()
    torch.cuda.synchronize()
    for _ in range(3):  # a window can come back without kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        mean = []
        for name in (kernel, "spin_kernel")[:1 + spin]:
            hits = [e for e in prof.key_averages() if name in e.key
                    and "fullcov" not in e.key]
            n = sum(e.count for e in hits)
            if n > REPS // 2:
                mean.append(sum(e.self_device_time_total
                                for e in hits) / n / 1e3)
        if len(mean) == 1 + spin:
            return tuple(mean) if spin else mean[0]
    return (None, None) if spin else None


def _fit(ms):
    """µs a step and the intercept (ms) of the least-squares line through
    the lengths' device ms."""
    ns = [n for n in ms if ms[n] is not None]
    slope, icpt = np.polyfit(ns, [ms[n] for n in ns], 1)
    return {"device_ms": ms, "us_per_step": float(slope) * 1e3,
            "intercept_ms": float(icpt)}


def probe(kernel, shape):
    B, S, K, D = (shape[k] for k in ("B", "S", "K", "D"))
    ms = {}
    for n in LENGTHS:
        rng = np.random.RandomState(n)
        data, prior, lm = _inputs(rng, B, S, K, D, n,
                                  kernel in ("K6", "K7"), "cuda")
        ms[n] = device_ms(_runner(kernel, data, prior, lm, K))
    return _fit(ms)


def probe_dp():
    """K2 over DP_LENGTHS, with the SM clock of its launches."""
    ms, spins = {}, []
    for N in DP_LENGTHS:
        fn, kernel = _dp_runner(N, "cuda")
        ms[N], spin_ms = device_ms(fn, kernel, spin=True)
        if spin_ms is not None:
            spins.append(spin_ms)
    out = dict(_fit(ms), kernel_name=kernel)
    mhz = SPIN_CYCLES / (np.mean(spins) * 1e3) if spins else None
    out.update(sm_mhz=mhz, cycles_per_step=(
        None if mhz is None else out["us_per_step"] * mhz))
    return out


def ptxas_report():
    """One JSON line a source (the chains', K2's): per kernel its ptxas
    resources and SASS mix (the helpers of ``score_probe``)."""
    import tempfile

    from segmentalist_torch.ops import cuda_lib
    from segmentalist_torch.utils import score_probe

    with tempfile.TemporaryDirectory() as tmp:
        for src in ("fixedvar_chain.cu", "diag_chain.cu", "forward_dp.cu"):
            obj = os.path.join(tmp, src + ".o")
            res = score_probe.ptxas(os.path.join(cuda_lib.CSRC, src), obj)
            mix = score_probe.sass_mix(obj)
            print(json.dumps({"source": src, "kernels": {
                name: dict(res.get(name, {}), sass=mix.get(name))
                for name in res}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="K3,K4,K6,K7")
    ap.add_argument("--root", default=None,
                    help="import segmentalist_torch from this checkout")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the kernels' resources and SASS mix first")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chain_probe: needs a CUDA card")
    import segmentalist_torch

    here = os.path.realpath(segmentalist_torch.__file__)
    if args.root and not here.startswith(os.path.realpath(args.root)):
        raise SystemExit("chain_probe: --root takes the probe run by its "
                         "path (python segmentalist_torch/utils/"
                         "chain_probe.py --root DIR): %s was imported "
                         "already" % here)

    if args.ptxas:
        ptxas_report()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for kernel in args.kernels.split(","):
        if kernel == "K2":
            print(json.dumps(dict(
                probe_dp(), kernel=kernel, shape="B %d, W %d" % (DP_B, DP_W),
                card=smi.splitlines()[0],
                package=segmentalist_torch.__file__)), flush=True)
            continue
        for name, shape in SHAPES.items():
            out = {"kernel": kernel, "shape": name, "D": shape["D"],
                   "card": smi.splitlines()[0],
                   "package": segmentalist_torch.__file__}
            out.update(probe(kernel, shape))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
