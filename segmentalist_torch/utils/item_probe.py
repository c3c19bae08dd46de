"""Probe the full family's item chain K11 on the card: where a step's time
goes.

    python -m segmentalist_torch.utils.item_probe [--n N]

Items as ``chip_smoke.py`` phase 3 builds them (N items around 50
prototypes, each in a uniformly drawn old column, the statistics from
those columns, the bench NIW prior), at D 13 (N 6,149, the flagship
state), D 40 and D 130 (N 300).  For each shape K11 runs as one launch in
four variants, timed by CUDA events (median of 3 launches after a
warm-up): the delete on (the sequential sweep: two derivations a step)
and off (``reassign_items``: one), each at K 1000 and at K 64 (the items'
old columns taken mod 64: far fewer occupied columns to score).  Prints
one JSON line a shape: µs a step of each variant, the occupied columns at
the start, and the card's name and power limit.  The differences bound
what the scores of ~K occupied columns and one derivation cost a step.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

SHAPES = {13: 6149, 40: 300, 130: 300}


def _inputs(N, K, D, seed=10):
    from segmentalist_torch.models import cov_module
    from segmentalist_torch.ops.stats import suff_stats_from_assignments
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    protos = 3.0 * rng.randn(50, D)
    X = protos[rng.randint(0, 50, N)] + 0.3 * rng.randn(N, D)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    k_old = rng.randint(0, 1000, N)
    noise = -np.log(-np.log(rng.uniform(1e-30, 1.0, (N, 1000))))
    prior = bench_prior("full", D, "cuda")
    out = {}
    for k in (1000, 64):
        ko = torch.as_tensor(k_old % k, dtype=torch.int32, device="cuda")
        out[k] = dict(X=X, log_prior=cov_module("full").log_prior_batch(
            prior, X), noise=torch.as_tensor(noise[:, :k], dtype=torch.float32,
                                             device="cuda").contiguous(),
            k_old=ko, stats=suff_stats_from_assignments(X, ko, k, True),
            prior=prior, K=k)
    return out


def _ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
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


def probe(D, N):
    from segmentalist_torch.ops import cuda_item_chain as cic

    out = {"D": D, "N": N}
    for K, d in _inputs(N, 1000, D).items():
        out["occupied_K%d" % K] = int((d["stats"].counts > 0).sum())
        for delete in (True, False):
            k_old = d["k_old"] if delete else torch.full_like(d["k_old"], -1)
            ms = _ms(lambda: cic.item_chain(
                "full", d["X"], d["log_prior"], d["noise"], k_old, d["stats"],
                d["prior"], 1.0, K))
            out["us_per_step_K%d_%s" % (K, "delete" if delete
                                        else "no_delete")] = ms * 1e3 / N
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="items at every shape (default 6149 at D 13, 300 "
                    "at D 40 and D 130)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("item_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for D, N in SHAPES.items():
        out = probe(D, args.n or N)
        out["card"] = card
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
