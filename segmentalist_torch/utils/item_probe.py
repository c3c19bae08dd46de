"""Probe the FBGMM's item chains on the card: where a step's time goes.

    python -m segmentalist_torch.utils.item_probe [--kernel K11] [--n N]
        [--cluster C] [--breakdown]
    python -m segmentalist_torch.utils.item_probe --kernel K10
        [--family fixed|diag] [--n N] [--breakdown] [--root DIR]

Items as ``chip_smoke.py`` phase 3 builds them (N items around 50
prototypes, each in a uniformly drawn old column, the statistics from
those columns, the bench prior of the family).

K11 (the full family, the default): at D 13 (N 6,149, the flagship
state), D 40 and D 130 (N 300), one launch in four variants, timed by
CUDA events (median of 3 launches after a warm-up): the delete on (the
sequential sweep: two derivations a step) and off (``reassign_items``:
one), each at K 1000 and at K 64 (the items' old columns taken mod 64:
far fewer occupied columns to score).  Prints one JSON line a shape: µs a
step of each variant, the occupied columns at the start, the launch plan
and the card's name and power limit.  ``--cluster C`` forces the plan's
cluster of C CTAs.  ``--breakdown`` adds, at D 13 and D 130, one launch of
the kernel's probe build (``kProbe``; the delete on, K 1000):
``clock64()`` cycles a step of each phase (``PHASES``).  Per CTA the probe
times the add's update warp (lane 0; the CTA form: thread 0) over the
whole step, apart on the steps whose update this CTA owns (the critical
path: "owner", with each phase's share of its step) and on the others
("other": mostly the wait for the owner), and the first scoring thread of
the warp form ("scorer").

K10 (``--family`` fixed or diag): at D 13 (N 6,149) and D 130 (N 300), K
1000, the delete on and off, µs a step by CUDA events around the
wrapper's launch (``cuda_item_chain._launch``), and the plan;
``--cluster C`` forces its C.  ``--breakdown`` adds one launch of its
probe build at each shape (the delete on): ``clock64()`` cycles a step of
each phase (``K10_PHASES``) of lane 0 of every warp, for an update warp
on the steps in which it updates a column ("owner", with each phase's
share), for the scoring warps ("scorer") and for an update warp that
waits ("idle").  ``--root DIR`` imports ``segmentalist_torch``
from another checkout (a parent tree, to compare two versions in one
call; run the probe by its path then, ``python
segmentalist_torch/utils/item_probe.py --root DIR``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = {13: 6149, 40: 300, 130: 300}
K10_SHAPES = {13: 6149, 130: 300}
# K11's probe phases (csrc/fullcov_item_chain.cu, enum Phase)
PHASES = ("scores", "reduce", "stats", "build", "cholesky", "inverse",
          "tables", "wait1", "wait2", "fit", "other")
# K10's probe phases (csrc/item_chain.cuh, enum Phase)
K10_PHASES = ("scores", "update", "fit", "reduce", "wait", "merge",
              "prefetch")


def _inputs(N, K, D, seed=10, family="full"):
    from segmentalist_torch.models import cov_module
    from segmentalist_torch.ops.stats import suff_stats_from_assignments
    from segmentalist_torch.utils.profiling import bench_prior

    rng = np.random.RandomState(seed)
    protos = 3.0 * rng.randn(50, D)
    X = protos[rng.randint(0, 50, N)] + 0.3 * rng.randn(N, D)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    k_old = rng.randint(0, 1000, N)
    noise = -np.log(-np.log(rng.uniform(1e-30, 1.0, (N, 1000))))
    prior = bench_prior(family, D, "cuda")
    out = {}
    for k in (1000, 64):
        ko = torch.as_tensor(k_old % k, dtype=torch.int32, device="cuda")
        out[k] = dict(X=X, log_prior=cov_module(family).log_prior_batch(
            prior, X), noise=torch.as_tensor(noise[:, :k], dtype=torch.float32,
                                             device="cuda").contiguous(),
            k_old=ko, stats=suff_stats_from_assignments(
                X, ko, k, family == "full"), prior=prior, K=k)
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


def _args(d, delete=True):
    from segmentalist_torch.ops import cuda_item_chain as cic

    k_old = d["k_old"] if delete else torch.full_like(d["k_old"], -1)
    return cic.full_chain_inputs(d["X"], d["log_prior"], d["noise"], k_old,
                                 d["stats"], d["prior"], 1.0, d["K"])


def probe(D, N, cluster=None):
    from segmentalist_torch.ops import cuda_item_chain as cic

    out = {"D": D, "N": N}
    for K, d in _inputs(N, 1000, D).items():
        out["occupied_K%d" % K] = int((d["stats"].counts > 0).sum())
        out["plan_K%d" % K] = cic.card_plan("full", D, K, cluster)._asdict()
        for delete in (True, False):
            args = _args(d, delete)
            ms = _ms(lambda: cic._launch_full(*args, cluster=cluster))
            out["us_per_step_K%d_%s" % (K, "delete" if delete
                                        else "no_delete")] = ms * 1e3 / N
    return out


def shares(rows):
    """Cycles a step of each phase from the probe buffer ``rows`` [C, 3,
    len(PHASES) + 1] (per CTA: the owner's steps, the other steps, the
    scoring thread; the last word the steps each row covers): the mean
    owner step and other step over the CTAs, each phase's share of the
    owner step, and the scoring thread's scores a step."""
    rows = rows.astype(np.float64)

    def mean(r):
        steps = r[:, -1].sum()
        return r[:, :-1].sum(0) / max(steps, 1.0)

    owner, other = mean(rows[:, 0]), mean(rows[:, 1])
    total = float(owner.sum())
    out = {"owner": {p: round(float(c), 1) for p, c in zip(PHASES, owner)},
           "other": {p: round(float(c), 1) for p, c in zip(PHASES, other)},
           "share": {p: round(float(c) / total, 4)
                     for p, c in zip(PHASES, owner)},
           "owner_step": round(total, 1),
           "other_step": round(float(other.sum()), 1),
           "owner_steps": int(rows[:, 0, -1].sum())}
    if rows[:, 2, -1].any():
        out["scorer_scores"] = round(float(mean(rows[:, 2])[0]), 1)
    return out


def breakdown(D, N, cluster=None):
    """One launch of K11's probe build (the delete on, K 1000) at D dims
    and N items: :func:`shares` of its probe buffer."""
    from segmentalist_torch.ops import cuda_item_chain as cic

    d = _inputs(N, 1000, D)[1000]
    args = _args(d)
    plan = cic.card_plan("full", D, 1000, cluster)
    buf = torch.zeros((plan.cluster, 3, len(PHASES) + 1), dtype=torch.int64,
                      device="cuda")
    ms = _ms(lambda: cic._launch_full(*args, probe=buf.zero_(),
                                      cluster=cluster), reps=1)
    return {"D": D, "N": N, "plan": plan._asdict(),
            **shares(buf.cpu().numpy()), "probe_us_per_step": ms * 1e3 / N}


def _k10_args(family, d, delete=True):
    from segmentalist_torch.ops import cuda_item_chain as cic

    k_old = d["k_old"] if delete else torch.full_like(d["k_old"], -1)
    return cic.item_chain_inputs(family, d["X"], d["log_prior"], d["noise"],
                                 k_old, d["stats"], d["prior"], 1.0, d["K"])


def k10_probe(family, D, N, cluster=None):
    """K10's µs a step at D dims and N items, K 1000, the delete on and
    off, and its plan (``cluster`` forces C)."""
    from segmentalist_torch.ops import cuda_item_chain as cic

    d = _inputs(N, 1000, D, family=family)[1000]
    force = {} if cluster is None else {"cluster": cluster}
    out = {"kernel": "K10", "family": family, "D": D, "N": N,
           "occupied": int((d["stats"].counts > 0).sum()),
           "plan": cic.card_plan(family, D, 1000, **force)._asdict()}
    for delete in (True, False):
        args = _k10_args(family, d, delete)
        ms = _ms(lambda: cic._launch(*args, **force))
        out["us_per_step_%s" % ("delete" if delete else "no_delete")] = (
            ms * 1e3 / N)
    return out


def k10_shares(rows):
    """Cycles a step of each K10 phase from the probe buffer ``rows`` [C,
    W, 2, len(K10_PHASES) + 1] (per warp: the steps in which it updated a
    column, the other steps; the last word the steps each row covers; the
    last two warps of a CTA update, the others score): the mean step of an
    updating warp ("owner", with each phase's share of it), of a scoring
    warp ("scorer") and of an update warp that waits ("idle")."""
    rows = rows.astype(np.float64)

    def mean(r):
        r = r.reshape(-1, len(K10_PHASES) + 1)
        return r[:, :-1].sum(0) / max(r[:, -1].sum(), 1.0)

    owner = mean(rows[:, -2:, 0])
    total = float(owner.sum())
    out = {"owner": {p: round(float(c), 1)
                     for p, c in zip(K10_PHASES, owner)},
           "share": {p: round(float(c) / total, 4)
                     for p, c in zip(K10_PHASES, owner)},
           "owner_step": round(total, 1),
           "owner_steps": int(rows[:, -2:, 0, -1].sum())}
    for name, r in (("scorer", rows[:, :-2, 1]), ("idle", rows[:, -2:, 1])):
        m = mean(r)
        out[name] = {p: round(float(c), 1) for p, c in zip(K10_PHASES, m)}
        out[name + "_step"] = round(float(m.sum()), 1)
    return out


def k10_breakdown(family, D, N, cluster=None):
    """One launch of K10's probe build (the delete on, K 1000) at D dims
    and N items: :func:`k10_shares` of its probe buffer."""
    from segmentalist_torch.ops import cuda_item_chain as cic

    d = _inputs(N, 1000, D, family=family)[1000]
    args = _k10_args(family, d)
    plan = cic.card_plan(family, D, 1000, cluster)
    buf = torch.zeros((plan.cluster, plan.threads // 32, 2,
                       len(K10_PHASES) + 1), dtype=torch.int64,
                      device="cuda")
    ms = _ms(lambda: cic._launch(*args, probe=buf.zero_(), cluster=cluster),
             reps=1)
    return {"kernel": "K10", "family": family, "D": D, "N": N,
            "plan": plan._asdict(), **k10_shares(buf.cpu().numpy()),
            "probe_us_per_step": ms * 1e3 / N}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="items at every shape (default 6149 at D 13, 300 "
                    "at D 40 and D 130)")
    ap.add_argument("--cluster", type=int, default=None,
                    help="force a cluster of this many CTAs (default: the "
                    "plan's)")
    ap.add_argument("--breakdown", action="store_true",
                    help="also one probe launch at D 13 and D 130: clock64 "
                    "cycles and shares of a step's phases")
    ap.add_argument("--kernel", choices=("K10", "K11"), default="K11")
    ap.add_argument("--family", choices=("fixed", "diag"), default="fixed",
                    help="K10's family")
    ap.add_argument("--root", default=None,
                    help="import segmentalist_torch from this checkout")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.realpath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("item_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import segmentalist_torch

    here = os.path.realpath(segmentalist_torch.__file__)
    if args.root and not here.startswith(os.path.realpath(args.root)):
        raise SystemExit("item_probe: --root takes the probe run by its path "
                         "(python segmentalist_torch/utils/item_probe.py "
                         "--root DIR): %s was imported already" % here)
    if args.kernel == "K10":
        for D, N in K10_SHAPES.items():
            out = k10_probe(args.family, D, args.n or N, args.cluster)
            out.update(card=card, root=os.path.dirname(os.path.dirname(here)))
            print(json.dumps(out), flush=True)
            if args.breakdown:
                out = k10_breakdown(args.family, D, args.n or N,
                                    args.cluster)
                out["card"] = card
                print(json.dumps(out), flush=True)
        return 0
    for D, N in SHAPES.items():
        out = probe(D, args.n or N, args.cluster)
        out["card"] = card
        print(json.dumps(out), flush=True)
        if args.breakdown and D != 40:
            out = breakdown(D, args.n or N, args.cluster)
            out["card"] = card
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
