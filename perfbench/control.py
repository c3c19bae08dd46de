"""The control of a cell's correctness check: the readings of the program
on a dozen seeds or more and, beside them, the reference put in the
program's place in float32 with TF32 matrix products (one step below the
configuration's float32 with TF32 off), judged by the same float64
reference and held to the cell's limits by the run's own comparison
(``control_correct``).  The limits in ``limits/<cell>.json`` are set
between the two.  With ``--fault <name>`` the program runs with that fault
of ``faults.py`` planted underneath, and its readings are the fault's.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n,n,...> [--fault <name>]

One JSON line a seed.  Needs a card; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of faults.py (no control)")
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    run.set_caches(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("control: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    cell = run.Cell(root, run.load(os.path.join(root, "BENCHMARK.json")),
                    args.workload)
    patch = None
    if args.fault:
        import pytest

        from perfbench.faults import FAULTS

        patch = pytest.MonkeyPatch()
        FAULTS[args.fault](patch)
    control = not args.fault
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res, _, readings = run.run_cell(cell, seed, args.seconds, False,
                                        with_control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "attempted": res["attempted"],
                          "correct": res["correct"],
                          "control_correct": res.get("control", {}).get(
                              "correct"),
                          "seconds": time.time() - t0,
                          "readings": readings}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
