"""Run one cell of the benchmark of ``segmentalist_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``configs/<name>.json``: the driver, the family,
its prior and settings) and a traffic mix (``traffic/<mix>.json``: the
corpus and how the run drives it).  From ``--seed`` the run makes the
corpus and seeds the sampler; it warms up, then runs whole sweeps
through the driver's entry point for ``--seconds`` (each timed on the
host clock and ended by a synchronize, the sweep in progress finished),
and prints the end-to-end metrics (:func:`end_to_end`); with ``--trace 1``
it then profiles a short slice of sweeps and prints the per-layer metrics
(``metrics/<name>.py``) instead.  Last, one check sweep on noise the
benchmark hands the program is held to the plain reference
(``reference/<driver>_<family>.py``) within the cell's limits
(``limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (sweeps), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
with its limit (also the last lines of standard error).  Without a card,
with fewer cards than the cell asks for, or with JAX loaded once the
window has closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "segmentalist_tpu")


def set_caches(root: str):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own library builds into ``segmentalist_torch/_build``
    there)."""
    base = os.path.join(root, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and the metrics it reports."""

    def __init__(self, root: str, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit("run: no workload %r in BENCHMARK.json" % name)
        self.root, self.name, self.w = root, name, by_name[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.w["config"]]
        self.cfg = load(os.path.join(root, conf["file"]))
        here = os.path.join(root, "perfbench")
        self.traffic = load(os.path.join(here, "traffic",
                                         self.w["traffic"] + ".json"))
        lim = os.path.join(here, "limits", name + ".json")
        self.limits = load(lim) if os.path.exists(lim) else None

        def mine(m):
            return name in m.get("workloads", [name])

        self.e2e = [m for m in bench["end_to_end"] if mine(m)]
        moved = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in bench["per_layer"]
                          if mine(m) and m["moves"] in moved]


class Window:
    """The host-clock readings of a run."""

    def __init__(self):
        self.sweep_s, self.elapsed_s = [], 0.0
        self.f1 = self.setup_s = float("nan")
        self.failed = 0


def end_to_end(run: Window) -> dict:
    """The end-to-end metrics of a run by name: ``ms_per_sweep``, the
    window's elapsed time to the end of its last sweep over its sweeps;
    ``sweep_ms_p95``, the 95th percentile of every sweep's time (linear
    between order statistics); ``boundary_f1``, the segmentation's
    word-boundary F1 at the window's end; ``setup_s``, process start to
    the first timed sweep."""
    import numpy as np

    return {"ms_per_sweep": 1e3 * run.elapsed_s / len(run.sweep_s),
            "sweep_ms_p95": 1e3 * float(np.percentile(run.sweep_s, 95)),
            "boundary_f1": run.f1, "setup_s": run.setup_s}


def compare(limits, readings: dict, failed: int):
    """(correct, [(name, value, limit)]): each number of ``limits`` read
    from ``readings`` (missing: the largest float) against its limit;
    correct where none passes its limit and no sweep failed."""
    limits = dict(limits or {}, check_failed=0)
    checks = [(name, readings.get(name, sys.float_info.max), lim)
              for name, lim in sorted(limits.items())]
    ok = all(v <= lim for _, v, lim in checks)
    return bool(failed == 0 and limits != {"check_failed": 0} and ok), checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", with_control: bool = False):
    """One run of ``cell``; returns (result dict, [(name, value, limit)]
    of the numbers compared, every reading of the check).  With
    ``with_control`` the check also puts the control in the program's
    place, and ``result["control"]`` says whether it passes the same
    limits."""
    import torch

    from perfbench import build, capture, find, synth
    from perfbench import trace as tracing
    from perfbench.reference import common

    cfg, traffic = cell.cfg, cell.traffic
    cuda = device.startswith("cuda")
    corpus = build.make_corpus(cfg, traffic, seed)
    tables = common.Tables(corpus, cfg["n_slices_max"])
    system = build.make_system(cfg, traffic, corpus, seed, device)

    def sweep():
        return build.sweep(system, cfg, traffic)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(traffic["warmup_sweeps"]):
        sweep()
    sync()
    run = Window()
    run.setup_s = time.time() - T_START
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            rec = sweep()
            sync()
            ok = math.isfinite(build.sweep_objective(rec, cfg))
        except Exception as e:  # a sweep that raises counts as failed
            print("run: sweep raised %r" % (e,), file=sys.stderr)
            ok = None
        te = time.perf_counter()
        run.sweep_s.append(te - ts)
        if not ok:
            run.failed += 1
        if ok is None or te - t0 >= seconds:
            break
    run.elapsed_s = time.perf_counter() - t0
    bounds = system.utterances.boundaries
    pred = {lab: bounds[u] for u, lab in enumerate(tables.labels)}
    run.f1 = synth.boundary_f_score(pred, tables.truth)[2]
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.w["chips"],
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if cuda else 0)}
    metrics, breakdown = {}, None
    if not trace:
        values = end_to_end(run)
        for m in cell.e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    elif run.failed == 0:
        readers = {m["name"]: find.module(cell.root, "metrics", m["name"])
                   for m in cell.per_layer}
        ranges = {}
        for r in readers.values():
            ranges.update(r.RANGES)
        ctx = tracing.profiled_slice(
            cell.root, system, sweep, traffic["trace_sweeps"], ranges,
            tables, cfg, run.elapsed_s / len(run.sweep_s))
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = ctx.breakdown()
        del ctx
    readings = {}
    if run.failed == 0:
        ref = find.module(cell.root, "reference", "%s_%s" % (
            cfg["driver"], cfg["family"]))
        try:
            cap = capture.check_sweep(system, sweep, ref.CAPTURE,
                                      tables.N_max, tables.W, seed,
                                      traffic["check_items"])
            if not math.isfinite(build.sweep_objective(cap["objective"],
                                                       cfg)):
                run.failed += 1
        except Exception:  # a check sweep that raises is not passed
            traceback.print_exc()
            cap = None
        del system
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        try:
            if cap is None:
                raise RuntimeError("run: the check sweep failed")
            readings = dict(ref.judge(cfg, tables, cap, device, seed),
                            check_failed=0)
            if with_control:
                ctl = ref.control(cfg, tables, cap, device, seed)
                readings.update({"control." + k: v for k, v in ctl.items()})
        except Exception:  # a check that cannot be made is not passed
            traceback.print_exc()
            readings = {"check_failed": 1}
    # a reading that is not finite (a fault) prints as the largest float,
    # so that the line stays plain JSON
    readings = {k: (v if math.isfinite(v) else sys.float_info.max)
                for k, v in readings.items()}
    correct, checks = compare(cell.limits, readings, run.failed)
    result = {"correct": correct, "attempted": len(run.sweep_s),
              "failed": run.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if with_control:
        # the control in the program's place, held to the same limits
        ctl = {k[len("control."):]: v for k, v in readings.items()
               if k.startswith("control.")}
        ctl_ok, ctl_checks = compare(cell.limits, dict(ctl, check_failed=0)
                                     if ctl else {}, run.failed)
        result["control"] = {"correct": ctl_ok, "checks": {
            n: {"value": v, "limit": lim} for n, v, lim in ctl_checks}}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks, readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        root = ROOT
    set_caches(root)
    sys.path.insert(0, root)
    import torch

    cell = Cell(root, load(os.path.join(root, "BENCHMARK.json")),
                args.workload)
    chips = cell.w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("run: needs %d CUDA card(s); found %d" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks, readings = run_cell(cell, args.seed, args.seconds,
                                        bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print("run: %s loaded in the benchmark's process" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for name in sorted(set(readings) - {c[0] for c in checks}):
        print("reading %s %r (not compared)" % (name, readings[name]),
              file=sys.stderr)
    for name, v, lim in checks:
        print("check %s %r limit %r" % (name, v, lim), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
