"""A tiny benchmark tree for the CPU tests: a checkout root in a temporary
directory with its own ``BENCHMARK.json``, configurations (the cells'
configurations at D 6, K 12 and blocks of 4), traffic (10 utterances of
2-9 landmarks), limits, and links to the real readers, counts and
references."""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PERFBENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LIMITS = {"score_err": 1e-3, "path_err": 1e-3, "draw_gap": 0.5,
          "stats_err": 1e-4, "mismatch": 0}
SEED = 2 ** 31 + 77
# each tiny cell takes the limits of the benchmark's cell it stands for
LIMITS_OF = {"tf": "unigram_fixed_d130.flagship",
             "tl": "unigram_fixed_d130.long",
             "tu": "unigram_full_d130.flagship",
             "ta": "unigram_full_d130.flagship"}


def make_root(tmp, link=("reference", "work", "metrics")) -> str:
    root = os.path.join(str(tmp), "checkout")
    pb = os.path.join(root, "perfbench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, d), exist_ok=True)
    for d in link:
        os.symlink(os.path.join(PERFBENCH, d), os.path.join(pb, d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    configs = []
    for fam in ("fixed", "full"):
        with open(os.path.join(PERFBENCH, "configs",
                               "unigram_%s_d130.json" % fam)) as f:
            c = json.load(f)
        c.update(D=6, am_K=12, batch_size=4, name="tiny_" + fam)
        path = "perfbench/configs/tiny_%s.json" % fam
        with open(os.path.join(root, path), "w") as f:
            json.dump(c, f)
        configs.append({"name": "tiny_" + fam, "source": "test",
                        "file": path, "reduced": [], "why": "test"})
    with open(os.path.join(PERFBENCH, "traffic", "flagship.json")) as f:
        t = json.load(f)
    t.update(n_utterances=10, n_landmarks_max=9, K_true=4, warmup_sweeps=1)
    traffic = {"tiny": t, "tinylong": dict(t, n_landmarks_max=14),
               "tinyam": dict(t, init_am_assignments="one-by-one",
                              am_n_iter=1, check_items=5)}
    for name, t in traffic.items():
        with open(os.path.join(pb, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    cells = {"tf": ("tiny_fixed", "tiny"), "tl": ("tiny_fixed", "tinylong"),
             "tu": ("tiny_full", "tiny"), "ta": ("tiny_full", "tinyam")}
    for name in cells:
        with open(os.path.join(PERFBENCH, "limits",
                               LIMITS_OF[name] + ".json")) as f:
            lim = json.load(f)
        with open(os.path.join(pb, "limits", name + ".json"), "w") as f:
            json.dump(lim, f)
    bench["configs"] = configs
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, (c, t) in cells.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def cell(root, name):
    from perfbench import run

    return run.Cell(root, run.load(os.path.join(root, "BENCHMARK.json")),
                    name)


def run_tiny(root, name, seed=SEED, seconds=0.3, full=False, **kw):
    """(result, checks), or with ``full`` also every reading."""
    import torch

    from perfbench import run

    torch.set_num_threads(1)
    out = run.run_cell(cell(root, name), seed, seconds, False,
                       device="cpu", **kw)
    return out if full else out[:2]
