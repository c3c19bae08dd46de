"""A configuration, a traffic mix, limits and metric files placed in a
fresh checkout are found by their names, with no edit to the harness."""

import json
import os

import numpy as np

import perfbench_tiny as tiny


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and limits under new names, and a
    cell that names them in BENCHMARK.json: the run finds and drives
    them."""
    root = tiny.make_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "tiny_fixed.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_fixed_b5", batch_size=5)
    with open(os.path.join(pb, "configs", "tiny_fixed_b5.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    traffic.update(n_utterances=7, n_landmarks_max=5)
    with open(os.path.join(pb, "traffic", "tinyshort.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "limits", "tf.json")) as f:
        limits = json.load(f)
    with open(os.path.join(pb, "limits", "new.json"), "w") as f:
        json.dump(limits, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_fixed_b5", "source": "test",
                             "file": "perfbench/configs/tiny_fixed_b5.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new", "config": "tiny_fixed_b5",
                               "traffic": "tinyshort", "chips": 1,
                               "why": "test"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = tiny.cell(root, "new")
    assert cell.cfg["batch_size"] == 5 and cell.traffic["n_utterances"] == 7
    assert cell.limits == limits
    res, _ = tiny.run_tiny(root, "new")
    assert res["correct"]
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}


def test_work_and_metric_files_are_found(tmp_path):
    from perfbench import find, work

    root = tiny.make_root(tmp_path, link=("reference",))
    pb = os.path.join(root, "perfbench")
    os.makedirs(os.path.join(pb, "work"))
    os.makedirs(os.path.join(pb, "metrics"))
    with open(os.path.join(pb, "work", "diag_score.py"), "w") as f:
        f.write("from ..peaks import Work\nLEVEL = 'block'\n\n"
                "def count(s):\n    return Work(flops=2.0 * s['D'])\n")
    with open(os.path.join(pb, "metrics", "diag_flops.py"), "w") as f:
        f.write("RANGES = {}\n\ndef read(ctx):\n"
                "    return ctx.work('score').flops\n")
    mod = work.find(root, "diag", "score")
    assert mod.count({"D": 3}).flops == 6.0
    assert work.find(root, "diag", "chain") is None

    class Ctx:
        def work(self, stage):
            return work.find(root, "diag", stage).count({"D": 5})

    assert find.module(root, "metrics", "diag_flops").read(Ctx()) == 10.0


def test_every_cell_of_the_benchmark_has_its_files():
    from perfbench import find, run

    bench = run.load(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    window = run.Window()
    window.sweep_s, window.elapsed_s = [1.0], 1.0
    for w in bench["workloads"]:
        cell = run.Cell(tiny.ROOT, bench, w["name"])
        assert cell.limits is not None, w["name"]
        find.module(tiny.ROOT, "reference", "%s_%s" % (
            cell.cfg["driver"], cell.cfg["family"]))
        assert {m["name"] for m in cell.e2e} <= set(run.end_to_end(window))
        for m in cell.per_layer:
            find.module(tiny.ROOT, "metrics", m["name"])
    assert np.all([c["file"].startswith("perfbench/configs/")
                   for c in bench["configs"]])
