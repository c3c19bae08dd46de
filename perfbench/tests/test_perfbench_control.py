"""The control on the card: the reference put in the program's place in
float32 with TF32 matrix products comes out not correct by the run's own
comparison against the cell's limits, where the program comes out
correct, at each cell's widths (D 130, K 1000) on one block of 125
utterances.  Needs a card (marker ``cuda``); the full-size readings
behind the limits come from ``perfbench/control.py`` (see ``PERF.md``)."""

import json
import os

import pytest

import perfbench_tiny as tiny

CELLS = [w["name"] for w in json.load(open(os.path.join(
    tiny.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, tmp_path, name):
    from perfbench import run

    root = tiny.make_root(tmp_path)
    bench = run.load(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pb = os.path.join(root, "perfbench")
    cfg = run.load(os.path.join(tiny.ROOT, conf["file"]))
    with open(os.path.join(pb, "configs", "card.json"), "w") as f:
        json.dump(cfg, f)
    t = run.load(os.path.join(tiny.PERFBENCH, "traffic",
                              w["traffic"] + ".json"))
    t.update(n_utterances=125)
    with open(os.path.join(pb, "traffic", "card.json"), "w") as f:
        json.dump(t, f)
    limits = run.load(os.path.join(tiny.PERFBENCH, "limits", name + ".json"))
    with open(os.path.join(pb, "limits", "card.json"), "w") as f:
        json.dump(limits, f)
    b = run.load(os.path.join(root, "BENCHMARK.json"))
    b["configs"].append(dict(conf, file="perfbench/configs/card.json"))
    b["workloads"] = [{"name": "card", "config": conf["name"],
                       "traffic": "card", "chips": 1, "why": "test"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = run.Cell(root, b, "card")
    res, checks, r = run.run_cell(cell, tiny.SEED, 2.0, False,
                                  with_control=True)
    assert res["correct"], checks
    assert res["control"]["correct"] is False, res["control"]
