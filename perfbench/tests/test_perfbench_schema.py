"""The result line's schema, and what a run prints without a card."""

import json
import subprocess
import sys

import perfbench_tiny as tiny


def test_result_line_schema(tmp_path):
    root = tiny.make_root(tmp_path)
    res, checks = tiny.run_tiny(root, "tf")
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name in ("ms_per_sweep", "sweep_ms_p95", "boundary_f1", "setup_s"):
        m = line["metrics"][name]
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert set(line["checks"]) == {n for n, _, _ in checks}
    for n, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    with open(tiny.PERFBENCH + "/limits/" + tiny.LIMITS_OF["tf"]
              + ".json") as f:
        assert set(json.load(f)) <= set(line["checks"])


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "unigram_fixed_d130.flagship", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_tree_of_the_benchmark_alone_fails(tmp_path):
    import shutil

    shutil.copytree(tiny.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT + "/BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "unigram_fixed_d130.flagship", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
