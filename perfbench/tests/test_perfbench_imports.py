"""The benchmark imports no JAX and no JAX package, and its reference
imports nothing of the program (top-level module names compared whole:
the port's name begins with the JAX package's)."""

import ast
import os

from perfbench_tiny import PERFBENCH

JAX_SIDE = {"jax", "jaxlib", "flax", "segmentalist_tpu", "bench",
            "benchmarks"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PERFBENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(imported(p)) & JAX_SIDE) for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_program():
    bad = {p: sorted(m for m in set(imported(p))
                     if m == "segmentalist_torch")
           for p in sources("reference")}
    assert not {p: b for p, b in bad.items() if b}


def test_names_are_compared_whole():
    # the port's top-level name begins with the JAX package's
    assert "segmentalist_torch" not in JAX_SIDE
    assert "segmentalist_tpu" in JAX_SIDE
