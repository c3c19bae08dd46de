"""The port's demos (``segmentalist_torch/demos.py`` and the modules'
``__main__`` hooks) and examples (``segmentalist_torch/examples``) on the
CPU, and ``demo_components``' printed numbers against the JAX package's.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from segmentalist_tpu import demos as jdemos

from segmentalist_torch import demos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUMBER = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def _skeleton(line):
    """The line without its numbers and its whitespace (numpy pads arrays
    to the widest number)."""
    return re.sub(r"\s", "", _NUMBER.sub("#", line))


@pytest.mark.parametrize("name", list(demos.DEMOS))
def test_demo_runs_on_the_cpu(name, capsys):
    """Each module hook's demo (``python -m <module> --device cpu``)."""
    demos.run_demo(name, ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip()
    assert "nan" not in out


@pytest.mark.parametrize("family", ["fixed", "diag", "full"])
def test_demo_components_matches_jax(family, capsys):
    """The same lines, and every printed number within 1e-5 relative of
    the JAX package's demo."""
    jdemos.demo_components(family)
    want = capsys.readouterr().out.splitlines()
    demos.demo_components(family, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert _skeleton(g) == _skeleton(w), (g, w)
        gn = np.array(_NUMBER.findall(g), dtype=float)
        wn = np.array(_NUMBER.findall(w), dtype=float)
        np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=0, err_msg=g)


def test_segmentation_example_runs_on_the_cpu(capsys):
    from segmentalist_torch.examples import segmentation_example

    f1s = segmentation_example.main(device="cpu")
    assert set(f1s) == {"unigram FBGMM", "segmental k-means", "bigram FBGMM"}
    assert all(0.3 < f <= 1.0 for f in f1s.values()), f1s
    assert "F1=" in capsys.readouterr().out


def test_clustering_example_writes_its_figure(tmp_path):
    pytest.importorskip("matplotlib")
    from segmentalist_torch.examples import clustering_examples

    out = tmp_path / "fig" / "clustering.png"
    log_marg, objective = clustering_examples.main(device="cpu",
                                                   out=str(out))
    assert np.isfinite(log_marg) and np.isfinite(objective)
    assert out.stat().st_size > 0
    assert not clustering_examples.DEFAULT_OUT.startswith(
        os.path.join(ROOT, "examples") + os.sep)


def test_new_modules_import_no_jax_and_no_matplotlib():
    """The demos, the debug and checkpoint utilities and the examples
    import neither JAX nor the JAX package, and matplotlib only when a
    figure is drawn."""
    code = ("import sys; before = set(sys.modules); "
            "import segmentalist_torch.demos, segmentalist_torch.utils.debug, "
            "segmentalist_torch.utils.checkpoint, "
            "segmentalist_torch.examples.segmentation_example, "
            "segmentalist_torch.examples.clustering_examples, "
            "segmentalist_torch.examples.plot_utils; "
            "new = set(sys.modules) - before; "
            "bad = [m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'segmentalist_tpu', 'matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
