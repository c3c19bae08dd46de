"""The port's profiling hooks (``segmentalist_torch/utils/profiling.py``:
``trace``, ``annotate``, ``device_timer``), the counterparts of the JAX
package's ``segmentalist_tpu/utils/profiling.py:27-49``, on the CPU."""

import glob
import os

import torch

from segmentalist_torch.utils import profiling


def test_trace_writes_a_trace_of_the_block(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    files = glob.glob(os.path.join(str(tmp_path), "*.json*"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_annotate_names_a_span_inside_the_trace(tmp_path):
    a = torch.ones(8)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("oracle span"):
            a.add(1.0)
    keys = [e.key for e in prof.key_averages()]
    assert "oracle span" in keys
    with open(glob.glob(os.path.join(str(tmp_path), "*.json*"))[0]) as f:
        assert "oracle span" in f.read()


def test_device_timer_returns_the_result_and_seconds_a_call():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    x = torch.arange(4.0)
    out, sec = profiling.device_timer(fn, x, n_iter=7, scale=2.0)
    assert torch.equal(out, x * 2.0)
    assert len(calls) == 8  # the warm-up and n_iter timed calls
    assert sec >= 0.0
    assert profiling._cuda_devices((x, {"k": [x]}, out)) == set()
