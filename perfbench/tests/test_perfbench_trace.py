"""The traced slice's attribution of device work to ranges by launch
correlation, its busy time and breakdown, on synthetic profiler events;
a wrapped range with no device work fails the run, and the readers leave
a metric out rather than read 0."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

import perfbench_tiny as tiny
from perfbench import trace
from perfbench.metrics import (chain_roofline, idle_share,
                               kernels_per_block, scorer_roofline)


def ev(name, dev, start, end, id_=0, annotation=False):
    return NS(name=name, device_type=NS(name=dev), id=id_,
              time_range=NS(start=start, end=end),
              is_user_annotation=annotation)


def events():
    return [
        # host: the scorer range launches kernel 1, the chain range kernel
        # 2 and a copy; bookkeeping launches kernel 4; kernel 3 outside
        ev("scorer", "CPU", 0, 10), ev("cudaLaunchKernel", "CPU", 2, 3, 1),
        ev("chain", "CPU", 20, 30), ev("cuLaunchKernel", "CPU", 21, 22, 2),
        ev("cudaMemcpyAsync", "CPU", 23, 24, 5),
        ev("aten::nonzero", "CPU", 31, 60),
        ev("cudaLaunchKernel", "CPU", 35, 36, 3),
        ev(trace.BOOKKEEPING, "CPU", 40, 45),
        ev("cudaLaunchKernel", "CPU", 41, 42, 4),
        # device
        ev("scores_kernel", "CUDA", 5, 15, 1),
        ev("fixedvar_chain_kernel", "CUDA", 25, 45, 2),
        ev("Memcpy DtoD", "CUDA", 45, 47, 5),
        ev("elementwise", "CUDA", 70, 80, 3),
        ev("bookkeeping_copy", "CUDA", 48, 50, 4),
        ev("chain", "CUDA", 25, 45, 0, annotation=True)]


def test_attribution_busy_and_breakdown():
    ctx = trace.Ctx(tiny.ROOT, "fixed", 1, 2, 100e-6, 1e-3, events(),
                    {"scorer": [], "chain": []}, {"block": [], "am": []})
    assert [e.name for e in ctx.by_range["scorer"]] == ["scores_kernel"]
    assert sorted(e.name for e in ctx.by_range["chain"]) == [
        "Memcpy DtoD", "fixedvar_chain_kernel"]
    assert "bookkeeping_copy" not in [e.name for e in ctx.device]
    # busy: [5, 15] + [25, 47] + [70, 80] us
    assert ctx.busy_s == pytest.approx(42e-6)
    assert ctx.range_s("chain") == pytest.approx(22e-6)
    assert kernels_per_block.read(ctx) == 3 / 2
    assert idle_share.read(ctx) == pytest.approx(58.0)
    b = ctx.breakdown()
    assert b["device_ops"][0] == ["fixedvar_chain_kernel", 20e-6]
    # the longest gap, [47, 70], opens inside aten::nonzero on the host
    assert b["idle_gaps"][0] == ["aten::nonzero", 23e-6]


def test_roofline_reads_work_over_range_time():
    s = {"D": 2, "K": 5, "W": 2, "K_occ": 3, "lengths": np.array([3]),
         "rows": np.array([5]), "occ": np.array([3]),
         "touched": np.array([1]), "steps": np.array([2]), "slot_steps": 2,
         "claimed": 0}
    ctx = trace.Ctx(tiny.ROOT, "fixed", 1, 1, 1.0, 1.0, events(),
                    {"scorer": [], "chain": []}, {"block": [s], "am": []})
    from perfbench.work import fixed_chain, fixed_score

    assert scorer_roofline.read(ctx) == pytest.approx(
        100 * fixed_score.count(s).seconds() / 10e-6)
    assert chain_roofline.read(ctx) == pytest.approx(
        100 * fixed_chain.count(s).seconds() / 22e-6)
    # no work count for the family: the metric is left out, not 0
    ctx.family = "diag"
    assert scorer_roofline.read(ctx) is None


def test_a_range_with_no_device_work_fails():
    ctx = trace.Ctx(tiny.ROOT, "fixed", 1, 1, 1.0, 1.0, events(),
                    {"scorer": [], "dp": []}, {"block": [], "am": []})
    ctx.require({"scorer": []})
    with pytest.raises(RuntimeError, match="dp"):
        ctx.require({"scorer": [], "dp": []})
