"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit) and the least time a count of work needs at them."""

from __future__ import annotations

from typing import NamedTuple

PEAK_FP32 = 67e12      # float32 outside the tensor cores, flop/s
PEAK_BYTES = 3.35e12   # HBM3, bytes/s
# special-function results (log, exp, reciprocal) a second: 16 a clock an
# SM (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz
PEAK_SFU = 16 * 132 * 1.98e9


class Work(NamedTuple):
    """Needed work: float32 operations, bytes moved to or from device
    memory (each input read once, each output written once),
    special-function results."""

    flops: float = 0.0
    bytes: float = 0.0
    sfu: float = 0.0

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes,
                    self.sfu + other.sfu)

    def seconds(self) -> float:
        """The least time at the peaks: the largest of the three."""
        return max(self.flops / PEAK_FP32, self.bytes / PEAK_BYTES,
                   self.sfu / PEAK_SFU)
