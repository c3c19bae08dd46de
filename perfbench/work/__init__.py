"""Needed work of each kernel's stage, counted from the sampler's state.

``work/<family>_<stage>.py`` (or ``work/<stage>.py`` where every family
shares it) defines ``LEVEL`` ("block": one count a block step, from the
block's summary; "am": one a sequential sweep of the acoustic model) and
``count(summary) -> peaks.Work``.  The summaries are the benchmark's own
reading of the state before and after each profiled step
(``trace.block_summary`` / ``trace.am_summary``): live candidate rows,
occupied components, the chain's steps, D; never a kernel's argument
tensors, so a roofline reads the same work whatever implements it.
"""

from .. import find as _find


def find(root: str, family: str, stage: str):
    """The work module of ``stage`` for ``family``, or None."""
    for name in ("%s_%s" % (family, stage), stage):
        mod = _find.module(root, "work", name, required=False)
        if mod is not None:
            return mod
    return None
