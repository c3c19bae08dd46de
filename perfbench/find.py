"""Find the benchmark's per-name files: ``<root>/perfbench/<kind>/<name>.py``
for a per-layer metric's reader (``metrics``), a work count (``work``) or a
reference (``reference``), loaded by path as ``perfbench.<kind>.<name>``
(so that relative imports inside them work), and the data files of
configurations, traffic mixes and limits.  A new cell, metric, count or
reference is a new file found here by its name, with no edit to the
harness."""

from __future__ import annotations

import importlib.util
import os
import sys


def module(root: str, kind: str, name: str, required: bool = True):
    """The module ``perfbench.<kind>.<name>`` from ``root``'s file, or None
    where there is none and it is not ``required``."""
    path = os.path.join(root, "perfbench", kind, name + ".py")
    full = "perfbench.%s.%s" % (kind, name)
    have = sys.modules.get(full)
    if have is not None and os.path.realpath(
            getattr(have, "__file__", "")) == os.path.realpath(path):
        return have
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(path)
        return None
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod
