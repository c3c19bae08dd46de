"""Per-layer metric readers: ``metrics/<name>.py`` for the per-layer
metric ``<name>`` of ``BENCHMARK.json``.  Each defines ``RANGES`` ({range
name: ["module:attribute", ...]}, the program's stage functions that the
traced slice wraps in that profiler range; empty where the reader needs
none) and ``read(ctx) -> float | None`` (``trace.Ctx``).  A reader that
finds nothing to read returns None, and the metric is left out of the
line; a wrapped range that launches no device work fails the run."""
