"""linalg_ms_per_sweep (ms): device time a sweep of the full family's
batched factorisations, ``aten::linalg_cholesky_ex`` and
``aten::linalg_solve_triangular``."""

RANGES = {}
OPS = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular")


def read(ctx):
    us = sum(e.device_time_total for e in ctx.key_averages if e.key in OPS)
    return us / 1e3 / ctx.sweeps if us > 0 else None
