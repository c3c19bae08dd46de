"""K11, the acoustic model's sequential sweep with full-covariance
components: per item every occupied column's fit through its triangular
factor (D (D + 1) + 3 D + 8 operations, a log1p and a log), and the two
changed columns' rank-1 updates (4 D^2 operations each).  Bytes: each
item's noise row (K) and vector (D) once, its old and new column once,
the occupied columns' tables (D^2 + D + 1 floats) read and written
once."""

from ..peaks import Work

LEVEL = "am"


def count(s) -> Work:
    D, K, n = s["D"], s["K"], float(s["items"])
    occ = 0.5 * (s["occ_start"] + s["occ_end"])
    col_steps = n * occ
    flops = col_steps * (D * (D + 1) + 3 * D + 8) + n * 8 * D * D
    n_bytes = n * (K + D + 2) * 4 + 2 * occ * (D * D + D + 1) * 4
    return Work(flops, n_bytes, 2 * col_steps)
