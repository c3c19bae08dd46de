"""K10, the acoustic model's sequential sweep with fixed-variance
components: per item every occupied column's fit (4 D + 8 operations and
the weight's log, as K3's), the Gumbel-max over all K slots (2 operations
a slot), and the two changed columns' updates (the item leaves its old
column and joins its new one: 2 D operations and D logs each).  Bytes:
each item's noise row (K), vector (D) and draw once, the occupied
columns' tables (mean and precision, 2 D floats, and the count) read and
written once."""

from ..peaks import Work

LEVEL = "am"


def count(s) -> Work:
    D, K, n = s["D"], s["K"], float(s["items"])
    occ = 0.5 * (s["occ_start"] + s["occ_end"])
    col_steps = n * occ
    flops = col_steps * (4 * D + 8) + n * (2 * K + 4 * D)
    n_bytes = n * (K + D + 1) * 4 + 2 * occ * (2 * D + 1) * 4
    return Work(flops, n_bytes, col_steps + n * 2 * D)
