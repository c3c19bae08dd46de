"""K9, the full-covariance assignment chain over its touched-slot tables:
per step each live slot's refit (2 D^2 + 3 D + 30 operations, a log1p
and a log), 8 operations a component for the weights and the Gumbel-max
over the global scores, and the joined slot's rank-1 update (4 D^2 + 6
D).  Bytes: each step's global score row and noise row (2 K) once, the
touched and claimed slots' tables (D^2 + D + 1 floats) once."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D, K = s["D"], s["K"]
    n = float(s["steps"].sum())
    slot_steps = float(s["slot_steps"])
    flops = (slot_steps * (2 * D * D + 3 * D + 30) + n * 8 * K
             + n * (4 * D * D + 6 * D))
    slots = float(s["touched"].sum()) + float(s["claimed"])
    n_bytes = n * (2 * K + D + 1) * 4 + slots * (D * D + D + 1) * 4
    return Work(flops, n_bytes, 2 * slot_steps)
