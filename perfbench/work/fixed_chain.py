"""K3, the fixed-variance assignment chain: per step (a new segment) the
fit of every component its utterance holds (4 D + 8 operations and the
weight's log), the Gumbel-max over all K slots (2 operations a slot: the
empty slots' noise takes part), and the joined column's update (2 D
operations, D logs).  Bytes: each step's noise row (K) and vector (D)
once, the occupied components' tables once a block plus the touched
components' columns of each utterance, the counts once a row."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D, K = s["D"], s["K"]
    steps = s["steps"].astype(float)
    col_steps = float((steps * s["occ"]).sum())
    n = float(steps.sum())
    flops = col_steps * (4 * D + 8) + n * (2 * K + 2 * D)
    tables = (s["K_occ"] + float(s["touched"].sum())) * 2 * D * 4
    n_bytes = n * (K + D + 1) * 4 + tables + len(steps) * K * 4
    return Work(flops, n_bytes, col_steps + n * D)
