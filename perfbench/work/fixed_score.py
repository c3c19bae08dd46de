"""K1, the fixed-variance candidate scorer: every live candidate row of a
block against every component its utterance's leave-out statistics hold,
``-0.5 sum_d (x_d - mu_kd)^2 p_kd`` (4 D operations) plus the weight, the
log-sum-exp's share (6 operations, one exp); per row the prior's density
(4 D + 4 operations) and the final log.  Bytes: the rows, their prior
densities and scores once; the occupied components' (mu, p) tables once a
block plus the touched components' leave-out columns of each utterance;
the weights and counts once a row of the block."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D, rows, occ = s["D"], s["rows"], s["occ"]
    pairs = float((rows * occ).sum())
    n_rows = float(rows.sum())
    flops = pairs * (4 * D + 6) + n_rows * (4 * D + 4)
    tables = (s["K_occ"] + float(s["touched"].sum())) * 2 * D * 4
    n_bytes = n_rows * (D + 2) * 4 + tables + len(rows) * s["K"] * 8
    return Work(flops, n_bytes, pairs + n_rows)
