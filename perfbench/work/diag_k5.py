"""K5, the diagonal-covariance candidate scorer in its grouped composition
(``csrc/diag_score.cu``; ``ops/cuda_score.py`` ``diag_scores_plain``): every
live candidate row of a block against every component its utterance's leave-
out statistics hold, ``const_k - (v_k + 1) / 2 sum_g log prod_{d in g} (1 +
(x_d - mu_kd)^2 inv_var_kd / v_k)`` over ceil(D / 4) groups of four
contiguous dims: per dim a difference, its square, the scaled ratio plus one
(a fused multiply-add, two operations) and the product, 5 operations; a log
and an add a group; the Student-t terms, the weight and the log-sum-exp's
share (8 operations, one exp) a pair; a log a row.  Per component and
utterance its Student-t constants (``inv_var / v``, D operations; two
lgammas and a log, counted as 3 special-function results).  Bytes: the rows,
their prior densities and scores once; the occupied components' (mu,
inv_var) tables and (log_prod_var, v) once a block plus the touched
components' leave-out columns of each utterance; the weights and counts once
a row of the block."""

from ..peaks import Work

LEVEL = "block"
GROUP = 4


def count(s) -> Work:
    D, rows, occ = s["D"], s["rows"], s["occ"]
    G = -(-D // GROUP)
    pairs = float((rows * occ).sum())
    n_rows = float(rows.sum())
    cols = s["K_occ"] + float(s["touched"].sum())
    flops = pairs * (5 * D + G + 8) + cols * D
    tables = cols * (2 * D + 2) * 4
    n_bytes = n_rows * (D + 2) * 4 + tables + len(rows) * s["K"] * 8
    return Work(flops, n_bytes, pairs * (G + 1) + n_rows + cols * 3)
