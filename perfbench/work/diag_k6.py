"""K6, the diagonal-covariance assignment chain (``csrc/diag_chain.cu``,
``DiagChain`` on the chain template): per step (a new segment) the fit of
every component its utterance holds in the composition the program defines,
four logs of stride-4 products of ``1 + (x_d - mu_kd)^2 / den_kd`` (5
operations a dim: the difference, its square, the quotient, the add and the
product; four logs and their sum, the Student-t terms and the weight, 8
operations), the Gumbel-max over all K slots (2 operations a slot: the
empty slots' noise takes part), and the joined column's re-derivation from
its running sums (the sums, m_n, the variance and den: 8 D + 30 operations;
D logs of the variances, and the log of v_n and the two Stirling series'
logs, 3 special-function results).  Each component the block reads is
derived once from its statistics the same way (the occupied components and
each utterance's touched leave-outs).  Bytes: each step's noise row (K) and
vector (D) once, the occupied components' sums (sx, ssq) once a block plus
the touched components' columns of each utterance, the counts once a
row."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D, K = s["D"], s["K"]
    steps = s["steps"].astype(float)
    col_steps = float((steps * s["occ"]).sum())
    n = float(steps.sum())
    cols = s["K_occ"] + float(s["touched"].sum())
    derived = n + cols
    flops = (col_steps * (5 * D + 8) + n * 2 * K
             + derived * (8 * D + 30))
    tables = cols * 2 * D * 4
    n_bytes = n * (K + D + 1) * 4 + tables + len(steps) * K * 4
    return Work(flops, n_bytes, col_steps * 4 + derived * (D + 3))
