"""K8, the full-covariance candidate scorer: every live candidate row
against every occupied component of its utterance's leave-out statistics,
the Mahalanobis form over the packed lanes (2 (F + D) + D + 8 operations
a pair, F = D (D + 1) / 2) and a log1p and an exp a pair; a log a row.
Bytes: the rows, their prior densities and scores once; the occupied
components' tables (F + D + 2 floats) once a block plus the touched
components' leave-out tables of each utterance."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D, rows, occ = s["D"], s["rows"], s["occ"]
    F = D * (D + 1) // 2
    pairs = float((rows * occ).sum())
    n_rows = float(rows.sum())
    tables = (s["K_occ"] + float(s["touched"].sum())) * (F + D + 2) * 4
    n_bytes = n_rows * (D + 2) * 4 + tables + len(rows) * s["K"] * 8
    return Work(pairs * (2 * (F + D) + D + 8), n_bytes, 2 * pairs + n_rows)
