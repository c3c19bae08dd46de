"""The full family's predictive factorisations of a block: one Cholesky
factor and its triangular inverse (D^3 / 3 operations each) for every
occupied component and for every touched component's leave-out.  Bytes:
each factorised matrix read once and its inverse factor written once."""

from ..peaks import Work

LEVEL = "block"


def count(s) -> Work:
    D = s["D"]
    mats = float(s["K_occ"]) + float(s["touched"].sum())
    return Work(mats * 2 * D ** 3 / 3, mats * 2 * D * D * 4, mats * D)
