"""Component models and the FBGMM container."""

from . import components_diag, components_fixedvar, components_full

COV_MODULES = {"fixed": components_fixedvar, "diag": components_diag,
               "full": components_full}


def cov_module(covariance_type: str):
    """The component module of a covariance family (the JAX package's
    ``models.cov_module``): "fixed", "diag" or "full"."""
    try:
        return COV_MODULES[covariance_type]
    except KeyError:
        raise ValueError("invalid covariance type: %r"
                         % (covariance_type,)) from None
