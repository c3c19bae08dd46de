"""Component models and the FBGMM container."""

from . import components_diag, components_fixedvar

COV_MODULES = {"fixed": components_fixedvar, "diag": components_diag}


def cov_module(covariance_type: str):
    """The component module of a covariance family (the JAX package's
    ``models.cov_module``): "fixed" or "diag"; "full" is not ported yet."""
    if covariance_type == "full":
        raise NotImplementedError(
            "covariance_type='full' (normal-inverse-Wishart, kernels K8-K9) "
            "is not ported yet: it waits for ROADMAP M11")
    try:
        return COV_MODULES[covariance_type]
    except KeyError:
        raise ValueError("invalid covariance type: %r"
                         % (covariance_type,)) from None
