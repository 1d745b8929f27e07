"""celerite2-tpu: a JAX framework for celerite-class Gaussian
processes on accelerators, built from scratch on JAX/XLA.

Feature parity target: exoplanet-dev/celerite2 (term DSL, O(N J^2)
semiseparable solver with O(N J^2) hand-derived gradients, GaussianProcess
API), plus an internal on-device inference engine (NUTS/HMC, VI, SMC)
sharded over device meshes — the capability the reference delegates to
PyMC/numpyro/emcee.
"""

from celerite2_tpu import models, ops
from celerite2_tpu.config import Config, get_config, set_config
from celerite2_tpu.models import terms
from celerite2_tpu.models.terms import (
    ComplexTerm,
    Matern32Term,
    OriginalCeleriteTerm,
    RealTerm,
    RotationTerm,
    SHOTerm,
    Term,
    TermConvolution,
    TermDiff,
    TermProduct,
    TermSum,
)
from celerite2_tpu.utils import LinAlgError

__version__ = "0.1.0"

__all__ = [
    "terms",
    "models",
    "ops",
    "Config",
    "get_config",
    "set_config",
    "LinAlgError",
    "Term",
    "TermSum",
    "TermProduct",
    "TermDiff",
    "TermConvolution",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "RotationTerm",
    "OriginalCeleriteTerm",
    "GaussianProcess",
    "gp_loglik",
    "pymc_support",
]


def __getattr__(name):
    # the GP layer imports ops lazily to avoid import cycles
    if name == "GaussianProcess":
        from celerite2_tpu.gp import GaussianProcess

        return GaussianProcess
    if name == "gp_loglik":
        from celerite2_tpu.gp import gp_loglik

        return gp_loglik
    if name == "pymc_support":
        from celerite2_tpu import pymc_support

        return pymc_support
    raise AttributeError(f"module 'celerite2_tpu' has no attribute {name!r}")
