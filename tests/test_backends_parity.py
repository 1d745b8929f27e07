"""Cross-backend GP parity via the shared comparators (the analogue of
the reference's backend test tier: jax/ vs numpy/ vs pymc/ suites)."""

import pytest

# compile-heavy cross-backend sweeps: excluded from the CI fast tier
pytestmark = pytest.mark.slow

from celerite2_tpu.models.terms import (
    ComplexTerm,
    Matern32Term,
    RealTerm,
    RotationTerm,
    SHOTerm,
)
from celerite2_tpu.testing import check_gp_backends

KERNELS = [
    SHOTerm(sigma=1.5, rho=3.4, tau=2.3),
    SHOTerm(S0=1.0, w0=2.5, Q=0.2),  # overdamped branch
    RealTerm(a=1.2, c=0.7),
    ComplexTerm(a=0.9, b=0.3, c=0.6, d=2.1),
    Matern32Term(sigma=1.1, rho=2.7),
    RotationTerm(sigma=1.0, period=3.1, Q0=1.5, dQ=0.4, f=0.3),
    SHOTerm(sigma=1.5, rho=3.4, tau=2.3) + RealTerm(a=0.8, c=0.3),
    SHOTerm(sigma=1.5, rho=3.4, tau=2.3)
    * RealTerm(a=0.8, c=0.3),
]


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: type(k).__name__)
def test_gp_backend_parity(kernel):
    check_gp_backends(kernel, backends=("scan", "assoc"))


@pytest.mark.parametrize("engine", ["two_level", "associative_scan"])
def test_gp_backend_parity_engines(engine):
    """Both prefix engines of the assoc tier under the same GP-surface
    oracle (one J=2 kernel)."""
    from celerite2_tpu.config import get_config, set_config

    prior = get_config()
    try:
        set_config(engine=engine)
        check_gp_backends(
            SHOTerm(sigma=1.5, rho=3.4, tau=2.3),
            backends=("scan", "assoc"),
            size=90,
        )
    finally:
        set_config(**prior.__dict__)
