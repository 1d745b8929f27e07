"""Assoc-tier geometry vs the lax.scan oracle, on both prefix engines.

Every forward and reverse op of ``ops/assoc.py`` runs at N=100 with
``engine_block=16`` (N is not a multiple of the block, and the blocked
engine recurses over several levels), an odd width J=3 padded to its
J bucket (zero columns must be exact no-ops), and K=3 right-hand
sides.  Results are sliced back to J and compared in float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from celerite2_tpu.config import get_config, pad_width, set_config
from celerite2_tpu.models.terms import RealTerm, SHOTerm
from celerite2_tpu.ops import assoc, scan
from celerite2_tpu.ops.api import _bucketed

N, K, BLOCK = 100, 3, 16
RTOL, ATOL = 1e-10, 1e-12
ENGINES = ["two_level", "associative_scan"]
SWEEPS = ["solve_lower", "solve_upper", "matmul_lower", "matmul_upper"]
REV = [(True, False), (True, True), (False, False), (False, True)]


@pytest.fixture(params=ENGINES)
def engine(request):
    prior = get_config()
    set_config(engine=request.param, engine_block=BLOCK)
    yield request.param
    set_config(**dataclasses.asdict(prior))


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(2024)
    t = np.sort(rng.uniform(0, 10, N))
    diag = rng.uniform(0.1, 0.3, N)
    kernel = SHOTerm(S0=5.0, w0=0.7, Q=3.45) + RealTerm(a=0.8, c=0.4)
    c, a, U, V = map(
        jnp.asarray, kernel.get_celerite_matrices(t, diag)
    )
    assert U.shape[1] == 3 and pad_width(3) == 4
    Y = jnp.asarray(rng.normal(size=(N, K)))
    t = jnp.asarray(t)
    d, W, S = scan.factor_scan(t, c, a, U, V)
    return dict(t=t, c=c, a=a, U=U, V=V, Y=Y, d=d, W=W, S=S)


def _close(out, ref, name):
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=RTOL, atol=ATOL,
        err_msg=name,
    )


def _padded(s, *names):
    """c and the named (N, J) matrices padded to the J bucket."""
    c_p, mats, J = _bucketed(s["c"], *(s[n] for n in names))
    assert c_p.shape[0] == 4 and J == 3
    return c_p, mats


def test_factor(system, engine):
    s = system
    c_p, (U_p, V_p) = _padded(s, "U", "V")
    d, W, S = assoc.factor_assoc(s["t"], c_p, s["a"], U_p, V_p)
    _close(d, s["d"], "d")
    _close(W[:, :3], s["W"], "W")
    _close(S[:, :3, :3], s["S"], "S")
    # the padded rows and columns stay identically zero
    assert float(jnp.max(jnp.abs(W[:, 3:]))) == 0.0
    assert float(jnp.max(jnp.abs(S[:, 3:, :]))) == 0.0


@pytest.mark.parametrize("op", SWEEPS)
def test_sweep(system, engine, op):
    s = system
    other = "W" if op.startswith("solve") else "V"
    c_p, (U_p, B_p) = _padded(s, "U", other)
    Z, F = getattr(assoc, f"{op}_assoc")(s["t"], c_p, U_p, B_p, s["Y"])
    Z_ref, F_ref = getattr(scan, f"{op}_scan")(
        s["t"], s["c"], s["U"], s[other], s["Y"]
    )
    _close(Z, Z_ref, "Z")
    _close(F[:, :3], F_ref, "F")


def test_factor_rev(system, engine):
    s = system
    rng = np.random.default_rng(7)
    bd = jnp.asarray(rng.normal(size=s["d"].shape))
    bW = jnp.asarray(rng.normal(size=s["W"].shape))
    ref = scan.factor_rev_scan(
        s["t"], s["c"], s["a"], s["U"], s["V"], s["d"], s["W"], s["S"],
        bd, bW,
    )
    c_p, (U_p, V_p, W_p, bW_p), _ = _bucketed(
        s["c"], s["U"], s["V"], s["W"], bW
    )
    S_p = jnp.pad(s["S"], ((0, 0), (0, 1), (0, 1)))
    out = assoc.factor_rev_assoc(
        s["t"], c_p, s["a"], U_p, V_p, s["d"], W_p, S_p, bd, bW_p
    )
    bt, bc, ba, bU, bV = out
    _close(bt, ref[0], "bt")
    _close(bc[:3], ref[1], "bc")
    _close(ba, ref[2], "ba")
    _close(bU[:, :3], ref[3], "bU")
    _close(bV[:, :3], ref[4], "bV")


@pytest.mark.parametrize(
    "is_solve,upper", REV,
    ids=[f"{'solve' if a else 'matmul'}_{'upper' if b else 'lower'}"
         for a, b in REV],
)
def test_sweep_rev(system, engine, is_solve, upper):
    s = system
    if is_solve:
        A, B = ("W", "U") if upper else ("U", "W")
    else:
        A, B = ("V", "U") if upper else ("U", "V")
    t, c, Y = s["t"], s["c"], s["Y"]
    Z, F = scan._sweep(t, c, s[A], s[B], Y, is_solve=is_solve, upper=upper)
    bZ = jnp.asarray(np.random.default_rng(11).normal(size=Z.shape))
    ref = scan.sweep_rev_scan(
        t, c, s[A], s[B], Y, Z, F, bZ, is_solve=is_solve, upper=upper
    )
    c_p, (A_p, B_p) = _padded(s, A, B)
    F_p = jnp.pad(F, ((0, 0), (0, 1), (0, 0)))
    bt, bc, bA, bB, bY = assoc.sweep_rev_assoc(
        t, c_p, A_p, B_p, Y, Z, F_p, bZ, is_solve=is_solve, upper=upper
    )
    _close(bt, ref[0], "bt")
    _close(bc[:3], ref[1], "bc")
    _close(bA[:, :3], ref[2], "bA")
    _close(bB[:, :3], ref[3], "bB")
    _close(bY, ref[4], "bY")
