"""Backend dispatch for the semiseparable ops.

Two tiers:

* **"scan"** — plain ``lax.scan`` recursions: the faithful port of the
  reference's sequential algorithm (forward.hpp:111-132), and the
  oracle every other path is checked against.
* **"assoc"** — the parallel prefix-composition formulations
  (``ops/assoc.py``): log-depth in N, with the prefix engine chosen by
  ``Config.engine``.

``Config.backend`` picks explicitly; "auto" = assoc for traced calls
at or above ``assoc_threshold`` rows (default 1024), else scan.
Forward and reverse route by the same rule, so a custom_vjp residual is
always produced and consumed by the same tier.
"""

from __future__ import annotations

import jax

from celerite2_tpu.config import get_config
from celerite2_tpu.ops import scan as _scan
from celerite2_tpu.ops.spec import validate_call


def _backend(n: int, ref=None) -> str:
    cfg = get_config()
    if cfg.backend != "auto":
        return cfg.backend
    if ref is not None and not isinstance(ref, jax.core.Tracer):
        # eager call: the scan tier runs as ONE compiled loop, while
        # the assoc engine would dispatch hundreds of individual ops
        return "scan"
    return "assoc" if n >= cfg.assoc_threshold else "scan"


def factor_impl(t, c, a, U, V):
    validate_call("factor", t, c, a, U, V)
    b = _backend(t.shape[0], a)
    with jax.named_scope(f"celerite2.factor.{b}"):
        if b == "assoc":
            from celerite2_tpu.ops import assoc as _assoc

            return _assoc.factor_assoc(t, c, a, U, V)
        return _scan.factor_scan(t, c, a, U, V)


def factor_solve_impl(t, c, a, U, V, Y):
    """Fused factor + lower solve (the log-likelihood forward)."""
    validate_call("factor", t, c, a, U, V)
    b = _backend(t.shape[0], a)
    with jax.named_scope(f"celerite2.factor_solve.{b}"):
        if b == "assoc":
            from celerite2_tpu.ops import assoc as _assoc

            if get_config().fused_forward:
                return _assoc.factor_solve_assoc(t, c, a, U, V, Y)
            d, W, S = _assoc.factor_assoc(t, c, a, U, V)
            Z, F = _assoc.solve_lower_assoc(t, c, U, W, Y)
            return d, W, Z, S, F
        return _scan.factor_solve_scan(t, c, a, U, V, Y)


def _sweep_fwd(op: str, t, c, A, B, Y):
    validate_call(op, t, c, A, B, Y)
    bk = _backend(t.shape[0], Y)
    with jax.named_scope(f"celerite2.{op}.{bk}"):
        if bk == "assoc":
            from celerite2_tpu.ops import assoc as _assoc

            return getattr(_assoc, f"{op}_assoc")(t, c, A, B, Y)
        return getattr(_scan, f"{op}_scan")(t, c, A, B, Y)


def solve_lower_impl(t, c, U, W, Y):
    return _sweep_fwd("solve_lower", t, c, U, W, Y)


def solve_upper_impl(t, c, U, W, Y):
    return _sweep_fwd("solve_upper", t, c, U, W, Y)


def matmul_lower_impl(t, c, U, V, Y):
    return _sweep_fwd("matmul_lower", t, c, U, V, Y)


def matmul_upper_impl(t, c, U, V, Y):
    return _sweep_fwd("matmul_upper", t, c, U, V, Y)


# ------------------------------------------------------ reverse sweeps


def factor_rev_impl(t, c, a, U, V, d, W, S, bd, bW):
    b = _backend(t.shape[0], bd)
    with jax.named_scope(f"celerite2.factor_rev.{b}"):
        return _factor_rev_routed(b, t, c, a, U, V, d, W, S, bd, bW)


def _factor_rev_routed(b, t, c, a, U, V, d, W, S, bd, bW):
    if b == "assoc":
        # the structured reverse engine keeps steps O(J^2) to apply and
        # densifies only per-block maps, so it serves ALL widths
        from celerite2_tpu.ops import assoc as _assoc

        return _assoc.factor_rev_assoc(t, c, a, U, V, d, W, S, bd, bW)
    return _scan.factor_rev_scan(t, c, a, U, V, d, W, S, bd, bW)


def factor_solve_rev_impl(
    t, c, a, U, V, Y, d, W, Z, S, F, bd, bW_pub, bZ
):
    """Reverse of the fused factor+solve: one paired engine pass on the
    assoc tier (K = 1), else the chained solve-then-factor adjoints."""
    b = _backend(t.shape[0], bZ)
    if (
        b == "assoc"
        and Y.shape[1] == 1
        and get_config().paired_reverse
    ):
        from celerite2_tpu.ops import assoc as _assoc

        with jax.named_scope("celerite2.factor_solve_rev.assoc"):
            return _assoc.factor_solve_rev_assoc(
                t, c, a, U, V, Y, d, W, Z, S, F, bd, bW_pub, bZ
            )
    bt1, bc1, bU1, bW1, bY = sweep_rev_impl(
        t, c, U, W, Y, Z, F, bZ, is_solve=True, upper=False
    )
    bt2, bc2, ba, bU2, bV = factor_rev_impl(
        t, c, a, U, V, d, W, S, bd, bW_pub + bW1
    )
    return bt1 + bt2, bc1 + bc2, ba, bU1 + bU2, bV, bY


def sweep_rev_impl(t, c, A, B, Y, Z, F, bZ, *, is_solve, upper):
    b = _backend(t.shape[0], bZ)
    with jax.named_scope(f"celerite2.sweep_rev.{b}"):
        if b == "assoc":
            from celerite2_tpu.ops import assoc as _assoc

            return _assoc.sweep_rev_assoc(
                t, c, A, B, Y, Z, F, bZ, is_solve=is_solve, upper=upper
            )
        return _scan.sweep_rev_scan(
            t, c, A, B, Y, Z, F, bZ, is_solve=is_solve, upper=upper
        )
