"""Public differentiable ops.

Each op is a ``jax.custom_vjp`` whose backward pass is the hand-derived
O(N J^2) adjoint recursion (math of /root/reference/c++/include/celerite2/
reverse.hpp), so reverse-mode autodiff never differentiates *through* the
scans (which would cost extra memory and FLOPs).  This replaces the
reference's dummy-JVP + transpose-to-custom-primitive pattern
(python/celerite2/jax/ops.py:115-151) — in a JAX-native framework the ops
are plain functions with custom VJPs; no XLA custom-call layer exists.

Gradients w.r.t. the input times ``t`` are included (the easy-to-forget
``bt`` terms, reference internal.hpp:236-240, reverse.hpp:70-74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from celerite2_tpu.config import MAX_WIDTH, get_config, pad_width
from celerite2_tpu.ops import scan as _scan
from celerite2_tpu.ops import dispatch as _dispatch
from celerite2_tpu.ops.spec import validate_call

__all__ = [
    "factor",
    "factor_solve",
    "solve_lower",
    "solve_upper",
    "matmul_lower",
    "matmul_upper",
    "general_matmul_lower",
    "general_matmul_upper",
    "to_dense",
]


# ==================================================== width bucketing
#
# Every distinct J triggers a fresh XLA compile of the scan/assoc
# programs.  Like the reference's UNWRAP_CASES J-specialization switch
# (driver.hpp:27-101), J is rounded up to a fixed bucket before entering
# the kernels: the recursions are exactly invariant to zero columns of
# U/V/W (the padded carry rows stay identically zero), so results are
# bit-identical while the number of compiled programs stays bounded.
# Padded c entries are 1.0 so the transport exp(-c dt) stays in (0, 1].
# Widths above MAX_WIDTH skip bucketing (generic tiers handle any J).


def _bucketed(c, *mats):
    """Pad ``c (J,)`` and the (N, J) matrices to the config J bucket.

    Returns ``(c_p, mats_p, J)`` where ``J`` is the ORIGINAL width (what
    callers slice outputs back to).
    """
    J = c.shape[0]
    if not get_config().bucket_widths or J == 0 or J > MAX_WIDTH:
        return c, mats, J
    Jp = pad_width(J)
    if Jp == J:
        return c, mats, J
    pad = Jp - J
    c_p = jnp.concatenate([c, jnp.ones((pad,), c.dtype)])
    mats_p = tuple(
        jnp.pad(m, ((0, 0), (0, pad))) for m in mats
    )
    return c_p, mats_p, J


# ============================================================== factor


@jax.custom_vjp
def factor(t, c, a, U, V):
    """LDL^T factorization: returns ``(d, W)``.

    ``K = L diag(d) L^T`` with ``L = I + tril_strict(U W^T (x) transport)``.
    A non-positive entry of ``d`` means the matrix is not positive
    definite (reference forward.hpp:128 returns the failing row; traced
    code checks ``jnp.all(d > 0)`` instead).
    """
    c_p, (U_p, V_p), J = _bucketed(c, U, V)
    d, W, _ = _dispatch.factor_impl(t, c_p, a, U_p, V_p)
    return d, W[:, :J]


def _factor_fwd(t, c, a, U, V):
    J = U.shape[1]
    c_p, (U_p, V_p), _ = _bucketed(c, U, V)
    d, W, S = _dispatch.factor_impl(t, c_p, a, U_p, V_p)
    # the cache S keeps its native (bucketed / packed) layout so the
    # reverse tier consumes exactly what its twin produced; the padded
    # columns of W are identically zero, so storing the sliced W and
    # re-padding in the bwd is exact
    return (d, W[:, :J]), (t, c, a, U, V, d, W[:, :J], S)


def _factor_bwd(res, grads):
    t, c, a, U, V, d, W, S = res
    bd, bW = grads
    J = c.shape[0]
    c_p, (U_p, V_p, W_p, bW_p), _ = _bucketed(c, U, V, W, bW)
    bt, bc, ba, bU, bV = _dispatch.factor_rev_impl(
        t, c_p, a, U_p, V_p, d, W_p, S, bd, bW_p
    )
    return bt, bc[:J], ba, bU[:, :J], bV[:, :J]


factor.defvjp(_factor_fwd, _factor_bwd)


# ======================================================== fused factor+solve


@jax.custom_vjp
def factor_solve(t, c, a, U, V, Y):
    """Fused ``factor`` + ``solve_lower``: returns ``(d, W, Z)`` with
    ``Z = L^{-1} Y`` — the log-likelihood forward in ONE pass over the
    data (one engine invocation on the assoc tier), replacing the
    back-to-back execution of the reference's factor + solve loops
    (forward.hpp:111-132 then internal.hpp:138-145).
    """
    c_p, (U_p, V_p), J = _bucketed(c, U, V)
    d, W, Z, _, _ = _dispatch.factor_solve_impl(t, c_p, a, U_p, V_p, Y)
    return d, W[:, :J], Z


def _factor_solve_fwd(t, c, a, U, V, Y):
    J = U.shape[1]
    c_p, (U_p, V_p), _ = _bucketed(c, U, V)
    d, W, Z, S, F = _dispatch.factor_solve_impl(t, c_p, a, U_p, V_p, Y)
    return (d, W[:, :J], Z), (t, c, a, U, V, Y, d, W[:, :J], Z, S, F)


def _factor_solve_bwd(res, grads):
    t, c, a, U, V, Y, d, W, Z, S, F = res
    bd, bW_pub, bZ = grads
    J = c.shape[0]
    c_p, (U_p, V_p, W_p, bW_pub_p), _ = _bucketed(c, U, V, W, bW_pub)
    bt, bc, ba, bU, bV, bY = _dispatch.factor_solve_rev_impl(
        t, c_p, a, U_p, V_p, Y, d, W_p, Z, S, F, bd, bW_pub_p, bZ
    )
    return bt, bc[:J], ba, bU[:, :J], bV[:, :J], bY


factor_solve.defvjp(_factor_solve_fwd, _factor_solve_bwd)


# =============================================================== solves


def _sweep_op(name, doc, impl_name, *, is_solve, upper, swap):
    """Build one bucketed custom_vjp sweep op.

    ``swap`` — whether the reverse pass receives (arg2, arg1) instead of
    (arg1, arg2): the upper sweeps project with the second factor and
    feed the carry with the first.
    """

    impl = getattr(_dispatch, impl_name)

    @jax.custom_vjp
    def op(t, c, M1, M2, Y):
        c_p, (M1_p, M2_p), _ = _bucketed(c, M1, M2)
        Z, _ = impl(t, c_p, M1_p, M2_p, Y)
        return Z

    def fwd(t, c, M1, M2, Y):
        c_p, (M1_p, M2_p), _ = _bucketed(c, M1, M2)
        Z, F = impl(t, c_p, M1_p, M2_p, Y)
        # F keeps its native (bucketed / packed) cache layout
        return Z, (t, c, M1, M2, Y, Z, F)

    def bwd(res, bZ):
        t, c, M1, M2, Y, Z, F = res
        J = c.shape[0]
        c_p, (M1_p, M2_p), _ = _bucketed(c, M1, M2)
        A, B = (M2_p, M1_p) if swap else (M1_p, M2_p)
        bt, bc, bA, bB, bY = _dispatch.sweep_rev_impl(
            t, c_p, A, B, Y, Z, F, bZ, is_solve=is_solve, upper=upper
        )
        b1, b2 = (bB, bA) if swap else (bA, bB)
        return bt, bc[:J], b1[:, :J], b2[:, :J], bY

    op.defvjp(fwd, bwd)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc
    return op


solve_lower = _sweep_op(
    "solve_lower",
    "Z = L^{-1} Y (unit lower-triangular semiseparable solve).",
    "solve_lower_impl",
    is_solve=True,
    upper=False,
    swap=False,
)

# the upper solve projects with W and feeds the carry with U, so its
# adjoint sees the swapped pair
solve_upper = _sweep_op(
    "solve_upper",
    "Z = L^{-T} Y.",
    "solve_upper_impl",
    is_solve=True,
    upper=True,
    swap=True,
)

matmul_lower = _sweep_op(
    "matmul_lower",
    "Z = tril_strict(U V^T (x) transport) @ Y.",
    "matmul_lower_impl",
    is_solve=False,
    upper=False,
    swap=False,
)

matmul_upper = _sweep_op(
    "matmul_upper",
    "Z = triu_strict(V U^T (x) transport) @ Y.",
    "matmul_upper_impl",
    is_solve=False,
    upper=True,
    swap=True,
)


# ===================================================== general matmuls
#
# Rectangular cross-covariance products (prediction at new points);
# forward-only like the reference (definitions.json:264 — no adjoint).
# The reference uses a sequential two-pointer merge over sorted t1/t2
# (forward.hpp:285-392); here the merge is a vectorized
# searchsorted + gather against the scanned carry.


def _transported_cumulative(phi, G, *, reverse=False):
    """Inclusive transported cumulative ``F_m = phi_m * F_prev + G_m``.

    Tier-routed like the other ops: the sequential ``lax.scan`` pays
    ~2.5 us/step of while-loop latency (0.25 s at M=1e5), so from the
    assoc threshold up the diag-affine prefix engine runs it instead
    (same engine as the sharded variant, parallel/sharded.py).
    """
    M = G.shape[0]
    if _dispatch._backend(M, ref=G) == "assoc":
        from celerite2_tpu.ops import assoc

        alpha = jnp.broadcast_to(phi[:, :, None], G.shape)
        return assoc._diag_affine_scan(alpha, G, reverse=reverse)

    def step(F, inp):
        p, g = inp
        F = p[:, None] * F + g
        return F, F

    _, F = jax.lax.scan(
        step,
        jnp.zeros(G.shape[1:], dtype=G.dtype),
        (phi, G),
        reverse=reverse,
    )
    return F


@_scan._full_precision
def general_matmul_lower(t1, t2, c, U, V, Y):
    """Z[n] = sum_{m: t2[m] <= t1[n]} U[n] . diag(e^{-c (t1[n]-t2[m])}) V[m] Y[m].

    ``t1 (N,)`` target points, ``t2 (M,)`` source points (both sorted),
    ``U (N, J)``, ``V (M, J)``, ``Y (M, K)`` -> ``Z (N, K)``.
    """
    validate_call("general_matmul_lower", t1, t2, c, U, V, Y)
    # F[m] = sum_{l <= m} diag(e^{-c (t2[m]-t2[l])}) V[l]^T Y[l], via the
    # inclusive transported cumulative (a diagonal affine scan).
    phi = _scan.transport(t2, c)
    G = V[:, :, None] * Y[:, None, :]  # (M, J, K)
    F = _transported_cumulative(phi, G)

    # index of the last source point with t2[m] <= t1[n]
    idx = jnp.searchsorted(t2, t1, side="right") - 1
    has_src = idx >= 0
    idx_c = jnp.clip(idx, 0, t2.shape[0] - 1)
    # jnp gather: t2 may be a numpy literal while idx_c is traced
    t2_g = jnp.asarray(t2)[idx_c]
    decay = jnp.exp(-c[None, :] * (t1 - t2_g)[:, None])  # (N, J)
    Fg = F[idx_c]  # (N, J, K)
    Z = jnp.einsum("nj,njk->nk", U * decay, Fg)
    return jnp.where(has_src[:, None], Z, jnp.zeros_like(Z))


@_scan._full_precision
def general_matmul_upper(t1, t2, c, U, V, Y):
    """Z[n] = sum_{m: t2[m] > t1[n]} U[n] . diag(e^{-c (t2[m]-t1[n])}) V[m] Y[m]."""
    validate_call("general_matmul_upper", t1, t2, c, U, V, Y)
    # reverse-time cumulative: F[m] = sum_{l >= m} transported V^T Y
    phi_up = _scan.transport_up(t2, c)
    G = V[:, :, None] * Y[:, None, :]
    F = _transported_cumulative(phi_up, G, reverse=True)

    # first source point with t2[m] > t1[n]
    idx = jnp.searchsorted(t2, t1, side="right")
    has_src = idx < t2.shape[0]
    idx_c = jnp.clip(idx, 0, t2.shape[0] - 1)
    t2_g = jnp.asarray(t2)[idx_c]
    decay = jnp.exp(-c[None, :] * (t2_g - t1)[:, None])
    Fg = F[idx_c]
    Z = jnp.einsum("nj,njk->nk", U * decay, Fg)
    return jnp.where(has_src[:, None], Z, jnp.zeros_like(Z))


# ============================================================= to_dense


@_scan._full_precision
def to_dense(t, c, a, U, V):
    """Materialize the dense celerite matrix (O(N^2 J); oracle only —
    reference forward.hpp:19-42)."""
    validate_call("to_dense", t, c, a, U, V)
    tau = t[:, None] - t[None, :]
    decay = jnp.exp(-c[None, None, :] * jnp.abs(tau)[:, :, None])
    K = jnp.einsum("nj,mj,nmj->nm", U, V, decay)
    lower = jnp.tril(K, k=-1)
    return lower + lower.T + jnp.diag(a)
