"""Tier-1 op implementations: ``lax.scan`` recursions.

These are direct JAX formulations of the O(N J^2) semiseparable recursions
(re-derived from the math in /root/reference/c++/include/celerite2/
forward.hpp, internal.hpp and reverse.hpp — not translations of the C++).
They are always correct, fully vmappable (thousands of NUTS chains batch
through the same scan), and serve as the oracle tier for the parallel
(associative / blocked) backends.

Shapes: ``t (N,)``, ``c (J,)``, ``a (N,)``, ``U (N, J)``, ``V (N, J)``,
``Y (N, K)``.  The transport factor is

    phi[n] = exp(-c * (t[n] - t[n-1])),  phi[0] = 0.

All functions are pure; "in-place" reference semantics (Z += ...) become
functional returns of the increment / result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "transport",
    "factor_scan",
    "factor_solve_scan",
    "factor_rev_scan",
    "solve_lower_scan",
    "solve_upper_scan",
    "matmul_lower_scan",
    "matmul_upper_scan",
    "sweep_rev_scan",
]


def _full_precision(fn):
    """The J-sized matmuls inside the recursions must not run in TF32,
    which XLA may pick for float32 dots on the GPU at default precision
    (~3 decimal digits: gradients lose that much).  Cost is negligible
    at J <= 32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def transport(t, c):
    """phi (N, J) with phi[0] = 0 (nothing propagates into the first row)."""
    dt = jnp.diff(t)
    phi = jnp.exp(-c[None, :] * dt[:, None])
    return jnp.concatenate(
        [jnp.zeros((1, c.shape[0]), dtype=phi.dtype), phi], axis=0
    )


def transport_up(t, c):
    """phi_up (N, J): phi_up[n] = exp(-c (t[n+1]-t[n])), phi_up[N-1] = 0."""
    dt = jnp.diff(t)
    phi = jnp.exp(-c[None, :] * dt[:, None])
    return jnp.concatenate(
        [phi, jnp.zeros((1, c.shape[0]), dtype=phi.dtype)], axis=0
    )


# ======================================================== factorization


@_full_precision
def factor_scan(t, c, a, U, V):
    """LDL^T factorization of the celerite system.

    Returns ``(d, W, S)`` where ``K = L diag(d) L^T`` with
    ``L = I + tril_strict(U W^T (x) transport)`` and ``S (N, J, J)`` is the
    one-sided transported carry cached for the reverse sweep (the value
    ``diag(phi_n) (S_{n-1} + d_{n-1} w_{n-1} w_{n-1}^T)``, matching the
    cache convention of reference forward.hpp:111-131).

    Negative pivots are not raised here (traced code); a non-positive
    ``d`` signals a non-PD matrix and is handled by the caller
    (quiet -> -inf semantics).  Divisions are guarded so a bad pivot
    produces finite garbage rather than NaNs that would poison gradients.
    """
    phi = transport(t, c)
    J = c.shape[0]
    dtype = U.dtype

    d0 = a[0]
    w0 = V[0] / _safe(d0)

    def step(carry, inp):
        S, d_prev, w_prev = carry
        phi_n, a_n, u_n, v_n = inp
        S = S + d_prev * jnp.outer(w_prev, w_prev)
        S_half = phi_n[:, None] * S  # cached (one-sided transport)
        S_full = S_half * phi_n[None, :]
        tmp = S_full @ u_n
        d_n = a_n - u_n @ tmp
        w_n = (v_n - tmp) / _safe(d_n)
        return (S_full, d_n, w_n), (d_n, w_n, S_half)

    init = (jnp.zeros((J, J), dtype=dtype), d0, w0)
    _, (d_rest, w_rest, S_rest) = lax.scan(
        step, init, (phi[1:], a[1:], U[1:], V[1:])
    )
    d = jnp.concatenate([d0[None], d_rest])
    W = jnp.concatenate([w0[None], w_rest])
    S = jnp.concatenate([jnp.zeros((1, J, J), dtype=dtype), S_rest])
    return d, W, S


def _safe(x):
    """Guarded divisor: keep traced failure finite (quiet semantics)."""
    return jnp.where(x > 0, x, jnp.ones_like(x))


@_full_precision
def factor_solve_scan(t, c, a, U, V, Y):
    """Fused LDL^T factorization + lower solve in ONE pass over the data.

    The log-likelihood hot path runs ``factor`` then ``solve_lower``
    back-to-back (the reference executes forward.hpp:111-132 then
    internal.hpp:138-145 per evaluation); fusing them halves the number
    of sweeps (and, on the assoc tier, engine invocations).

    Returns ``(d, W, Z, S, F)`` where ``(d, W, S)`` match
    :func:`factor_scan` and ``(Z, F)`` match :func:`solve_lower_scan`
    exactly (same cache conventions, so the standard reverse tiers
    consume them unchanged).
    """
    phi = transport(t, c)
    N, J = U.shape
    K = Y.shape[1]
    dtype = U.dtype

    d0 = a[0]
    w0 = V[0] / _safe(d0)
    z0 = Y[0]

    def step(carry, inp):
        S, F, d_prev, w_prev, z_prev = carry
        phi_n, a_n, u_n, v_n, y_n = inp
        # factor
        S = S + d_prev * jnp.outer(w_prev, w_prev)
        S_half = phi_n[:, None] * S
        S_full = S_half * phi_n[None, :]
        tmp = S_full @ u_n
        d_n = a_n - u_n @ tmp
        w_n = (v_n - tmp) / _safe(d_n)
        # solve (feedback on the output row)
        F_cache = F + jnp.outer(w_prev, z_prev)
        F_post = phi_n[:, None] * F_cache
        z_n = y_n - F_post.T @ u_n
        return (S_full, F_post, d_n, w_n, z_n), (
            d_n,
            w_n,
            z_n,
            S_half,
            F_cache,
        )

    init = (
        jnp.zeros((J, J), dtype=dtype),
        jnp.zeros((J, K), dtype=Y.dtype),
        d0,
        w0,
        z0,
    )
    _, (d_r, w_r, z_r, S_r, F_r) = lax.scan(
        step, init, (phi[1:], a[1:], U[1:], V[1:], Y[1:])
    )
    d = jnp.concatenate([d0[None], d_r])
    W = jnp.concatenate([w0[None], w_r])
    Z = jnp.concatenate([z0[None], z_r])
    S = jnp.concatenate([jnp.zeros((1, J, J), dtype=dtype), S_r])
    F = jnp.concatenate([jnp.zeros((1, J, K), dtype=Y.dtype), F_r])
    return d, W, Z, S, F


@_full_precision
def factor_rev_scan(t, c, a, U, V, d, W, S, bd, bW):
    """Reverse sweep of :func:`factor_scan` (math of reference
    reverse.hpp:10-85, re-derived as a reversed scan).

    The carried adjoint state is ``bS (J, J)``; contributions that land on
    row ``n-1`` (the ``ba``/``bV`` increments) are deferred through the
    carry and consumed by the next (earlier) step.

    Returns ``(bt, bc, ba, bU, bV)``.
    """
    del a, V  # the factor adjoint does not need them (d, W suffice)
    N, J = U.shape
    phi = transport(t, c)
    dts = jnp.concatenate([jnp.zeros((1,), t.dtype), -jnp.diff(t)])

    bV0_base = bW / d[:, None]

    def step(carry, inp):
        bS, dba_next, dbv_next = carry
        p, dt, u_n, w_n, w_prev, S_half, bd_n, bv_base = inp

        ba_n = bd_n + dba_next
        bv_n = bv_base + dbv_next
        ba_n = ba_n - w_n @ bv_n
        S_full = S_half * p[None, :]
        bU_n = -(S_full @ (bv_n + 2.0 * ba_n * u_n))
        bS = bS - jnp.outer(u_n, bv_n + ba_n * u_n)

        bp = jnp.diagonal(bS @ S_half + S_half.T @ bS) * p
        bc_n = dt * bp
        ft_n = c @ bp

        bS = p[:, None] * bS * p[None, :]
        dba = w_prev @ (bS @ w_prev)
        dbv = (bS + bS.T) @ w_prev
        return (bS, dba, dbv), (ba_n, bv_n, bU_n, bc_n, ft_n)

    init = (
        jnp.zeros((J, J), dtype=U.dtype),
        jnp.zeros((), dtype=d.dtype),
        jnp.zeros((J,), dtype=U.dtype),
    )
    inputs = (
        phi[1:],
        dts[1:],
        U[1:],
        W[1:],
        W[:-1],
        S[1:],
        bd[1:],
        bV0_base[1:],
    )
    (bS, dba0, dbv0), (ba_r, bv_r, bU_r, bc_steps, ft) = lax.scan(
        step, init, inputs, reverse=True
    )
    del bS

    bv_0 = bV0_base[0] + dbv0
    ba_0 = bd[0] + dba0 - bv_0 @ W[0]

    ba = jnp.concatenate([ba_0[None], ba_r])
    bV = jnp.concatenate([bv_0[None], bv_r])
    bU = jnp.concatenate([jnp.zeros((1, J), dtype=U.dtype), bU_r])
    bc = jnp.sum(bc_steps, axis=0)
    # Steps n=1..N-1 contribute bt[n] -= ft_n and bt[n-1] += ft_n, so
    # bt[k] = ft[k+1] - ft[k] with ft_0 = ft_N = 0.
    ft_full = jnp.concatenate(
        [jnp.zeros((1,), t.dtype), ft, jnp.zeros((1,), t.dtype)]
    )
    bt = ft_full[1:] - ft_full[:-1]
    return bt, bc, ba, bU, bV


# ===================================================== sweeps (fwd dir)


@_full_precision
def _sweep(t, c, A, B, Y, *, is_solve: bool, upper: bool):
    """Shared recursion behind solves and matmuls
    (math of reference internal.hpp:105-189).

    Lower (time-forward) sweep:
        F_n = phi_n (F_{n-1} + B_{n-1} r_{n-1}^T),  out_n (+|-)= A_n F_n
    where ``r`` is the output row itself for solves (feedback) and the
    input row for matmuls.  Upper sweeps run time-reversed with
    phi_up[n] = exp(-c (t[n+1]-t[n])).

    Returns ``(Z, F_cache)`` with ``F_cache`` the pre-transport carry
    (reference workspace convention).
    """
    N, J = A.shape
    K = Y.shape[1]
    phi = transport_up(t, c) if upper else transport(t, c)
    sign = -1.0 if is_solve else 1.0

    def step(carry, inp):
        F, b_prev, r_prev = carry
        phi_n, a_n, b_n, y_n = inp
        F = F + jnp.outer(b_prev, r_prev)
        F_cache = F
        F = phi_n[:, None] * F
        proj = F.T @ a_n
        z_n = y_n + sign * proj if is_solve else proj
        r_n = z_n if is_solve else y_n
        return (F, b_n, r_n), (z_n, F_cache)

    init = (
        jnp.zeros((J, K), dtype=Y.dtype),
        jnp.zeros((J,), dtype=A.dtype),
        jnp.zeros((K,), dtype=Y.dtype),
    )
    xs = (phi, A, B, Y)
    if upper:
        _, (Z, F) = lax.scan(step, init, xs, reverse=True)
    else:
        _, (Z, F) = lax.scan(step, init, xs)
    return Z, F


def solve_lower_scan(t, c, U, W, Y):
    """Z = L^{-1} Y with L = I + tril_strict(U W^T (x) transport)."""
    return _sweep(t, c, U, W, Y, is_solve=True, upper=False)


def solve_upper_scan(t, c, U, W, Y):
    """Z = L^{-T} Y."""
    return _sweep(t, c, W, U, Y, is_solve=True, upper=True)


def matmul_lower_scan(t, c, U, V, Y):
    """Z = tril_strict(U V^T (x) transport) @ Y (the increment only)."""
    return _sweep(t, c, U, V, Y, is_solve=False, upper=False)


def matmul_upper_scan(t, c, U, V, Y):
    """Z = triu_strict(V U^T (x) transport) @ Y (the increment only)."""
    return _sweep(t, c, V, U, Y, is_solve=False, upper=True)


# ===================================================== sweeps (rev dir)


@_full_precision
def sweep_rev_scan(t, c, A, B, Y, Z, F, bZ, *, is_solve: bool, upper: bool):
    """Adjoint of :func:`_sweep` (math of reference internal.hpp:191-303).

    Args mirror the forward: ``A`` projects rows into the output, ``B``
    feeds the carry.  ``F`` is the pre-transport carry cache from the
    forward.  Returns ``(bt, bc, bA, bB, bY)`` where for solves ``bY`` is
    the fully accumulated adjoint of the right-hand side (the reference
    aliases bY == bZ; here it is returned functionally).
    """
    N, J = A.shape
    phi = transport_up(t, c) if upper else transport(t, c)
    if upper:
        dts = jnp.concatenate([jnp.diff(t), jnp.zeros((1,), t.dtype)])
        dts = -dts  # dt = t[n] - t[n+1]
    else:
        dts = jnp.concatenate([jnp.zeros((1,), t.dtype), -jnp.diff(t)])

    sign = -1.0 if is_solve else 1.0
    R = Z if is_solve else Y  # rows feeding the forward carry

    def step2(carry, inp):
        bF, defer_br, defer_bprev = carry
        p, dt, a_n, b_prev, r_prev, F_n, bz_in = inp

        bz_n = bz_in + defer_bprev if is_solve else bz_in
        pF = p[:, None] * F_n
        bA_n = sign * (pF @ bz_n)
        bF = bF + sign * jnp.outer(a_n, bz_n)

        bp = jnp.sum(F_n * bF, axis=1) * p
        bc_n = dt * bp
        ft_n = c @ bp

        bF = p[:, None] * bF
        dbB_prev = bF @ r_prev  # -> bB[prev]
        dbR_prev = bF.T @ b_prev  # -> bY[prev] (matmul) / bZ[prev] (solve)
        return (bF, dbB_prev, dbR_prev), (
            bA_n,
            bc_n,
            ft_n,
            bz_n,
            dbB_prev,
            dbR_prev,
        )

    K = Y.shape[1]
    init = (
        jnp.zeros((J, K), dtype=Y.dtype),
        jnp.zeros((J,), dtype=A.dtype),
        jnp.zeros((K,), dtype=Y.dtype),
    )

    if not upper:
        # active steps n = 1..N-1, processed in reverse
        xs = (phi[1:], dts[1:], A[1:], B[:-1], R[:-1], F[1:], bZ[1:])
        (bF, dbB0, dbR0), outs = lax.scan(step2, init, xs, reverse=True)
        bA_r, bc_steps, ft, bz_r, dbB_shift, dbR_shift = outs
        # assemble per-row outputs
        bA = jnp.concatenate([jnp.zeros((1, J), A.dtype), bA_r])
        # bB[m] gets dbB emitted by step m+1 (for m = 0..N-2)
        bB = jnp.concatenate([dbB_shift, jnp.zeros((1, J), A.dtype)])
        if is_solve:
            # bY == accumulated bZ rows; row 0 = bZ[0] + deferred
            bY = jnp.concatenate([(bZ[0] + dbR0)[None], bz_r])
            # bB/dbR were computed against accumulated bz (correct)
        else:
            bY = jnp.concatenate([dbR_shift, jnp.zeros((1, K), Y.dtype)])
    else:
        # active steps n = 0..N-2, processed forward; "prev" is n+1
        xs = (phi[:-1], dts[:-1], A[:-1], B[1:], R[1:], F[:-1], bZ[:-1])
        (bF, dbBN, dbRN), outs = lax.scan(step2, init, xs)
        bA_r, bc_steps, ft, bz_r, dbB_shift, dbR_shift = outs
        bA = jnp.concatenate([bA_r, jnp.zeros((1, J), A.dtype)])
        # bB[m] gets dbB emitted by step m-1 (for m = 1..N-1)
        bB = jnp.concatenate([jnp.zeros((1, J), A.dtype), dbB_shift])
        if is_solve:
            bY = jnp.concatenate([bz_r, (bZ[-1] + dbRN)[None]])
        else:
            bY = jnp.concatenate([jnp.zeros((1, K), Y.dtype), dbR_shift])

    bc = jnp.sum(bc_steps, axis=0)

    if not upper:
        ft_full = jnp.concatenate(
            [jnp.zeros((1,), t.dtype), ft]
        )  # ft at steps 1..N-1
        # bt[n] -= ft[n]; bt[n-1] += ft[n]
        bt = -ft_full
        bt = bt.at[:-1].add(ft_full[1:])
    else:
        ft_full = jnp.concatenate([ft, jnp.zeros((1,), t.dtype)])
        # bt[n+1] -= ft[n]; bt[n] += ft[n]
        bt = ft_full
        bt = bt.at[1:].add(-ft_full[:-1])

    return bt, bc, bA, bB, bY
