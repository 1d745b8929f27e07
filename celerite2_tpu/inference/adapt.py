"""Warmup adaptation: dual-averaging step size + Welford mass matrix
(diagonal or dense), plus the mass-metric helpers shared by the
samplers.

Stan-style windowed schedule: an initial fast window (step size only),
doubling slow windows (mass matrix), and a final fast window.  All pure
functions over NamedTuple states, vmappable across chains.

The dense-metric linear algebra (Cholesky, triangular solve) is
Python-unrolled over the (small, static) parameter dimension instead
of calling ``jnp.linalg``: dim is <= a few dozen hyperparameters here,
so the unrolled form is one small fused program with no solver custom
call, in any dtype and under any batching.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "build_schedule",
    "mass_matvec",
    "mass_kinetic",
    "mass_momentum",
    "chol_small",
]


class DualAveragingState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def da_init(eps0):
    log_eps0 = jnp.log(eps0)
    return DualAveragingState(
        log_eps=log_eps0,
        log_eps_avg=jnp.zeros_like(log_eps0),
        h_avg=jnp.zeros_like(log_eps0),
        mu=jnp.log(10.0) + log_eps0,
        count=jnp.zeros_like(log_eps0),
    )


def da_update(
    state: DualAveragingState,
    accept_prob,
    *,
    target=0.8,
    gamma=0.05,
    t0=10.0,
    kappa=0.75,
):
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014)."""
    count = state.count + 1
    w = 1.0 / (count + t0)
    h_avg = (1.0 - w) * state.h_avg + w * (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(
        log_eps=log_eps,
        log_eps_avg=log_eps_avg,
        h_avg=h_avg,
        mu=state.mu,
        count=count,
    )


class WelfordState(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def welford_init(dim, dtype=jnp.float64, *, dense=False):
    """``dense=True`` accumulates the full (dim, dim) second-moment
    matrix for a dense mass metric."""
    m2_shape = (dim, dim) if dense else (dim,)
    return WelfordState(
        mean=jnp.zeros((dim,), dtype),
        m2=jnp.zeros(m2_shape, dtype),
        count=jnp.zeros((), dtype),
    )


def welford_update(state: WelfordState, x):
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    if state.m2.ndim == 2:
        m2 = state.m2 + jnp.outer(delta, x - mean)
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, *, regularize=True):
    """Sample variance (diag) or covariance (dense), with Stan's
    shrinkage towards unit scale for short windows."""
    var = state.m2 / jnp.maximum(state.count - 1, 1)
    if regularize:
        n = state.count
        unit = (
            jnp.eye(var.shape[0], dtype=var.dtype)
            if var.ndim == 2
            else 1.0
        )
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0)) * unit
    return var


# ------------------------------------------------- mass-metric helpers
#
# ``inv_mass`` is the estimated posterior (co)variance: (dim,) for a
# diagonal metric, (dim, dim) for a dense one.  Momenta are drawn from
# N(0, inv_mass^{-1}).


def _chol_rows(A):
    """Lower-Cholesky entries of a small SPD matrix as a list of row
    lists, Python-unrolled over the static dimension (works in any
    dtype — no solver custom call)."""
    dim = A.shape[0]
    rows = [[None] * dim for _ in range(dim)]
    for i in range(dim):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = jnp.sqrt(s)
            else:
                rows[i][j] = s / rows[j][j]
    return rows


def chol_small(A):
    """Lower Cholesky of a small SPD matrix as a dense array."""
    dim = A.shape[0]
    rows = _chol_rows(A)
    out = jnp.zeros_like(A)
    for i in range(dim):
        for j in range(i + 1):
            out = out.at[i, j].set(rows[i][j])
    return out


def _tri_solve_upper(LT_rows, z):
    """Solve L^T x = z given the rows of L (list-of-lists from the
    unrolled Cholesky context); backward substitution, unrolled."""
    dim = z.shape[0]
    x = [None] * dim
    for i in range(dim - 1, -1, -1):
        s = z[i]
        for k in range(i + 1, dim):
            # (L^T)[i, k] = L[k, i]
            s = s - LT_rows[k][i] * x[k]
        x[i] = s / LT_rows[i][i]
    return jnp.stack(x)


# Dense-metric products enter the Hamiltonian, whose differences decide
# acceptance: keep them out of TF32 (float32 dots on the GPU at default
# precision keep ~3 decimal digits).
_HIGHEST = "highest"


def mass_matvec(inv_mass, p):
    """inv_mass @ p for either metric shape."""
    if inv_mass.ndim == 2:
        return jnp.matmul(inv_mass, p, precision=_HIGHEST)
    return inv_mass * p


def mass_kinetic(inv_mass, p):
    """0.5 * p^T inv_mass p."""
    if inv_mass.ndim == 2:
        return 0.5 * jnp.dot(p, mass_matvec(inv_mass, p),
                             precision=_HIGHEST)
    return 0.5 * jnp.sum(inv_mass * p**2)


def mass_momentum(key, inv_mass, dtype):
    """Draw p ~ N(0, inv_mass^{-1}).

    Dense: with inv_mass = Sigma = L L^T, the momentum covariance is
    Sigma^{-1} = L^{-T} L^{-1}, so p = L^{-T} z for z ~ N(0, I).
    """
    import jax

    dim = inv_mass.shape[0]
    z = jax.random.normal(key, (dim,), dtype)
    if inv_mass.ndim == 2:
        # rows used directly: packing the factor into a matrix and
        # re-extracting entries would add dim^2 scatters/gathers to
        # every step body (the compile-time wall for batched samplers)
        return _tri_solve_upper(_chol_rows(inv_mass), z)
    return z / jnp.sqrt(inv_mass)


def build_schedule(num_warmup, *, init_frac=0.15, final_frac=0.1):
    """Per-step flags: (in_slow_window, window_end) as numpy arrays.

    Mirrors Stan's 75/25/... doubling slow windows between an initial
    and final fast (step-size-only) window.
    """
    import numpy as np

    num_warmup = int(num_warmup)
    init_n = max(1, int(init_frac * num_warmup))
    final_n = max(1, int(final_frac * num_warmup))
    slow_total = max(0, num_warmup - init_n - final_n)

    in_slow = np.zeros(num_warmup, dtype=bool)
    win_end = np.zeros(num_warmup, dtype=bool)
    if slow_total > 0:
        in_slow[init_n : init_n + slow_total] = True
        # doubling windows: 25, 50, 100, ... scaled to fit
        w = max(1, slow_total // 15)
        pos = init_n
        while pos < init_n + slow_total:
            w_eff = min(w, init_n + slow_total - pos)
            # merge a too-small tail into the last window
            if init_n + slow_total - (pos + w_eff) < w * 2:
                w_eff = init_n + slow_total - pos
            pos += w_eff
            win_end[pos - 1] = True
            w *= 2
    return in_slow, win_end
