"""Tier-2 op implementations: log-depth associative scans.

The reference's recursions are strictly sequential over N
(forward.hpp:111, internal.hpp:138,181).  On a parallel accelerator,
sequential depth is the enemy for single large-N evaluations, so every
op is reformulated as a prefix composition (``jax.lax.associative_scan``
or :func:`two_level_prefix`):

* **matmuls** — the carry update ``F_n = diag(phi_n) (F_{n-1} + g_{n-1})``
  is a *diagonal* affine recurrence: elements ``(alpha, beta)`` combine
  elementwise.  O(N J K) work, log-depth.

* **solves** — substituting the output feedback turns the carry into a
  dense affine recurrence ``F_n = A_n F_{n-1} + b_n`` with
  ``A_n = diag(phi_n)(I - w_{n-1} u_{n-1}^T)`` (J x J).  Elements combine
  by matrix multiplication: O(N J^3) work, log-depth.

* **factor** — the Cholesky carry
  ``S_n = diag(phi_n)(S_{n-1} + (v - S u)(v - S u)^T / (a - u^T S u))diag(phi_n)``
  is a *Riccati flow*.  Verified identity (rank-one matrix-inversion
  lemma; cf. temporal-parallelization-of-Kalman-smoothers literature):

      S_plus = Q + A S (I + R S)^{-1} A^T
      A = diag(phi)(I - v u^T / a),  Q = diag(phi) v v^T/a diag(phi),
      R = -u u^T / a

  Riccati maps compose associatively (they are Moebius actions of 2J x 2J
  matrices on symmetric J x J matrices), with the combination

      Gamma = (I + Q1 R2)^{-1}
      A12 = A2 Gamma A1
      Q12 = Q2 + A2 Gamma Q1 A2^T
      R12 = R1 + A1^T R2 Gamma A1        (R2 Gamma == (I + R2 Q1)^{-1} R2)

  so the LDL^T factorization itself runs in log-depth — this framework's
  replacement for the reference's "THE hot loop" (forward.hpp:111-132).

All functions return exactly the same (value, cache) pairs as the tier-1
scans in :mod:`celerite2_tpu.ops.scan`, and are cross-validated against
them in the test suite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from celerite2_tpu.ops.scan import (
    _full_precision,
    _safe,
    transport,
    transport_up,
)

__all__ = [
    "two_level_prefix",
    "factor_assoc",
    "factor_solve_assoc",
    "factor_rev_assoc",
    "sweep_rev_assoc",
    "solve_lower_assoc",
    "solve_upper_assoc",
    "matmul_lower_assoc",
    "matmul_upper_assoc",
]


# ======================================================== scan engines
#
# Two interchangeable engines compute inclusive prefix compositions of
# monoid elements:
#
#   * ``lax.associative_scan`` — log-depth, minimal work; the default
#     (``Config.engine="auto"``).
#   * ``two_level_prefix`` — a blocked formulation in plain
#     ``lax.scan``: compose within blocks (one scan of ``engine_block``
#     steps, each step batched over all blocks), recurse on the block
#     maps, then one batched combine distributes block prefixes to
#     every row.  ~2N combines per level, ~block * log_block(N)
#     sequential steps.  Selected with ``Config.engine="two_level"``.



def two_level_prefix(combine, elems, identity, *, reverse=False,
                     block=None, distribute_combine=None):
    """Inclusive prefix composition of ``elems`` along axis 0 via a
    recursive blocked scheme.

    ``combine(earlier, later)`` must be associative and batch over
    leading dims; ``identity(elems)`` returns the monoid identity as a
    pytree matching one element with leading dim 1 (used for padding
    and initial carries).

    Level structure: compose within length-``block`` blocks with one
    ``lax.scan`` whose every step is batched over ALL blocks, recurse
    on the ~N/block block maps, then one batched combine distributes
    the (exclusive) block prefixes to every row.  Sequential steps
    total ~block * log_block(N); work ~2N combines per level.

    ``distribute_combine`` (optional): a cheaper combine used ONLY for
    the top-level distribute step — the fattest single op, whose output
    most callers consume only partially (e.g. the factor prefix only
    needs Q per row).  It must return the SAME pytree structure; the
    unneeded leaves may hold placeholder values.  The recursion and the
    small-N leaf always use the full ``combine``.
    """
    if block is None:
        from celerite2_tpu.config import get_config

        block = get_config().engine_block
    if reverse:
        flipped = jax.tree_util.tree_map(lambda x: x[::-1], elems)
        out = two_level_prefix(
            combine, flipped, identity, block=block,
            distribute_combine=distribute_combine,
        )
        return jax.tree_util.tree_map(lambda x: x[::-1], out)

    leaves = jax.tree_util.tree_leaves(elems)
    N = leaves[0].shape[0]
    # inherit the elements' device-varying-ness (shard_map's vma checks
    # reject mixing replicated scan carries with varying inputs)
    one = leaves[0].reshape(-1)[0] * 0 + 1
    ident = jax.tree_util.tree_map(
        lambda x: x * one, identity(elems)
    )
    id_one = jax.tree_util.tree_map(lambda x: x[0], ident)

    def step(acc, el):
        new = combine(acc, el)
        return new, new

    if N <= block:
        # leaf: plain sequential prefix
        _, pref = lax.scan(step, id_one, elems)
        return pref

    L = block
    NB = -(-N // L)
    pad = L * NB - N
    if pad:
        elems = jax.tree_util.tree_map(
            lambda x, i: jnp.concatenate(
                [x, jnp.broadcast_to(i, (pad,) + x.shape[1:])], axis=0
            ),
            elems,
            ident,
        )

    # (N,) -> (NB, L, ...) -> (L, NB, ...): time-major within blocks
    def to_lm(x):
        x = x.reshape((NB, L) + x.shape[1:])
        return jnp.swapaxes(x, 0, 1)

    elems_lm = jax.tree_util.tree_map(to_lm, elems)
    id_block = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[:1], (NB,) + x.shape[1:]),
        ident,
    )

    _, prefixes = lax.scan(step, id_block, elems_lm)

    block_maps = jax.tree_util.tree_map(lambda p: p[-1], prefixes)
    incl = two_level_prefix(combine, block_maps, identity, block=block)
    # exclusive block prefixes: shift right, identity first
    excl = jax.tree_util.tree_map(
        lambda inc, i: jnp.concatenate([i, inc[:-1]], axis=0),
        incl,
        ident,
    )

    # distribute: row (l, b) = combine(excl_b, prefix_{l, b})
    excl_b = jax.tree_util.tree_map(
        lambda e, p: jnp.broadcast_to(e[None], p.shape), excl, prefixes
    )
    full = (distribute_combine or combine)(excl_b, prefixes)

    def from_lm(x):
        x = jnp.swapaxes(x, 0, 1).reshape((L * NB,) + x.shape[2:])
        return x[:N]

    return jax.tree_util.tree_map(from_lm, full)


def _id_affine(elems):
    """Identity for (A (N,J,J), b (N,...)) affine elements."""
    A, b = elems
    J = A.shape[-1]
    return (
        jnp.broadcast_to(jnp.eye(J, dtype=A.dtype), (1,) + A.shape[1:]),
        jnp.zeros((1,) + b.shape[1:], b.dtype),
    )


def _id_diag(elems):
    alpha, beta = elems
    return (
        jnp.ones((1,) + alpha.shape[1:], alpha.dtype),
        jnp.zeros((1,) + beta.shape[1:], beta.dtype),
    )


def _id_riccati(elems):
    A, Q, R = elems
    J = A.shape[-1]
    return (
        jnp.broadcast_to(jnp.eye(J, dtype=A.dtype), (1,) + A.shape[1:]),
        jnp.zeros((1,) + Q.shape[1:], Q.dtype),
        jnp.zeros((1,) + R.shape[1:], R.dtype),
    )


def _vmapped(x) -> bool:
    """True when tracing under vmap (a chain-fleet batch): memory-bound
    paths must then prefer structured over materialized elements."""
    try:
        from jax._src.interpreters.batching import BatchTracer
    except ImportError:  # pragma: no cover - moved across jax versions
        return False
    return isinstance(x, BatchTracer)


def _engine_scan(combine, elems, identity, *, reverse=False,
                 distribute_combine=None):
    """Run the configured prefix-composition engine.

    ``distribute_combine`` is a two-level-only optimization (see
    :func:`two_level_prefix`); the associative_scan path ignores it
    (full results everywhere), so callers may rely only on the leaves
    the reduced combine documents as valid.
    """
    from celerite2_tpu.config import get_config

    if get_config().engine == "two_level":
        return two_level_prefix(
            combine, elems, identity, reverse=reverse,
            distribute_combine=distribute_combine,
        )
    return lax.associative_scan(combine, elems, reverse=reverse)


# ===================================================== diagonal affine


def _diag_affine_scan(alpha, beta, *, reverse=False):
    """Prefix (or suffix) solutions of f_n = alpha_n * f_{prev} + beta_n.

    ``fn(a, b)`` in ``associative_scan`` always composes "a applied first,
    b applied after" — with ``reverse=True`` jax flips the operands and
    runs the same forward scan, so the combine is identical.
    """

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, a2 * b1 + b2

    _, f = _engine_scan(combine, (alpha, beta), _id_diag,
                        reverse=reverse,
                        distribute_combine=_diag_distribute_b)
    return f


@_full_precision
def matmul_lower_assoc(t, c, U, V, Y):
    phi = transport(t, c)  # (N, J); row 0 = 0
    G = V[:, :, None] * Y[:, None, :]  # (N, J, K)
    # F_n = phi_n * (F_{n-1} + G_{n-1}) ->
    #   alpha_n = phi_n, beta_n = phi_n * G_{n-1}
    G_prev = jnp.concatenate([jnp.zeros_like(G[:1]), G[:-1]], axis=0)
    alpha = phi[:, :, None]
    beta = alpha * G_prev
    F_post = _diag_affine_scan(
        jnp.broadcast_to(alpha, G.shape), beta
    )
    Z = jnp.sum(U[:, :, None] * F_post, axis=1)
    # pre-transport cache (reference workspace convention)
    F_pre = (
        jnp.concatenate([jnp.zeros_like(F_post[:1]), F_post[:-1]], axis=0)
        + G_prev
    )
    return Z, F_pre


@_full_precision
def matmul_upper_assoc(t, c, U, V, Y):
    phi = transport_up(t, c)  # (N, J); row N-1 = 0
    G = U[:, :, None] * Y[:, None, :]
    G_next = jnp.concatenate([G[1:], jnp.zeros_like(G[:1])], axis=0)
    alpha = phi[:, :, None]
    beta = alpha * G_next
    F_post = _diag_affine_scan(
        jnp.broadcast_to(alpha, G.shape), beta, reverse=True
    )
    Z = jnp.sum(V[:, :, None] * F_post, axis=1)
    F_pre = (
        jnp.concatenate([F_post[1:], jnp.zeros_like(F_post[:1])], axis=0)
        + G_next
    )
    return Z, F_pre


# ======================================================= dense affine


def _bmm(A, B):
    """Batched (..., n, m) @ (..., m, k).

    Small matmuls (m < 16) use broadcast-multiply-reduce, which XLA
    fuses with the surrounding elementwise work instead of launching a
    batched GEMM of tiny tiles.  Contractions of m >= 16 (the J^2-sized
    reverse block maps) use a real dot_general: there the broadcast
    intermediate (..., n, m, k) is m^3/element and materializes into
    GBs under vmapped fleets.  Callers run inside
    ``default_matmul_precision("highest")`` (``_full_precision``), so
    the dot_general branch never drops to TF32.
    """
    m = A.shape[-1]
    if m >= 16:
        return A @ B
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def _bmv(A, x):
    """Batched matrix-vector product (..., n, m) @ (..., m)."""
    if A.shape[-1] >= 16:
        return jnp.einsum("...nm,...m->...n", A, x)
    return jnp.sum(A * x[..., None, :], axis=-1)


def _mat_affine_combine(e1, e2):
    """(A, b) composition for F' = A2 (A1 F + b1) + b2 (e1 earlier)."""
    A1, b1 = e1
    A2, b2 = e2
    return _bmm(A2, A1), _bmm(A2, b1) + b2


def _affine_distribute_b(e1, e2):
    """Distribute-phase affine combine: only the b (state) slot of the
    result is valid; the A slot is a passthrough placeholder.  Skips
    the (D, D) @ (D, D) map product — the fattest op of the engine's
    fattest phase — for callers that consume per-row STATES only."""
    A1, b1 = e1
    A2, b2 = e2
    return A2, _bmm(A2, b1) + b2


def _diag_distribute_b(e1, e2):
    """Diagonal-affine distribute: only beta is valid."""
    a1, b1 = e1
    a2, b2 = e2
    return a2, a2 * b1 + b2


@_full_precision
def solve_lower_assoc(t, c, U, W, Y):
    N, J = U.shape
    phi = transport(t, c)
    I = jnp.eye(J, dtype=U.dtype)
    # elements for n >= 1; element 0 annihilates (F_0 = 0)
    A_body = phi[1:, :, None] * (
        I[None] - jnp.einsum("nj,nk->njk", W[:-1], U[:-1])
    )
    A = jnp.concatenate([jnp.zeros((1, J, J), U.dtype), A_body], axis=0)
    b_body = phi[1:, :, None] * jnp.einsum(
        "nj,nk->njk", W[:-1], Y[:-1]
    )
    b = jnp.concatenate(
        [jnp.zeros((1, J, Y.shape[1]), Y.dtype), b_body], axis=0
    )
    with jax.default_matmul_precision("highest"):
        A_pref, b_pref = _engine_scan(
            _mat_affine_combine, (A, b), _id_affine,
            distribute_combine=_affine_distribute_b,
        )
    F_post = b_pref  # applied to F_init = 0
    Z = Y - jnp.sum(U[:, :, None] * F_post, axis=1)
    F_prev = jnp.concatenate(
        [jnp.zeros_like(F_post[:1]), F_post[:-1]], axis=0
    )
    Z_prev = jnp.concatenate([jnp.zeros_like(Z[:1]), Z[:-1]], axis=0)
    W_prev = jnp.concatenate([jnp.zeros_like(W[:1]), W[:-1]], axis=0)
    F_pre = F_prev + jnp.einsum("nj,nk->njk", W_prev, Z_prev)
    return Z, F_pre


@_full_precision
def solve_upper_assoc(t, c, U, W, Y):
    N, J = U.shape
    phi = transport_up(t, c)
    I = jnp.eye(J, dtype=U.dtype)
    # F_n = diag(phi_n)(I - u_{n+1} w_{n+1}^T) F_{n+1}
    #       + diag(phi_n) u_{n+1} y_{n+1}^T
    A_body = phi[:-1, :, None] * (
        I[None] - jnp.einsum("nj,nk->njk", U[1:], W[1:])
    )
    A = jnp.concatenate([A_body, jnp.zeros((1, J, J), U.dtype)], axis=0)
    b_body = phi[:-1, :, None] * jnp.einsum("nj,nk->njk", U[1:], Y[1:])
    b = jnp.concatenate(
        [b_body, jnp.zeros((1, J, Y.shape[1]), Y.dtype)], axis=0
    )

    with jax.default_matmul_precision("highest"):
        A_pref, b_pref = _engine_scan(
            _mat_affine_combine, (A, b), _id_affine, reverse=True,
            distribute_combine=_affine_distribute_b,
        )
    F_post = b_pref
    Z = Y - jnp.sum(W[:, :, None] * F_post, axis=1)
    F_next = jnp.concatenate(
        [F_post[1:], jnp.zeros_like(F_post[:1])], axis=0
    )
    Z_next = jnp.concatenate([Z[1:], jnp.zeros_like(Z[:1])], axis=0)
    U_next = jnp.concatenate([U[1:], jnp.zeros_like(U[:1])], axis=0)
    F_pre = F_next + jnp.einsum("nj,nk->njk", U_next, Z_next)
    return Z, F_pre


# ============================================================= factor


def _mT(x):
    return jnp.swapaxes(x, -1, -2)


def _small_inv(M):
    """Batched closed-form inverse of a J x J matrix (J = 1, 2, or a
    power of two via 2x2-block Schur recursion; other J are bordered).

    No pivoting / argmax: a pivoted Gauss-Jordan fallback would put
    data-dependent gathers in every combine of the engine.  The
    matrices inverted here are ``I + Q R`` Riccati Gram combinations,
    which are far from singular for valid (positive-definite) systems —
    but invertibility of the FULL matrix does not guarantee
    invertibility of its leading principal blocks, so the 2x2 base case
    clamps its determinant magnitude: a (rare) near-singular leading
    block yields large-but-finite values that the quiet non-PD
    semantics absorb, instead of inf/NaN poisoning the whole engine.
    """
    J = M.shape[-1]
    if J == 1:
        return 1.0 / M
    if J == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        d = M[..., 1, 1]
        det = a * d - b * c
        # scale-aware determinant floor (quiet-failure guard)
        floor = jnp.finfo(M.dtype).eps * (
            jnp.abs(a * d) + jnp.abs(b * c)
        ) + jnp.finfo(M.dtype).tiny
        det = jnp.where(
            jnp.abs(det) >= floor,
            det,
            jnp.where(det < 0, -floor, floor),
        )
        inv = jnp.stack(
            [
                jnp.stack([d, -b], axis=-1),
                jnp.stack([-c, a], axis=-1),
            ],
            axis=-2,
        )
        return inv / det[..., None, None]
    if J % 2:
        # border to even size with an identity block (exact)
        pad = [(0, 0)] * (M.ndim - 2) + [(0, 1), (0, 1)]
        Mp = jnp.pad(M, pad)
        eye_fix = jnp.zeros_like(Mp).at[..., J, J].set(1.0)
        return _small_inv(Mp + eye_fix)[..., :J, :J]
    h = J // 2
    A = M[..., :h, :h]
    B = M[..., :h, h:]
    C = M[..., h:, :h]
    D = M[..., h:, h:]
    Ai = _small_inv(A)
    AiB = _bmm(Ai, B)
    Si = _small_inv(D - _bmm(C, AiB))
    CAi = _bmm(C, Ai)
    AiBSi = _bmm(AiB, Si)
    TL = Ai + _bmm(AiBSi, CAi)
    TR = -AiBSi
    BL = -_bmm(Si, CAi)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _small_solve(M, B):
    """Batched J x J solve via the closed-form inverse (see _small_inv)."""
    return _bmm(_small_inv(M), B)


def _riccati_combine(e1, e2):
    """Compose Riccati elements (e1 earlier, e2 later)."""
    A1, Q1, R1 = e1
    A2, Q2, R2 = e2
    J = A1.shape[-1]
    I = jnp.eye(J, dtype=A1.dtype)
    # Gamma = (I + Q1 R2)^{-1}; the push-through identity
    # (I + R2 Q1)^{-1} R2 == R2 Gamma shares ONE inverse for all three
    # uses (was two independent solves)
    G = _small_inv(I + _bmm(Q1, R2))
    GA1 = _bmm(G, A1)
    GQ1 = _bmm(G, Q1)
    R2G = _bmm(R2, G)
    A12 = _bmm(A2, GA1)
    Q12 = Q2 + _bmm(_bmm(A2, GQ1), _mT(A2))
    R12 = R1 + _bmm(_bmm(_mT(A1), R2G), A1)
    # symmetrize to fight drift over long products
    Q12 = 0.5 * (Q12 + _mT(Q12))
    R12 = 0.5 * (R12 + _mT(R12))
    return A12, Q12, R12


def _riccati_distribute_Q(e1, e2):
    """Distribute-phase Riccati combine: only the Q slot (the composed
    state applied to S0 = 0) is valid; A/R are passthroughs.  One
    solve + two products instead of the full five."""
    A1, Q1, R1 = e1
    A2, Q2, R2 = e2
    J = A1.shape[-1]
    I = jnp.eye(J, dtype=A1.dtype)
    GQ1 = _small_solve(I + _bmm(Q1, R2), Q1)
    Q12 = Q2 + _bmm(_bmm(A2, GQ1), _mT(A2))
    Q12 = 0.5 * (Q12 + _mT(Q12))
    return A2, Q12, R2


@_full_precision
def factor_assoc(t, c, a, U, V):
    """Associative-scan LDL^T.  Returns ``(d, W, S_half)`` identical to
    :func:`celerite2_tpu.ops.scan.factor_scan`."""
    N, J = U.shape
    phi = transport(t, c)
    I = jnp.eye(J, dtype=U.dtype)

    ar = _safe(a)
    # elements n >= 1 built from row n-1 and phi_n
    u, v = U[:-1], V[:-1]
    al = ar[:-1, None, None]
    p = phi[1:]
    A_body = p[:, :, None] * (
        I[None] - jnp.einsum("nj,nk->njk", v, u) / al
    )
    Q_body = (
        p[:, :, None]
        * (jnp.einsum("nj,nk->njk", v, v) / al)
        * p[:, None, :]
    )
    R_body = -jnp.einsum("nj,nk->njk", u, u) / al
    # element 0 = identity map
    A = jnp.concatenate([I[None], A_body], axis=0)
    Q = jnp.concatenate([jnp.zeros((1, J, J), U.dtype), Q_body], axis=0)
    R = jnp.concatenate([jnp.zeros((1, J, J), U.dtype), R_body], axis=0)

    # f32 matmuls may run in TF32 on the GPU (~3 decimal digits);
    # 1e5 Riccati compositions need full precision or pivots go negative
    with jax.default_matmul_precision("highest"):
        _, S_full, _ = _engine_scan(
            _riccati_combine, (A, Q, R), _id_riccati,
            distribute_combine=_riccati_distribute_Q,
        )
    # S applied to S_init = 0 is just the combined Q
    d = a - jnp.sum(_bmv(S_full, U) * U, axis=-1)
    W = (V - _bmv(S_full, U)) / _safe(d)[:, None]

    # one-sided cache: S_half_n = diag(phi_n)(S_full_{n-1} + d W W^T)
    S_prev = jnp.concatenate(
        [jnp.zeros_like(S_full[:1]), S_full[:-1]], axis=0
    )
    d_prev = jnp.concatenate([jnp.zeros_like(d[:1]), d[:-1]])
    W_prev = jnp.concatenate([jnp.zeros_like(W[:1]), W[:-1]], axis=0)
    S_half = phi[:, :, None] * (
        S_prev
        + d_prev[:, None, None]
        * jnp.einsum("nj,nk->njk", W_prev, W_prev)
    )
    return d, W, S_half


# ================================================ fused factor + solve
#
# The log-likelihood needs `factor` THEN `solve_lower` — two engine
# passes if run separately.  The pair is exactly a Kalman filter
# (celerite kernels are state-space models): S plays the predictive
# covariance (Riccati flow), the solve feedback carry F plays the mean.
# The temporal-parallelization-of-Kalman-filters element
# (Sarkka & Garcia-Fernandez 2021) extends the (A, Q, R) Riccati element
# with two J x K components (b, eta), acting on (S, F) as
#
#     S' = A (I + S R)^{-1} S A^T + Q
#     F' = A (I + S R)^{-1} (F + S eta) + b
#
# Verified single-step fit (derivation in factor_solve_assoc): with the
# factor element (A, Q, R) of `factor_assoc` built from row data
# (phi, a, u, v) and
#
#     b = diag(phi) v y^T / a,   eta = -u y^T / a
#
# the composed action reproduces the fused recursion
#     F_n = diag(phi_n)(F_{n-1} + w_{n-1} z_{n-1}^T),
#     z_n = y_n - U_n^T F_n
# with w, z the factor/solve outputs of row n-1.  One engine pass now
# yields d, W, AND the whitened residual z.


def _id_kalman(elems):
    A, Q, R, b, eta = elems
    J = A.shape[-1]
    return (
        jnp.broadcast_to(jnp.eye(J, dtype=A.dtype), (1,) + A.shape[1:]),
        jnp.zeros((1,) + Q.shape[1:], Q.dtype),
        jnp.zeros((1,) + R.shape[1:], R.dtype),
        jnp.zeros((1,) + b.shape[1:], b.dtype),
        jnp.zeros((1,) + eta.shape[1:], eta.dtype),
    )


def _kalman_combine(e1, e2):
    """Compose fused factor+solve elements (e1 earlier, e2 later)."""
    A1, Q1, R1, b1, eta1 = e1
    A2, Q2, R2, b2, eta2 = e2
    J = A1.shape[-1]
    I = jnp.eye(J, dtype=A1.dtype)
    # Gamma = (I + Q1 R2)^{-1}; the push-through identity gives every
    # (I + R2 Q1)^{-1} X as either X' Gamma or via Gamma^T products, so
    # ONE inverse serves all five uses:
    #   (I + R2 Q1)^{-1} R2        == R2 Gamma
    #   (I + R2 Q1)^{-1} v         == (I - R2 Gamma Q1) v
    G = _small_inv(I + _bmm(Q1, R2))
    GA1 = _bmm(G, A1)
    GQ1 = _bmm(G, Q1)
    Gb = _bmm(G, b1 + _bmm(Q1, eta2))
    R2G = _bmm(R2, G)
    vE = eta2 - _bmm(R2, b1)
    Eeta = vE - _bmm(R2G, _bmm(Q1, vE))
    A12 = _bmm(A2, GA1)
    Q12 = Q2 + _bmm(_bmm(A2, GQ1), _mT(A2))
    R12 = R1 + _bmm(_bmm(_mT(A1), R2G), A1)
    b12 = b2 + _bmm(A2, Gb)
    eta12 = eta1 + _bmm(_mT(A1), Eeta)
    Q12 = 0.5 * (Q12 + _mT(Q12))
    R12 = 0.5 * (R12 + _mT(R12))
    return A12, Q12, R12, b12, eta12


def _kalman_distribute(e1, e2):
    """Distribute-phase fused combine: only the Q (covariance state)
    and b (mean state) slots of the result are valid."""
    A1, Q1, R1, b1, eta1 = e1
    A2, Q2, R2, b2, eta2 = e2
    J = A1.shape[-1]
    I = jnp.eye(J, dtype=A1.dtype)
    rhs = jnp.concatenate([Q1, b1 + _bmm(Q1, eta2)], axis=-1)
    G = _small_solve(I + _bmm(Q1, R2), rhs)
    GQ1 = G[..., :J]
    Gb = G[..., J:]
    Q12 = Q2 + _bmm(_bmm(A2, GQ1), _mT(A2))
    Q12 = 0.5 * (Q12 + _mT(Q12))
    b12 = b2 + _bmm(A2, Gb)
    return A2, Q12, R2, b12, eta2


@_full_precision
def factor_solve_assoc(t, c, a, U, V, Y):
    """Fused factor + lower solve in ONE engine pass.

    Returns ``(d, W, Z, S_half, F_pre)`` bit-matching
    ``factor_assoc`` + ``solve_lower_assoc`` cache conventions (the
    standard reverse tiers consume them unchanged).
    """
    N, J = U.shape
    K = Y.shape[1]
    phi = transport(t, c)
    I = jnp.eye(J, dtype=U.dtype)

    ar = _safe(a)
    u, v = U[:-1], V[:-1]
    al = ar[:-1, None, None]
    p = phi[1:]
    A_body = p[:, :, None] * (
        I[None] - jnp.einsum("nj,nk->njk", v, u) / al
    )
    Q_body = (
        p[:, :, None]
        * (jnp.einsum("nj,nk->njk", v, v) / al)
        * p[:, None, :]
    )
    R_body = -jnp.einsum("nj,nk->njk", u, u) / al
    y_over_a = Y[:-1] / ar[:-1, None]
    b_body = p[:, :, None] * jnp.einsum("nj,nk->njk", v, y_over_a)
    eta_body = -jnp.einsum("nj,nk->njk", u, y_over_a)

    A = jnp.concatenate([I[None], A_body], axis=0)
    Q = jnp.concatenate([jnp.zeros((1, J, J), U.dtype), Q_body], axis=0)
    R = jnp.concatenate([jnp.zeros((1, J, J), U.dtype), R_body], axis=0)
    b = jnp.concatenate([jnp.zeros((1, J, K), Y.dtype), b_body], axis=0)
    eta = jnp.concatenate(
        [jnp.zeros((1, J, K), Y.dtype), eta_body], axis=0
    )

    with jax.default_matmul_precision("highest"):
        _, S_full, _, F_post, _ = _engine_scan(
            _kalman_combine, (A, Q, R, b, eta), _id_kalman,
            distribute_combine=_kalman_distribute,
        )
    # prefix applied to (S0, F0) = (0, 0): S = combined Q, F = combined b
    d = a - jnp.sum(_bmv(S_full, U) * U, axis=-1)
    W = (V - _bmv(S_full, U)) / _safe(d)[:, None]
    Z = Y - jnp.sum(U[:, :, None] * F_post, axis=1)

    # caches in the standard conventions
    S_prev = jnp.concatenate(
        [jnp.zeros_like(S_full[:1]), S_full[:-1]], axis=0
    )
    d_prev = jnp.concatenate([jnp.zeros_like(d[:1]), d[:-1]])
    W_prev = jnp.concatenate([jnp.zeros_like(W[:1]), W[:-1]], axis=0)
    S_half = phi[:, :, None] * (
        S_prev
        + d_prev[:, None, None]
        * jnp.einsum("nj,nk->njk", W_prev, W_prev)
    )
    F_prev = jnp.concatenate(
        [jnp.zeros_like(F_post[:1]), F_post[:-1]], axis=0
    )
    Z_prev = jnp.concatenate([jnp.zeros_like(Z[:1]), Z[:-1]], axis=0)
    F_pre = F_prev + jnp.einsum("nj,nk->njk", W_prev, Z_prev)
    return d, W, Z, S_half, F_pre


# ===================================================== reverse sweeps
#
# The adjoint recursions (reference reverse.hpp / internal.hpp:191-303)
# are *affine* in their carried state, so they parallelize exactly like
# the forwards:
#   * matmul_rev:  bF' = diag(p)(bF + a bz^T)            — diagonal affine
#   * solve_rev:   bF' = diag(p)[(I - a b^T) bF - a bz^T] — J x J affine
#   * factor_rev:  bS' = p (.) Lin(bS) (.) p + const      — J^2 affine
# The factor operator Lin is materialized by applying the (hand-derived)
# step map to the J^2 basis matrices — bug-resistant and exact.


def _suffix_states(elems, combine, identity, *, reverse,
                   distribute_combine=None):
    """Inclusive prefix/suffix composition results for affine elements."""
    with jax.default_matmul_precision("highest"):
        return _engine_scan(combine, elems, identity, reverse=reverse,
                            distribute_combine=distribute_combine)


@_full_precision
def sweep_rev_assoc(t, c, A, B, Y, Z, F, bZ, *, is_solve, upper):
    """Associative-scan twin of scan.sweep_rev_scan (same outputs)."""
    N, J = A.shape
    K = Y.shape[1]
    dtype = Y.dtype
    phi = transport_up(t, c) if upper else transport(t, c)
    if upper:
        dts = -jnp.concatenate([jnp.diff(t), jnp.zeros((1,), t.dtype)])
    else:
        dts = jnp.concatenate([jnp.zeros((1,), t.dtype), -jnp.diff(t)])
    sign = -1.0 if is_solve else 1.0
    R_rows = Z if is_solve else Y

    if not upper:
        # active steps n = 1..N-1, applied in decreasing n
        sl_step = slice(1, None)
        sl_feed = slice(None, -1)  # feeder/prev rows n-1
    else:
        # active steps n = 0..N-2, applied in increasing n
        sl_step = slice(None, -1)
        sl_feed = slice(1, None)  # feeder rows n+1

    p = phi[sl_step]  # (N-1, J)
    dt = dts[sl_step]
    An = A[sl_step]
    Bn = B[sl_step]  # row n's own feeder row (deferral consumption)
    Bfeed = B[sl_feed]  # neighbour feeder row (deferral emission)
    bZn = bZ[sl_step]
    Fn = F[sl_step]

    if is_solve:
        # matrix affine elements
        I = jnp.eye(J, dtype=dtype)
        Amat = p[:, :, None] * (
            I[None] - jnp.einsum("nj,nk->njk", An, Bn)
        )
        bvec = -p[:, :, None] * jnp.einsum("nj,nk->njk", An, bZn)
        _, R = _suffix_states(
            (Amat, bvec), _mat_affine_combine, _id_affine,
            reverse=not upper,
            distribute_combine=_affine_distribute_b,
        )  # applied to zero init
    else:
        alpha = jnp.broadcast_to(p[:, :, None], (p.shape[0], J, K))
        beta = p[:, :, None] * (
            sign * jnp.einsum("nj,nk->njk", An, bZn)
        )

        def diag_combine(e1, e2):
            a1, b1 = e1
            a2, b2 = e2
            return a2 * a1, a2 * b1 + b2

        _, R = _suffix_states(
            (alpha, beta), diag_combine, _id_diag, reverse=not upper,
            distribute_combine=_diag_distribute_b,
        )

    # carry entering step n: the state AFTER the neighbouring step
    zero = jnp.zeros((1, J, K), dtype)
    if not upper:
        bF_in = jnp.concatenate([R[1:], zero], axis=0)
    else:
        bF_in = jnp.concatenate([zero, R[:-1]], axis=0)

    # effective bz (solves accumulate the deferred contribution)
    if is_solve:
        bz_eff = bZn + jnp.sum(bF_in * Bn[:, :, None], axis=1)
    else:
        bz_eff = bZn

    pF = p[:, :, None] * Fn
    bA_steps = sign * _bmv(pF, bz_eff)
    mid = bF_in + sign * jnp.einsum("nj,nk->njk", An, bz_eff)
    bp = jnp.sum(Fn * mid, axis=-1) * p
    bc = jnp.sum(bp * dt[:, None], axis=0)
    ft = bp @ c
    post = p[:, :, None] * mid  # == R at each step
    dbB = _bmv(post, R_rows[sl_feed])
    dbR = jnp.sum(post * Bfeed[:, :, None], axis=1)

    # ---- assemble per-row outputs (same layout as the scan version)
    zJ = jnp.zeros((1, J), dtype)
    zK = jnp.zeros((1, K), dtype)
    if not upper:
        bA = jnp.concatenate([zJ, bA_steps])
        bB = jnp.concatenate([dbB, zJ])
        if is_solve:
            bY = jnp.concatenate([(bZ[0] + dbR[0])[None] if N > 1 else bZ[:1], bz_eff])
            # note: dbR[0] is the deferral emitted by step n=1 onto row 0
        else:
            bY = jnp.concatenate([dbR, zK])
        ft_full = jnp.concatenate([jnp.zeros((1,), t.dtype), ft])
        bt = -ft_full
        bt = bt.at[:-1].add(ft_full[1:])
    else:
        bA = jnp.concatenate([bA_steps, zJ])
        bB = jnp.concatenate([zJ, dbB])
        if is_solve:
            bY = jnp.concatenate([bz_eff, (bZ[-1] + dbR[-1])[None] if N > 1 else bZ[-1:]])
        else:
            bY = jnp.concatenate([zK, dbR])
        ft_full = jnp.concatenate([ft, jnp.zeros((1,), t.dtype)])
        bt = ft_full
        bt = bt.at[1:].add(-ft_full[:-1])

    return bt, bc, bA, bB, bY


def _frev_apply(M, par, *, affine: bool):
    """One reverse-factor step applied to the carried matrix M.

    The step (math of reference reverse.hpp:58-81, reorganized as an
    affine flow):
      bv  = [bv0] + (M + M^T) w
      ba  = [bdp] - w^T M w
      M'  = p (.) [M - u (x) bv - ba u (x) u] (.) p
    ``affine=False`` drops the bracketed constants (the linear part).
    Batches over any leading dims; O(J^2) per application.
    """
    p, u, w, bv0, bdp = par
    Mw = _bmv(M, w)
    bv = Mw + _bmv(_mT(M), w)
    ba = -jnp.sum(w * Mw, axis=-1)
    if affine:
        bv = bv + bv0
        ba = ba + bdp
    uu = u[..., :, None] * u[..., None, :]
    mid = (
        M
        - u[..., :, None] * bv[..., None, :]
        - ba[..., None, None] * uu
    )
    return p[..., :, None] * mid * p[..., None, :]


def _frev_identity_params(par, n):
    """Identity-step padding (p=1, everything else 0)."""
    p, u, w, bv0, bdp = par
    J = p.shape[-1]
    return (
        jnp.ones((n, J), p.dtype),
        jnp.zeros((n, J), u.dtype),
        jnp.zeros((n, J), w.dtype),
        jnp.zeros((n, J), bv0.dtype),
        jnp.zeros((n,), bdp.dtype),
    )


def _frev_suffix_states(par, *, block=None):
    """Carry entering every reverse-factor step, for ANY J.

    ``par = (p, u, w, bv0, bdp)`` in step order n = 1..N-1 (ascending);
    steps are applied in DECREASING n.  Returns ``M_in (N-1, J, J)`` —
    the state each step consumes (suffix composition of all later steps
    applied to the zero initial state).

    Instead of materializing each step as a (J^2, J^2) matrix (O(N J^4)
    memory — the round-1 J<=4 limit), the steps stay *structured*
    (O(J^2) to apply) and only per-BLOCK composed maps are densified:

      A. per block, push the J^2 basis matrices + the zero state through
         the block's steps (batched across blocks) -> dense block map;
      B. prefix-compose the ~N/B block maps with the standard affine
         engine;
      C. re-run each block from its incoming composed state, emitting
         the per-step carries.

    Work O(N J^4), memory O(N J + (N/B) J^4).
    """
    if block is None:
        from celerite2_tpu.config import get_config

        block = get_config().engine_block
    p = par[0]
    M_steps = p.shape[0]
    J = p.shape[-1]
    dtype = p.dtype

    # application order = reversed step order
    par_app = jax.tree_util.tree_map(lambda x: x[::-1], par)

    L = min(block, M_steps) or 1
    NB = -(-M_steps // L)
    pad = L * NB - M_steps
    if pad:
        ident = _frev_identity_params(par_app, pad)
        par_app = jax.tree_util.tree_map(
            lambda x, i: jnp.concatenate([x, i], axis=0), par_app, ident
        )

    def to_lm(x):
        x = x.reshape((NB, L) + x.shape[1:])
        return jnp.swapaxes(x, 0, 1)

    par_lm = jax.tree_util.tree_map(to_lm, par_app)  # leaves (L, NB, ...)

    # ---- phase A: block maps via basis propagation
    basis = jnp.eye(J * J, dtype=dtype).reshape(J * J, J, J)
    basis = jnp.broadcast_to(basis[None], (NB, J * J, J, J))
    const = jnp.zeros((NB, J, J), dtype)

    def stepA(carry, par_n):
        Bas, Con = carry
        par_ch = jax.tree_util.tree_map(
            lambda x: x[:, None, ...], par_n
        )  # broadcast over the J^2 basis channels
        Bas = _frev_apply(Bas, par_ch, affine=False)
        Con = _frev_apply(Con, par_n, affine=True)
        return (Bas, Con), None

    (BasF, ConF), _ = lax.scan(stepA, (basis, const), par_lm)
    # column k of the block map = vec of the image of basis matrix k
    L_blk = jnp.swapaxes(BasF.reshape(NB, J * J, J * J), -1, -2)
    c_blk = ConF.reshape(NB, J * J)

    # ---- phase B: compose block maps (application order)
    with jax.default_matmul_precision("highest"):
        L_pref, c_pref = _engine_scan(
            _mat_affine_combine, (L_blk, c_blk[..., None]), _id_affine,
            distribute_combine=_affine_distribute_b,
        )
    # exclusive prefix applied to the zero init -> incoming block state
    c_excl = jnp.concatenate(
        [jnp.zeros_like(c_pref[:1]), c_pref[:-1]], axis=0
    )
    M_in_blk = c_excl.reshape(NB, J, J)

    # ---- phase C: emit the carry entering each step
    def stepC(carry, par_n):
        out = carry
        carry = _frev_apply(carry, par_n, affine=True)
        return carry, out

    _, M_pre = lax.scan(stepC, M_in_blk, par_lm)  # (L, NB, J, J)
    M_in_app = jnp.swapaxes(M_pre, 0, 1).reshape(NB * L, J, J)[:M_steps]
    return M_in_app[::-1]


# ------------------------------------------------- paired reverse pass
#
# The fused log-likelihood backward needs the solve adjoint
# (internal.hpp:191-303 math) THEN the factor adjoint
# (reverse.hpp:10-85 math) — two engine passes if run separately,
# coupled through bW: the solve's gradient w.r.t. W feeds the factor
# reverse one row later.  Both carries evolve affinely, and the
# coupling is causal in the shared (decreasing-n) step order, so ONE
# structured affine state
#
#     x = [bF (J), dbR (1), dbB (J), vec(bS) (J^2)]
#
# runs the whole backward in a single two-level pass (K = 1, the
# log-likelihood case).  dbR / dbB are the one-step deferrals: the
# solve contribution to the next row's bz and bW respectively.


def _pair_dim(J):
    return 2 * J + 1 + J * J


def _pair_rev_apply(x, par, *, affine: bool):
    """One joint (solve + factor) reverse step on the flat state x.

    ``par = (p, u, w, w_prev, z_prev, bZn, bWn, bdn, dinv)`` — per-step
    row data (constants only enter when ``affine``).  Batches over
    leading dims; O(J^2) per application.
    """
    p, u, w, w_prev, z_prev, bZn, bWn, bdn, dinv = par
    J = p.shape[-1]
    bF = x[..., :J]
    dbR = x[..., J]
    dbB = x[..., J + 1 : 2 * J + 1]
    M = x[..., 2 * J + 1 :].reshape(x.shape[:-1] + (J, J))

    # solve part
    bz = dbR + (bZn if affine else 0.0)
    bF_mid = bF - u * bz[..., None]
    bF_out = p * bF_mid
    dbR_out = jnp.sum(bF_out * w_prev, axis=-1)
    dbB_out = bF_out * z_prev[..., None]

    # factor part (consumes the dbB deferred by the later solve step)
    bv0 = dbB * dinv[..., None]
    bdp = -jnp.sum(w * bv0, axis=-1)
    if affine:
        bv0 = bv0 + bWn * dinv[..., None]
        bdp = bdp + bdn - jnp.sum(w * bWn, axis=-1) * dinv
    M_out = _frev_apply(M, (p, u, w, bv0, bdp), affine=True)
    # (bv0/bdp already carry the affine constants; _frev_apply's own
    # affine flag just includes them in bv/ba, which is always wanted)

    return jnp.concatenate(
        [
            bF_out,
            dbR_out[..., None],
            dbB_out,
            M_out.reshape(x.shape[:-1] + (J * J,)),
        ],
        axis=-1,
    )


def _pair_identity_params(par, n):
    p = par[0]
    J = p.shape[-1]
    f = p.dtype
    zJ = jnp.zeros((n, J), f)
    z = jnp.zeros((n,), f)
    return (jnp.ones((n, J), f), zJ, zJ, zJ, z, z, zJ, z, z)


def _structured_suffix_states(apply_fn, identity_fn, par, dim,
                              *, block=None):
    """Incoming flat state for every step of a structured affine suffix
    flow (generic twin of :func:`_frev_suffix_states`).

    ``apply_fn(x, par, affine=...)`` applies one step to flat states x
    (any leading batch dims); steps given in step order (ascending) are
    applied in DESCENDING order.  Returns (x_in (M, dim), x_final
    (dim,)) — per-step incoming states and the state after ALL steps.
    """
    if block is None:
        from celerite2_tpu.config import get_config

        block = get_config().engine_block
    p = par[0]
    M_steps = p.shape[0]
    dtype = p.dtype
    if M_steps == 0:
        # zero steps (N = 1): nothing to compose (mirrors the dense
        # twin _pair_dense_suffix_states' M_steps guard)
        return (
            jnp.zeros((0, dim), dtype),
            jnp.zeros((dim,), dtype),
        )

    par_app = jax.tree_util.tree_map(lambda x: x[::-1], par)
    L = min(block, M_steps) or 1
    NB = -(-M_steps // L)
    pad = L * NB - M_steps
    if pad:
        # padding steps sit AFTER every real step in application order;
        # no real row consumes their (zeroed) deferrals
        ident = identity_fn(par_app, pad)
        par_app = jax.tree_util.tree_map(
            lambda x, i: jnp.concatenate([x, i], axis=0), par_app, ident
        )

    def to_lm(x):
        x = x.reshape((NB, L) + x.shape[1:])
        return jnp.swapaxes(x, 0, 1)

    par_lm = jax.tree_util.tree_map(to_lm, par_app)

    basis = jnp.broadcast_to(
        jnp.eye(dim, dtype=dtype)[None], (NB, dim, dim)
    )
    const = jnp.zeros((NB, dim), dtype)

    def stepA(carry, par_n):
        Bas, Con = carry
        par_ch = jax.tree_util.tree_map(lambda x: x[:, None], par_n)
        Bas = apply_fn(Bas, par_ch, affine=False)
        Con = apply_fn(Con, par_n, affine=True)
        return (Bas, Con), None

    (BasF, ConF), _ = lax.scan(stepA, (basis, const), par_lm)
    L_blk = jnp.swapaxes(BasF, -1, -2)  # column k = image of e_k
    c_blk = ConF

    with jax.default_matmul_precision("highest"):
        _, c_pref = _engine_scan(
            _mat_affine_combine, (L_blk, c_blk[..., None]), _id_affine,
            distribute_combine=_affine_distribute_b,
        )
    c_excl = jnp.concatenate(
        [jnp.zeros_like(c_pref[:1]), c_pref[:-1]], axis=0
    )
    x_in_blk = c_excl[..., 0]

    def stepC(carry, par_n):
        out = carry
        carry = apply_fn(carry, par_n, affine=True)
        return carry, out

    _, x_pre = lax.scan(stepC, x_in_blk, par_lm)
    x_in = jnp.swapaxes(x_pre, 0, 1).reshape(NB * L, dim)[:M_steps]
    x_in = x_in[::-1]
    # state after ALL steps: apply the last-applied step (step order 0)
    # explicitly — the in-block final carry would include padding steps,
    # which are NOT identities on the deferral components
    first_par = jax.tree_util.tree_map(lambda x: x[0], par)
    x_fin = apply_fn(x_in[0], first_par, affine=True)
    return x_in, x_fin


def _pair_dense_elements(par, dim):
    """Densify paired-flow steps: per-row (dim, dim) linear map built by
    pushing the dim basis vectors through :func:`_pair_rev_apply` in ONE
    vectorized call (outside any scan), plus the (dim,) constant."""
    p = par[0]
    M_steps = p.shape[0]
    dtype = p.dtype
    basis = jnp.broadcast_to(
        jnp.eye(dim, dtype=dtype)[None], (M_steps, dim, dim)
    )
    par_ch = jax.tree_util.tree_map(lambda x: x[:, None], par)
    cols = _pair_rev_apply(basis, par_ch, affine=False)
    Lmat = jnp.swapaxes(cols, -1, -2)  # column k = image of e_k
    cvec = _pair_rev_apply(jnp.zeros((M_steps, dim), dtype), par,
                           affine=True)
    return Lmat, cvec


def _pair_dense_suffix_states(par, dim):
    """Dense variant of the paired suffix flow for small state dims.

    Memory O(N dim^2): the fastest path while dim^2 stays small
    (J <= 4 -> dim <= 25).
    """
    p = par[0]
    M_steps = p.shape[0]
    dtype = p.dtype
    Lmat, cvec = _pair_dense_elements(par, dim)
    _, x_aft = _suffix_states(
        (Lmat, cvec[..., None]), _mat_affine_combine, _id_affine,
        reverse=True, distribute_combine=_affine_distribute_b,
    )
    x_aft = x_aft[..., 0]  # state AFTER each step (suffix incl.)
    # carry entering step n = state after step n+1
    x_in = jnp.concatenate(
        [x_aft[1:], jnp.zeros((1, dim), dtype)], axis=0
    )
    x_fin = x_aft[0] if M_steps else jnp.zeros((dim,), dtype)
    return x_in, x_fin


def _pair_unpack(x, J):
    """Split the flat paired state into (bF, dbR, dbB, M)."""
    bF = x[..., :J]
    dbR = x[..., J]
    dbB = x[..., J + 1 : 2 * J + 1]
    M = x[..., 2 * J + 1 :].reshape(x.shape[:-1] + (J, J))
    return bF, dbR, dbB, M


def _pair_row_outputs(x_in, p, u, w, F_rows, S_half, bZ_s, bW_s, bd_s,
                      dinv_s):
    """Per-step outputs of the paired reverse flow given the incoming
    states (shared by the single-device and sequence-sharded paths).

    Returns ``(bz, bU, bv, ba, bp)`` — the accumulated RHS cotangent,
    the U cotangent (solve + factor parts), the V cotangent, the diag
    cotangent, and the per-step transport cotangent (for bc/bt).
    """
    J = p.shape[-1]
    bF_in, dbR_in, dbB_in, M_in = _pair_unpack(x_in, J)

    # solve part
    bz = bZ_s + dbR_in
    bF_mid = bF_in - u * bz[..., None]
    bU1 = -(p * F_rows) * bz[..., None]
    bp1 = F_rows * bF_mid * p  # K = 1: the K-sum is elementwise

    # factor part
    bv0 = (bW_s + dbB_in) * dinv_s[..., None]
    bdp = bd_s - jnp.sum(w * bv0, axis=-1)
    bv = bv0 + _bmv(M_in + _mT(M_in), w)
    ba = bdp - jnp.sum(w * _bmv(M_in, w), axis=-1)
    S_full = S_half * p[..., None, :]
    bU2 = -_bmv(S_full, bv + 2.0 * ba[..., None] * u)
    mid = (
        M_in
        - u[..., :, None] * bv[..., None, :]
        - ba[..., None, None] * (u[..., :, None] * u[..., None, :])
    )
    bp2 = (
        jnp.einsum("...ik,...ki->...i", mid, S_half)
        + jnp.einsum("...ki,...ki->...i", S_half, mid)
    ) * p
    return bz, bU1 + bU2, bv, ba, bp1 + bp2


@_full_precision
def factor_solve_rev_assoc(
    t, c, a, U, V, Y, d, W, Z, S, F, bd, bW_pub, bZ
):
    """Paired reverse of the fused factor+solve (K = 1): the solve and
    factor adjoints in ONE structured engine pass.

    Outputs match running ``sweep_rev`` (solve, lower) followed by
    ``factor_rev`` with ``bW = bW_pub + (solve's bB)`` — the two-pass
    path used by the generic tiers — to float precision.
    """
    del a, V
    N, J = U.shape
    dtype = U.dtype
    phi = transport(t, c)
    dts = jnp.concatenate([jnp.zeros((1,), t.dtype), -jnp.diff(t)])
    dinv = 1.0 / _safe(d)
    y1 = bZ[..., 0] if bZ.ndim == 2 else bZ
    Zv = Z[..., 0] if Z.ndim == 2 else Z

    # per-step rows n = 1..N-1
    par = (
        phi[1:],
        U[1:],
        W[1:],
        W[:-1],
        Zv[:-1],
        y1[1:],
        bW_pub[1:],
        bd[1:],
        dinv[1:],
    )
    dim = _pair_dim(J)
    if J <= 2 and not _vmapped(U):
        x_in, x_fin = _pair_dense_suffix_states(par, dim)
    else:
        x_in, x_fin = _structured_suffix_states(
            _pair_rev_apply, _pair_identity_params, par, dim
        )

    bz, bU_steps, bv, ba, bp = _pair_row_outputs(
        x_in,
        phi[1:],
        U[1:],
        W[1:],
        F[1:, :, 0],
        S[1:],
        y1[1:],
        bW_pub[1:],
        bd[1:],
        dinv[1:],
    )
    bc = jnp.sum(bp * dts[1:, None], axis=0)
    ft = bp @ c

    # ---- row 0 boundary (uses the state after ALL steps)
    if N > 1:
        _, dbR_fin, dbB_fin, M0 = _pair_unpack(x_fin, J)
    else:
        dbR_fin = jnp.zeros((), dtype)
        dbB_fin = jnp.zeros((J,), dtype)
        M0 = jnp.zeros((J, J), dtype)
    bY0 = y1[0] + dbR_fin
    bv0_0 = (bW_pub[0] + dbB_fin) * dinv[0]
    bv_0 = bv0_0 + (M0 + M0.T) @ W[0]
    ba_0 = (
        bd[0]
        - W[0] @ bv0_0
        + W[0] @ (M0 @ W[0])
        - W[0] @ ((M0 + M0.T) @ W[0])
    )

    ba_out = jnp.concatenate([ba_0[None], ba])
    bV_out = jnp.concatenate([bv_0[None], bv])
    bU_out = jnp.concatenate([jnp.zeros((1, J), dtype), bU_steps])
    bY_out = jnp.concatenate([bY0[None], bz])[:, None]
    ft_full = jnp.concatenate(
        [jnp.zeros((1,), t.dtype), ft, jnp.zeros((1,), t.dtype)]
    )
    bt = ft_full[1:] - ft_full[:-1]
    return bt, bc, ba_out, bU_out, bV_out, bY_out


def _frev_suffix_states_dense(p, u, w, bv0n, bdpn):
    """Dense small-J variant of :func:`_frev_suffix_states`: the step's
    linear part as an explicit J^2 x J^2 operator (closed form):
      dM'[jk]/dM[lm] = p_j p_k [ d_jl d_km
                                 - u_j (d_kl w_m + d_km w_l)
                                 + u_j u_k w_l w_m ]
    O(N J^4) element memory — the fastest path for J <= 4 where the
    (J^2, J^2) matmuls are tiny."""
    J = p.shape[-1]
    dtype = p.dtype
    delta = jnp.eye(J, dtype=dtype)
    T1 = (
        delta[:, None, :, None] * delta[None, :, None, :]
    )  # (j,k,l,m) = d_jl d_km
    uN = u[:, :, None, None, None]
    uK = u[:, None, :, None, None]
    wL = w[:, None, None, :, None]
    wM = w[:, None, None, None, :]
    T2 = uN * (
        delta[None, None, :, :, None] * wM
        + delta[None, None, :, None, :] * wL
    )
    T3 = uN * uK * wL * wM
    pj = p[:, :, None, None, None]
    pk = p[:, None, :, None, None]
    L = (pj * pk) * (T1[None] - T2 + T3)
    L = L.reshape(-1, J * J, J * J)
    # constant part: the step applied to M = 0
    mid0 = (
        -u[:, :, None] * bv0n[:, None, :]
        - bdpn[:, None, None] * (u[:, :, None] * u[:, None, :])
    )
    Cv = (p[:, :, None] * mid0 * p[:, None, :]).reshape(-1, J * J)
    _, R = _suffix_states(
        (L, Cv[..., None]), _mat_affine_combine, _id_affine,
        reverse=True, distribute_combine=_affine_distribute_b,
    )
    R = R.reshape(-1, J, J)  # bS after each step (applied to zero init)
    # carry entering step n = state after step n+1
    return jnp.concatenate(
        [R[1:], jnp.zeros((1, J, J), dtype)], axis=0
    )


@_full_precision
def factor_rev_assoc(t, c, a, U, V, d, W, S, bd, bW):
    """Associative twin of scan.factor_rev_scan (same outputs), any J.

    The adjoint carry bS evolves affinely (see :func:`_frev_apply`);
    the structured two-level engine (:func:`_frev_suffix_states`)
    parallelizes the suffix composition without the O(N J^4) element
    materialization that limited round 1 to J <= 4.
    """
    del a, V
    N, J = U.shape
    dtype = U.dtype
    phi = transport(t, c)
    dts = jnp.concatenate([jnp.zeros((1,), t.dtype), -jnp.diff(t)])
    bv0 = bW / d[:, None]
    bdp = bd - jnp.einsum("nj,nj->n", W, bv0)

    # step parameters for n = 1..N-1
    p = phi[1:]
    u = U[1:]
    w = W[1:]
    bv0n = bv0[1:]
    bdpn = bdp[1:]

    if J <= 2 and not _vmapped(U):
        # dense route only at J <= 2 for SINGLE evaluations:
        # materializing the (J^2, J^2) linear part per row is cheap for
        # 4x4 maps but grows as J^4 per row; vmapped fleets always take
        # the structured O(C N J^2) scheme.
        M_in = _frev_suffix_states_dense(p, u, w, bv0n, bdpn)
    else:
        M_in = _frev_suffix_states((p, u, w, bv0n, bdpn))

    bv = bv0n + _bmv(M_in + jnp.swapaxes(M_in, 1, 2), w)
    ba = bdpn - jnp.sum(w * _bmv(M_in, w), axis=-1)
    S_half = S[1:]
    S_full = S_half * p[:, None, :]
    bU_steps = -_bmv(S_full, bv + 2.0 * ba[:, None] * u)
    mid = (
        M_in
        - jnp.einsum("nj,nk->njk", u, bv)
        - ba[:, None, None] * jnp.einsum("nj,nk->njk", u, u)
    )
    # bp = diag(mid @ S_half + S_half^T @ mid) * p
    bp = (
        jnp.einsum("nik,nki->ni", mid, S_half)
        + jnp.einsum("nki,nki->ni", S_half, mid)
    ) * p
    bc = jnp.sum(bp * dts[1:, None], axis=0)
    ft = bp @ c

    # row 0 boundary: the state after step 1 (the full composition)
    M0 = (
        _frev_apply(
            M_in[0],
            (p[0], u[0], w[0], bv0n[0], bdpn[0]),
            affine=True,
        )
        if N > 1
        else jnp.zeros((J, J), dtype)
    )
    bv_0 = bv0[0] + (M0 + M0.T) @ W[0]
    ba_0 = bd[0] + W[0] @ (M0 @ W[0]) - bv_0 @ W[0]

    ba_steps = ba
    ba_out = jnp.concatenate([ba_0[None], ba_steps])
    bV_out = jnp.concatenate([bv_0[None], bv])
    bU_out = jnp.concatenate([jnp.zeros((1, J), dtype), bU_steps])
    ft_full = jnp.concatenate(
        [jnp.zeros((1,), t.dtype), ft, jnp.zeros((1,), t.dtype)]
    )
    bt = ft_full[1:] - ft_full[:-1]
    return bt, bc, ba_out, bU_out, bV_out
