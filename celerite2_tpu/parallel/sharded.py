"""Sequence-parallel GP log-likelihood over a device mesh.

The reference's recursions are single-threaded over N
(forward.hpp:111-132); the sequence-parallel equivalent shards N over the
``seq`` mesh axis and exchanges only O(J^2) carries between devices —
the celerite analogue of ring-attention's blockwise pass (SURVEY.md
section 5.7), built on ``shard_map`` + ``all_gather``/``psum``.

Algorithm (three phases, two passes over local data):

1. **Boundary exchange** — each device sends its last row's
   ``(t, a, U, V)`` to its right neighbor (``ppermute``), so the
   neighbor can build the Riccati/affine element that crosses the shard
   boundary.
2. **Block-map composition + carry exchange** — each device composes its
   local Riccati elements (factorization) into a single block map
   ``(A, Q, R)`` (J x J each), all-gathers the n_dev block maps, and
   prefix-composes the maps before its own index to obtain the incoming
   carry ``S_in``.  The solve pass does the same with affine
   ``(A, b)`` elements.
3. **Local evaluation** — the plain O(B J^2) recursions run from the
   incoming carry; ``psum`` reduces log-det and the quadratic form.

Every public function runs under ``default_matmul_precision("highest")``
(``_full_precision``): the carry exchange and the block-map folds are
float32 matrix products that must not drop to TF32 on the GPU.

Total cross-device traffic per likelihood: O(n_dev J^2) floats —
independent of N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from functools import partial

from celerite2_tpu.gp import LOG2PI
from celerite2_tpu.ops.assoc import (
    _bmm,
    _bmv,
    _engine_scan,
    _id_affine,
    _id_riccati,
    _mat_affine_combine,
    _pair_dense_elements,
    _pair_dim,
    _pair_row_outputs,
    _riccati_combine,
    _small_inv,
    _suffix_states,
)
from celerite2_tpu.ops.scan import _full_precision, _safe

__all__ = [
    "sharded_loglik",
    "sharded_factor",
    "sharded_solve_lower",
    "sharded_solve_upper",
    "sharded_matmul_lower",
    "sharded_matmul_upper",
    "sharded_apply_inverse",
    "sharded_dot_tril",
    "sharded_predict_mean",
    "sharded_predict_mean_at",
    "sharded_general_matmul_lower",
    "sharded_general_matmul_upper",
    "sharded_conditional_variance",
    "sharded_conditional_covariance",
    "make_sharded_logdensity",
    "sharded_sample_conditional",
    "make_sharded_conditional_sampler",
]


def _vma(x):
    """Varying manual axes of ``x`` (empty outside shard_map)."""
    return frozenset(getattr(jax.typeof(x), "vma", frozenset()))


def _pcast_up(x, target):
    """Promote ``x`` to vary over every mesh axis in ``target``.

    ``pcast(..., to='varying')`` is a real primitive whose transpose is
    a psum over the added axes — exactly the reduction a replicated
    primal's cotangent needs when the surrounding computation varies
    over more axes than the primal does (e.g. chain-varying theta with
    chains-replicated data under a (chains, seq) mesh)."""
    missing = tuple(sorted(target - _vma(x)))
    if not missing:
        return x
    return lax.pcast(x, missing, to="varying")


def _prefix_incoming(blocks, idx, combine, identity):
    """Fold block maps 0..idx-1 (n_dev is small: unrolled masked fold)."""
    n = jax.tree_util.tree_leaves(blocks)[0].shape[0]
    acc = identity

    for k in range(n):
        el = jax.tree_util.tree_map(lambda x: x[k], blocks)
        new = combine(acc, el)
        take = k < idx
        acc = jax.tree_util.tree_map(
            lambda new_l, old_l: jnp.where(take, new_l, old_l), new, acc
        )
    return acc


@_full_precision
def sharded_loglik(t, c, a, U, V, resid, *, axis_name="seq"):
    """Fused GP log-likelihood on sequence-sharded inputs.

    Must run inside ``shard_map`` with ``t (B,)``, ``a (B,)``,
    ``U/V (B, J)``, ``resid (B,)`` local shards (global N = B * n_dev)
    and replicated ``c (J,)``.  Returns the replicated scalar
    log-likelihood.

    Reverse mode uses the HAND-DERIVED sharded adjoint (custom VJP):
    the paired solve+factor reverse flow runs as per-shard suffix maps
    with one O(D^2)-sized map exchange (D = J^2 + 2J + 1) — O(B J^2)
    memory per shard instead of autodiff taping every engine
    intermediate (role of reference reverse.hpp:10-85 +
    internal.hpp:191-303, sequence-sharded).

    Under a multi-axis mesh the arguments may vary over different
    manual-axis sets (theta-derived ``c/a/U/V`` vary over ``chains``,
    the data ``t/resid`` only over ``seq``): the custom-VJP type
    contract requires cotangents to match primal varying axes, so all
    primals are promoted to the union first (the inserted ``pcast``'s
    transpose psums the replicated primals' cotangents over the added
    axes — the mathematically correct reduction).
    """
    args = (t, c, a, U, V, resid)
    union = frozenset().union(*(_vma(x) for x in args))
    t, c, a, U, V, resid = (_pcast_up(x, union) for x in args)
    return _sharded_loglik_vjp(axis_name, t, c, a, U, V, resid)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sharded_loglik_vjp(axis_name, t, c, a, U, V, resid):
    ll, _ = _sharded_forward(axis_name, t, c, a, U, V, resid)
    return ll


@_full_precision
def _sharded_forward(axis_name, t, c, a, U, V, resid):
    B, J = U.shape
    dtype = U.dtype
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)

    # ---- phase 1: boundary exchange (previous shard's last row)
    right = [(k, k + 1) for k in range(n_dev - 1)]
    t_in = lax.ppermute(t[-1], axis_name, right)
    a_in = lax.ppermute(a[-1], axis_name, right)
    u_in = lax.ppermute(U[-1], axis_name, right)
    v_in = lax.ppermute(V[-1], axis_name, right)

    is_first = idx == 0
    # previous-row arrays aligned with local rows
    t_prev = jnp.concatenate([t_in[None], t[:-1]])
    a_prev = jnp.concatenate([a_in[None], a[:-1]])
    U_prev = jnp.concatenate([u_in[None], U[:-1]])
    V_prev = jnp.concatenate([v_in[None], V[:-1]])

    dt = t - t_prev
    phi = jnp.exp(-c[None, :] * dt[:, None])
    # the very first row globally has no predecessor: identity transport
    # with zero source (phi = 0 kills the incoming element)
    phi = jnp.where(
        jnp.logical_and(is_first, jnp.arange(B)[:, None] == 0),
        jnp.zeros_like(phi),
        phi,
    )

    # ---- phase 2a: local factor prefix maps (parallel engine) +
    #      block-map exchange
    I = jnp.eye(J, dtype=dtype)
    al = _safe(a_prev)[:, None, None]
    A_r = phi[:, :, None] * (
        I[None] - V_prev[:, :, None] * U_prev[:, None, :] / al
    )
    Q_r = (
        phi[:, :, None]
        * (V_prev[:, :, None] * V_prev[:, None, :] / al)
        * phi[:, None, :]
    )
    R_r = -U_prev[:, :, None] * U_prev[:, None, :] / al
    pref = _engine_scan(
        _riccati_combine, (A_r, Q_r, R_r), _id_riccati,
    )
    blocks = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x[-1], axis_name), pref
    )
    S_identity = (I, jnp.zeros((J, J), dtype), jnp.zeros((J, J), dtype))
    e_in = _prefix_incoming(blocks, idx, _riccati_combine, S_identity)
    S_in = e_in[1]  # map applied to S0 = 0 is the combined Q

    # ---- phase 3a: per-row state = prefix map applied to S_in
    Ap, Qp, Rp = pref
    G = _small_inv(I[None] + _bmm(Rp, jnp.broadcast_to(S_in, Rp.shape)))
    S_full = Qp + _bmm(
        _bmm(Ap, _bmm(jnp.broadcast_to(S_in, Rp.shape), G)),
        jnp.swapaxes(Ap, -1, -2),
    )
    d = a - jnp.sum(_bmv(S_full, U) * U, axis=-1)
    W = (V - _bmv(S_full, U)) / _safe(d)[:, None]
    ok_local = jnp.all(d > 0)
    logdet_local = jnp.sum(jnp.log(_safe(d)))

    # ---- phase 2b: solve prefix maps (affine) + carry exchange
    w_in = lax.ppermute(W[-1], axis_name, right)
    r_in = lax.ppermute(resid[-1], axis_name, right)
    W_prev = jnp.concatenate([w_in[None], W[:-1]])
    resid_prev = jnp.concatenate([r_in[None], resid[:-1]])

    A_el = phi[:, :, None] * (
        I[None] - W_prev[:, :, None] * U_prev[:, None, :]
    )
    b_el = phi * (W_prev * resid_prev[:, None])
    prefF = _engine_scan(
        _mat_affine_combine, (A_el, b_el[..., None]), _id_affine,
    )
    blocksF = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x[-1], axis_name), prefF
    )

    def aff_combine(acc, el):
        Aa, ba = acc
        Ae, be = el
        return _bmm(Ae, Aa), _bmv(Ae, ba) + be

    F_identity = (I, jnp.zeros((J,), dtype))
    _, F_in = _prefix_incoming(
        (blocksF[0], blocksF[1][..., 0]), idx, aff_combine, F_identity
    )

    # ---- phase 3b: per-row solve from F_in
    ApF, bpF = prefF
    F_post = _bmv(ApF, jnp.broadcast_to(F_in, (B, J))) + bpF[..., 0]
    z = resid - jnp.sum(U * F_post, axis=-1)
    quad_local = jnp.sum(z**2 / _safe(d))

    # ---- caches in the standard reverse conventions
    # S_half_r = phi_r (.) (S_full_{r-1} + d_{r-1} w_{r-1} w_{r-1}^T);
    # boundary rows come from the left neighbour (ppermute fills zeros
    # for shard 0, and phi row 0 there is zero anyway)
    S_in_b = lax.ppermute(S_full[-1], axis_name, right)
    d_in_b = lax.ppermute(d[-1], axis_name, right)
    S_prev = jnp.concatenate([S_in_b[None], S_full[:-1]])
    d_prev = jnp.concatenate([d_in_b[None], d[:-1]])
    S_half = phi[:, :, None] * (
        S_prev
        + d_prev[:, None, None]
        * (W_prev[:, :, None] * W_prev[:, None, :])
    )
    z_in_b = lax.ppermute(z[-1], axis_name, right)
    z_prev = jnp.concatenate([z_in_b[None], z[:-1]])
    F_prev = jnp.concatenate(
        [lax.ppermute(F_post[-1], axis_name, right)[None], F_post[:-1]]
    )
    F_pre = F_prev + W_prev * z_prev[:, None]
    dts = t - t_prev

    # ---- reduce
    logdet = lax.psum(logdet_local, axis_name)
    quad = lax.psum(quad_local, axis_name)
    ok = lax.psum(ok_local.astype(jnp.int32), axis_name) == n_dev
    n_total = B * n_dev
    ll = -0.5 * (logdet + quad + n_total * LOG2PI)
    ll = jnp.where(ok, ll, -jnp.inf)
    return ll, (U, W, d, z, S_half, F_pre, phi, dts, c, ok)


def _sharded_loglik_fwd(axis_name, t, c, a, U, V, resid):
    ll, res = _sharded_forward(axis_name, t, c, a, U, V, resid)
    return ll, res


@_full_precision
def _sharded_loglik_bwd(axis_name, res, bll):
    """Hand-derived adjoint of the sharded fused log-likelihood.

    The paired reverse flow (ops.assoc._pair_rev_apply) runs globally in
    DECREASING row order; per shard it becomes: densify local steps,
    compose in-shard suffix maps, all_gather ONE (D, D) map per shard to
    obtain the incoming cross-shard state, then evaluate all per-row
    outputs locally.  Every local row is a step; the global first row is
    a phantom step (phi = 0) whose row outputs reduce exactly to the
    boundary formulas.  Traffic: O(n_dev D^2) floats, one ppermute for
    the bt stencil.
    """
    U, W, d, z, S_half, F_pre, phi, dts, c, ok = res
    B, J = U.shape
    dtype = U.dtype
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right = [(k, k + 1) for k in range(n_dev - 1)]
    left = [(k + 1, k) for k in range(n_dev - 1)]

    # direct cotangents of the elementwise head (quiet -inf => zero)
    scale = jnp.where(ok, bll, jnp.zeros_like(bll))
    safe_d = _safe(d)
    bd_s = scale * (-0.5) * (1.0 / safe_d - (z / safe_d) ** 2)
    bz_cot = -scale * z / safe_d
    dinv = 1.0 / safe_d

    w_prev = jnp.concatenate(
        [lax.ppermute(W[-1], axis_name, right)[None], W[:-1]]
    )
    z_prev = jnp.concatenate(
        [lax.ppermute(z[-1], axis_name, right)[None], z[:-1]]
    )

    par = (
        phi,
        U,
        W,
        w_prev,
        z_prev,
        bz_cot,
        jnp.zeros_like(W),  # the log-likelihood exposes no bW
        bd_s,
        dinv,
    )
    dim = _pair_dim(J)
    Lmat, cvec = _pair_dense_elements(par, dim)
    A_suf, b_suf = _suffix_states(
        (Lmat, cvec[..., None]), _mat_affine_combine, _id_affine,
        reverse=True,
    )
    b_suf = b_suf[..., 0]

    # cross-shard incoming state: compose the later shards' total maps
    # (higher shard index = larger rows = applied earlier)
    gA = lax.all_gather(A_suf[0], axis_name)
    gb = lax.all_gather(b_suf[0], axis_name)
    accA = jnp.eye(dim, dtype=dtype)
    accb = jnp.zeros((dim,), dtype)
    for k in range(n_dev - 1, -1, -1):
        newA = gA[k] @ accA
        newb = gA[k] @ accb + gb[k]
        take = k > idx
        accA = jnp.where(take, newA, accA)
        accb = jnp.where(take, newb, accb)
    x_shard_in = accb  # composed flow applied to the zero init

    # per-row incoming states: steps r+1..B-1 applied to x_shard_in
    A_shift = jnp.concatenate(
        [A_suf[1:], jnp.eye(dim, dtype=dtype)[None]]
    )
    b_shift = jnp.concatenate([b_suf[1:], jnp.zeros((1, dim), dtype)])
    x_in = _bmv(A_shift, jnp.broadcast_to(x_shard_in, (B, dim)))
    x_in = x_in + b_shift

    bz, bU, bV, ba, bp = _pair_row_outputs(
        x_in, phi, U, W, F_pre, S_half, bz_cot,
        jnp.zeros_like(W), bd_s, dinv,
    )
    # LOCAL c-contribution only: every primal was promoted to the union
    # vma in sharded_loglik, so the cotangent for c must VARY over seq
    # (the per-shard share) — the outer pcast's transpose performs the
    # one true psum.  A psum here would double-count it n_dev times.
    bc = jnp.sum(bp * (-dts)[:, None], axis=0)
    # under shard_map(check_vma=False) there is no vma tracking: the
    # outer pcast (whose transpose psums the replicated primals'
    # cotangents) never fires AND shard_map's own output-cotangent
    # scaling changes (measured: components come out divided by n_dev)
    # — gradients would be silently wrong.  Fail loudly instead.
    if not _vma(U):
        raise NotImplementedError(
            "gradients of sharded_loglik require shard_map with "
            "check_vma=True (the default): with vma tracking disabled "
            "the adjoint's cross-shard cotangent reductions cannot be "
            "placed and the result would be silently wrong"
        )
    ft = bp @ c
    # bt[r] = ft[r+1] - ft[r]; the r+1 of the shard's last row lives on
    # the right neighbour (zero past the global end)
    ft_next = jnp.concatenate(
        [ft[1:], lax.ppermute(ft[0], axis_name, left)[None]]
    )
    bt = ft_next - ft
    # safety: all cotangents should already vary over the union vma
    # (they are built from union-varying residuals); pcast is a no-op
    # then, and fixes up any replicated stragglers otherwise.
    union = _vma(U)
    return tuple(_pcast_up(b, union) for b in (bt, bc, ba, bU, bV, bz))


_sharded_loglik_vjp.defvjp(_sharded_loglik_fwd, _sharded_loglik_bwd)


# ===================================== sharded GP op surface (K = 1)
#
# dot_tril / apply_inverse / predict-mean on sequence-sharded data:
# the same three-phase pattern (local prefix; one O(J..J^2) map per
# shard exchanged; local apply).  Gradients go through autodiff here —
# these are cold paths with O(B J) tapes; only the log-likelihood hot
# path carries the hand-derived adjoint above.


def _right_left(n_dev):
    right = [(k, k + 1) for k in range(n_dev - 1)]
    left = [(k + 1, k) for k in range(n_dev - 1)]
    return right, left


def _prev_rows(x, axis_name, right):
    """x shifted one row later; the boundary row comes from the left
    neighbour (zeros on shard 0)."""
    return jnp.concatenate(
        [lax.ppermute(x[-1], axis_name, right)[None], x[:-1]]
    )


def _next_rows(x, axis_name, left):
    """x shifted one row earlier; the boundary row comes from the right
    neighbour (zeros on the last shard)."""
    return jnp.concatenate(
        [x[1:], lax.ppermute(x[0], axis_name, left)[None]]
    )


def _sharded_transport(axis_name, t, c, right):
    """phi (B, J) against the previous GLOBAL row; first row zeroed."""
    idx = lax.axis_index(axis_name)
    B = t.shape[0]
    t_prev = _prev_rows(t, axis_name, right)
    phi = jnp.exp(-c[None, :] * (t - t_prev)[:, None])
    first = jnp.logical_and(idx == 0, jnp.arange(B)[:, None] == 0)
    return jnp.where(first, jnp.zeros_like(phi), phi)


def _sharded_transport_up(axis_name, t, c, left):
    """phi_up (B, J) against the next GLOBAL row; last row zeroed."""
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    B = t.shape[0]
    t_next = _next_rows(t, axis_name, left)
    phi = jnp.exp(-c[None, :] * (t_next - t)[:, None])
    last = jnp.logical_and(
        idx == n_dev - 1, jnp.arange(B)[:, None] == B - 1
    )
    return jnp.where(last, jnp.zeros_like(phi), phi)


def _fold_shards(gA, gb, idx, *, later_first):
    """Masked fold of per-shard affine maps into this shard's incoming
    state (applied to a zero initial state)."""
    n_dev = gA.shape[0]
    dim = gA.shape[-1]
    accA = jnp.eye(dim, dtype=gA.dtype)
    accb = jnp.zeros((dim,), gb.dtype)
    order = range(n_dev - 1, -1, -1) if later_first else range(n_dev)
    for k in order:
        newA = gA[k] @ accA
        newb = gA[k] @ accb + gb[k]
        take = (k > idx) if later_first else (k < idx)
        accA = jnp.where(take, newA, accA)
        accb = jnp.where(take, newb, accb)
    return accb


@_full_precision
def sharded_factor(t, c, a, U, V, *, axis_name="seq"):
    """Sequence-sharded LDL^T: returns ``(d, W, ok)`` local shards."""
    B, J = U.shape
    dtype = U.dtype
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right, _ = _right_left(n_dev)

    a_prev = _prev_rows(a, axis_name, right)
    U_prev = _prev_rows(U, axis_name, right)
    V_prev = _prev_rows(V, axis_name, right)
    phi = _sharded_transport(axis_name, t, c, right)

    I = jnp.eye(J, dtype=dtype)
    al = _safe(a_prev)[:, None, None]
    A_r = phi[:, :, None] * (
        I[None] - V_prev[:, :, None] * U_prev[:, None, :] / al
    )
    Q_r = (
        phi[:, :, None]
        * (V_prev[:, :, None] * V_prev[:, None, :] / al)
        * phi[:, None, :]
    )
    R_r = -U_prev[:, :, None] * U_prev[:, None, :] / al
    pref = _engine_scan(
        _riccati_combine, (A_r, Q_r, R_r), _id_riccati,
    )
    blocks = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x[-1], axis_name), pref
    )
    S_identity = (I, jnp.zeros((J, J), dtype), jnp.zeros((J, J), dtype))
    e_in = _prefix_incoming(blocks, idx, _riccati_combine, S_identity)
    S_in = e_in[1]
    Ap, Qp, Rp = pref
    G = _small_inv(I[None] + _bmm(Rp, jnp.broadcast_to(S_in, Rp.shape)))
    S_full = Qp + _bmm(
        _bmm(Ap, _bmm(jnp.broadcast_to(S_in, Rp.shape), G)),
        jnp.swapaxes(Ap, -1, -2),
    )
    d = a - jnp.sum(_bmv(S_full, U) * U, axis=-1)
    W = (V - _bmv(S_full, U)) / _safe(d)[:, None]
    ok = (
        lax.psum(jnp.all(d > 0).astype(jnp.int32), axis_name) == n_dev
    )
    return d, W, ok


def _as_mat(y):
    return (y[:, None], True) if y.ndim == 1 else (y, False)


def _fold_shards_mat(gA, gb, idx, *, later_first):
    """Matrix-RHS variant of :func:`_fold_shards` (gb (n_dev, D, K))."""
    n_dev = gA.shape[0]
    dim = gA.shape[-1]
    K = gb.shape[-1]
    accA = jnp.eye(dim, dtype=gA.dtype)
    accb = jnp.zeros((dim, K), gb.dtype)
    order = range(n_dev - 1, -1, -1) if later_first else range(n_dev)
    for k in order:
        newA = gA[k] @ accA
        newb = gA[k] @ accb + gb[k]
        take = (k > idx) if later_first else (k < idx)
        accA = jnp.where(take, newA, accA)
        accb = jnp.where(take, newb, accb)
    return accb


@_full_precision
def sharded_solve_lower(t, c, U, W, y, *, axis_name="seq"):
    """z = L^{-1} y on sequence shards (vector or matrix RHS)."""
    B, J = U.shape
    dtype = U.dtype
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right, _ = _right_left(n_dev)
    Y, is_vec = _as_mat(y)
    K = Y.shape[1]

    phi = _sharded_transport(axis_name, t, c, right)
    U_prev = _prev_rows(U, axis_name, right)
    W_prev = _prev_rows(W, axis_name, right)
    Y_prev = _prev_rows(Y, axis_name, right)

    I = jnp.eye(J, dtype=dtype)
    A_el = phi[:, :, None] * (
        I[None] - W_prev[:, :, None] * U_prev[:, None, :]
    )
    b_el = phi[:, :, None] * (
        W_prev[:, :, None] * Y_prev[:, None, :]
    )
    Apf, bpf = _engine_scan(
        _mat_affine_combine, (A_el, b_el), _id_affine,
    )
    gA = lax.all_gather(Apf[-1], axis_name)
    gb = lax.all_gather(bpf[-1], axis_name)
    F_in = _fold_shards_mat(gA, gb, idx, later_first=False)
    F_post = _bmm(Apf, jnp.broadcast_to(F_in, (B, J, K))) + bpf
    Z = Y - jnp.sum(U[:, :, None] * F_post, axis=1)
    return Z[:, 0] if is_vec else Z


@_full_precision
def sharded_solve_upper(t, c, U, W, y, *, axis_name="seq"):
    """z = L^{-T} y on sequence shards (vector or matrix RHS)."""
    B, J = U.shape
    dtype = U.dtype
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right, left = _right_left(n_dev)
    Y, is_vec = _as_mat(y)
    K = Y.shape[1]

    phi = _sharded_transport_up(axis_name, t, c, left)
    U_next = _next_rows(U, axis_name, left)
    W_next = _next_rows(W, axis_name, left)
    Y_next = _next_rows(Y, axis_name, left)

    I = jnp.eye(J, dtype=dtype)
    # F_r = phi_r (I - u_{r+1} w_{r+1}^T) F_{r+1} + phi_r u_{r+1} z_{r+1}
    A_el = phi[:, :, None] * (
        I[None] - U_next[:, :, None] * W_next[:, None, :]
    )
    b_el = phi[:, :, None] * (
        U_next[:, :, None] * Y_next[:, None, :]
    )
    A_suf, b_suf = _suffix_states(
        (A_el, b_el), _mat_affine_combine, _id_affine, reverse=True
    )
    gA = lax.all_gather(A_suf[0], axis_name)
    gb = lax.all_gather(b_suf[0], axis_name)
    F_in = _fold_shards_mat(gA, gb, idx, later_first=True)
    F_post = _bmm(A_suf, jnp.broadcast_to(F_in, (B, J, K))) + b_suf
    Z = Y - jnp.sum(W[:, :, None] * F_post, axis=1)
    return Z[:, 0] if is_vec else Z


def _sharded_matmul(t, c, A, B_mat, y, *, axis_name, upper):
    """Shared diagonal-affine cumulative for the strict matmuls."""
    n_dev = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    right, left = _right_left(n_dev)
    Bn, J = A.shape

    G = B_mat * y[:, None]
    if not upper:
        phi = _sharded_transport(axis_name, t, c, right)
        G_feed = _prev_rows(G, axis_name, right)
        alpha, beta = phi, phi * G_feed
        pa, pb = _engine_scan(
            lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
            (alpha, beta),
            lambda e: (
                jnp.ones((1, J), e[0].dtype),
                jnp.zeros((1, J), e[1].dtype),
            ),
        )
        ga = lax.all_gather(pa[-1], axis_name)
        gb = lax.all_gather(pb[-1], axis_name)
        acc_a = jnp.ones((J,), A.dtype)
        acc_b = jnp.zeros((J,), A.dtype)
        for k in range(n_dev):
            na = ga[k] * acc_a
            nb = ga[k] * acc_b + gb[k]
            take = k < idx
            acc_a = jnp.where(take, na, acc_a)
            acc_b = jnp.where(take, nb, acc_b)
        F = pa * acc_b[None, :] + pb
    else:
        phi = _sharded_transport_up(axis_name, t, c, left)
        G_feed = _next_rows(G, axis_name, left)
        alpha, beta = phi, phi * G_feed
        pa, pb = _engine_scan(
            lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
            (alpha, beta),
            lambda e: (
                jnp.ones((1, J), e[0].dtype),
                jnp.zeros((1, J), e[1].dtype),
            ),
            reverse=True,
        )
        ga = lax.all_gather(pa[0], axis_name)
        gb = lax.all_gather(pb[0], axis_name)
        acc_a = jnp.ones((J,), A.dtype)
        acc_b = jnp.zeros((J,), A.dtype)
        for k in range(n_dev - 1, -1, -1):
            na = ga[k] * acc_a
            nb = ga[k] * acc_b + gb[k]
            take = k > idx
            acc_a = jnp.where(take, na, acc_a)
            acc_b = jnp.where(take, nb, acc_b)
        F = pa * acc_b[None, :] + pb
    return jnp.sum(A * F, axis=-1)


@_full_precision
def sharded_matmul_lower(t, c, U, V, y, *, axis_name="seq"):
    """tril_strict(U V^T (x) transport) @ y on sequence shards."""
    return _sharded_matmul(t, c, U, V, y, axis_name=axis_name,
                           upper=False)


@_full_precision
def sharded_matmul_upper(t, c, U, V, y, *, axis_name="seq"):
    """triu_strict(V U^T (x) transport) @ y on sequence shards."""
    return _sharded_matmul(t, c, V, U, y, axis_name=axis_name,
                           upper=True)


@_full_precision
def sharded_apply_inverse(t, c, U, W, d, y, *, axis_name="seq"):
    """K^{-1} y = L^{-T} d^{-1} L^{-1} y on sequence shards
    (vector or matrix RHS)."""
    z = sharded_solve_lower(t, c, U, W, y, axis_name=axis_name)
    z = z / (_safe(d) if z.ndim == 1 else _safe(d)[:, None])
    return sharded_solve_upper(t, c, U, W, z, axis_name=axis_name)


@_full_precision
def sharded_conditional_variance(
    t, c, a, U, V, KxsT_local, k0, *, axis_name="seq"
):
    """Conditional predictive variance with the length-N axis sharded.

    The reference's conditional variance is a dense O(N M) contraction
    (core.py:52-66,134-140) with no sharding story; here the N rows of
    the cross-covariance ``KxsT (B, M)`` live on their sequence shards
    (the caller builds them with ``kernel.get_value`` under an
    ``in_spec P(axis, None)``), the M solves run through the
    matrix-RHS sharded ops, and one psum reduces the contraction:

        var_m = k0 - sum_n KxsT[n, m] * (K^{-1} KxsT)[n, m]

    Returns the replicated (M,) variance vector.
    """
    d, W, _ = sharded_factor(t, c, a, U, V, axis_name=axis_name)
    Kinv_KxsT = sharded_apply_inverse(
        t, c, U, W, d, KxsT_local, axis_name=axis_name
    )
    return k0 - lax.psum(
        jnp.sum(KxsT_local * Kinv_KxsT, axis=0), axis_name
    )


@_full_precision
def sharded_conditional_covariance(
    t, c, a, U, V, KxsT_local, Kss, *, axis_name="seq"
):
    """Full conditional predictive covariance with the length-N axis
    sharded (dense-M counterpart of :func:`sharded_conditional_variance`;
    reference core.py:142-150 has no sharding story).

    ``KxsT_local (B, M)`` are this shard's rows of the N x M
    cross-covariance; ``Kss (M, M)`` is the replicated target prior
    covariance.  The M right-hand sides run through the matrix-RHS
    sharded solves and one psum reduces the rank-B contractions::

        cov = Kss - sum_n KxsT[n, :] (K^{-1} KxsT)[n, :]^T

    Returns the replicated (M, M) covariance.  O(M^2) output memory is
    inherent to the dense conditional; the O(N M) work is what shards.
    """
    d, W, _ = sharded_factor(t, c, a, U, V, axis_name=axis_name)
    Kinv_KxsT = sharded_apply_inverse(
        t, c, U, W, d, KxsT_local, axis_name=axis_name
    )
    return Kss - lax.psum(
        KxsT_local.T @ Kinv_KxsT, axis_name
    )


@_full_precision
def sharded_dot_tril(t, c, U, W, d, y, *, axis_name="seq"):
    """L sqrt(d) y (prior sampling weight) on sequence shards."""
    z = jnp.sqrt(jnp.where(d > 0, d, jnp.zeros_like(d))) * y
    return z + sharded_matmul_lower(
        t, c, U, W, z, axis_name=axis_name
    )


@_full_precision
def sharded_general_matmul_lower(
    t1, t2, c, U1, V2, Y, *, axis_name="seq"
):
    """Rectangular cross-covariance product with the SOURCE axis
    sharded: ``Z[n] = sum_{m: t2[m] <= t1[n]} U1[n] .
    diag(e^{-c (t1[n]-t2[m])}) V2[m] Y[m]``.

    ``t1 (M,)``, ``U1 (M, J)`` replicated target points; ``t2 (B,)``,
    ``V2 (B, J)``, ``Y (B,)`` local source shards.  Returns the
    replicated ``Z (M,)``.  (Sharded role of reference
    forward.hpp:285-332; used for conditional means at new points.)
    """
    B, J = V2.shape
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right, left = _right_left(n_dev)

    # transported inclusive cumulative F[m] = p_m F[m-1] + V2[m] Y[m]
    phi = _sharded_transport(axis_name, t2, c, right)
    G = V2 * Y[:, None]
    pa, pb = _engine_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
        (phi, G),
        lambda e: (
            jnp.ones((1, J), phi.dtype),
            jnp.zeros((1, J), G.dtype),
        ),
    )
    F_loc = pa * _fold_diag_in(pa, pb, idx, n_dev, axis_name) + pb

    # ownership: this shard holds the LAST source <= t1[n]
    i_loc = jnp.searchsorted(t2, t1, side="right") - 1
    has_local = i_loc >= 0
    # the next shard's first source (+inf past the end)
    t2_next0 = lax.ppermute(t2[0], axis_name, left)
    t2_next0 = jnp.where(
        idx == n_dev - 1, jnp.full_like(t2_next0, jnp.inf), t2_next0
    )
    owner = jnp.logical_and(has_local, t1 < t2_next0)

    i_c = jnp.clip(i_loc, 0, B - 1)
    decay = jnp.exp(-c[None, :] * (t1 - t2[i_c])[:, None])
    Z_part = jnp.sum(U1 * decay * F_loc[i_c], axis=-1)
    Z_part = jnp.where(owner, Z_part, jnp.zeros_like(Z_part))
    return lax.psum(Z_part, axis_name)


@_full_precision
def sharded_general_matmul_upper(
    t1, t2, c, U1, V2, Y, *, axis_name="seq"
):
    """Upper counterpart: sources strictly AFTER each target
    (reference forward.hpp:346-392, source axis sharded)."""
    B, J = V2.shape
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    right, left = _right_left(n_dev)

    # reverse transported cumulative F[m] = p_m F[m+1] + V2[m] Y[m]
    phi_up = _sharded_transport_up(axis_name, t2, c, left)
    G = V2 * Y[:, None]
    pa, pb = _engine_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
        (phi_up, G),
        lambda e: (
            jnp.ones((1, J), phi_up.dtype),
            jnp.zeros((1, J), G.dtype),
        ),
        reverse=True,
    )
    # incoming suffix carry from the RIGHT shards
    ga = lax.all_gather(pa[0], axis_name)
    gb = lax.all_gather(pb[0], axis_name)
    acc_a = jnp.ones((J,), pa.dtype)
    acc_b = jnp.zeros((J,), pb.dtype)
    for k in range(n_dev - 1, -1, -1):
        na = ga[k] * acc_a
        nb = ga[k] * acc_b + gb[k]
        take = k > idx
        acc_a = jnp.where(take, na, acc_a)
        acc_b = jnp.where(take, nb, acc_b)
    F_loc = pa * acc_b[None, :] + pb

    # ownership: this shard holds the FIRST source > t1[n]
    i_loc = jnp.searchsorted(t2, t1, side="right")
    has_local = i_loc < B
    t2_prev_last = lax.ppermute(t2[-1], axis_name, right)
    t2_prev_last = jnp.where(
        idx == 0, jnp.full_like(t2_prev_last, -jnp.inf), t2_prev_last
    )
    owner = jnp.logical_and(has_local, t1 >= t2_prev_last)

    i_c = jnp.clip(i_loc, 0, B - 1)
    decay = jnp.exp(-c[None, :] * (t2[i_c] - t1)[:, None])
    Z_part = jnp.sum(U1 * decay * F_loc[i_c], axis=-1)
    Z_part = jnp.where(owner, Z_part, jnp.zeros_like(Z_part))
    return lax.psum(Z_part, axis_name)


def _fold_diag_in(pa, pb, idx, n_dev, axis_name):
    """Incoming diagonal-affine carry from the LEFT shards."""
    J = pa.shape[-1]
    ga = lax.all_gather(pa[-1], axis_name)
    gb = lax.all_gather(pb[-1], axis_name)
    acc_a = jnp.ones((J,), pa.dtype)
    acc_b = jnp.zeros((J,), pb.dtype)
    for k in range(n_dev):
        na = ga[k] * acc_a
        nb = ga[k] * acc_b + gb[k]
        take = k < idx
        acc_a = jnp.where(take, na, acc_a)
        acc_b = jnp.where(take, nb, acc_b)
    return acc_b[None, :]


@_full_precision
def sharded_predict_mean_at(
    t, c, a, U, V, resid, t_new, U_new, V_new, *, axis_name="seq"
):
    """Conditional mean at NEW (replicated) points with the training
    axis sharded: ``mu = K*(t_new, t) K^{-1} resid`` via the sharded
    general matmuls (reference core.py:91-113 general path).

    ``t_new (M,)``, ``U_new/V_new (M, J)`` are the new points'
    celerite matrices (replicated); training arrays are local shards.
    Returns the replicated ``mu (M,)``.
    """
    d, W, _ = sharded_factor(t, c, a, U, V, axis_name=axis_name)
    alpha = sharded_apply_inverse(
        t, c, U, W, d, resid, axis_name=axis_name
    )
    lower = sharded_general_matmul_lower(
        t_new, t, c, U_new, V, alpha, axis_name=axis_name
    )
    upper = sharded_general_matmul_upper(
        t_new, t, c, V_new, U, alpha, axis_name=axis_name
    )
    return lower + upper


@_full_precision
def sharded_predict_mean(t, c, a, U, V, diag, resid, *,
                         axis_name="seq"):
    """Conditional mean at the training points (the O(N) fast path of
    reference core.py:115-132) on sequence shards: y - diag K^{-1} r."""
    d, W, ok = sharded_factor(t, c, a, U, V, axis_name=axis_name)
    alpha = sharded_apply_inverse(
        t, c, U, W, d, resid, axis_name=axis_name
    )
    return resid - diag * alpha


def make_sharded_logdensity(
    kernel_builder,
    t,
    y,
    yerr,
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
):
    """Build ``logdensity(theta)`` whose data axis is sharded over
    ``mesh[seq_axis]``.

    ``kernel_builder(theta) -> Term``.  ``t, y, yerr`` are global arrays
    whose length must divide evenly over the axis.  The returned
    function is jit/grad-compatible and replicated in theta.
    """
    from jax import shard_map
    import numpy as np

    # numpy (not device) arrays: the returned closure is jitted by the
    # caller, and concrete closure values must become HLO literals
    # rather than captured device buffers
    t = np.asarray(t)
    y = np.asarray(y)
    yerr = np.broadcast_to(np.asarray(yerr), t.shape)

    seq_spec = P(seq_axis)
    rep = P()

    def logdensity(theta):
        kernel = kernel_builder(theta)
        c, a, U, V = kernel.get_celerite_matrices(t, yerr**2)
        resid = y  # mean handled by the caller via kernel_builder

        fn = shard_map(
            lambda tt, aa, UU, VV, rr, cc: sharded_loglik(
                tt, cc, aa, UU, VV, rr, axis_name=seq_axis
            ),
            mesh=mesh,
            in_specs=(seq_spec, seq_spec, seq_spec, seq_spec, seq_spec, rep),
            out_specs=rep,
        )
        return fn(t, a, U, V, resid, c)

    return logdensity


@_full_precision
def sharded_sample_conditional(
    t, c, a, U, V, resid, diag,
    t_u, a_u, U_u, V_u,
    pos_train, pos_test,
    t_new, U_new, V_new,
    z_u, eps,
    *, axis_name="seq",
):
    """One exact conditional sample with the sequence axis sharded,
    via pathwise (Matheron) conditioning — NO dense M x M Cholesky.

    The reference's conditional sampler is an O(M^3) dense Cholesky
    (core.py:152-179) with no sharding story.  Here the sample is::

        f* | y  =  f*  +  K(t_new, t) (K_tt + S)^{-1} (resid - f_t - e)

    with ``(f_t, f*)`` one draw of the joint latent prior over the
    sorted union of training and target times — computed with the
    *sharded* semiseparable factor + matmul (O((N+M) J^2) work spread
    over the mesh) — and ``e = sqrt(diag) * eps``.  Exactly the law of
    the dense conditional.

    Local (per-shard) arguments: training ``t, a, U, V, resid, diag``
    and the union grid ``t_u, a_u, U_u, V_u, z_u`` plus ``pos_train``
    (this shard's training points' positions in the GLOBAL union) and
    ``eps``.  Replicated: ``c``, ``pos_test (M,)`` (target positions in
    the global union), and the target matrices ``t_new, U_new, V_new``.
    The union may be padded past its true end (extra later rows never
    influence earlier rows of the forward factorization); ``pos_*``
    simply never reference pad rows.

    Communication: the sharded-op collectives plus ONE O(N+M) vector
    ``all_gather`` of the latent draw (the permutation union -> (train,
    test) crosses shard boundaries; gathering the vector is ~MBs even
    at N=1e6, negligible next to the J^2 recursions).

    Returns the replicated sample ``(M,)`` (mean NOT included — the
    caller owns the mean function, cf. ``make_sharded_logdensity``).
    """
    # joint latent prior draw on the union shards
    d_u, W_u, _ = sharded_factor(
        t_u, c, a_u, U_u, V_u, axis_name=axis_name
    )
    f_u = sharded_dot_tril(
        t_u, c, U_u, W_u, d_u, z_u, axis_name=axis_name
    )
    # replicate the latent draw: each shard scatters its slice into its
    # global slot and one psum assembles the vector (psum output is
    # replicated in the varying-axes system, unlike all_gather's)
    idx = lax.axis_index(axis_name)
    n_dev = lax.axis_size(axis_name)
    B_u = f_u.shape[0]
    f_glob = lax.psum(
        lax.dynamic_update_slice(
            jnp.zeros((n_dev * B_u,), f_u.dtype), f_u, (idx * B_u,)
        ),
        axis_name,
    )
    f_train = f_glob[pos_train]
    f_test = f_glob[pos_test]

    # conditional correction through the training factorization
    r = resid - f_train - jnp.sqrt(diag) * eps
    d, W, _ = sharded_factor(t, c, a, U, V, axis_name=axis_name)
    alpha = sharded_apply_inverse(
        t, c, U, W, d, r, axis_name=axis_name
    )
    corr = sharded_general_matmul_lower(
        t_new, t, c, U_new, V, alpha, axis_name=axis_name
    ) + sharded_general_matmul_upper(
        t_new, t, c, V_new, U, alpha, axis_name=axis_name
    )
    return f_test + corr


def make_sharded_conditional_sampler(
    kernel, t, y, yerr, t_new, mesh: Mesh, *,
    seq_axis: str = "seq", mean=0.0, regularize=None,
):
    """Build ``sample(key) -> (M,)`` drawing exact conditional samples
    at ``t_new`` with the sequence axis sharded over ``mesh[seq_axis]``
    (pathwise conditioning; see :func:`sharded_sample_conditional`).

    Host-side setup: sorts the (t, t_new) union, pads it to divide the
    axis evenly (pad times extend past the end — they cannot influence
    earlier rows of the forward factorization), and records the static
    union positions of the training/target points.  ``len(t)`` itself
    must divide evenly (same contract as ``make_sharded_logdensity``).
    ``regularize`` adds jitter to the *joint* prior diagonal — required
    when ``t_new`` duplicates training times.
    """
    import numpy as np
    from jax import shard_map

    t = np.asarray(t)
    y = np.asarray(y)
    t_new = np.asarray(t_new)
    yerr = np.broadcast_to(np.asarray(yerr), t.shape)
    N, M = t.shape[0], t_new.shape[0]
    n_dev = mesh.shape[seq_axis]

    # sorted union (+ even-division padding past the end)
    t_all = np.concatenate([t, t_new])
    order = np.argsort(t_all, kind="stable")
    t_u = t_all[order]
    inv = np.argsort(order, kind="stable")
    pos_train, pos_test = inv[:N], inv[N:]
    pad = (-(N + M)) % n_dev
    if pad:
        step = np.median(np.diff(t_u)) if N + M > 1 else 1.0
        extra = t_u[-1] + step * np.arange(1, pad + 1)
        t_u = np.concatenate([t_u, extra])
    diag_u = np.zeros_like(t_u)
    if regularize is not None:
        diag_u = diag_u + regularize

    mean_fn = mean if callable(mean) else (lambda x: mean)
    resid = y - np.broadcast_to(np.asarray(mean_fn(t)), t.shape)
    mean_new = jnp.broadcast_to(
        jnp.asarray(mean_fn(t_new)), t_new.shape
    )

    c, a, U, V = (
        np.asarray(x) for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    _, a_u, U_u, V_u = (
        np.asarray(x) for x in kernel.get_celerite_matrices(t_u, diag_u)
    )
    _, _, U_new, V_new = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(
            t_new, np.zeros_like(t_new)
        )
    )

    seq = P(seq_axis)
    rep = P()
    core = shard_map(
        partial(sharded_sample_conditional, axis_name=seq_axis),
        mesh=mesh,
        in_specs=(
            seq, rep, seq, seq, seq, seq, seq,   # training + resid/diag
            seq, seq, seq, seq,                  # union grid
            seq, rep,                            # pos_train, pos_test
            rep, rep, rep,                       # target matrices
            seq, seq,                            # z_u, eps
        ),
        out_specs=rep,
    )

    def sample(key):
        kz, ke = jax.random.split(key)
        z_u = jax.random.normal(kz, t_u.shape, dtype=jnp.asarray(
            t_u
        ).dtype)
        eps = jax.random.normal(ke, t.shape, dtype=z_u.dtype)
        samp = core(
            t, c, a, U, V, resid, yerr**2,
            t_u, a_u, U_u, V_u,
            pos_train, pos_test,
            t_new, U_new, V_new,
            z_u, eps,
        )
        return samp + mean_new

    return sample
