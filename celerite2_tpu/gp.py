"""The GaussianProcess API.

Functional parity with the reference's GP layer
(/root/reference/python/celerite2/core.py:182-501 and the per-backend
subclasses, e.g. jax/celerite2.py), designed JAX-first:

* a **functional core** (:func:`gp_compute`, :func:`gp_log_likelihood`,
  ...) operating on an immutable :class:`GPState` pytree — this is what
  jit/grad/vmap/pjit touch, and what the inference engine drives;
* a thin **object shell** (:class:`GaussianProcess`) with the familiar
  ``compute / log_likelihood / predict / condition / dot_tril /
  apply_inverse / sample`` surface for users coming from the reference.

Error semantics: eager calls raise ``ValueError`` / ``LinAlgError`` like
the reference bindings; traced code uses branchless "quiet" semantics —
a non-positive-definite system yields ``log_likelihood = -inf``
(reference jax/celerite2.py:40-49, core.py:276-281).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from celerite2_tpu import ops
from celerite2_tpu.utils import LinAlgError
from celerite2_tpu.utils.misc import asarr as _asarr, atleast_1d as _atleast_1d

__all__ = [
    "ConstantMean",
    "GPState",
    "GaussianProcess",
    "ConditionalDistribution",
    "gp_compute",
    "gp_log_likelihood",
    "gp_loglik",
    "gp_sample_conditional",
]

LOG2PI = math.log(2.0 * math.pi)


class ConstantMean:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, x):
        return jnp.broadcast_to(_asarr(self.value), jnp.shape(x))


class GPState(NamedTuple):
    """Everything the solver needs after ``compute`` (a pytree)."""

    t: jax.Array  # (N,)
    c: jax.Array  # (J,)
    a: jax.Array  # (N,) original diagonal (incl. observational diag)
    U: jax.Array  # (N, J)
    V: jax.Array  # (N, J)
    d: jax.Array  # (N,) Cholesky diagonal
    W: jax.Array  # (N, J) Cholesky low-rank factor
    diag: jax.Array  # (N,) observational variance
    mean_value: jax.Array  # (N,)
    ok: jax.Array  # () bool: positive definite
    log_det: jax.Array  # ()
    norm: jax.Array  # () = -(log_det + N log 2pi)/2


# ========================================================== functional


# --------------------------------------------------------- f64 island
#
# Stiff kernels (eps-regularized Matern32Term and friends) carry ~1/eps
# coefficient amplitudes whose f32 cancellation corrupts gradients
# (measured: d(ll)/d(eps) wrong-signed and ~30x too large at
# eps=0.01/N=4e3).  The reference's answer is a global f64 mandate
# (jax/ops.py:84); the answer here is an opt-in ISLAND: upcast
# the inputs AND the kernel's parameters, trace the matrix build +
# factorization under jax.enable_x64 (real f64 semantics even in an
# f32 process), downcast the outputs.
# The upcast/downcast casts are differentiable, so grads flow back to
# the caller's f32 parameters at f64 internal accuracy.


def _island_active(t) -> bool:
    from celerite2_tpu.config import get_config

    return (
        get_config().core_dtype == "float64"
        and jnp.asarray(t).dtype != jnp.float64
    )


def _upcast(x):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x.astype(jnp.float64)
    return x


def _upcast_kernel(kernel):
    """Upcast every floating leaf of the kernel pytree (terms are
    registered pytrees; structure is preserved)."""
    return jax.tree_util.tree_map(_upcast, kernel)


# --- island batching guard -------------------------------------------
# The island does NOT survive jaxpr-level batching of control flow
# around it (vmapped sampler while-loops): the batching rule re-binds
# the island's f64 ops under the process's x64-off config and silently
# truncates them, failing later with an unrelated dtype error.  This
# sentinel identity primitive turns that into an immediate, actionable
# error: its batching rule raises when invoked OUTSIDE an x64 context.
# Python-level vmap (vmap(grad(...)) etc.) retraces the island's
# callable inside `jax.enable_x64(True)`, so the rule passes there —
# exactly the supported/unsupported split pinned in test_numerics.py.
try:
    from jax.extend.core import Primitive as _Primitive
except ImportError:  # pragma: no cover - older jax layouts
    from jax.core import Primitive as _Primitive

from jax.interpreters import ad as _ad
from jax.interpreters import batching as _batching
from jax.interpreters import mlir as _mlir

_island_guard_p = _Primitive("celerite2_f64_island_guard")
_island_guard_p.def_impl(lambda x: x)
_island_guard_p.def_abstract_eval(lambda x: x)
_ad.deflinear2(_island_guard_p, lambda ct, x: [ct])
_mlir.register_lowering(_island_guard_p, lambda ctx, x: [x])


def _island_guard_batcher(args, dims):
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "the f64 island (config.core_dtype='float64') was batched "
            "at the jaxpr level outside an x64 context — this happens "
            "when lax control flow AROUND the island (e.g. a vmapped "
            "NUTS/HMC chain while-loop) is vmapped, and would silently "
            "truncate the island's f64 ops.  Scope the WHOLE call in "
            "jax.enable_x64(True) instead (see config.core_dtype docs "
            "and benchmarks/configs.py config4)."
        )
    (x,), (d,) = args, dims
    return _island_guard_p.bind(x), d


_batching.primitive_batchers[_island_guard_p] = _island_guard_batcher


def _apply_island_guard(tree):
    """Thread the first floating leaf through the sentinel primitive
    (one guard poisons the whole jaxpr for illegal rebinding)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
            leaves = list(leaves)
            leaves[i] = _island_guard_p.bind(jnp.asarray(leaf))
            break
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _island_run(fn, out_dtype, *args):
    """Run ``fn(*args)`` with every floating leaf upcast to f64 under
    ``jax.enable_x64`` and results downcast to the inputs' dtype, on
    the forward-stable SCAN tier.

    The tier pin matters as much as the precision: the assoc engine's
    inverse-based Riccati combine amplifies stiffness like ~1/eps^2
    (measured: the d(ll)/d(eps) gradient of a Matern32+SHO model at
    eps=0.01 is off by 18% between tiers even in f64, converging
    smoothly — 1e-5 at eps=0.05, 4e-9 at eps=0.3 — while the
    sequential recursion is forward-stable at every eps).  Stiff
    kernels are exactly where the island activates, so it routes to
    the scan tier (the reference's sequential algorithm,
    forward.hpp:111-132, which has the same stability property).

    The x64 context only affects ops traced lexically inside it, but
    reverse-mode AD traces the (custom-)VJPs of the inner ops *later*,
    when the caller's gradient is built — outside any context, where an
    x64-disabled process would truncate their f64 zeros/constants back
    to f32.  So the island is itself a ``custom_vjp``: the forward
    captures ``jax.vjp(fn)`` inside a context (linearizing every inner
    op under x64 semantics) and the backward replays the stored
    transpose inside another one.  Gradients flow to the caller's f32
    leaves through the cast boundaries at f64 internal accuracy.
    """
    def inner(*a):
        a64 = jax.tree_util.tree_map(_upcast, a)
        a64 = _apply_island_guard(a64)
        out = fn(*a64)
        return jax.tree_util.tree_map(
            lambda x: x.astype(out_dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else x,
            out,
        )

    from celerite2_tpu.config import get_config, set_config

    def _scan_tier():
        prior = get_config()
        set_config(backend="scan")
        return prior

    @jax.custom_vjp
    def call(*a):
        prior = _scan_tier()
        try:
            with jax.enable_x64(True):
                return inner(*a)
        finally:
            set_config(**prior.__dict__)

    def fwd(*a):
        prior = _scan_tier()
        try:
            with jax.enable_x64(True):
                return jax.vjp(inner, *a)
        finally:
            set_config(**prior.__dict__)

    def bwd(vjp_fn, ct):
        # the inner ops' custom-VJP bwd rules trace HERE (not at
        # fwd-linearization time), so the scan-tier pin is needed
        # again or the reverse sweeps would re-route to the assoc tier
        prior = _scan_tier()
        try:
            with jax.enable_x64(True):
                return vjp_fn(ct)
        finally:
            set_config(**prior.__dict__)

    call.defvjp(fwd, bwd)
    return call(*args)


def gp_compute(kernel, t, *, yerr=None, diag=None, mean=0.0) -> GPState:
    """Build and factorize the GP system (reference core.py:262-317).

    Under ``config.core_dtype == "float64"`` the matrix build and the
    factorization run in an f64 island (see above); the returned state
    is downcast to the input dtype (prediction/conditioning then run at
    input precision on the accurately-computed factors).
    """
    t = _atleast_1d((t))
    if yerr is not None and diag is not None:
        raise ValueError("only one of 'diag' and 'yerr' can be provided")
    if yerr is not None:
        diag_v = jnp.broadcast_to(_asarr(yerr), t.shape) ** 2
    elif diag is not None:
        diag_v = jnp.broadcast_to(_asarr(diag), t.shape)
    else:
        diag_v = jnp.zeros_like(t)

    mean_fn = mean if callable(mean) else ConstantMean(mean)
    mean_value = jnp.broadcast_to(_asarr(mean_fn(t)), t.shape)

    if _island_active(t):
        c, a, U, V, d, W = _island_run(
            _compute_core, t.dtype, kernel, t, diag_v
        )
    else:
        c, a, U, V, d, W = _compute_core(kernel, t, diag_v)

    ok = jnp.all(d > 0)
    safe_d = jnp.where(d > 0, d, jnp.ones_like(d))
    log_det = jnp.where(ok, jnp.sum(jnp.log(safe_d)), -jnp.inf)
    norm = jnp.where(
        ok,
        -0.5 * (log_det + t.shape[0] * LOG2PI),
        jnp.inf,
    )
    return GPState(
        t=t,
        c=c,
        a=a,
        U=U,
        V=V,
        d=d,
        W=W,
        diag=diag_v,
        mean_value=mean_value,
        ok=ok,
        log_det=log_det,
        norm=norm,
    )


def _compute_core(kernel, t, diag_v):
    c, a, U, V = kernel.get_celerite_matrices(t, diag_v)
    d, W = ops.factor(t, c, a, U, V)
    return c, a, U, V, d, W


def _as_matrix(y):
    y = _asarr(y)
    if y.ndim == 1:
        return y[:, None], True
    return y, False


def gp_apply_inverse(state: GPState, y):
    """K^{-1} y = L^{-T} d^{-1} L^{-1} y (reference numpy.py:94-98)."""
    Y, is_vec = _as_matrix(y)
    safe_d = jnp.where(state.d > 0, state.d, jnp.ones_like(state.d))
    z = ops.solve_lower(state.t, state.c, state.U, state.W, Y)
    z = z / safe_d[:, None]
    z = ops.solve_upper(state.t, state.c, state.U, state.W, z)
    return z[:, 0] if is_vec else z


def gp_dot_tril(state: GPState, y):
    """L sqrt(d)-weighted product: x = L diag(sqrt(d)) y, so that
    x x^T averages to K (reference numpy.py:100-102)."""
    Y, is_vec = _as_matrix(y)
    safe_d = jnp.where(state.d > 0, state.d, jnp.zeros_like(state.d))
    z = jnp.sqrt(safe_d)[:, None] * Y
    z = z + ops.matmul_lower(state.t, state.c, state.U, state.W, z)
    return z[:, 0] if is_vec else z


def gp_log_likelihood(state: GPState, y):
    """norm - (log_det + alpha^T d^{-1} alpha)/2 (reference core.py:407-428,
    numpy.py:104-109), with quiet -inf on non-PD systems."""
    y = _asarr(y)
    resid = (y - state.mean_value)[:, None]
    alpha = ops.solve_lower(state.t, state.c, state.U, state.W, resid)[:, 0]
    safe_d = jnp.where(state.d > 0, state.d, jnp.ones_like(state.d))
    quad = jnp.sum(alpha**2 / safe_d)
    ll = state.norm - 0.5 * quad
    return jnp.where(state.ok, ll, -jnp.inf)


def gp_loglik(kernel, t, y, *, yerr=None, diag=None, mean=0.0):
    """GP log-likelihood in ONE fused pass (the sampler hot path).

    Equivalent to ``gp_log_likelihood(gp_compute(kernel, t, ...), y)``
    but runs factor + solve as a single sweep / engine invocation
    (``ops.factor_solve``), halving the forward cost.  Use this inside
    log-posteriors driven by the inference engine; use
    ``gp_compute`` + the state API when you also need prediction or
    sampling from the same factorization.
    """
    t = _atleast_1d((t))
    if yerr is not None and diag is not None:
        raise ValueError("only one of 'diag' and 'yerr' can be provided")
    if yerr is not None:
        diag_v = jnp.broadcast_to(_asarr(yerr), t.shape) ** 2
    elif diag is not None:
        diag_v = jnp.broadcast_to(_asarr(diag), t.shape)
    else:
        diag_v = jnp.zeros_like(t)
    mean_fn = mean if callable(mean) else ConstantMean(mean)
    resid = _asarr(y) - jnp.broadcast_to(_asarr(mean_fn(t)), t.shape)

    if _island_active(t):
        return _island_run(_loglik_core, t.dtype, kernel, t, resid, diag_v)
    return _loglik_core(kernel, t, resid, diag_v)


def _loglik_core(kernel, t, resid, diag_v):
    c, a, U, V = kernel.get_celerite_matrices(t, diag_v)
    d, _, z = ops.factor_solve(t, c, a, U, V, resid[:, None])

    ok = jnp.all(d > 0)
    safe_d = jnp.where(d > 0, d, jnp.ones_like(d))
    quad = jnp.sum(z[:, 0] ** 2 / safe_d)
    ll = -0.5 * (
        jnp.sum(jnp.log(safe_d)) + quad + t.shape[0] * LOG2PI
    )
    return jnp.where(ok, ll, -jnp.inf)


def gp_sample(state: GPState, key, *, shape=(), include_mean=True):
    """Prior samples via L sqrt(d) z (reference numpy.py:111-121)."""
    n = state.t.shape[0]
    z = jax.random.normal(key, shape + (n,), dtype=state.t.dtype)
    flat = z.reshape(-1, n).T
    samp = gp_dot_tril(state, flat).T.reshape(shape + (n,))
    if include_mean:
        samp = samp + state.mean_value
    return samp


def _cross_dot(kernel, t_train, xs, inp):
    """``K*(xs, t_train) @ inp`` via the rectangular semiseparable ops
    (reference core.py:68-113)."""
    zeros_t = jnp.zeros_like(t_train)
    zeros_s = jnp.zeros_like(xs)
    c, _, U1, V1 = kernel.get_celerite_matrices(t_train, zeros_t)
    _, _, U2, V2 = kernel.get_celerite_matrices(xs, zeros_s)
    inp2, is_vec = _as_matrix(inp)
    z = ops.general_matmul_lower(
        xs, t_train, c, U2, V1, inp2
    ) + ops.general_matmul_upper(xs, t_train, c, V2, U1, inp2)
    return z[:, 0] if is_vec else z


def _complement_kernel(full, component):
    """The kernel ``full - component`` when it is derivable: ``full``
    must be a :class:`~celerite2_tpu.models.terms.TermSum` containing
    ``component`` (by identity) as one of its summands, possibly
    nested.  Used by the component pathwise conditional, which needs an
    independent draw from the *rest* of the kernel (the reference's
    dense path, core.py:74-113, never needs this because it
    materializes the M x M covariance).
    """
    from celerite2_tpu.models.terms import TermSum

    if component is full:
        return None
    if not isinstance(full, TermSum):
        raise ValueError(
            "pathwise component conditionals need the complement kernel "
            "(full - kernel); it is derived automatically only when the "
            "GP kernel is a sum containing `kernel` as a summand — pass "
            "complement= explicitly otherwise"
        )
    rest = []
    found = 0
    for sub in full.terms:
        if sub is component:
            found += 1
        elif isinstance(sub, TermSum) and component in _flat_terms(sub):
            inner = _complement_kernel(sub, component)
            if inner is not None:
                rest.append(inner)
            found += 1
        else:
            rest.append(sub)
    if found != 1:
        raise ValueError(
            "could not uniquely identify `kernel` as a summand of the "
            "GP kernel; pass complement= explicitly"
        )
    if not rest:
        raise ValueError(
            "`kernel` IS the full kernel; drop kernel= for the "
            "full-kernel conditional"
        )
    return rest[0] if len(rest) == 1 else TermSum(*rest)


def _flat_terms(term):
    from celerite2_tpu.models.terms import TermSum

    if isinstance(term, TermSum):
        out = []
        for sub in term.terms:
            out.extend(_flat_terms(sub))
        return out
    return [term]


def _pathwise_core(state, kernel, y, xs, z, eps, *, regularize=None,
                   complement=None, z_comp=None):
    """Pathwise (Matheron) conditional draws as a pure function of the
    noise: ``f* + K(xs, t) (K_tt + S)^{-1} (y - m - f_t - e)`` with
    ``(f_t, f*)`` one joint latent prior draw over the sorted union of
    training and target times (O((N+M) J^2) semiseparable factor) and
    ``e = sqrt(diag) * eps``.  Mean at ``xs`` NOT included.

    Component conditionals (``complement is not None``): ``kernel`` is
    the component K1 and ``complement`` the remaining kernel K2 with
    K_full = K1 + K2.  The joint K1-prior supplies ``(g_t, g*)``; an
    independent draw ``h_t ~ N(0, K2(t,t))`` (from ``z_comp``, via the
    O(N J2^2) semiseparable factor at the training points) completes
    the training-side latent so that ``g_t + h_t + e`` has the full
    covariance ``K_tt + S`` while ``Cov(g*, g_t + h_t) = K1(xs, t)``
    — exactly the cross-covariance the component conditional needs.
    The output law is N(K1(xs,t) (K+S)^{-1} (y-m),
    K1(xs,xs) - K1(xs,t) (K+S)^{-1} K1(t,xs)), the same as the dense
    component conditional (reference core.py:74-113).
    """
    N = state.t.shape[0]
    M = xs.shape[0]

    # joint latent prior over the sorted union of (t, xs); a stable
    # argsort keeps equal times in (train, test) order so duplicated
    # points stay adjacent (use ``regularize`` then: the
    # exactly-duplicated joint system is singular)
    t_all = jnp.concatenate([state.t, xs])
    order = jnp.argsort(t_all, stable=True)
    t_u = t_all[order]
    inv = jnp.argsort(order, stable=True)
    pos_train, pos_test = inv[:N], inv[N:]
    diag_u = jnp.zeros_like(t_u)
    if regularize is not None:
        diag_u = diag_u + regularize
    c, a, U, V = kernel.get_celerite_matrices(t_u, diag_u)
    d_u, W_u = ops.factor(t_u, c, a, U, V)

    # f ~ N(0, K_joint) via the O(N+M) semiseparable factor
    zf = z.reshape(-1, N + M).T
    safe_d = jnp.where(d_u > 0, d_u, jnp.zeros_like(d_u))
    f = jnp.sqrt(safe_d)[:, None] * zf
    f = f + ops.matmul_lower(t_u, c, U, W_u, f)
    f_all = f.T.reshape(z.shape)
    f_train = f_all[..., pos_train]
    f_test = f_all[..., pos_test]

    if complement is not None:
        # independent complement draw h ~ N(0, K2(t, t)) at the
        # training points completes the full training-side latent
        diag_c = jnp.zeros_like(state.t)
        if regularize is not None:
            diag_c = diag_c + regularize
        c2, a2, U2, V2 = complement.get_celerite_matrices(state.t, diag_c)
        d2, W2 = ops.factor(state.t, c2, a2, U2, V2)
        zc = z_comp.reshape(-1, N).T
        safe_d2 = jnp.where(d2 > 0, d2, jnp.zeros_like(d2))
        h = jnp.sqrt(safe_d2)[:, None] * zc
        h = h + ops.matmul_lower(state.t, c2, U2, W2, h)
        f_train = f_train + h.T.reshape(z_comp.shape)

    # correction: K(xs, t) (K_tt + Sigma)^{-1} (y - m - f - eps)
    noise = eps * jnp.sqrt(state.diag)
    resid = (y - state.mean_value) - f_train - noise
    alpha = gp_apply_inverse(
        state, jnp.moveaxis(resid.reshape(-1, N), 0, 1)
    )
    corr = _cross_dot(kernel, state.t, xs, alpha)
    return f_test + jnp.moveaxis(corr, 0, -1).reshape(
        eps.shape[:-1] + (M,)
    )


def gp_sample_conditional(state, kernel, y, t_new, key, *, shape=(),
                          mean=0.0, regularize=None, complement=None):
    """Exact conditional samples at ``t_new`` — functional core of
    :meth:`ConditionalDistribution.sample_pathwise` (pathwise/Matheron
    conditioning, O(N+M) per draw, no dense Cholesky).

    Being a pure function of ``(state, kernel, y)`` pytrees, this is
    the posterior-predictive building block for FLEETS: vmap it over a
    stack of posterior ``GPState``s (one per theta draw) and the whole
    predictive ensemble is one XLA program.

    ``mean`` (scalar or callable) is the mean function evaluated at
    ``t_new`` (the training mean is already in ``state.mean_value``).
    ``regularize`` jitters the joint prior diagonal — required when
    ``t_new`` duplicates training times.

    Component conditionals: pass the component as ``kernel`` and the
    remaining kernel (full minus component) as ``complement``; the law
    is then the component conditional (cf. reference core.py:74-113).
    """
    t_new = _atleast_1d(t_new)
    y = _asarr(y)
    N = state.t.shape[0]
    M = t_new.shape[0]
    kz, kc, ke = jax.random.split(key, 3)
    z = jax.random.normal(kz, shape + (N + M,), dtype=state.t.dtype)
    eps = jax.random.normal(ke, shape + (N,), dtype=state.t.dtype)
    z_comp = None
    if complement is not None:
        z_comp = jax.random.normal(kc, shape + (N,), dtype=state.t.dtype)
    samp = _pathwise_core(
        state, kernel, y, t_new, z, eps, regularize=regularize,
        complement=complement, z_comp=z_comp,
    )
    mean_fn = mean if callable(mean) else ConstantMean(mean)
    return samp + jnp.broadcast_to(_asarr(mean_fn(t_new)), (M,))


# ======================================================== conditional


class ConditionalDistribution:
    """The conditional (predictive) distribution
    (reference core.py:20-179).

    The mean uses the O(N + M) semiseparable path; ``variance`` and
    ``covariance`` build the dense N x M cross-covariance like the
    reference (core.py:52-66,134-150) — a documented O(N M) cost.
    """

    def __init__(self, gp, y, t=None, *, include_mean=True, kernel=None):
        self.gp = gp
        self.y = _asarr(y)
        self.t = None if t is None else _atleast_1d((t))
        if self.t is not None and self.t.ndim != 1:
            raise ValueError("'t' must be one-dimensional")
        self.include_mean = include_mean
        self.kernel = kernel
        self._xs = self.gp._state.t if self.t is None else self.t

    # -------------------------------------------------- dense pieces
    @property
    def KxsT(self):
        kernel = self.kernel or self.gp.kernel
        tau = self.gp._state.t[:, None] - self._xs[None, :]
        return kernel.get_value(tau)

    @property
    def Kinv_KxsT(self):
        return self.gp.apply_inverse(self.KxsT)

    # ----------------------------------------------------- the mean
    def _alpha(self):
        st = self.gp._state
        resid = (self.y - st.mean_value)[:, None]
        return self.gp.apply_inverse(resid)[:, 0]

    def _do_dot(self, inp):
        """General cross-kernel product K*(xs, t) @ inp via the
        rectangular semiseparable ops (reference core.py:68-113)."""
        kernel = self.kernel or self.gp.kernel
        return _cross_dot(kernel, self.gp._state.t, self._xs, inp)

    @property
    def mean(self):
        st = self.gp._state
        alpha = self._alpha()

        if self.t is None and self.kernel is None:
            # fast O(N) path: mu = y - diag * alpha
            mu = self.y - st.diag * alpha
            if not self.include_mean:
                mu = mu - st.mean_value
            return mu

        mu = self._do_dot(alpha)
        if self.include_mean:
            mu = mu + self.gp._mean(self._xs)
        return mu

    @property
    def variance(self):
        kernel = self.kernel or self.gp.kernel
        var = kernel.get_value(jnp.zeros((1,)))[0] - jnp.sum(
            self.KxsT * self.Kinv_KxsT, axis=0
        )
        return var

    @property
    def covariance(self):
        kernel = self.kernel or self.gp.kernel
        cov = kernel.get_value(self._xs[:, None] - self._xs[None, :])
        cov = cov - self._do_dot(self.Kinv_KxsT)
        return cov

    def sample(self, key, *, shape=(), regularize=None):
        """Sample the conditional; O(M^3) (reference core.py:152-179)."""
        mu = self.mean
        cov = self.covariance
        if regularize is not None:
            cov = cov + regularize * jnp.eye(
                cov.shape[0], dtype=cov.dtype
            )
        chol = jnp.linalg.cholesky(cov)
        z = jax.random.normal(
            key, shape + (cov.shape[0],), dtype=cov.dtype
        )
        return mu + jnp.einsum("ij,...j->...i", chol, z,
                               precision="highest")

    # -------------------------------------------- pathwise sampling
    def _pathwise_transform(self, z, eps, *, regularize=None,
                            z_comp=None, complement=None):
        """The affine map behind :meth:`sample_pathwise`.

        ``z (..., N+M)`` standard normals for the joint latent prior,
        ``eps (..., N)`` standard normals for the observation noise
        (plus ``z_comp (..., N)`` for the complement draw on component
        conditionals).  Returns conditional samples ``(..., M)``.
        Exposed separately so tests can verify the *exact* second
        moment: the map is affine in ``(z, z_comp, eps)``, and its
        Jacobian ``A`` must satisfy ``A A^T == covariance`` (no Monte
        Carlo error involved).
        """
        kernel = self.kernel or self.gp.kernel
        if self.kernel is not None and complement is None:
            complement = _complement_kernel(self.gp.kernel, self.kernel)
        samp = _pathwise_core(
            self.gp._state, kernel, self.y, self._xs, z, eps,
            regularize=regularize, complement=complement, z_comp=z_comp,
        )
        if self.include_mean:
            samp = samp + self.gp._mean(self._xs)
        return samp

    def sample_pathwise(self, key, *, shape=(), regularize=None,
                        complement=None):
        """Exact conditional sampling WITHOUT the M x M Cholesky.

        Pathwise (Matheron's rule) conditioning: draw the joint latent
        prior over the sorted union of training and target points with
        the O((N+M) J^2) semiseparable factor, then shift by the
        conditional correction computed from the already-available
        training factorization::

            f* | y  =  f*  +  K(xs, t) (K_tt + S)^{-1} (y - m - f_t - e)

        with ``(f_t, f*)`` a joint prior draw and ``e ~ N(0, S)``.  The
        result is *exactly* ``N(mean, covariance)`` — same law as
        :meth:`sample` (reference core.py:152-179) — at O(N + M) cost
        per sample instead of O(M^3), so it scales to sampling entire
        light curves.  Replacement for the dense path; all
        pieces (factor, matmul_lower, solves, general matmuls) run on
        the semiseparable engine tiers.

        ``regularize`` adds a jitter to the *joint* prior diagonal;
        required when target points duplicate training times (the
        joint system is singular there).

        Component (``kernel=``) conditionals draw the joint prior from
        the component and an independent complement draw at the
        training points (law matches the dense component conditional
        exactly; see :func:`_pathwise_core`).  The complement kernel is
        derived automatically when the GP kernel is a sum containing
        the component as a summand; pass ``complement=`` otherwise.
        """
        st = self.gp._state
        N = st.t.shape[0]
        M = self._xs.shape[0]
        if self.kernel is not None and complement is None:
            complement = _complement_kernel(self.gp.kernel, self.kernel)
        kz, kc, ke = jax.random.split(key, 3)
        z = jax.random.normal(kz, shape + (N + M,), dtype=st.t.dtype)
        eps = jax.random.normal(ke, shape + (N,), dtype=st.t.dtype)
        z_comp = None
        if self.kernel is not None:
            z_comp = jax.random.normal(kc, shape + (N,), dtype=st.t.dtype)
        return self._pathwise_transform(
            z, eps, regularize=regularize, z_comp=z_comp,
            complement=complement,
        )


# ============================================================ the shell


class GaussianProcess:
    """User-facing GP object (reference core.py:182-501 surface).

    In addition to the reference API, the functional core is exposed:
    ``gp.state`` after ``compute``, and the module-level ``gp_*``
    functions for fully-traced pipelines.
    """

    conditional_distribution = ConditionalDistribution

    def __init__(self, kernel, t=None, *, mean=0.0, **kwargs):
        self.kernel = kernel
        self.mean = mean
        self._state: Optional[GPState] = None
        if t is not None:
            self.compute(t, **kwargs)

    # -------------------------------------------------------- mean
    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, mean):
        self._mean = mean if callable(mean) else ConstantMean(mean)

    @property
    def mean_value(self):
        self._require_computed()
        return self._state.mean_value

    @property
    def state(self) -> GPState:
        self._require_computed()
        return self._state

    # ------------------------------------------------------ compute
    def compute(
        self, t, *, yerr=None, diag=None, check_sorted=True, quiet=False
    ):
        t = _atleast_1d((t))
        if t.ndim != 1:
            raise ValueError(
                "The input coordinates must be one dimensional"
            )
        if check_sorted and not isinstance(t, jax.core.Tracer):
            if bool(jnp.any(t[1:] < t[:-1])):
                raise ValueError(
                    "The input coordinates must be sorted"
                )
        self._state = gp_compute(
            self.kernel, t, yerr=yerr, diag=diag, mean=self._mean
        )
        if not quiet and not isinstance(
            self._state.ok, jax.core.Tracer
        ):
            if not bool(self._state.ok):
                raise LinAlgError(
                    "failed to factorize or solve matrix; the system is "
                    "not positive definite (use quiet=True for -inf "
                    "log-likelihood semantics)"
                )
        return self

    def recompute(self, *, quiet=False):
        """Re-factorize with the stored inputs (reference core.py:319-339)."""
        self._require_computed()
        st = self._state
        return self.compute(
            st.t, diag=st.diag, check_sorted=False, quiet=quiet
        )

    def _require_computed(self):
        if self._state is None:
            raise RuntimeError("you must call 'compute' first")

    def _process_input(self, y, *, require_vector=False):
        self._require_computed()
        y = _asarr(y)
        if require_vector and y.ndim != 1:
            raise ValueError("'y' must be one dimensional")
        if y.shape[0] != self._state.t.shape[0]:
            raise ValueError("dimension mismatch")
        return y

    # ------------------------------------------------------- solver
    def apply_inverse(self, y, **_ignored):
        y = self._process_input(y)
        return gp_apply_inverse(self._state, y)

    def dot_tril(self, y, **_ignored):
        y = self._process_input(y)
        return gp_dot_tril(self._state, y)

    def log_likelihood(self, y, **_ignored):
        y = self._process_input(y, require_vector=True)
        return gp_log_likelihood(self._state, y)

    # --------------------------------------------------- prediction
    def predict(
        self,
        y,
        t=None,
        *,
        return_cov=False,
        return_var=False,
        include_mean=True,
        kernel=None,
    ):
        cond = self.condition(
            y, t=t, include_mean=include_mean, kernel=kernel
        )
        if return_var:
            return cond.mean, cond.variance
        if return_cov:
            return cond.mean, cond.covariance
        return cond.mean

    def condition(self, y, t=None, *, include_mean=True, kernel=None):
        y = self._process_input(y, require_vector=True)
        return self.conditional_distribution(
            self, y, t=t, include_mean=include_mean, kernel=kernel
        )

    # ----------------------------------------------------- sampling
    def sample(self, key, *, size=None, include_mean=True):
        self._require_computed()
        shape = () if size is None else (size,)
        return gp_sample(
            self._state, key, shape=shape, include_mean=include_mean
        )

    def numpyro_dist(self):
        """A numpyro distribution over the observations (gated import;
        reference jax/celerite2.py:71-74)."""
        from celerite2_tpu.distributions import CeleriteNormal

        return CeleriteNormal(self)

    @property
    def citations(self):
        """BibTeX for the celerite method papers (reference
        pymc/celerite2.py:74-80, citation.py)."""
        from celerite2_tpu.citation import CITATION_KEYS, get_citations

        return CITATION_KEYS, get_citations()
