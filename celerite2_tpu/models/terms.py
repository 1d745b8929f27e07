"""The celerite kernel ("term") DSL, as JAX pytrees.

Functional parity with the reference's term DSL
(/root/reference/python/celerite2/terms.py:3-826 and the traced variant in
python/celerite2/jax/terms.py), re-designed for accelerators:

* every term is a registered pytree, so terms can be passed through ``jit``,
  ``grad``, ``vmap`` and ``pjit`` directly (hyperparameters are leaves);
* all widths (J) are static properties of the term *structure*, never of
  parameter values, so shapes are known at trace time;
* everything is branchless: ``SHOTerm`` evaluates both the over- and
  under-damped regimes and selects with ``jnp.where`` so ``Q`` can be a
  traced value (cf. reference jax/terms.py:481-547).

A term models the kernel function

    k(tau) = sum_j ar_j * exp(-cr_j * tau)
           + sum_j exp(-cc_j * tau) * (ac_j cos(dc_j tau) + bc_j sin(dc_j tau))

and exposes the semiseparable representation ``(c, a, U, V)`` with

    K[n, m] = sum_j U[n, j] * V[m, j] * exp(-c_j (t[n] - t[m]))   (n > m)

via :meth:`Term.get_celerite_matrices` (reference terms.py:117-177).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from celerite2_tpu.utils.misc import asarr as _asarr, atleast_1d as _atleast_1d

__all__ = [
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
]


def _register(cls):
    """Register a Term subclass as a pytree; leaves are ``cls._params``."""

    def flatten(obj):
        return tuple(getattr(obj, p) for p in cls._params), None

    def flatten_with_keys(obj):
        return (
            tuple(
                (jax.tree_util.GetAttrKey(p), getattr(obj, p))
                for p in cls._params
            ),
            None,
        )

    def unflatten(aux, children):
        obj = object.__new__(cls)
        for name, val in zip(cls._params, children):
            object.__setattr__(obj, name, val)
        return obj

    jax.tree_util.register_pytree_with_keys(
        cls, flatten_with_keys, unflatten, flatten
    )
    return cls


class Term:
    """Abstract base term.

    Subclasses define ``_params`` (pytree leaf attribute names) and
    either :meth:`get_coefficients` or override the matrix/value/psd
    methods directly (as :class:`SHOTerm` does).
    """

    _params: tuple = ()

    # ---------------------------------------------------------- algebra
    def __add__(self, other):
        return TermSum(self, other)

    def __mul__(self, other):
        return TermProduct(self, other)

    @property
    def terms(self):
        return (self,)

    # ------------------------------------------------------ coefficients
    def get_coefficients(self):
        """Return ``(ar, cr, ac, bc, cc, dc)`` coefficient arrays."""
        raise NotImplementedError("subclasses must implement this method")

    @property
    def width(self) -> int:
        """The celerite width J implied by this term's structure."""
        ar, _, ac, _, _, _ = self._coeff_shape()
        return ar + 2 * ac

    def _coeff_shape(self):
        """Static (n_real, n_real, n_complex x4) coefficient counts."""
        coeffs = jax.eval_shape(lambda t: t.get_coefficients(), self)
        return tuple(int(c.shape[0]) for c in coeffs)

    # ------------------------------------------------------- evaluation
    def get_value(self, tau):
        """Evaluate k(tau) (reference terms.py:58-79)."""
        tau = jnp.abs(_atleast_1d((tau)))[..., None]
        ar, cr, ac, bc, cc, dc = self.get_coefficients()
        k = jnp.sum(ar * jnp.exp(-cr * tau), axis=-1)
        arg = dc * tau
        k += jnp.sum(
            jnp.exp(-cc * tau) * (ac * jnp.cos(arg) + bc * jnp.sin(arg)),
            axis=-1,
        )
        return k

    def get_psd(self, omega):
        """Power spectral density (reference terms.py:81-104)."""
        w2 = _atleast_1d((omega))[..., None] ** 2
        ar, cr, ac, bc, cc, dc = self.get_coefficients()
        psd = jnp.sum(ar * cr / (cr**2 + w2), axis=-1)
        w02 = cc**2 + dc**2
        psd += jnp.sum(
            ((ac * cc + bc * dc) * w02 + (ac * cc - bc * dc) * w2)
            / (w2**2 + 2.0 * (cc * cc - dc * dc) * w2 + w02 * w02),
            axis=-1,
        )
        return jnp.sqrt(2.0 / jnp.pi) * psd

    def to_dense(self, x, diag):
        """Dense covariance matrix (test oracle; reference terms.py:106-115)."""
        x = _atleast_1d((x))
        K = self.get_value(x[:, None] - x[None, :])
        return K + jnp.diag(_atleast_1d((diag)))

    # ----------------------------------------------------- the matrices
    def get_celerite_matrices(self, x, diag):
        """Build ``(c, a, U, V)`` for the semiseparable solver.

        Complex pairs are interleaved after the real columns, matching the
        reference layout (terms.py:171-176).
        """
        x = _atleast_1d((x))
        diag = jnp.broadcast_to(_asarr(diag), x.shape)
        ar, cr, ac, bc, cc, dc = self.get_coefficients()
        return _matrices_from_coefficients(
            x, diag, ar, cr, ac, bc, cc, dc
        )

    def dot(self, x, diag, y):
        """Apply ``K @ y`` in O(N J nrhs) (reference terms.py:179-207)."""
        from celerite2_tpu.ops import matmul_lower, matmul_upper

        x = _atleast_1d((x))
        y = _asarr(y)
        if y.shape[0] != x.shape[0]:
            raise ValueError("dimension mismatch")
        is_vector = y.ndim == 1
        if is_vector:
            y = y[:, None]
        if y.ndim != 2:
            raise ValueError("'y' can only be a vector or matrix")

        c, a, U, V = self.get_celerite_matrices(x, diag)
        z = a[:, None] * y
        z = z + matmul_lower(x, c, U, V, y)
        z = z + matmul_upper(x, c, U, V, y)
        return z[:, 0] if is_vector else z


def _matrices_from_coefficients(x, diag, ar, cr, ac, bc, cc, dc):
    """Vectorized (c, a, U, V) construction.

    Replacement for the fused C++ fill kernel
    (reference driver.cpp:422-477): a handful of elementwise ops XLA fuses
    into one pass over the (N, J) matrices.
    """
    N = x.shape[0]
    Jr = ar.shape[0]
    Jc = ac.shape[0]
    dtype = jnp.result_type(x.dtype, ar.dtype, ac.dtype)

    a = diag + (jnp.sum(ar) + jnp.sum(ac))

    cols_c, cols_U, cols_V = [], [], []
    if Jr:
        cols_c.append(cr)
        cols_U.append(jnp.broadcast_to(ar, (N, Jr)))
        cols_V.append(jnp.ones((N, Jr), dtype=dtype))
    if Jc:
        arg = dc[None, :] * x[:, None]
        cos, sin = jnp.cos(arg), jnp.sin(arg)
        U1 = ac * cos + bc * sin
        U2 = ac * sin - bc * cos
        # interleave the two columns of each complex pair
        Uc = jnp.stack([U1, U2], axis=-1).reshape(N, 2 * Jc)
        Vc = jnp.stack([cos, sin], axis=-1).reshape(N, 2 * Jc)
        cc2 = jnp.stack([cc, cc], axis=-1).reshape(2 * Jc)
        cols_c.append(cc2)
        cols_U.append(Uc)
        cols_V.append(Vc)

    if not cols_c:
        J = 0
        return (
            jnp.zeros((0,), dtype=dtype),
            a,
            jnp.zeros((N, J), dtype=dtype),
            jnp.zeros((N, J), dtype=dtype),
        )
    c = jnp.concatenate(cols_c).astype(dtype)
    U = jnp.concatenate(cols_U, axis=1).astype(dtype)
    V = jnp.concatenate(cols_V, axis=1).astype(dtype)
    return c, a.astype(dtype), U, V


# =============================================================== algebra


def _no_convolution(*terms, op: str):
    if any(isinstance(t, TermConvolution) for t in terms):
        raise TypeError(
            "You cannot perform operations on a TermConvolution, it must "
            "be the outer term in the kernel"
        )


@_register
class TermSum(Term):
    """Sum of terms; widths concatenate (reference terms.py:210-235)."""

    _params = ("_terms",)

    def __init__(self, *terms):
        _no_convolution(*terms, op="sum")
        self._terms = tuple(terms)

    @property
    def terms(self):
        return self._terms

    def get_coefficients(self):
        coeffs = [t.get_coefficients() for t in self._terms]
        return tuple(jnp.concatenate(parts) for parts in zip(*coeffs))

    def get_celerite_matrices(self, x, diag):
        # Compose via the sub-term matrices so terms that override matrix
        # construction (SHOTerm, sub-kernels) stay correct under tracing
        # (cf. reference jax/terms.py:182-205).
        x = _atleast_1d((x))
        diag = jnp.broadcast_to(_asarr(diag), x.shape)
        zero = jnp.zeros_like(diag)
        cs, alist, Us, Vs = [], [], [], []
        for t in self._terms:
            c, a, U, V = t.get_celerite_matrices(x, zero)
            cs.append(c)
            alist.append(a)
            Us.append(U)
            Vs.append(V)
        return (
            jnp.concatenate(cs),
            diag + sum(alist),
            jnp.concatenate(Us, axis=1),
            jnp.concatenate(Vs, axis=1),
        )

    def get_value(self, tau):
        return sum(t.get_value(tau) for t in self._terms)

    def get_psd(self, omega):
        return sum(t.get_psd(omega) for t in self._terms)

    @property
    def width(self) -> int:
        return sum(t.width for t in self._terms)


@_register
class TermProduct(Term):
    """Product of two terms; width is J1*J2 (reference terms.py:238-301).

    The closed-form coefficient products:
      real x real       -> real (a1 a2, c1 + c2)
      real x complex    -> complex (amplitudes scale, exponents add)
      complex x complex -> two complex terms at dc1 -+ dc2
    """

    _params = ("term1", "term2")

    def __init__(self, term1, term2):
        _no_convolution(term1, term2, op="product")
        self.term1 = term1
        self.term2 = term2

    def get_coefficients(self):
        ar1, cr1, ac1, bc1, cc1, dc1 = self.term1.get_coefficients()
        ar2, cr2, ac2, bc2, cc2, dc2 = self.term2.get_coefficients()

        def outer(u, v):
            return (u[:, None] * v[None, :]).reshape(-1)

        def outer_sum(u, v):
            return (u[:, None] + v[None, :]).reshape(-1)

        # real x real
        ar = outer(ar1, ar2)
        cr = outer_sum(cr1, cr2)

        acs, bcs, ccs, dcs = [], [], [], []
        # real x complex (both orders)
        for (arr, crr), (a2, b2, c2, d2) in (
            ((ar1, cr1), (ac2, bc2, cc2, dc2)),
            ((ar2, cr2), (ac1, bc1, cc1, dc1)),
        ):
            acs.append(outer(arr, a2))
            bcs.append(outer(arr, b2))
            ccs.append(outer_sum(crr, c2))
            dcs.append(jnp.broadcast_to(
                d2[None, :], (arr.shape[0], d2.shape[0])
            ).reshape(-1))

        # complex x complex: product of two damped cosinusoids splits into
        # the difference- and sum-frequency components.
        def o(u, v):
            return (u[:, None] * v[None, :]).reshape(-1)

        aa, bb = o(ac1, ac2), o(bc1, bc2)
        ab, ba = o(ac1, bc2), o(bc1, ac2)
        ccx = outer_sum(cc1, cc2)
        d_diff = (dc1[:, None] - dc2[None, :]).reshape(-1)
        d_sum = (dc1[:, None] + dc2[None, :]).reshape(-1)
        # interleave (diff, sum) pairs to mirror the reference ordering
        acs.append(
            jnp.stack(
                [0.5 * (aa + bb), 0.5 * (aa - bb)], axis=-1
            ).reshape(-1)
        )
        bcs.append(
            jnp.stack(
                [0.5 * (ba - ab), 0.5 * (ba + ab)], axis=-1
            ).reshape(-1)
        )
        ccs.append(jnp.stack([ccx, ccx], axis=-1).reshape(-1))
        dcs.append(jnp.stack([d_diff, d_sum], axis=-1).reshape(-1))

        return (
            ar,
            cr,
            jnp.concatenate(acs),
            jnp.concatenate(bcs),
            jnp.concatenate(ccs),
            jnp.concatenate(dcs),
        )

    @property
    def width(self) -> int:
        return self.term1.width * self.term2.width

    def get_value(self, tau):
        return self.term1.get_value(tau) * self.term2.get_value(tau)

    def get_celerite_matrices(self, x, diag):
        # Hadamard product of two semiseparable kernels is semiseparable
        # with row-wise Kronecker (Khatri-Rao) factors and summed transport
        # coefficients: K1[n,m] K2[n,m]
        #   = sum_{jk} (U1 kr U2)[n,jk] (V1 kr V2)[m,jk] e^{-(c_j+c_k) dt}.
        # Composing at the matrix level keeps branchless sub-terms (SHOTerm)
        # traceable (cf. reference jax/terms.py:218-232).
        x = _atleast_1d((x))
        diag = jnp.broadcast_to(_asarr(diag), x.shape)
        zero = jnp.zeros_like(diag)
        c1, a1, U1, V1 = self.term1.get_celerite_matrices(x, zero)
        c2, a2, U2, V2 = self.term2.get_celerite_matrices(x, zero)
        N = x.shape[0]
        J = c1.shape[0] * c2.shape[0]

        def kr(A, B):
            return (A[:, :, None] * B[:, None, :]).reshape(N, J)

        return (
            (c1[:, None] + c2[None, :]).reshape(J),
            diag + a1 * a2,
            kr(U1, U2),
            kr(V1, V2),
        )


@_register
class TermDiff(Term):
    """Second derivative kernel -d^2 k/d tau^2 (reference terms.py:304-330)."""

    _params = ("term",)

    def __init__(self, term):
        _no_convolution(term, op="diff")
        self.term = term

    def get_coefficients(self):
        ar, cr, a, b, c, d = self.term.get_coefficients()
        return (
            -ar * cr**2,
            cr,
            a * (d**2 - c**2) + 2 * b * c * d,
            b * (d**2 - c**2) - 2 * a * c * d,
            c,
            d,
        )


def _damped_exponentials(coeffs):
    """Collapse a 6-tuple coefficient set into complex (w, z) pairs.

    Every celerite component — real or oscillatory — is a damped complex
    exponential ``k(tau) = Re[w exp(-z tau)]`` with ``w = a + i b`` and
    ``z = c + i d`` (real components have b = d = 0).  Working in this
    unified form lets the boxcar-convolution closed forms below be
    written ONCE instead of per real/complex block.

    Returns ``(w, z, n_real)`` where the first ``n_real`` pairs are the
    purely-real components.
    """
    ar, cr, ac, bc, cc, dc = coeffs
    cplx = jnp.result_type(ar.dtype, jnp.complex64)
    w = jnp.concatenate([ar.astype(cplx), ac + 1j * bc])
    z = jnp.concatenate([cr.astype(cplx), cc + 1j * dc])
    return w, z, ar.shape[0]


def _boxcar_far_amplitudes(w, z, delta):
    """Amplitudes of the boxcar-convolved kernel at lags tau >= delta.

    Averaging ``Re[w e^{-z tau'}]`` over two width-``delta`` exposure
    windows multiplies each amplitude by
    ``(1/delta^2) int_0^d e^{zu} du int_0^d e^{-zv} dv
      = 2 (cosh(z d) - 1) / (z d)^2``
    as long as the windows do not overlap (tau >= delta); the exponents
    z are unchanged.  (Same kernel family as reference terms.py:384-410,
    derived here in the unified complex form.)
    """
    zd = z * delta
    return 2.0 * w * (jnp.cosh(zd) - 1.0) / zd**2


def _boxcar_variance_excess(w, z, delta):
    """``k_conv(0) - sum(Re[far amplitudes])``: the tau -> 0 limit of the
    convolved kernel exceeds what the far-field (semiseparable)
    representation predicts, because the exposure windows overlap.  The
    excess per component is ``2 Re[w (z d - sinh(z d))] / (z d)^2`` —
    this is the diagonal correction applied when building the celerite
    matrices (role of reference terms.py:350-382)."""
    zd = z * delta
    return 2.0 * jnp.sum((w * (zd - jnp.sinh(zd)) / zd**2).real)


@_register
class TermConvolution(Term):
    """Boxcar (exposure-time) convolution of a term.

    Same capability as reference terms.py:333-482, re-derived in the
    unified complex-exponential form (see :func:`_damped_exponentials`):
    the convolved kernel is

        k_conv(tau) = (1/d^2) int_0^d int_0^d k(tau - u + v) du dv

    which for each component ``Re[w e^{-z tau}]`` evaluates to

        tau >= d:  Re[ w' e^{-z tau} ],  w' = 2 w (cosh(zd)-1)/(zd)^2
        tau <  d:  Re[ w (2 (d-tau)/z
                         + (e^{-z(d-tau)} + e^{-z(d+tau)}
                            - 2 e^{-z tau}) / z^2) ] / d^2

    (integrate the triangular lag density (d-|s|)/d^2 over s in [-d, d]
    piecewise around s = tau).
    """

    _params = ("term", "delta")

    def __init__(self, term, delta):
        self.term = term
        self.delta = _asarr(delta)

    def get_celerite_matrices(self, x, diag):
        # Semiseparable representation = far-field amplitudes; the
        # overlap region only affects pairs closer than delta, of which
        # the diagonal is the exactly-correctable part.
        w, z, _ = _damped_exponentials(self.term.get_coefficients())
        excess = _boxcar_variance_excess(w, z, self.delta)
        x = _atleast_1d((x))
        diag = jnp.broadcast_to(_asarr(diag), x.shape)
        return Term.get_celerite_matrices(self, x, diag + excess)

    def get_coefficients(self):
        ar, cr, ac, bc, cc, dc = self.term.get_coefficients()
        w, z, n_real = _damped_exponentials(
            (ar, cr, ac, bc, cc, dc)
        )
        wp = _boxcar_far_amplitudes(w, z, self.delta)
        return (wp[:n_real].real, cr, wp[n_real:].real, wp[n_real:].imag, cc, dc)

    def get_psd(self, omega):
        omega = _atleast_1d((omega))
        psd0 = self.term.get_psd(omega)
        arg = 0.5 * self.delta * omega
        sinc = jnp.where(arg == 0.0, 1.0, jnp.sin(arg) / jnp.where(arg == 0.0, 1.0, arg))
        return psd0 * sinc**2

    def get_value(self, tau0):
        w, z, _ = _damped_exponentials(self.term.get_coefficients())
        d = self.delta
        tau0 = jnp.abs(_atleast_1d((tau0)))
        tau = tau0[..., None]

        far = jnp.sum(
            (_boxcar_far_amplitudes(w, z, d) * jnp.exp(-z * tau)).real,
            axis=-1,
        )

        gap = d - tau
        near_per = w * (
            2.0 * gap / z
            + (jnp.exp(-z * gap) + jnp.exp(-z * (d + tau)) - 2.0 * jnp.exp(-z * tau))
            / z**2
        )
        near = jnp.sum(near_per.real, axis=-1) / d**2

        return jnp.where(tau0 >= d, far, near)


# ====================================================== primitive terms


@_register
class RealTerm(Term):
    """k(tau) = a exp(-c tau) (reference terms.py:485-521)."""

    _params = ("a", "c")

    @staticmethod
    def get_test_parameters():
        return dict(a=1.5, c=0.7)

    def __init__(self, *, a, c):
        self.a = _asarr(a)
        self.c = _asarr(c)

    def get_coefficients(self):
        e = jnp.zeros((0,), dtype=jnp.result_type(self.a))
        return (
            _atleast_1d(self.a),
            _atleast_1d(self.c),
            e,
            e,
            e,
            e,
        )


@_register
class ComplexTerm(Term):
    """k(tau) = exp(-c tau) (a cos(d tau) + b sin(d tau))
    (reference terms.py:524-569)."""

    _params = ("a", "b", "c", "d")

    @staticmethod
    def get_test_parameters():
        return dict(a=1.5, b=0.7, c=0.7, d=0.5)

    def __init__(self, *, a, b, c, d):
        self.a = _asarr(a)
        self.b = _asarr(b)
        self.c = _asarr(c)
        self.d = _asarr(d)

    def get_coefficients(self):
        e = jnp.zeros((0,), dtype=jnp.result_type(self.a))
        return (
            e,
            e,
            _atleast_1d(self.a),
            _atleast_1d(self.b),
            _atleast_1d(self.c),
            _atleast_1d(self.d),
        )


def resolve_parameter_spec(spec, kwargs):
    """Resolve alternative parameterizations from a declarative table.

    ``spec`` rows are ``(primary, alternatives)`` where ``alternatives``
    maps each alternate keyword to a converter
    ``(resolved_so_far: dict, value) -> primary_value`` — converters may
    depend on primaries resolved by EARLIER rows only, which keeps the
    dependency order explicit in the table itself.  Exactly one spelling
    per row must appear in ``kwargs``; consumed names are popped, so the
    caller can detect leftover unknown keywords.  Returns the dict of
    primary values.  (Fills the role of the reference's
    ``handle_parameter_spec`` decorator, terms.py:572-601, as a plain
    data-driven function instead of an ``__init__`` wrapper.)
    """
    resolved = {}
    for primary, alternatives in spec:
        spellings = (primary, *alternatives)
        present = [name for name in spellings if name in kwargs]
        if len(present) != 1:
            raise ValueError(
                f"exactly one of {sorted(spellings)} must be defined"
            )
        (name,) = present
        value = _asarr(kwargs.pop(name))
        if name != primary:
            value = alternatives[name](resolved, value)
        resolved[primary] = value
    return resolved


@_register
class SHOTerm(Term):
    """Stochastically-driven damped harmonic oscillator
    (reference terms.py:604-691; branchless per jax/terms.py:481-547).

    Supports alternative parameterizations ``rho = 2 pi / w0``,
    ``tau = 2 Q / w0``, ``sigma = sqrt(S0 w0 Q)``.

    Both damping regimes have width J=2 (two real terms when overdamped,
    one complex pair when underdamped), so the celerite matrices can be
    selected elementwise with ``jnp.where`` and ``Q`` stays traceable.
    """

    _params = ("w0", "Q", "S0", "eps")

    __parameter_spec__ = (
        ("w0", {"rho": lambda p, rho: 2 * math.pi / rho}),
        ("Q", {"tau": lambda p, tau: 0.5 * p["w0"] * tau}),
        ("S0", {"sigma": lambda p, sigma: sigma**2 / (p["w0"] * p["Q"])}),
    )

    @staticmethod
    def get_test_parameters():
        return dict(sigma=1.5, tau=2.345, rho=3.4)

    def __init__(self, *, eps=1e-5, **params):
        resolved = resolve_parameter_spec(self.__parameter_spec__, params)
        if params:
            raise TypeError(
                f"unexpected SHOTerm parameters: {sorted(params)}"
            )
        for name, value in resolved.items():
            setattr(self, name, value)
        self.eps = _asarr(eps)

    # -- the two regimes, each as width-2 coefficient sets ------------
    def _overdamped(self):
        Q = self.Q
        f = jnp.sqrt(jnp.maximum(1.0 - 4.0 * Q**2, self.eps))
        amp = 0.5 * self.S0 * self.w0 * Q
        ar = amp * jnp.stack([1.0 + 1.0 / f, 1.0 - 1.0 / f])
        cr = 0.5 * self.w0 / Q * jnp.stack([1.0 - f, 1.0 + f])
        return ar, cr

    def _underdamped(self):
        Q = self.Q
        f = jnp.sqrt(jnp.maximum(4.0 * Q**2 - 1.0, self.eps))
        a = self.S0 * self.w0 * Q
        c = 0.5 * self.w0 / Q
        return (
            jnp.stack([a]),
            jnp.stack([a / f]),
            jnp.stack([c]),
            jnp.stack([c * f]),
        )

    @property
    def _is_over(self):
        return jnp.less(self.Q, 0.5)

    def get_coefficients(self):
        # The coefficient *structure* depends on the damping regime, so
        # this only works with a concrete Q (eager mode, like the
        # reference NumPy DSL terms.py:690-691).  Traced code should use
        # the branchless get_value/get_psd/get_celerite_matrices.
        if isinstance(self.Q, jax.core.Tracer):
            raise NotImplementedError(
                "SHOTerm.get_coefficients needs a concrete Q (the "
                "coefficient structure depends on the damping regime); "
                "under jit/grad/vmap use the branchless "
                "get_value/get_psd/get_celerite_matrices instead"
            )
        e = jnp.zeros((0,), dtype=jnp.result_type(self.S0))
        if float(self.Q) < 0.5:
            ar, cr = self._overdamped()
            return ar, cr, e, e, e, e
        ac, bc, cc, dc = self._underdamped()
        return e, e, ac, bc, cc, dc

    @property
    def width(self) -> int:
        return 2

    def get_value(self, tau):
        ar, cr = self._overdamped()
        ac, bc, cc, dc = self._underdamped()
        tau = jnp.abs(_atleast_1d((tau)))[..., None]
        over = jnp.sum(ar * jnp.exp(-cr * tau), axis=-1)
        arg = dc * tau
        under = jnp.sum(
            jnp.exp(-cc * tau) * (ac * jnp.cos(arg) + bc * jnp.sin(arg)),
            axis=-1,
        )
        return jnp.where(self._is_over, over, under)

    def get_psd(self, omega):
        # Closed form (same for both regimes):
        # S(w) = sqrt(2/pi) S0 w0^4 / ((w^2-w0^2)^2 + w0^2 w^2 / Q^2)
        w2 = _atleast_1d((omega)) ** 2
        w02 = self.w0**2
        return (
            jnp.sqrt(2.0 / jnp.pi)
            * self.S0
            * w02**2
            / ((w2 - w02) ** 2 + w02 * w2 / self.Q**2)
        )

    def get_celerite_matrices(self, x, diag):
        x = _atleast_1d((x))
        diag = jnp.broadcast_to(_asarr(diag), x.shape)
        e = jnp.zeros((0,), dtype=x.dtype)

        ar, cr = self._overdamped()
        c_o, a_o, U_o, V_o = _matrices_from_coefficients(
            x, diag, ar, cr, e, e, e, e
        )
        ac, bc, cc, dc = self._underdamped()
        c_u, a_u, U_u, V_u = _matrices_from_coefficients(
            x, diag, e, e, ac, bc, cc, dc
        )
        cond = self._is_over
        return (
            jnp.where(cond, c_o, c_u),
            jnp.where(cond, a_o, a_u),
            jnp.where(cond, U_o, U_u),
            jnp.where(cond, V_o, V_u),
        )


@_register
class Matern32Term(Term):
    """Approximate Matern-3/2 kernel (reference terms.py:694-745)."""

    _params = ("sigma", "rho", "eps")

    @staticmethod
    def get_test_parameters():
        return dict(sigma=1.5, rho=2.345)

    def __init__(self, *, sigma, rho, eps=0.01):
        self.sigma = _asarr(sigma)
        self.rho = _asarr(rho)
        self.eps = _asarr(eps)

    def get_coefficients(self):
        w0 = jnp.sqrt(3.0) / self.rho
        S0 = self.sigma**2 / w0
        e = jnp.zeros((0,), dtype=jnp.result_type(self.sigma))
        return (
            e,
            e,
            _atleast_1d(w0 * S0),
            _atleast_1d(w0**2 * S0 / self.eps),
            _atleast_1d(w0),
            _atleast_1d(self.eps),
        )


@_register
class RotationTerm(Term):
    """Stellar-rotation model: SHO at P plus SHO at P/2
    (reference terms.py:748-812)."""

    _params = ("sigma", "period", "Q0", "dQ", "f")

    @staticmethod
    def get_test_parameters():
        return dict(sigma=1.5, period=3.45, Q0=1.3, dQ=1.05, f=0.5)

    def __init__(self, *, sigma, period, Q0, dQ, f):
        self.sigma = _asarr(sigma)
        self.period = _asarr(period)
        self.Q0 = _asarr(Q0)
        self.dQ = _asarr(dQ)
        self.f = _asarr(f)

    def _sho_terms(self):
        amp = self.sigma**2 / (1 + self.f)

        Q1 = 0.5 + self.Q0 + self.dQ
        w1 = 4 * math.pi * Q1 / (self.period * jnp.sqrt(4 * Q1**2 - 1))
        S1 = amp / (w1 * Q1)

        Q2 = 0.5 + self.Q0
        w2 = 8 * math.pi * Q2 / (self.period * jnp.sqrt(4 * Q2**2 - 1))
        S2 = self.f * amp / (w2 * Q2)

        return SHOTerm(S0=S1, w0=w1, Q=Q1), SHOTerm(S0=S2, w0=w2, Q=Q2)

    @property
    def terms(self):
        return self._sho_terms()

    @property
    def width(self) -> int:
        return 4

    def get_coefficients(self):
        # Both modes are underdamped by construction (Q >= 1/2 + Q0 > 1/2),
        # so the coefficient view is well defined.
        t1, t2 = self._sho_terms()
        ac1, bc1, cc1, dc1 = t1._underdamped()
        ac2, bc2, cc2, dc2 = t2._underdamped()
        e = jnp.zeros((0,), dtype=jnp.result_type(self.sigma))
        return (
            e,
            e,
            jnp.concatenate([ac1, ac2]),
            jnp.concatenate([bc1, bc2]),
            jnp.concatenate([cc1, cc2]),
            jnp.concatenate([dc1, dc2]),
        )


@_register
class OriginalCeleriteTerm(Term):
    """Wrap a celerite-v1 term (reference terms.py:815-826).

    The v1 term's coefficients are extracted eagerly (v1 terms are not
    traceable), then held as pytree leaves.
    """

    _params = ("ar", "cr", "ac", "bc", "cc", "dc")

    def __init__(self, term):
        coeffs = term.get_all_coefficients()
        self.ar, self.cr, self.ac, self.bc, self.cc, self.dc = (
            _asarr(c) for c in coeffs
        )

    def get_coefficients(self):
        return (self.ar, self.cr, self.ac, self.bc, self.cc, self.dc)
