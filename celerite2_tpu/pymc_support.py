"""PyMC (pytensor) integration layer.

The reference ships a full pytensor backend — per-op ``Op`` wrappers
over its C driver (``pymc/ops.py:38-141``), a pytensor term DSL
(``pymc/terms.py``), a GP subclass (``pymc/celerite2.py:82-155``) and a
``CeleriteNormal`` distribution (``pymc/distribution.py:32-128``) —
because its compute lives in C and every node of the model graph must
be a pytensor node.

This framework's compute lives in JAX, so the bridge here is the
opposite shape: ONE black-box likelihood ``Op`` whose ``perform`` calls
a jitted JAX function and whose ``grad`` chains into a companion VJP
``Op`` (hand-derived O(N J^2) adjoints and tier dispatch come along for
free), plus a ``jax_funcify`` registration so PyMC's JAX-based samplers
(``pymc.sampling.jax`` / numpyro / blackjax) strip the pytensor shell
entirely and run the pure-JAX graph on the accelerator with zero per-leapfrog
boundary crossings.  Kernels are built with this package's own term
DSL inside the wrapped function; no pytensor term re-implementation is
needed (and none would be traceable by XLA anyway).

Like :mod:`celerite2_tpu.distributions` (the numpyro adapter), the
behavior lives in a pytensor-independent core (:class:`LoglikCore`,
:func:`perform_value`, :func:`perform_grad`) so the full contract is
tested even when pymc/pytensor are absent from the environment; the
gated shell is thin.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "HAS_PYTENSOR",
    "LoglikCore",
    "MarginalCore",
    "ConditionalMomentsCore",
    "celerite_loglik_op",
    "marginal",
    "marginal_potential",
    "conditional",
]


class LoglikCore:
    """pytensor-independent engine of the black-box likelihood Op.

    Wraps ``fn(*params) -> scalar`` (typically a closure over
    :func:`celerite2_tpu.gp.gp_loglik` with fixed data) with cached
    jitted value and VJP callables operating on host numpy arrays, the
    contract a pytensor ``Op.perform`` needs.  Non-PD kernels follow
    the library's quiet semantics (branchless ``-inf``), which
    ``pm.Potential`` / ``check_parameters`` turn into a rejected step —
    the role of the reference's ``factor_quiet`` + ``pt.switch``
    (``pymc/celerite2.py:38-52``).
    """

    def __init__(self, fn):
        self.fn = fn
        self._value = jax.jit(fn)
        # VJP with a cotangent argument (not plain grad): pytensor's
        # L_op supplies the output gradient, and chaining through it
        # keeps second-order graphs honest.
        self._vjp = jax.jit(partial(self._vjp_impl, fn))

    @staticmethod
    def _vjp_impl(fn, ct, *params):
        out, pull = jax.vjp(fn, *params)
        del out
        return pull(ct)

    def value(self, *params):
        return np.asarray(self._value(*params))

    def grad(self, ct, *params):
        return tuple(np.asarray(g) for g in self._vjp(ct, *params))


def perform_value(core, inputs, output_storage):
    """``Op.perform`` body for the value Op (pure function so the
    plumbing is testable without pytensor): writes the scalar loglik
    into ``output_storage[0][0]`` preserving the input float dtype."""
    out = core.value(*inputs)
    dt = np.result_type(*[np.asarray(i).dtype for i in inputs])
    output_storage[0][0] = np.asarray(out, dtype=dt)


def perform_grad(core, inputs, output_storage):
    """``Op.perform`` body for the VJP Op: ``inputs`` is
    ``(ct, *params)``; writes one cotangent per parameter."""
    ct, *params = inputs
    grads = core.grad(np.asarray(ct), *params)
    for slot, p, g in zip(output_storage, params, grads):
        slot[0] = np.asarray(g, dtype=np.asarray(p).dtype)


def make_gp_loglik_fn(make_kernel, t, y, *, yerr=None, diag=None, mean=0.0):
    """Close :func:`~celerite2_tpu.gp.gp_loglik` over fixed data:
    returns ``fn(*params) -> scalar`` with the kernel built by
    ``make_kernel(*params)`` (this package's term DSL; branchless, so
    any parameter may be sampled).

    Data is captured as NUMPY so the jitted closures embed it as HLO
    literals rather than captured device buffers.
    """
    from celerite2_tpu.gp import gp_loglik

    t = np.asarray(t)
    y = np.asarray(y)
    yerr = None if yerr is None else np.asarray(yerr)
    diag = None if diag is None else np.asarray(diag)

    def fn(*params):
        params = tuple(jnp.asarray(p) for p in params)
        return gp_loglik(
            make_kernel(*params), t, y, yerr=yerr, diag=diag, mean=mean
        )

    return fn


class MarginalCore:
    """pytensor-independent engine of the marginal GP distribution.

    Pairs the log-density ``logp(value, *params)`` (a :class:`LoglikCore`
    with the observed vector as the FIRST argument — the
    ``pm.CustomDist`` logp contract) with a prior sampler
    ``prior_draws(rng, size, *params)`` computing
    ``m + L sqrt(d) z`` through the O(N J^2) semiseparable factor on
    device (role of the reference's ``CeleriteNormalRV.rng_fn``,
    pymc/distribution.py:46-93, which loops ``driver.matmul_lower`` on
    the CPU).  Together they make the marginal a full random variable:
    ``pm.sample_prior_predictive`` / posterior predictive work.
    """

    def __init__(self, make_kernel, t, *, yerr=None, diag=None, mean=0.0):
        from celerite2_tpu.gp import gp_compute, gp_dot_tril, gp_loglik

        t = np.asarray(t)
        yerr = None if yerr is None else np.asarray(yerr)
        diag = None if diag is None else np.asarray(diag)
        self.n = t.shape[0]

        def logp_fn(value, *params):
            value = jnp.asarray(value)
            params = tuple(jnp.asarray(p) for p in params)
            return gp_loglik(
                make_kernel(*params), t, value, yerr=yerr, diag=diag,
                mean=mean,
            )

        self.logp = LoglikCore(logp_fn)

        def draw_fn(z, *params):
            # z: (K, N) standard normals -> (K, N) prior draws
            params = tuple(jnp.asarray(p) for p in params)
            state = gp_compute(
                make_kernel(*params), t, yerr=yerr, diag=diag, mean=mean
            )
            return gp_dot_tril(state, z.T).T + state.mean_value

        self._draw = jax.jit(draw_fn)

    def prior_draws(self, rng, size, *params):
        shape = () if size is None else tuple(np.atleast_1d(size))
        k = int(np.prod(shape, dtype=int)) if shape else 1
        z = rng.standard_normal((k, self.n))
        out = np.asarray(self._draw(z, *params))
        return out.reshape(shape + (self.n,)) if shape else out[0]


class ConditionalMomentsCore:
    """pytensor-independent (mu, cov) of the conditional distribution.

    ``values(*params) -> (mu (M,), cov (M, M))`` and the matching VJP,
    built on :class:`~celerite2_tpu.gp.ConditionalDistribution` (the
    O(N + M) mean path + dense covariance, exactly the quantities the
    reference's ``conditional()`` model helper feeds ``pm.MvNormal``,
    pymc/celerite2.py:108-155).  ``component`` is an optional callable
    ``(*params) -> Term`` selecting a sub-kernel (the reference's
    ``kernel=`` argument).
    """

    def __init__(self, make_kernel, t, y, *, t_new=None, yerr=None,
                 diag=None, mean=0.0, include_mean=True, component=None):
        from celerite2_tpu.gp import GaussianProcess

        t = np.asarray(t)
        if np.any(t[1:] < t[:-1]):
            raise ValueError("The input coordinates must be sorted")
        y = np.asarray(y)
        yerr = None if yerr is None else np.asarray(yerr)
        diag = None if diag is None else np.asarray(diag)
        t_new = None if t_new is None else np.asarray(t_new)
        self.m = t.shape[0] if t_new is None else t_new.shape[0]

        def fn(*params):
            params = tuple(jnp.asarray(p) for p in params)
            kernel = make_kernel(*params)
            # t validated above on the host; the shell's own check
            # cannot run under jit (traced bool)
            gp = GaussianProcess(
                kernel, t=t, yerr=yerr, diag=diag, mean=mean,
                check_sorted=False, quiet=True,
            )
            cond = gp.condition(
                y, t=t_new, include_mean=include_mean,
                kernel=None if component is None else component(*params),
            )
            return cond.mean, cond.covariance

        self.fn = fn
        self._value = jax.jit(fn)
        self._vjp = jax.jit(partial(self._vjp_impl, fn))

    @staticmethod
    def _vjp_impl(fn, cts, *params):
        out, pull = jax.vjp(fn, *params)
        del out
        return pull(cts)

    def values(self, *params):
        mu, cov = self._value(*params)
        return np.asarray(mu), np.asarray(cov)

    def vjp(self, gmu, gcov, *params):
        grads = self._vjp((jnp.asarray(gmu), jnp.asarray(gcov)), *params)
        return tuple(np.asarray(g) for g in grads)


def perform_moments(core, inputs, output_storage):
    """``Op.perform`` body for the conditional-moments Op."""
    mu, cov = core.values(*inputs)
    dt = np.result_type(*[np.asarray(i).dtype for i in inputs])
    output_storage[0][0] = np.asarray(mu, dtype=dt)
    output_storage[1][0] = np.asarray(cov, dtype=dt)


def perform_moments_grad(core, inputs, output_storage):
    """``Op.perform`` body for the moments VJP Op: inputs are
    ``(gmu, gcov, *params)``."""
    gmu, gcov, *params = inputs
    grads = core.vjp(gmu, gcov, *params)
    for slot, p, g in zip(output_storage, params, grads):
        slot[0] = np.asarray(g, dtype=np.asarray(p).dtype)


try:  # pragma: no cover - pytensor is optional and absent in this image
    import pytensor.tensor as pt
    from pytensor.graph import basic
    from pytensor.graph import op as pt_op
    from pytensor.link.jax.dispatch import jax_funcify

    HAS_PYTENSOR = True

    # NOTE: no __props__ on either Op: props-based equality would make
    # ops wrapping DIFFERENT cores/data compare equal and let
    # pytensor's merge rewrite collapse distinct likelihoods; the
    # default identity equality is the correct semantics here.
    class _CeleriteLoglikGradOp(pt_op.Op):
        def __init__(self, core):
            self.core = core
            super().__init__()

        def make_node(self, ct, *params):
            ct = pt.as_tensor_variable(ct)
            params = [pt.as_tensor_variable(p) for p in params]
            return basic.Apply(self, [ct, *params], [p.type() for p in params])

        def infer_shape(self, fgraph, node, shapes):
            return shapes[1:]

        def perform(self, node, inputs, output_storage):
            perform_grad(self.core, inputs, output_storage)

    class CeleriteLoglikOp(pt_op.Op):
        """Scalar GP log-likelihood as a pytensor Op (role of the whole
        reference ``pymc/ops.py`` op family, collapsed to one node)."""

        def __init__(self, core):
            self.core = core
            self._grad_op = _CeleriteLoglikGradOp(core)
            super().__init__()

        def make_node(self, *params):
            params = [pt.as_tensor_variable(p) for p in params]
            out = pt.TensorType(params[0].dtype, ())()
            return basic.Apply(self, params, [out])

        def infer_shape(self, fgraph, node, shapes):
            return [()]

        def perform(self, node, inputs, output_storage):
            perform_value(self.core, inputs, output_storage)

        def grad(self, inputs, output_grads):
            # return_list: with ONE parameter __call__ would hand back
            # a bare Variable, and list() would symbolically iterate it
            return self._grad_op(
                output_grads[0], *inputs, return_list=True
            )

    class _CeleriteMomentsGradOp(pt_op.Op):
        def __init__(self, core):
            self.core = core
            super().__init__()

        def make_node(self, gmu, gcov, *params):
            gmu = pt.as_tensor_variable(gmu)
            gcov = pt.as_tensor_variable(gcov)
            params = [pt.as_tensor_variable(p) for p in params]
            return basic.Apply(
                self, [gmu, gcov, *params], [p.type() for p in params]
            )

        def infer_shape(self, fgraph, node, shapes):
            return shapes[2:]

        def perform(self, node, inputs, output_storage):
            perform_moments_grad(self.core, inputs, output_storage)

    class CeleriteConditionalMomentsOp(pt_op.Op):
        """(mu, cov) of the conditional GP as one differentiable
        pytensor node (role of the symbolic mean/covariance graphs the
        reference builds op-by-op for ``conditional()``,
        pymc/celerite2.py:108-155)."""

        def __init__(self, core):
            self.core = core
            self._grad_op = _CeleriteMomentsGradOp(core)
            super().__init__()

        def make_node(self, *params):
            params = [pt.as_tensor_variable(p) for p in params]
            dtype = params[0].dtype if params else "float64"
            m = self.core.m
            mu = pt.TensorType(dtype, shape=(m,))()
            cov = pt.TensorType(dtype, shape=(m, m))()
            return basic.Apply(self, params, [mu, cov])

        def infer_shape(self, fgraph, node, shapes):
            m = self.core.m
            return [(m,), (m, m)]

        def perform(self, node, inputs, output_storage):
            perform_moments(self.core, inputs, output_storage)

        def L_op(self, inputs, outputs, output_grads):
            from pytensor.gradient import DisconnectedType

            gmu, gcov = output_grads
            dtype = outputs[0].dtype
            m = self.core.m
            if isinstance(gmu.type, DisconnectedType):
                gmu = pt.zeros((m,), dtype=dtype)
            if isinstance(gcov.type, DisconnectedType):
                gcov = pt.zeros((m, m), dtype=dtype)
            return self._grad_op(gmu, gcov, *inputs, return_list=True)

    @jax_funcify.register(CeleriteConditionalMomentsOp)
    def _jax_funcify_moments(op, **kwargs):
        return op.core.fn

    @jax_funcify.register(_CeleriteMomentsGradOp)
    def _jax_funcify_moments_grad(op, node=None, **kwargs):
        def vjp(gmu, gcov, *params):
            out = ConditionalMomentsCore._vjp_impl(
                op.core.fn, (gmu, gcov), *params
            )
            if node is not None and len(node.outputs) == 1:
                return out[0]
            return out

        return vjp

    @jax_funcify.register(CeleriteLoglikOp)
    def _jax_funcify_loglik(op, **kwargs):
        # PyMC's JAX samplers get the raw traced function: the model
        # compiles to one XLA program, pytensor is gone.
        return op.core.fn

    @jax_funcify.register(_CeleriteLoglikGradOp)
    def _jax_funcify_loglik_grad(op, node=None, **kwargs):
        vjp = partial(LoglikCore._vjp_impl, op.core.fn)
        if node is not None and len(node.outputs) == 1:
            # single-output nodes must return the array, not a 1-tuple
            def vjp_single(ct, *params):
                return vjp(ct, *params)[0]

            return vjp_single
        return vjp

except ImportError:  # pytensor/pymc not installed

    HAS_PYTENSOR = False

    class CeleriteLoglikOp:  # type: ignore[no-redef]
        """Fallback when pytensor is absent: keeps the core reachable
        (``.core``) so tests exercise the full perform/VJP contract,
        but symbolic use needs the real dependency."""

        def __init__(self, core):
            self.core = core

        def __call__(self, *params):
            raise ImportError(
                "pymc/pytensor is not installed; use the built-in "
                "inference engine (celerite2_tpu.inference), or install "
                "pymc to use this Op in a model"
            )

    class CeleriteConditionalMomentsOp:  # type: ignore[no-redef]
        """Fallback when pytensor is absent (same contract as the
        loglik shell: core reachable, symbolic use gated)."""

        def __init__(self, core):
            self.core = core

        def __call__(self, *params):
            raise ImportError(
                "pymc/pytensor is not installed; use "
                "GaussianProcess.condition / the built-in inference "
                "engine, or install pymc to use this Op in a model"
            )


def celerite_loglik_op(make_kernel, t, y, *, yerr=None, diag=None, mean=0.0):
    """Build the marginal-likelihood Op for a PyMC model.

    Example::

        op = celerite_loglik_op(
            lambda s, r, tau: terms.SHOTerm(sigma=s, rho=r, tau=tau),
            t, y, yerr=yerr)
        with pm.Model():
            s = pm.HalfNormal("sigma", 1.0)
            ...
            pm.Potential("gp", op(s, r, tau))

    Works under both pytensor's C/perform path (jitted JAX called per
    leapfrog) and its JAX linker (fused into the sampler's XLA
    program).
    """
    return CeleriteLoglikOp(
        LoglikCore(make_gp_loglik_fn(make_kernel, t, y, yerr=yerr, diag=diag, mean=mean))
    )


def _register_citations(model=None):
    import pymc as pm

    from celerite2_tpu.citation import CITATIONS

    model = pm.modelcontext(model)
    if not hasattr(model, "__citations__"):
        model.__citations__ = dict()
    model.__citations__["celerite2_tpu"] = CITATIONS
    return model


def _vector_signature(params, support="(n)"):
    """gufunc-style CustomDist signature from the params' ndims,
    e.g. two scalars -> ``"(),()->(n)"``."""
    dims = []
    for i, p in enumerate(params):
        nd = getattr(p, "ndim", np.asarray(p).ndim)
        dims.append("(" + ",".join(f"p{i}d{j}" for j in range(nd)) + ")")
    return ",".join(dims) + "->" + support


def marginal_potential(name, make_kernel, params, t, y, *, yerr=None,
                       diag=None, mean=0.0, model=None):
    """Attach the GP marginal likelihood to the current PyMC model as a
    ``Potential`` — the minimal black-box form (observed data baked
    into the Op).  Prefer :func:`marginal`, which is a full random
    variable (prior/posterior predictive sampling work).
    """
    import pymc as pm

    model = _register_citations(model)
    op = celerite_loglik_op(make_kernel, t, y, yerr=yerr, diag=diag, mean=mean)
    return pm.Potential(name, op(*params), model=model)


def marginal(name, make_kernel, params, t, *, observed=None, yerr=None,
             diag=None, mean=0.0, model=None, **kwargs):
    """The GP marginal as a proper PyMC random variable (role of
    reference ``GaussianProcess.marginal`` + ``CeleriteNormal``,
    ``pymc/celerite2.py:82-106`` and ``pymc/distribution.py:96-128``).

    Built as one ``pm.CustomDist`` whose ``logp`` is the black-box JAX
    likelihood Op (hand adjoints + tier dispatch under both the
    perform path and the JAX linker) and whose ``random`` draws
    ``m + L sqrt(d) z`` through the on-device semiseparable factor —
    so ``pm.sample_prior_predictive`` and
    ``pm.sample_posterior_predictive`` work, unlike a ``Potential``.

    Example::

        with pm.Model():
            sigma = pm.HalfNormal("sigma", 1.0)
            rho = pm.HalfNormal("rho", 5.0)
            marginal("obs", lambda s, r: terms.SHOTerm(sigma=s, rho=r,
                     tau=r), (sigma, rho), t, yerr=yerr, observed=y)
    """
    import pymc as pm

    _register_citations(model)
    core = MarginalCore(make_kernel, t, yerr=yerr, diag=diag, mean=mean)
    op = CeleriteLoglikOp(core.logp)

    def logp(value, *ps):
        return op(value, *ps)

    def random(*args, rng=None, size=None):
        return core.prior_draws(rng, size, *args)

    params = tuple(params)
    return pm.CustomDist(
        name,
        *params,
        logp=logp,
        random=random,
        signature=_vector_signature(params),
        observed=observed,
        **kwargs,
    )


def conditional(name, make_kernel, params, t, y, *, t_new=None, yerr=None,
                diag=None, mean=0.0, include_mean=True, component=None,
                model=None, **kwargs):
    """Add the conditional (predictive) density to a PyMC model as a
    ``pm.MvNormal`` over the target points (role of reference
    ``GaussianProcess.conditional``, ``pymc/celerite2.py:108-155``).

    ``(mu, cov)`` come from one differentiable conditional-moments Op
    (O(N + M) mean through the semiseparable solves; dense covariance
    like the reference).  ``component`` is an optional callable
    ``(*params) -> Term`` computing a sub-kernel for component
    conditionals (the reference's ``kernel=``).  As in the reference,
    prefer ``Deterministic`` tracking of ``GaussianProcess.predict``
    when you only need the predictive mean — MvNormal adds M sampled
    dimensions to the posterior.
    """
    import pymc as pm

    _register_citations(model)
    core = ConditionalMomentsCore(
        make_kernel, t, y, t_new=t_new, yerr=yerr, diag=diag, mean=mean,
        include_mean=include_mean, component=component,
    )
    op = CeleriteConditionalMomentsOp(core)
    mu, cov = op(*params)
    shape = kwargs.pop("shape", core.m)
    return pm.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)
