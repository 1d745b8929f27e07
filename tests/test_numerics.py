"""Numerical stress tests for the engine tier.

The assoc tier's prefix engines carry the fast path's numerics; these
tests force them on CPU (``config.engine``) and probe f32 at large N
against f64 ground truth, wide-dynamic-range time gaps, near-singular
``I + Q R`` combinations, and forward+reverse sweeps across large gaps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celerite2_tpu import terms
from celerite2_tpu.config import get_config, set_config
from celerite2_tpu.ops import assoc, scan
from celerite2_tpu.testing import get_matrices


@pytest.fixture
def force_two_level():
    prior = get_config()
    set_config(engine="two_level")
    yield
    set_config(**dataclasses.asdict(prior))


def _loglik_parts(factor_fn, solve_fn, t, c, a, U, V, y):
    d, W, _ = factor_fn(t, c, a, U, V)
    z, _ = solve_fn(t, c, U, W, y[:, None])
    return d, z[:, 0]


@pytest.mark.slow
def test_two_level_f32_large_N_vs_f64(force_two_level):
    """f32 two-level engine at N=1e5 against f64 associative_scan truth:
    the blocked composition must not lose more than ~4 digits on the
    aggregate statistics (BASELINE accuracy ladder)."""
    N = 100_000
    rng = np.random.default_rng(0)
    t64 = np.sort(rng.uniform(0, 1000, N))
    kernel = terms.SHOTerm(sigma=1.0, rho=5.0, tau=3.0)
    c, a, U, V = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(t64, np.full(N, 0.0625))
    )
    y = np.sin(0.7 * t64)

    # f64 ground truth through the same two-level engine
    args64 = tuple(
        jnp.asarray(x, jnp.float64) for x in (t64, c, a, U, V)
    )
    d64, z64 = _loglik_parts(
        assoc.factor_assoc, assoc.solve_lower_assoc, *args64,
        jnp.asarray(y, jnp.float64),
    )
    ld64 = float(jnp.sum(jnp.log(d64)))
    q64 = float(jnp.sum(z64**2 / d64))

    args32 = tuple(
        jnp.asarray(np.asarray(x), jnp.float32) for x in (t64, c, a, U, V)
    )
    d32, z32 = _loglik_parts(
        assoc.factor_assoc, assoc.solve_lower_assoc, *args32,
        jnp.asarray(y, jnp.float32),
    )
    assert bool(jnp.all(d32 > 0))
    ld32 = float(jnp.sum(jnp.log(d32.astype(jnp.float64))))
    q32 = float(jnp.sum((z32.astype(jnp.float64)) ** 2 / d32))
    assert abs(ld32 - ld64) / abs(ld64) < 1e-4
    assert abs(q32 - q64) / abs(q64) < 1e-3
    # per-row pivots: error accumulates over ~sqrt-depth composed
    # combines; ~5e-4 relative observed at N=1e5 (f32 eps 1.2e-7)
    np.testing.assert_allclose(
        np.asarray(d32), np.asarray(d64), rtol=2e-3
    )


def test_two_level_wide_dynamic_range_gaps(force_two_level):
    """Clusters separated by gaps up to ~90 time constants: the
    transport underflows gracefully and the engine matches the
    sequential scan to f64 precision."""
    rng = np.random.default_rng(3)
    clusters = []
    base = 0.0
    for k in range(6):
        clusters.append(np.sort(rng.uniform(base, base + 5.0, 40)))
        base += 5.0 + 10.0 ** (1 + k / 2)  # growing gaps: 15 .. ~320
    t = np.concatenate(clusters)
    N = len(t)
    kernel = terms.SHOTerm(sigma=1.2, rho=2.0, tau=1.5) + terms.RealTerm(
        a=0.7, c=0.3
    )
    c, a, U, V = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(t, np.full(N, 0.04))
    )
    y = rng.normal(size=N)
    args = tuple(map(jnp.asarray, (t, c, a, U, V)))

    d_ref, W_ref, _ = scan.factor_scan(*args)
    z_ref, _ = scan.solve_lower_scan(args[0], args[1], args[3], W_ref,
                                     jnp.asarray(y)[:, None])
    d2, W2, _ = assoc.factor_assoc(*args)
    z2, _ = assoc.solve_lower_assoc(args[0], args[1], args[3], W2,
                                    jnp.asarray(y)[:, None])
    np.testing.assert_allclose(d2, d_ref, rtol=1e-10)
    np.testing.assert_allclose(W2, W_ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(z2, z_ref, rtol=1e-8, atol=1e-10)
    assert np.all(np.isfinite(np.asarray(d2)))


def test_near_singular_riccati_combinations(force_two_level):
    """Nearly non-positive-definite system (tiny observational diag on
    a smooth kernel): the no-pivot _small_inv path must track the
    sequential scan; exactly-zero diag must stay finite (quiet)."""
    rng = np.random.default_rng(11)
    N = 512
    t = np.sort(rng.uniform(0, 10, N))
    kernel = terms.SHOTerm(sigma=2.0, rho=4.0, tau=8.0)

    # the conditioning of d = a - u^T S u is eps * a/d per op: at
    # diag=1e-10 that is ~2e-6, amplified a little by composition
    for diag_val, rtol in ((1e-10, 1e-6), (1e-13, None)):
        c, a, U, V = (
            np.asarray(x)
            for x in kernel.get_celerite_matrices(
                t, np.full(N, diag_val)
            )
        )
        args = tuple(map(jnp.asarray, (t, c, a, U, V)))
        d_ref, W_ref, _ = scan.factor_scan(*args)
        d2, W2, _ = assoc.factor_assoc(*args)
        if rtol is not None:
            # absolute error is bounded by ~eps * a (the cancellation
            # operand scale), NOT by eps * d
            np.testing.assert_allclose(
                d2, d_ref, rtol=rtol, atol=1e-7 * float(np.max(a))
            )
        else:
            # at the f64 cancellation edge no algorithm resolves d to
            # relative accuracy; require finite, positive, same scale
            assert np.all(np.isfinite(np.asarray(d2)))
            assert np.all(np.asarray(d2) > 0)
            np.testing.assert_allclose(
                d2, d_ref, rtol=0.5, atol=1e-6 * float(np.max(a))
            )

    # exactly zero diag: may or may not stay PD, but NEVER NaN/inf
    c, a, U, V = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(t, np.zeros(N))
    )
    d0, W0, _ = assoc.factor_assoc(*map(jnp.asarray, (t, c, a, U, V)))
    assert np.all(np.isfinite(np.asarray(d0)))
    assert np.all(np.isfinite(np.asarray(W0)))


@pytest.mark.parametrize("J_terms", [1, 2], ids=["J2", "J4"])
@pytest.mark.parametrize("engine", ["two_level", "associative_scan"])
def test_assoc_large_gaps(engine, J_terms):
    """Forward factor + reverse adjoint across large time gaps (the
    transport factors underflow to ~0 between clusters) stay equal to
    the scan oracle on both prefix engines."""
    rng = np.random.default_rng(5)
    parts = [
        np.sort(rng.uniform(0, 3, 40)),
        np.sort(rng.uniform(150, 153, 40)),
        np.sort(rng.uniform(400, 403, 48)),
    ]
    t = np.concatenate(parts)
    N = len(t)
    kernel = terms.SHOTerm(sigma=1.0, rho=1.0, tau=2.0)
    if J_terms == 2:
        kernel = kernel + terms.SHOTerm(sigma=0.5, rho=0.3, Q=0.4)
    c, a, U, V = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(t, np.full(N, 0.04))
    )
    t, c, a, U, V = map(jnp.asarray, (t, c, a, U, V))
    assert U.shape[1] == 2 * J_terms

    prior = get_config()
    try:
        set_config(engine=engine, engine_block=16)
        d_ref, W_ref, S_ref = scan.factor_scan(t, c, a, U, V)
        d2, W2, S2 = assoc.factor_assoc(t, c, a, U, V)
        np.testing.assert_allclose(d2, d_ref, rtol=1e-10)
        np.testing.assert_allclose(W2, W_ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(S2, S_ref, rtol=1e-9, atol=1e-12)

        bd = jnp.asarray(rng.normal(size=d_ref.shape))
        bW = jnp.asarray(rng.normal(size=W_ref.shape))
        ref = scan.factor_rev_scan(
            t, c, a, U, V, d_ref, W_ref, S_ref, bd, bW
        )
        out = assoc.factor_rev_assoc(t, c, a, U, V, d2, W2, S2, bd, bW)
        for r, o, name in zip(ref, out, ["bt", "bc", "ba", "bU", "bV"]):
            np.testing.assert_allclose(
                o, r, rtol=1e-7, atol=1e-9, err_msg=name
            )
    finally:
        set_config(**dataclasses.asdict(prior))


# ------------------------------------------------------ f64 island


def _stiff_problem(N=2000, dtype=np.float32):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, N)).astype(dtype)
    yerr = np.full(N, 0.05, dtype)
    y = (
        np.sin(t.astype(np.float64) * 2.0) * 0.8
        + 0.05 * rng.normal(size=N)
    ).astype(dtype)
    return t, yerr, y


def _stiff_loglik(theta, t, y, yerr):
    from celerite2_tpu.gp import gp_loglik

    k = terms.Matern32Term(
        sigma=theta[0], rho=theta[1], eps=theta[2]
    ) + terms.SHOTerm(sigma=theta[3], rho=theta[4], tau=theta[5])
    return gp_loglik(k, t, y, yerr=yerr)


def test_f64_island_fixes_stiff_gradient():
    """core_dtype="float64" recovers the forward-stable f64 scan-tier
    gradient of a stiff Matern32+SHO model from f32 inputs.  Plain f32 corrupts d(ll)/d(eps) — wrong sign, ~30x
    magnitude (measured) — which is what stalls NUTS adaptation."""
    t, yerr, y = _stiff_problem()
    th32 = jnp.asarray(
        [0.8, 0.9, 0.01, 1.0, 9.0, 20.0], jnp.float32
    )
    args32 = (th32, jnp.asarray(t), jnp.asarray(y), jnp.asarray(yerr))

    # ground truth: f64 inputs on the forward-stable scan tier
    prior = get_config()
    try:
        set_config(backend="scan")
        f64 = lambda x: jnp.asarray(np.asarray(x, np.float64))  # noqa: E731
        v_ref, g_ref = jax.jit(jax.value_and_grad(_stiff_loglik))(
            f64(th32), f64(t), f64(y), f64(yerr)
        )
    finally:
        set_config(**prior.__dict__)

    # the island from f32 inputs
    try:
        set_config(core_dtype="float64")
        v_isl, g_isl = jax.jit(jax.value_and_grad(_stiff_loglik))(
            *args32
        )
    finally:
        set_config(**prior.__dict__)
    assert v_isl.dtype == jnp.float32
    assert g_isl.dtype == jnp.float32
    np.testing.assert_allclose(
        float(v_isl), float(v_ref), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(g_isl), np.asarray(g_ref), rtol=2e-4
    )

    # discriminating power: plain f32 must be visibly wrong on the
    # eps gradient (else this test guards nothing)
    v32, g32 = jax.jit(jax.value_and_grad(_stiff_loglik))(*args32)
    assert not np.allclose(
        np.asarray(g32)[2], np.asarray(g_ref)[2], rtol=0.3
    )


def test_f64_island_gp_compute_state():
    """gp_compute under the island: the stiff factorization that goes
    non-PD in plain f32 comes back positive-definite, downcast to the
    input dtype."""
    from celerite2_tpu.gp import gp_compute

    t, yerr, y = _stiff_problem()
    kernel = terms.Matern32Term(sigma=0.8, rho=0.9, eps=0.01)
    prior = get_config()
    try:
        set_config(core_dtype="float64")
        state = gp_compute(
            kernel, jnp.asarray(t), yerr=jnp.asarray(yerr)
        )
    finally:
        set_config(**prior.__dict__)
    assert state.d.dtype == jnp.float32
    assert bool(state.ok)
    assert np.all(np.asarray(state.d) > 0)
    # restoration: config untouched after the island ran
    assert get_config().core_dtype == prior.core_dtype
    assert get_config().backend == prior.backend


def test_f64_island_vmap_grad():
    """Island composition contract: vmap(value_and_grad) works (the
    custom_vjp fwd/bwd re-enter the x64 scope on retrace).  Run inside
    an x64-OFF scope to mimic an f32 process."""
    with jax.enable_x64(False):
        t, yerr, y = _stiff_problem(N=800)
        args = (jnp.asarray(t), jnp.asarray(y), jnp.asarray(yerr))
        thetas = jnp.asarray(
            [[0.8, 0.9, 0.01, 1.0, 9.0, 20.0],
             [0.7, 1.1, 0.02, 0.9, 8.0, 15.0]],
            jnp.float32,
        )
        prior = get_config()
        try:
            set_config(core_dtype="float64")
            vg = jax.vmap(
                jax.value_and_grad(lambda th: _stiff_loglik(th, *args))
            )
            vs, gs = jax.jit(vg)(thetas)
            v0, g0 = jax.jit(
                jax.value_and_grad(lambda th: _stiff_loglik(th, *args))
            )(thetas[0])
        finally:
            set_config(**prior.__dict__)
        assert vs.dtype == jnp.float32
        np.testing.assert_allclose(float(vs[0]), float(v0), rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(gs[0]), np.asarray(g0), rtol=1e-5
        )


@pytest.mark.slow
def test_stiff_sampler_x64_scope():
    """The supported pattern for FULL sampler runs on stiff models in
    an f32 process: scope the whole call in jax.enable_x64(True)
    (the per-op island cannot survive the samplers' vmapped
    while-loops; see config.core_dtype docs)."""
    from celerite2_tpu.inference import run_nuts

    with jax.enable_x64(False):
        t, yerr, y = _stiff_problem(N=150)

        def logpost(th):
            from celerite2_tpu.gp import gp_loglik

            k = terms.Matern32Term(sigma=th[0], rho=th[1], eps=th[2])
            return gp_loglik(
                k,
                jnp.asarray(t, jnp.float64),
                jnp.asarray(y, jnp.float64),
                yerr=jnp.asarray(yerr, jnp.float64),
            ) - 0.5 * jnp.sum(th**2)

        with jax.enable_x64(True):
            res = run_nuts(
                logpost,
                jnp.asarray([0.8, 0.9, 0.05], jnp.float64),
                jax.random.PRNGKey(0),
                num_warmup=10,
                num_samples=10,
                num_chains=1,
            )
            samples = np.asarray(res.samples)
        assert samples.shape == (1, 10, 3)
        assert np.isfinite(samples).all()


def test_f64_island_batched_control_flow_raises_clearly():
    """Vmapping lax control
    flow AROUND the island is unsupported (jaxpr-level batching would
    re-bind the f64 ops under the x64-off process config and silently
    truncate them) — the island's sentinel primitive now turns that
    into an immediate, actionable error."""
    with jax.enable_x64(False):
        t, yerr, y = _stiff_problem(N=200)
        args = (jnp.asarray(t), jnp.asarray(y), jnp.asarray(yerr))
        thetas = jnp.asarray(
            [[0.8, 0.9, 0.01, 1.0, 9.0, 20.0],
             [0.7, 1.1, 0.02, 0.9, 8.0, 15.0]],
            jnp.float32,
        )

        def chain(th):
            def body(carry, _):
                v, g = jax.value_and_grad(
                    lambda x: _stiff_loglik(x, *args)
                )(carry)
                return carry + 1e-6 * g, v

            out, _ = jax.lax.scan(body, th, None, length=2)
            return out

        prior = get_config()
        try:
            set_config(core_dtype="float64")
            with pytest.raises(RuntimeError, match="enable_x64"):
                jax.vmap(chain)(thetas)
        finally:
            set_config(**prior.__dict__)

        # and the supported global-x64 scope still passes the guard
        try:
            set_config(core_dtype="float64")
            with jax.enable_x64(True):
                out = jax.vmap(chain)(thetas)
            assert np.all(np.isfinite(np.asarray(out)))
        finally:
            set_config(**prior.__dict__)
