"""Multi-device parity on the 8-virtual-CPU mesh.

Tier (a)+(b) from SURVEY.md section 4.3: sharded-vs-unsharded
consistency of the blocked/sharded scan, and chain-sharded NUTS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from celerite2_tpu import terms
from celerite2_tpu.gp import gp_compute, gp_log_likelihood
from celerite2_tpu.parallel import (
    P,
    chain_sharding,
    make_mesh,
    make_sharded_logdensity,
)

# the multichip gate suite: run explicitly per commit (verify skill);
# excluded from the fast tier by wall clock (~9 min of shard_map compiles)
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "tests need 8 virtual devices"
    return make_mesh(chains=2, seq=4)


@pytest.fixture(scope="module")
def mesh_seq():
    return make_mesh(chains=1, seq=8)


def _data(n=256):
    rng = np.random.default_rng(99)
    t = np.sort(rng.uniform(0, 20, n))
    yerr = rng.uniform(0.1, 0.3, n)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    import celerite2_tpu as c2

    gp = c2.GaussianProcess(kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(5)))
    return t, yerr, y


def test_sharded_loglik_matches_unsharded(mesh_seq):
    t, yerr, y = _data(256)

    def builder(theta):
        return terms.SHOTerm(
            sigma=theta[0], rho=theta[1], tau=theta[2]
        )

    logd = make_sharded_logdensity(builder, t, y, yerr, mesh_seq)
    theta = jnp.asarray([1.2, 4.0, 3.0])
    ll_sharded = jax.jit(logd)(theta)

    state = gp_compute(builder(theta), t, yerr=yerr)
    ll_ref = gp_log_likelihood(state, y)
    np.testing.assert_allclose(ll_sharded, ll_ref, rtol=1e-9)


def test_sharded_loglik_grad(mesh_seq):
    t, yerr, y = _data(128)

    def builder(theta):
        return terms.SHOTerm(sigma=theta[0], rho=theta[1], tau=theta[2])

    logd = make_sharded_logdensity(builder, t, y, yerr, mesh_seq)
    theta = jnp.asarray([1.2, 4.0, 3.0])
    g_sharded = jax.jit(jax.grad(logd))(theta)

    def ref(theta):
        state = gp_compute(builder(theta), t, yerr=yerr)
        return gp_log_likelihood(state, y)

    g_ref = jax.grad(ref)(theta)
    np.testing.assert_allclose(g_sharded, g_ref, rtol=1e-7, atol=1e-9)


def test_sharded_loglik_grad_check_vma_false_raises(mesh_seq):
    """shard_map(check_vma=False) disables vma tracking; the adjoint's
    cotangent reductions then cannot be placed (measured: components
    come out scaled by 1/n_dev) — the bwd must fail loudly rather than
    return silently wrong gradients (round-3 review regression).  The
    forward VALUE must still work."""
    from celerite2_tpu.parallel import sharded

    t, yerr, y = _data(128)

    def builder(theta):
        return terms.SHOTerm(sigma=theta[0], rho=theta[1], tau=theta[2])

    mesh = mesh_seq
    tn, yn, en = map(np.asarray, (t, y, yerr))

    def logd(theta):
        kernel = builder(theta)
        c, a, U, V = kernel.get_celerite_matrices(tn, en**2)
        fn = jax.shard_map(
            lambda tt, aa, UU, VV, rr, cc: sharded.sharded_loglik(
                tt, cc, aa, UU, VV, rr, axis_name="seq"
            ),
            mesh=mesh,
            in_specs=(P("seq"),) * 5 + (P(),),
            out_specs=P(),
            check_vma=False,
        )
        return fn(tn, a, U, V, yn, c)

    theta = jnp.asarray([1.2, 4.0, 3.0])
    val = jax.jit(logd)(theta)
    state = gp_compute(builder(theta), t, yerr=yerr)
    np.testing.assert_allclose(
        float(val), float(gp_log_likelihood(state, y)), rtol=1e-9
    )
    with pytest.raises(NotImplementedError, match="check_vma"):
        jax.grad(logd)(theta)


def test_sharded_nonpd_minus_inf(mesh_seq):
    t, yerr, y = _data(128)

    def builder(theta):
        return terms.RealTerm(a=theta[0], c=theta[1])

    logd = make_sharded_logdensity(builder, t, 0.0 * np.asarray(y), 0.0 * yerr, mesh_seq)
    val = jax.jit(logd)(jnp.asarray([-5.0, 0.5]))
    assert np.isneginf(float(val))


def test_chain_sharded_nuts(mesh8):
    """Chains sharded over the mesh: same program, 8 chains on 8 devs."""
    from celerite2_tpu.inference import run_nuts, split_rhat

    dim = 3
    prec = jnp.asarray(np.diag([1.0, 2.0, 0.5]))
    mu = jnp.asarray([1.0, -1.0, 0.0])

    def logp(q):
        r = q - mu
        return -0.5 * r @ prec @ r

    sharding = NamedSharding(mesh8, P(("chains", "seq")))
    res = run_nuts(
        logp,
        jnp.zeros(dim),
        jax.random.PRNGKey(0),
        num_warmup=300,
        num_samples=300,
        num_chains=8,
        chain_axis=sharding,
    )
    assert res.samples.shape == (8, 300, 3)
    assert np.all(np.asarray(split_rhat(res.samples)) < 1.1)
    m = np.asarray(res.samples).reshape(-1, 3).mean(axis=0)
    np.testing.assert_allclose(m, np.asarray(mu), atol=0.3)


def test_particle_sharded_smc(mesh8):
    """SMC with the particle cloud sharded over all 8 devices: the
    systematic-resampling gather, ESS/evidence reductions, and cloud-
    spread preconditioning all cross device boundaries (XLA SPMD turns
    them into all_gather/psum).  Must match the unsharded run."""
    from celerite2_tpu.inference import run_smc

    mu = jnp.asarray([0.5, -0.25])

    def log_prior(q):
        return -0.5 * jnp.sum(q**2) / 9.0

    def log_like(q):
        r = q - mu
        return -0.5 * jnp.sum(r**2) / 0.25

    def sample_prior(key, n):
        return 3.0 * jax.random.normal(key, (n, 2), jnp.float64)

    kwargs = dict(
        num_particles=512, mutation_steps=8, mutation_eps=0.4
    )
    res_ref = run_smc(
        log_prior, log_like, sample_prior, jax.random.PRNGKey(3),
        **kwargs,
    )
    sharding = NamedSharding(mesh8, P(("chains", "seq")))
    res_sh = run_smc(
        log_prior, log_like, sample_prior, jax.random.PRNGKey(3),
        particle_axis=sharding, **kwargs,
    )
    # the sharded run must still be laid out across devices at the end
    assert len(res_sh.particles.sharding.device_set) == 8
    assert float(res_sh.final_beta) == 1.0
    # identical ladder + identical draws: reductions may reassociate,
    # so allow roundoff-level drift only
    assert int(res_sh.n_stages) == int(res_ref.n_stages)
    np.testing.assert_allclose(
        float(res_sh.log_evidence), float(res_ref.log_evidence),
        rtol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.particles), np.asarray(res_ref.particles),
        rtol=1e-6, atol=1e-9,
    )


def test_two_level_engine_inside_shard_map():
    """engine="two_level" runs two_level_prefix INSIDE shard_map;
    exercise that combination explicitly on the CPU mesh (the default
    engine is lax.associative_scan)."""
    import jax
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from celerite2_tpu.ops.assoc import (
        _id_affine,
        _mat_affine_combine,
        two_level_prefix,
    )

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("seq",))
    rng = np.random.default_rng(0)
    N = 64
    A = jnp.asarray(np.eye(2) + 0.1 * rng.normal(size=(N, 2, 2)))
    b = jnp.asarray(rng.normal(size=(N, 2, 1)))

    def local_prefix_last(A_l, b_l):
        # per-shard inclusive prefix via the blocked engine, then
        # return each shard's composed block map
        Ap, bp = two_level_prefix(
            _mat_affine_combine, (A_l, b_l), _id_affine, block=8
        )
        return Ap[-1:], bp[-1:]

    fn = jax.jit(
        jax.shard_map(
            local_prefix_last,
            mesh=mesh,
            in_specs=(P("seq"), P("seq")),
            out_specs=(P("seq"), P("seq")),
        )
    )
    Ab, bb = fn(A, b)

    B = N // 4
    # shard k's block map composes rows [kB, (k+1)B): compute directly
    for k in range(4):
        Aref, bref = lax.associative_scan(
            _mat_affine_combine,
            (A[k * B:(k + 1) * B], b[k * B:(k + 1) * B]),
        )
        np.testing.assert_allclose(Ab[k], Aref[-1], rtol=1e-10)
        np.testing.assert_allclose(bb[k], bref[-1], rtol=1e-10)


def test_sharded_ops_match_unsharded(mesh_seq):
    """sharded factor/solves/matmuls/dot_tril/predict-mean vs the
    single-device ops on the same data."""
    from celerite2_tpu import ops
    from celerite2_tpu.parallel import sharded as sh

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    tj, yj = jnp.asarray(t), jnp.asarray(y)

    d_ref, W_ref = ops.factor(tj, c, a, U, V)
    z_lo_ref = ops.solve_lower(tj, c, U, W_ref, yj[:, None])[:, 0]
    z_up_ref = ops.solve_upper(tj, c, U, W_ref, yj[:, None])[:, 0]
    ml_ref = ops.matmul_lower(tj, c, U, V, yj[:, None])[:, 0]
    mu_ref = ops.matmul_upper(tj, c, U, V, yj[:, None])[:, 0]

    def body(tl, cl, al, Ul, Vl, yl):
        d, W, ok = sh.sharded_factor(tl, cl, al, Ul, Vl)
        zlo = sh.sharded_solve_lower(tl, cl, Ul, W, yl)
        zup = sh.sharded_solve_upper(tl, cl, Ul, W, yl)
        ml = sh.sharded_matmul_lower(tl, cl, Ul, Vl, yl)
        mu = sh.sharded_matmul_upper(tl, cl, Ul, Vl, yl)
        dt = sh.sharded_dot_tril(tl, cl, Ul, W, d, yl)
        return d, W, zlo, zup, ml, mu, dt

    seq = P("seq")
    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, seq),
            out_specs=(seq, seq, seq, seq, seq, seq, seq),
        )
    )
    d, W, zlo, zup, ml, mu, dt = fn(tj, c, a, U, V, yj)

    np.testing.assert_allclose(d, d_ref, rtol=1e-9)
    np.testing.assert_allclose(W, W_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(zlo, z_lo_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(zup, z_up_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(ml, ml_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-8, atol=1e-10)

    dt_ref = np.sqrt(np.asarray(d_ref)) * y + np.asarray(ml_ref * 0)
    # dot_tril reference via the unsharded helper
    from celerite2_tpu.gp import GPState, gp_dot_tril

    z0 = jnp.sqrt(d_ref) * yj
    dt_ref = z0 + ops.matmul_lower(tj, c, U, W_ref, z0[:, None])[:, 0]
    np.testing.assert_allclose(dt, dt_ref, rtol=1e-8, atol=1e-10)


def test_sharded_predict_mean_matches(mesh_seq):
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import sharded as sh

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    mu_ref = np.asarray(gp.predict(y))

    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    seq = P("seq")
    fn = jax.jit(
        jax.shard_map(
            lambda tl, cl, al, Ul, Vl, dl, rl: sh.sharded_predict_mean(
                tl, cl, al, Ul, Vl, dl, rl
            ),
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, seq, seq),
            out_specs=seq,
        )
    )
    mu = fn(
        jnp.asarray(t), c, a, U, V, jnp.asarray(yerr**2), jnp.asarray(y)
    )
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-8, atol=1e-9)


def test_sharded_loglik_time_gradient(mesh_seq):
    """The hand-derived sharded adjoint must include the t gradients
    (the easy-to-forget bt terms) — parity vs the unsharded fused op."""
    from celerite2_tpu.gp import gp_loglik
    from celerite2_tpu.parallel.sharded import sharded_loglik

    t, yerr, y = _data(64)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )

    seq = P("seq")

    def sharded_ll(tj):
        fn = jax.shard_map(
            lambda tl, cl, al, Ul, Vl, rl: sharded_loglik(
                tl, cl, al, Ul, Vl, rl
            ),
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, seq),
            out_specs=P(),
        )
        return fn(tj, c, a, U, V, jnp.asarray(y))

    def unsharded_ll(tj):
        from celerite2_tpu import ops

        d, W, z = ops.factor_solve(tj, c, a, U, V, jnp.asarray(y)[:, None])
        import math

        safe = jnp.where(d > 0, d, 1.0)
        return -0.5 * (
            jnp.sum(jnp.log(safe))
            + jnp.sum(z[:, 0] ** 2 / safe)
            + t.shape[0] * math.log(2 * math.pi)
        )

    tj = jnp.asarray(t)
    g_sh = jax.jit(jax.grad(sharded_ll))(tj)
    g_ref = jax.jit(jax.grad(unsharded_ll))(tj)
    np.testing.assert_allclose(g_sh, g_ref, rtol=1e-6, atol=1e-9)


def test_combined_mesh_loglik_grad(mesh8):
    """value_and_grad(sharded_loglik) under vmap(chains) inside a
    (chains=2, seq=4) shard_map — the configuration that regressed in
    round 2 (MULTICHIP_r02): theta-derived c/a/U/V vary over the
    ``chains`` mesh axis while t/resid vary only over ``seq``, so the
    custom-VJP cotangents must be reduced/promoted onto each primal's
    own varying axes.  Checks gradient VALUES against the unsharded
    path, not just that it compiles."""
    t, yerr, y = _data(64)
    tj, yj = jnp.asarray(t), jnp.asarray(y)
    yerrj = jnp.asarray(yerr)

    def builder(theta):
        return terms.SHOTerm(
            sigma=theta[0], rho=theta[1], tau=theta[2]
        )

    from celerite2_tpu.parallel.sharded import sharded_loglik

    def body(thetas, tl, yl, yerrl):
        def one_chain(theta):
            def ll(th):
                kernel = builder(th)
                c, a, U, V = kernel.get_celerite_matrices(
                    tl, yerrl**2
                )
                return sharded_loglik(
                    tl, c, a, U, V, yl, axis_name="seq"
                )

            return jax.value_and_grad(ll)(theta)

        return jax.vmap(one_chain)(thetas)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh8,
            in_specs=(P("chains", None), P("seq"), P("seq"), P("seq")),
            out_specs=(P("chains"), P("chains", None)),
        )
    )
    thetas = jnp.asarray(
        [[1.2, 4.0, 3.0], [0.8, 5.0, 2.0], [1.5, 3.0, 4.0],
         [1.0, 4.5, 2.5]]
    )
    vals, grads = fn(thetas, tj, yj, yerrj)

    def ref(theta):
        state = gp_compute(builder(theta), t, yerr=yerr)
        return gp_log_likelihood(state, y)

    for k in range(4):
        v_ref, g_ref = jax.value_and_grad(ref)(thetas[k])
        np.testing.assert_allclose(vals[k], v_ref, rtol=1e-8)
        np.testing.assert_allclose(
            grads[k], g_ref, rtol=1e-6, atol=1e-9
        )


def test_hmc_train_step_combined_mesh(mesh8):
    """make_hmc_train_step — the exact dryrun_multichip code path —
    runs on the combined (chains x seq) mesh and produces finite,
    moving states."""
    from celerite2_tpu.parallel.train_step import make_hmc_train_step

    t, yerr, y = _data(64)

    def builder(theta):
        return terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )

    step_fn, init_fn = make_hmc_train_step(
        builder, t, y, yerr, mesh8, step_size=0.01, num_leapfrog=2
    )
    qs, keys = init_fn(4, 3, jax.random.PRNGKey(0))
    qs2, accept = step_fn(qs, keys)
    assert qs2.shape == (4, 3)
    assert np.all(np.isfinite(np.asarray(qs2)))
    assert accept.shape == (4,)


def test_sharded_conditional_variance_matches(mesh_seq):
    """Sharded predictive variance (matrix-RHS solves + psum
    contraction) vs the single-device ConditionalDistribution."""
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import sharded as sh

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    t_new = np.linspace(2, 18, 24)

    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    var_ref = np.asarray(gp.condition(y, t=t_new).variance)

    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    KxsT = jnp.asarray(
        np.asarray(kernel.get_value(t[:, None] - t_new[None, :]))
    )
    k0 = jnp.asarray(float(np.asarray(kernel.get_value(np.zeros(1)))[0]))

    seq = P("seq")
    fn = jax.jit(
        jax.shard_map(
            lambda tl, cl, al, Ul, Vl, Kl, k0l: sh.sharded_conditional_variance(
                tl, cl, al, Ul, Vl, Kl, k0l
            ),
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, P("seq", None), P()),
            out_specs=P(),
        )
    )
    var = fn(jnp.asarray(t), c, a, U, V, KxsT, k0)
    np.testing.assert_allclose(var, var_ref, rtol=1e-7, atol=1e-9)


def test_sharded_predict_mean_at_new_points(mesh_seq):
    """Conditional mean at new points with the training axis sharded
    (sharded general matmuls) vs the single-device path."""
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import sharded as sh

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    # new points both inside, before, and after the training span
    t_new = np.concatenate(
        [np.linspace(-2.0, 22.0, 37), np.asarray([0.0, 19.99])]
    )
    t_new = np.sort(t_new)

    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    mu_ref = np.asarray(gp.predict(y, t=t_new, include_mean=False))

    zeros_t = np.zeros_like(t)
    zeros_n = np.zeros_like(t_new)
    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    _, _, U2, V2 = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t_new, zeros_n)
    )
    # a with observational diag is what factor consumes; rebuild
    seq = P("seq")
    fn = jax.jit(
        jax.shard_map(
            lambda tl, cl, al, Ul, Vl, rl, tn, Un, Vn: sh.sharded_predict_mean_at(
                tl, cl, al, Ul, Vl, rl, tn, Un, Vn
            ),
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, seq, P(), P(), P()),
            out_specs=P(),
        )
    )
    mu = fn(
        jnp.asarray(t), c, a, U, V, jnp.asarray(y),
        jnp.asarray(t_new), U2, V2,
    )
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_sharded_pathwise_sample_matches_single_chip(mesh_seq):
    """sharded_sample_conditional with pinned noise reproduces the
    single-chip pathwise transform exactly (same affine map, split
    across the mesh).  Compile-heavy (~4 min: two sharded factors +
    solves + general matmuls in one shard_map program) -> slow tier;
    test_make_sharded_conditional_sampler keeps fast-tier coverage."""
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import sharded as sh
    from jax import shard_map
    from functools import partial

    t, yerr, y = _data(120)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    M = 24  # N + M = 144 divides over 8 devices; no padding
    t_new = np.linspace(-1.0, 21.0, M)

    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    cond = gp.condition(y, t=t_new)
    rng = np.random.default_rng(77)
    z = rng.normal(size=120 + M)
    eps = rng.normal(size=120)
    want = np.asarray(
        cond._pathwise_transform(jnp.asarray(z), jnp.asarray(eps))
    )

    # host-side setup mirroring make_sharded_conditional_sampler
    t_all = np.concatenate([t, t_new])
    order = np.argsort(t_all, kind="stable")
    t_u = t_all[order]
    inv = np.argsort(order, kind="stable")
    pos_train, pos_test = inv[:120], inv[120:]
    c, a, U, V = (
        np.asarray(x) for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    _, a_u, U_u, V_u = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(t_u, np.zeros_like(t_u))
    )
    _, _, U_new, V_new = (
        np.asarray(x)
        for x in kernel.get_celerite_matrices(
            t_new, np.zeros_like(t_new)
        )
    )
    seq, rep = P("seq"), P()
    core = shard_map(
        partial(sh.sharded_sample_conditional, axis_name="seq"),
        mesh=mesh_seq,
        in_specs=(
            seq, rep, seq, seq, seq, seq, seq,
            seq, seq, seq, seq,
            seq, rep,
            rep, rep, rep,
            seq, seq,
        ),
        out_specs=rep,
    )
    got = core(
        t, c, a, U, V, y, yerr**2,
        t_u, a_u, U_u, V_u,
        pos_train, pos_test,
        t_new, U_new, V_new,
        z, eps,
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                               atol=1e-9)


def test_make_sharded_conditional_sampler(mesh_seq):
    """End-to-end wrapper: union padding, mean handling, and sample
    moments against the dense conditional."""
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import make_sharded_conditional_sampler

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    M = 11  # N + M = 139 -> pads to 144 over 8 devices
    t_new = np.linspace(2.0, 18.0, M)

    sampler = jax.jit(
        make_sharded_conditional_sampler(
            kernel, t, y, yerr, t_new, mesh_seq, mean=0.7
        )
    )
    keys = jax.random.split(jax.random.PRNGKey(11), 400)
    samps = np.asarray(jnp.stack([sampler(k) for k in keys[:2]]))
    assert samps.shape == (2, M)
    assert np.all(np.isfinite(samps))

    gp = GaussianProcess(kernel, t=t, yerr=yerr, mean=0.7)
    cond = gp.condition(y, t=t_new)
    samps = np.asarray(jax.vmap(sampler)(keys))
    emp_mean = samps.mean(axis=0)
    emp_cov = np.cov(samps.T)
    sd = np.sqrt(np.asarray(cond.variance))
    np.testing.assert_allclose(
        emp_mean, np.asarray(cond.mean), atol=4.5 * sd.max() / 20.0
    )
    np.testing.assert_allclose(
        emp_cov, np.asarray(cond.covariance),
        atol=5.0 * float(sd.max() ** 2) / 20.0 + 1e-3,
    )


def test_sharded_conditional_covariance_matches(mesh_seq):
    """Sharded full predictive covariance vs the single-device
    ConditionalDistribution."""
    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.parallel import sharded as sh

    t, yerr, y = _data(128)
    kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    t_new = np.linspace(2, 18, 17)

    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    cov_ref = np.asarray(gp.condition(y, t=t_new).covariance)

    c, a, U, V = (
        jnp.asarray(np.asarray(x))
        for x in kernel.get_celerite_matrices(t, yerr**2)
    )
    KxsT = jnp.asarray(
        np.asarray(kernel.get_value(t[:, None] - t_new[None, :]))
    )
    Kss = jnp.asarray(
        np.asarray(kernel.get_value(t_new[:, None] - t_new[None, :]))
    )

    seq = P("seq")
    fn = jax.jit(
        jax.shard_map(
            lambda tl, cl, al, Ul, Vl, Kl, Ks: sh.sharded_conditional_covariance(
                tl, cl, al, Ul, Vl, Kl, Ks
            ),
            mesh=mesh_seq,
            in_specs=(seq, P(), seq, seq, seq, P("seq", None), P()),
            out_specs=P(),
        )
    )
    cov = fn(jnp.asarray(t), c, a, U, V, KxsT, Kss)
    np.testing.assert_allclose(cov, cov_ref, rtol=1e-6, atol=1e-8)
