"""BASELINE eval-config harness: one command per config, JSON out.

Runs the BASELINE.md eval configs and the reference tutorial model
(/root/reference/docs/tutorials/first.ipynb — data generated with the
same seeds/process; the reference itself cannot run in this image, so
posterior "goldens" are established by cross-METHOD agreement: NUTS,
fleet HMC, and (config 4) VI + SMC must agree within Monte-Carlo error,
and the recorded moments serve as regression goldens thereafter).

Usage:
    python benchmarks/configs.py [config1|...|config5|tutorial|all]

Each config prints one JSON line:
    {"config": ..., "metrics": {...}, "posterior": {...}}
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

# runnable from anywhere: `python benchmarks/configs.py ...`
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _sync(v):
    return np.asarray(jax.block_until_ready(v))


def _timer(fn, *args, reps=5):
    v = fn(*args)
    _sync(v)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        v = fn(*args)
        _sync(v)
        best = min(best, time.perf_counter() - t0)
    return best, v


def _summarize(samples, seconds):
    """Posterior moments + sampling health from (C, S, dim) draws."""
    from celerite2_tpu.inference import effective_sample_size, split_rhat

    ess = np.asarray(effective_sample_size(samples))
    rhat = np.asarray(split_rhat(samples))
    flat = np.asarray(samples).reshape(-1, samples.shape[-1])
    return dict(
        mean=flat.mean(axis=0).tolist(),
        sd=flat.std(axis=0).tolist(),
        ess=ess.tolist(),
        min_ess=float(ess.min()),
        max_rhat=float(rhat.max()),
        ess_per_s=float(ess.min() / seconds),
        seconds=seconds,
    )


# ----------------------------------------------------------- config 1


def config1():
    """SHOTerm N=200: log-likelihood, gradient, predict (values+time)."""
    from celerite2_tpu import GaussianProcess, terms
    from celerite2_tpu.gp import gp_loglik

    rng = np.random.default_rng(42)
    N = 200
    t = np.sort(rng.uniform(0, 10, N))
    yerr = np.full(N, 0.2)
    y = np.sin(t) + yerr * rng.normal(size=N)
    t_new = np.linspace(-1, 11, 100)

    kernel = terms.SHOTerm(sigma=1.5, rho=3.4, tau=2.345)
    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    ll = float(gp.log_likelihood(y))
    mu = np.asarray(gp.predict(y, t=t_new))

    def ll_grad(theta, t, y, yerr):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )
        return gp_loglik(k, t, y, yerr=yerr)

    f = jax.jit(jax.value_and_grad(ll_grad))
    args = (
        jnp.log(jnp.asarray([1.5, 3.4, 2.345])),
        jnp.asarray(t),
        jnp.asarray(y),
        jnp.asarray(yerr),
    )
    v, g = f(*args)
    dt, _ = _timer(lambda *a: f(*a)[0], *args)
    return dict(
        config="config1_sho_n200",
        metrics=dict(
            loglik=ll,
            loglik_grad_ms=dt * 1e3,
            predict_mean_head=mu[:3].tolist(),
            grad=np.asarray(g).tolist(),
        ),
    )


# ----------------------------------------------------------- config 2


def config2(num_warmup=500, num_samples=500):
    """RotationTerm N=1e3: MAP then 4-chain NUTS; ESS/s + moments."""
    from celerite2_tpu import GaussianProcess, terms
    from celerite2_tpu.gp import gp_loglik
    from celerite2_tpu.inference import fit_map, run_nuts

    rng = np.random.default_rng(123)
    N = 1000
    t = np.sort(rng.uniform(0, 50, N))
    yerr = np.full(N, 0.1)
    true_kernel = terms.RotationTerm(
        sigma=1.0, period=3.5, Q0=2.0, dQ=1.0, f=0.3
    )
    gp = GaussianProcess(true_kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(11)))

    prior_sigma = 2.0

    def logpost(theta):
        sigma, period, Q0, dQ = jnp.exp(theta[:4])
        f = jax.nn.sigmoid(theta[4])  # f in (0, 1)
        k = terms.RotationTerm(
            sigma=sigma, period=period, Q0=Q0, dQ=dQ, f=f
        )
        ll = gp_loglik(k, t, y, yerr=yerr)
        prior = -0.5 * jnp.sum((theta / prior_sigma) ** 2)
        return ll + prior

    init = jnp.asarray([0.0, jnp.log(3.0), jnp.log(1.5), 0.0, 0.0])
    t0 = time.perf_counter()
    res = fit_map(logpost, init, num_steps=300)
    map_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    nuts = run_nuts(
        logpost,
        res.params,
        jax.random.PRNGKey(0),
        num_warmup=num_warmup,
        num_samples=num_samples,
        num_chains=4,
        max_depth=8,
        chunk_size=100,  # bounded device executions (CLAUDE.md)
    )
    jax.block_until_ready(nuts.samples)
    nuts_seconds = time.perf_counter() - t0

    out = _summarize(nuts.samples, nuts_seconds)
    out["divergence_rate"] = float(jnp.mean(nuts.diverging))
    return dict(
        config="config2_rotation_n1e3_map_nuts",
        metrics=dict(
            map_logpost=float(res.log_prob),
            map_seconds=map_seconds,
        ),
        posterior=out,
    )


# ----------------------------------------------------------- config 3


def config3(num_warmup=400, num_samples=400, num_chains=8, n=30_000):
    """SHO-mixture N=3e4 sampling via the fleet HMC path (the
    fixed-trajectory sampler that keeps fleet compiles flat)."""
    from celerite2_tpu import GaussianProcess, set_config, terms
    from celerite2_tpu.gp import gp_loglik
    from celerite2_tpu.inference import run_hmc

    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 300, n))
    yerr = np.full(n, 0.2)
    true_kernel = terms.SHOTerm(sigma=1.0, rho=8.0, tau=20.0) + terms.SHOTerm(
        sigma=0.6, rho=2.0, Q=0.3
    )
    gp = GaussianProcess(true_kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(5)))

    set_config(assoc_threshold=64)  # long run: engine tier pays off

    def logpost(theta):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        ) + terms.SHOTerm(
            sigma=jnp.exp(theta[3]),
            rho=jnp.exp(theta[4]),
            Q=0.3,
        )
        ll = gp_loglik(k, t, y, yerr=yerr)
        return ll - 0.5 * jnp.sum((theta / 2.0) ** 2)

    init = jnp.asarray([0.0, np.log(5.0), np.log(10.0), -0.5, np.log(3.0)])
    t0 = time.perf_counter()
    res = run_hmc(
        logpost,
        init,
        jax.random.PRNGKey(1),
        num_warmup=num_warmup,
        num_samples=num_samples,
        num_chains=num_chains,
        max_leapfrog=256,
        # bounded device executions (chunked runs are retried from a
        # host snapshot on a device fault)
        chunk_size=25,
    )
    jax.block_until_ready(res.samples)
    seconds = time.perf_counter() - t0

    out = _summarize(res.samples, seconds)
    out["divergence_rate"] = float(jnp.mean(res.diverging))
    from celerite2_tpu import set_config as _sc

    _sc(assoc_threshold=1024)
    return dict(config="config3_shomix_n3e4_hmc", posterior=out)


# ----------------------------------------------------------- config 4


def config4():
    """Matern32+SHO sums/products: VI and SMC posteriors vs NUTS.

    The two components live at SEPARATED timescales (short-scale
    Matern-3/2 + long-period SHO) so the posterior is unimodal and the
    three methods are comparable; overlapping timescales make the
    decomposition unidentifiable (label-switching-like multimodality)
    and no sampler agreement can be expected.

    In an f32 process this config runs inside a SCOPED jax.enable_x64
    context: Matern32Term's eps-regularized complex pair carries a
    ~1/eps amplitude whose plain-f32 cancellation flips gradient signs
    and stalls NUTS adaptation (measured; the reference mandates f64
    globally for the same reason, jax/ops.py:84).  The per-op f64
    island (config.core_dtype) covers jit/grad/vmap-of-grad consumers
    but NOT the samplers' vmapped while-loops (jaxpr-level batching
    re-binds f64 ops under the process's x64-off config and truncates
    them) — whole-sampler scoping is the supported pattern for full
    inference runs (docs/api.md).  x64 reference agreement: NUTS/VI/
    SMC posterior means within ~0.05 on all five parameters."""
    if not jax.config.jax_enable_x64:
        # f32 process: run the whole stiff config in a scoped
        # x64 region (data is built as numpy f64; jnp keeps it f64)
        with jax.enable_x64(True):
            return _config4_body()
    return _config4_body()


def _config4_body():
    from celerite2_tpu import GaussianProcess, terms
    from celerite2_tpu.gp import gp_loglik
    from celerite2_tpu.inference import fit_map, run_advi, run_nuts, run_smc

    rng = np.random.default_rng(99)
    N = 400
    t = np.sort(rng.uniform(0, 40, N))
    yerr = np.full(N, 0.15)
    true_kernel = terms.Matern32Term(sigma=0.8, rho=0.9) + terms.SHOTerm(
        sigma=1.0, rho=8.0, tau=12.0
    )
    gp = GaussianProcess(true_kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(21)))

    prior_sigma = 1.0

    # weakly-informative priors around the component scales keep the
    # decomposition identified
    prior_mu = jnp.log(jnp.asarray([1.0, 1.0, 1.0, 6.0, 8.0]))

    def logpost(theta):
        k = terms.Matern32Term(
            sigma=jnp.exp(theta[0]), rho=jnp.exp(theta[1])
        ) + terms.SHOTerm(
            sigma=jnp.exp(theta[2]),
            rho=jnp.exp(theta[3]),
            tau=jnp.exp(theta[4]),
        )
        ll = gp_loglik(k, t, y, yerr=yerr)
        return ll - 0.5 * jnp.sum(((theta - prior_mu) / prior_sigma) ** 2)

    init = jnp.asarray(fit_map(logpost, prior_mu, num_steps=300).params)

    t0 = time.perf_counter()
    nuts = run_nuts(
        logpost,
        init,
        jax.random.PRNGKey(2),
        num_warmup=400,
        num_samples=400,
        num_chains=4,
        max_depth=8,
        chunk_size=100,
    )
    jax.block_until_ready(nuts.samples)
    nuts_out = _summarize(nuts.samples, time.perf_counter() - t0)

    t0 = time.perf_counter()
    vi = run_advi(logpost, init, jax.random.PRNGKey(3), num_steps=2000)
    jax.block_until_ready(vi.mean)
    vi_seconds = time.perf_counter() - t0

    def log_prior(q):
        return -0.5 * jnp.sum(((q - prior_mu) / prior_sigma) ** 2)

    def log_like(q):
        return logpost(q) - log_prior(q)

    def sample_prior(key, n):
        return prior_mu + prior_sigma * jax.random.normal(
            key, (n, 5), jnp.result_type(float)
        )

    t0 = time.perf_counter()
    smc = run_smc(
        log_prior,
        log_like,
        sample_prior,
        jax.random.PRNGKey(4),
        num_particles=2048,
        mutation_steps=10,
    )
    jax.block_until_ready(smc.particles)
    smc_seconds = time.perf_counter() - t0
    particles = np.asarray(smc.particles)

    return dict(
        config="config4_m32_sho_vi_smc",
        posterior=dict(
            nuts=nuts_out,
            vi=dict(
                mean=np.asarray(vi.mean).tolist(),
                sd=np.exp(np.asarray(vi.log_sigma)).tolist(),
                seconds=vi_seconds,
            ),
            smc=dict(
                mean=particles.mean(axis=0).tolist(),
                sd=particles.std(axis=0).tolist(),
                log_evidence=float(smc.log_evidence),
                seconds=smc_seconds,
            ),
        ),
    )


# ----------------------------------------------------- tutorial model


def tutorial_data():
    """Exact data process of the reference quickstart
    (first.ipynb cell 1: seed 42, two uniform windows)."""
    np.random.seed(42)
    t = np.sort(
        np.append(
            np.random.uniform(0, 3.8, 57),
            np.random.uniform(5.5, 10, 68),
        )
    )
    yerr = np.random.uniform(0.08, 0.22, len(t))
    y = (
        0.2 * (t - 5)
        + np.sin(3 * t + 0.1 * (t - 5) ** 2)
        + yerr * np.random.randn(len(t))
    )
    return t, yerr, y


def tutorial_logpost(t, yerr, y, prior_sigma=2.0):
    """The 7-parameter tutorial posterior (first.ipynb cells 9/19/23):
    params = [mean, log_sigma1, log_rho1, log_tau, log_sigma2,
    log_rho2, log_jitter], N(0, prior_sigma) priors."""
    from celerite2_tpu import terms
    from celerite2_tpu.gp import gp_loglik

    t = jnp.asarray(t)
    yerr = jnp.asarray(yerr)
    y = jnp.asarray(y)

    def logpost(params):
        mean = params[0]
        th = jnp.exp(params[1:])
        kernel = terms.SHOTerm(
            sigma=th[0], rho=th[1], tau=th[2]
        ) + terms.SHOTerm(sigma=th[3], rho=th[4], Q=0.25)
        ll = gp_loglik(
            kernel,
            t,
            y - mean,
            diag=yerr**2 + th[5],
        )
        return ll - 0.5 * jnp.sum((params / prior_sigma) ** 2)

    return logpost


def tutorial(num_warmup=1000, num_samples=1000):
    """MAP + NUTS + fleet-HMC on the reference tutorial model; the two
    samplers' moments must agree within MC error (cross-method golden)."""
    from celerite2_tpu.inference import fit_map, run_hmc, run_nuts

    t, yerr, y = tutorial_data()
    logpost = tutorial_logpost(t, yerr, y)

    init = jnp.asarray(
        [0.0, 0.0, 0.0, np.log(10.0), 0.0, np.log(5.0), np.log(0.01)]
    )
    res = fit_map(logpost, init, num_steps=500)

    t0 = time.perf_counter()
    nuts = run_nuts(
        logpost,
        res.params,
        jax.random.PRNGKey(34923),
        num_warmup=num_warmup,
        num_samples=num_samples,
        num_chains=2,
        max_depth=10,
        chunk_size=250,
    )
    jax.block_until_ready(nuts.samples)
    nuts_out = _summarize(nuts.samples, time.perf_counter() - t0)
    nuts_out["divergence_rate"] = float(jnp.mean(nuts.diverging))

    t0 = time.perf_counter()
    hmc = run_hmc(
        logpost,
        res.params,
        jax.random.PRNGKey(777),
        num_warmup=num_warmup,
        num_samples=num_samples,
        num_chains=16,
        max_leapfrog=256,
        chunk_size=250,
    )
    jax.block_until_ready(hmc.samples)
    hmc_out = _summarize(hmc.samples, time.perf_counter() - t0)
    hmc_out["divergence_rate"] = float(jnp.mean(hmc.diverging))

    return dict(
        config="tutorial_first_ipynb",
        metrics=dict(map_logpost=float(res.log_prob)),
        posterior=dict(nuts=nuts_out, hmc=hmc_out),
        params=[
            "mean",
            "log_sigma1",
            "log_rho1",
            "log_tau",
            "log_sigma2",
            "log_rho2",
            "log_jitter",
        ],
    )


# ----------------------------------------------------------- config 5


def config5(n=1_000_000, chain_len=50, reps=3):
    """BASELINE config 5's single-chip slice: loglik+grad throughput
    and peak device memory at N=1e6 (the full config is N=1e6 x 4096
    chains on a multi-host mesh; this measures the per-card building
    block every sharding decision needs).

    Measured in-graph (chain_len chained value_and_grad evals inside
    one jit, as a sampler consumes the density) on the assoc engine
    with auto-tuned levels; J=2 (SHOTerm) and J=4 (SHO mixture).
    Reference counterpart: the same N on the sequential single-thread
    algorithm (forward.hpp:111-132) is ~19 s/eval extrapolated — not
    run at this size."""
    from celerite2_tpu import get_config, set_config, terms
    from celerite2_tpu.gp import gp_loglik

    rng = np.random.default_rng(11)
    t_np = np.sort(rng.uniform(0, 10_000.0, n))
    y_np = np.sin(0.7 * t_np) + 0.25 * rng.normal(size=n)

    def make_many(make_kernel):
        def ll(theta, t, yerr, y):
            return gp_loglik(make_kernel(theta), t, y, yerr=yerr)

        def many(theta, t, yerr, y):
            def body(carry, _):
                v, g = jax.value_and_grad(ll)(carry, t, yerr, y)
                return carry + 1e-9 * g, v

            _, vs = jax.lax.scan(body, theta, None, length=chain_len)
            return vs[-1]

        return jax.jit(many)

    def sho2(theta):  # J=2
        return terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )

    def sho4(theta):  # J=4 mixture
        return terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        ) + terms.SHOTerm(
            sigma=jnp.exp(theta[3]), rho=jnp.exp(theta[4]), Q=0.3
        )

    dev = jax.devices()[0]
    t_d = jnp.asarray(t_np)
    yerr_d = jnp.full(n, 0.25, t_d.dtype)
    y_d = jnp.asarray(y_np)

    prior_cfg = get_config()
    set_config(assoc_threshold=64)
    metrics = {}
    try:
        for label, make_kernel, nparam in (
            ("J2", sho2, 3),
            ("J4", sho4, 5),
        ):
            theta = jnp.zeros(nparam, t_d.dtype)
            fn = make_many(make_kernel)
            args = (theta, t_d, yerr_d, y_d)
            dt, val = _timer(fn, *args, reps=reps)
            per_eval = dt / chain_len
            entry = {
                "loglik": float(val),
                "ms_per_eval": per_eval * 1e3,
                "evals_per_s": 1.0 / per_eval,
            }
            stats = getattr(dev, "memory_stats", lambda: None)()
            if stats:
                entry["peak_bytes_in_use"] = int(
                    stats.get("peak_bytes_in_use", 0)
                )
            metrics[label] = entry
    finally:
        set_config(**prior_cfg.__dict__)

    return dict(config="config5_N1e6_single_chip", metrics=metrics)


CONFIGS = dict(
    config1=config1,
    config2=config2,
    config3=config3,
    config4=config4,
    config5=config5,
    tutorial=tutorial,
)


def main(argv):
    names = argv[1:] or ["config1", "config2", "config4", "tutorial"]
    if names == ["all"]:
        names = list(CONFIGS)
    for name in names:
        out = CONFIGS[name]()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv)
