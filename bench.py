"""Benchmark: GP log-likelihood + gradient throughput (the NUTS inner
loop) at N = 1e5 on a SHOTerm kernel, on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "evals/s", "vs_baseline": R, ...}

``value``       — evals/s of the fast tier, measured IN-GRAPH: K
                  chained evaluations inside one jit, the way a
                  sampler actually consumes the log-density.
``vs_baseline`` — speedup over the tier-1 sequential ``lax.scan``
                  recursion, i.e. over a faithful port of the
                  reference's single-thread algorithm
                  (forward.hpp:111-132) on the same card, measured the
                  same way.

A run that finds no GPU fails; ``--smoke`` (small N, no fleet) runs on
whatever platform JAX finds, for CI.
"""

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from celerite2_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")
)


def make_fn(backend, chain_len):
    from celerite2_tpu import set_config, terms
    from celerite2_tpu.gp import gp_loglik

    # backend routing is read at TRACE time and participates in the
    # jit cache key (config fingerprint) — set it OUTSIDE the traced
    # function, or the fingerprint flip mid-trace forces a retrace on
    # the next call (i.e. inside the timed region)
    set_config(backend=backend)

    # data flows through ARGUMENTS, never closures
    def ll(theta, t, yerr, y):
        kernel = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )
        # fused factor+solve: ONE engine pass for the forward
        return gp_loglik(kernel, t, y, yerr=yerr)

    def many(theta, t, yerr, y):
        def body(carry, _):
            v, g = jax.value_and_grad(ll)(carry, t, yerr, y)
            return carry + 1e-9 * g, v
        _, vs = jax.lax.scan(body, theta, None, length=chain_len)
        return vs[-1]

    return jax.jit(many)


def time_fn(fn, args, chain_len, *, reps, warmup=1):
    for _ in range(warmup):
        v = np.asarray(jax.block_until_ready(fn(*args)))
    start = time.perf_counter()
    for _ in range(reps):
        v = np.asarray(jax.block_until_ready(fn(*args)))
    dt = (time.perf_counter() - start) / (reps * chain_len)
    return dt, float(v)


def main(smoke: bool = False):
    """Full benchmark, or ``--smoke``: a minutes-scale CI gate (small N,
    short chains, no fleet) that checks the metric pipeline end to end
    and still prints the one JSON line."""
    dev = jax.devices()[0]
    if not smoke and dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU found (platform {dev.platform!r})")
    N = 4_096 if smoke else 100_000
    rng = np.random.default_rng(42)
    t = jnp.asarray(np.sort(rng.uniform(0, 1000, N)))
    yerr = jnp.full(N, 0.25, t.dtype)
    y = jnp.asarray(
        np.sin(0.7 * np.asarray(t)) + 0.25 * rng.normal(size=N)
    )
    theta = jnp.log(jnp.asarray([1.0, 5.0, 3.0], t.dtype))
    args = (theta, t, yerr, y)

    # the fast tier (assoc) against the sequential scan tier
    results = {}
    vals = {}
    plan = (
        (("scan", 2, 1), ("assoc", 10, 1))
        if smoke
        else (("scan", 2, 1), ("assoc", 200, 3))
    )
    for backend, chain_len, reps in plan:
        fn = make_fn(backend, chain_len)
        dt, val = time_fn(fn, args, chain_len, reps=reps)
        results[backend] = 1.0 / dt
        vals[backend] = val

    # sanity: both backends agree
    rel = abs(vals["scan"] - vals["assoc"]) / max(1.0, abs(vals["scan"]))
    assert rel < 1e-3, (vals, rel)

    best = max(results.values())
    baseline = results["scan"]
    payload = {
        "metric": (
            "gp_loglik_grad_evals_per_s_N4096_SHOTerm_smoke"
            if smoke
            else "gp_loglik_grad_evals_per_s_N1e5_SHOTerm"
        ),
        "value": round(best, 3),
        "unit": "evals/s",
        "vs_baseline": round(best / baseline, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if not smoke:
        fleet = _fleet_ess_rate()
        # headline fleet number: compile EXCLUDED (the compiled program
        # is reusable and chain-count independent); the rate with
        # compile is reported beside it
        payload["ess_per_s_fleet_N3e4_C64"] = fleet["excl_compile"]
        payload["ess_per_s_fleet_incl_compile"] = fleet["incl_compile"]
        payload["fleet_min_ess"] = fleet["min_ess"]
    print(json.dumps(payload))


def _fleet_ess_rate():
    """min-ESS/s of the ChEES-HMC fleet path (64 chains, N=3e4,
    SHO-mixture), wall time including compile — the BASELINE config-3
    capability number."""
    from celerite2_tpu import GaussianProcess, set_config, terms
    from celerite2_tpu.gp import gp_loglik
    from celerite2_tpu.inference import effective_sample_size, run_hmc

    N = 30_000
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 300, N))
    yerr = np.full(N, 0.2)
    kernel = terms.SHOTerm(sigma=1.0, rho=8.0, tau=20.0) + terms.SHOTerm(
        sigma=0.6, rho=2.0, Q=0.3
    )
    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(5)))

    tj, yj, yerrj = jnp.asarray(t), jnp.asarray(y), jnp.asarray(yerr)

    def logpost(theta):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        ) + terms.SHOTerm(
            sigma=jnp.exp(theta[3]), rho=jnp.exp(theta[4]), Q=0.3
        )
        return gp_loglik(k, tj, yj, yerr=yerrj) - 0.5 * jnp.sum(
            (theta / 2.0) ** 2
        )

    init = jnp.asarray(
        [0.0, np.log(5.0), np.log(10.0), -0.5, np.log(3.0)], tj.dtype
    )
    # snapshot/restore the WHOLE config (don't clobber the caller's
    # assoc_threshold, and restore even on exceptions)
    from celerite2_tpu.config import get_config

    prior = get_config()
    stamps = []
    try:
        set_config(assoc_threshold=64)
        t0 = time.perf_counter()
        res = jax.block_until_ready(
            run_hmc(
                logpost,
                init,
                jax.random.PRNGKey(1),
                num_warmup=60,
                num_samples=60,
                num_chains=64,
                max_leapfrog=48,
                chunk_size=20,  # bounded device executions
                monitor=lambda step, stats: stamps.append(
                    time.perf_counter()
                ),
            )
        )
        wall = time.perf_counter() - t0
        ess = float(
            np.min(np.asarray(effective_sample_size(res.samples)))
        )
    finally:
        set_config(**prior.__dict__)
    # chunk 0's wall includes the one-off XLA compile; the remaining
    # chunks measure pure sampling throughput of the reusable program
    if len(stamps) > 1:
        per_chunk = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
        wall_sampling = per_chunk * len(stamps)
    else:  # pragma: no cover - single-chunk fallback
        wall_sampling = wall
    return dict(
        incl_compile=round(ess / wall, 3),
        excl_compile=round(ess / wall_sampling, 3),
        min_ess=round(ess, 1),
    )


if __name__ == "__main__":
    import sys

    main(smoke="--smoke" in sys.argv[1:])
