"""Throughput harness (SURVEY.md section 7.7): GP log-likelihood +
gradient evals/s per chip, single-evaluation and chain-parallel.

Timings are IN-GRAPH (chained evaluations inside one jit), the way a
sampler consumes the log-density; per-call timing adds host dispatch.

    python benchmarks/throughput.py --n 100000 --chains 64
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import jax
import jax.numpy as jnp


def make_eval(backend):
    from celerite2_tpu import set_config, terms
    from celerite2_tpu.gp import gp_compute, gp_log_likelihood

    # outside the traced fn: the config fingerprint is part of the jit
    # cache key, so flipping it mid-trace would force a later retrace
    set_config(backend=backend)

    def ll(theta, t, yerr, y):
        kernel = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )
        return gp_log_likelihood(gp_compute(kernel, t, yerr=yerr), y)

    return ll


def time_in_graph(fn, theta, args, *, chain_len, reps):
    def many(theta, *args):
        def body(carry, _):
            v, g = jax.value_and_grad(fn)(carry, *args)
            return carry + 1e-9 * g, v

        _, vs = jax.lax.scan(body, theta, None, length=chain_len)
        return vs[-1]

    jit_fn = jax.jit(many)
    jax.block_until_ready(jit_fn(theta, *args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(jit_fn(theta, *args))
    return (time.perf_counter() - t0) / (reps * chain_len)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--backend", default="assoc")
    ap.add_argument("--chain-len", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args()

    rng = np.random.default_rng(42)
    t = jnp.asarray(np.sort(rng.uniform(0, 1000, opts.n)))
    yerr = jnp.full(opts.n, 0.25, t.dtype)
    y = jnp.asarray(
        np.sin(0.7 * np.asarray(t)) + 0.25 * rng.normal(size=opts.n)
    )
    theta = jnp.log(jnp.asarray([1.0, 5.0, 3.0], t.dtype))
    fn = make_eval(opts.backend)

    # single evaluation stream
    dt1 = time_in_graph(
        fn, theta, (t, yerr, y),
        chain_len=opts.chain_len, reps=opts.reps,
    )

    # chain-parallel stream (vmapped over theta).  Per-call timing is
    # fine here: the fleet's compute dwarfs the ~30 ms dispatch, and
    # wrapping a vmapped engine in a further scan explodes XLA compile
    # (the batched-while pathology, see CLAUDE.md).
    C = opts.chains
    thetas = theta[None, :] + 0.01 * jnp.arange(C)[:, None]
    jit_v = jax.jit(
        jax.vmap(
            jax.value_and_grad(lambda th: fn(th, t, yerr, y))
        )
    )
    jax.block_until_ready(jit_v(thetas))
    t0 = time.perf_counter()
    reps_v = max(3, opts.reps)
    for _ in range(reps_v):
        jax.block_until_ready(jit_v(thetas))
    dtC = (time.perf_counter() - t0) / reps_v

    print(json.dumps({
        "platform": jax.default_backend(),
        "backend": opts.backend,
        "n": opts.n,
        "single_evals_per_s": round(1.0 / dt1, 2),
        "chains": C,
        "chain_evals_per_s": round(C / dtC, 2),
    }))


if __name__ == "__main__":
    main()
