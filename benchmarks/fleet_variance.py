"""Fleet ESS/s variance: the bench.py fleet metric over 3 seeds, with
compile-inclusive and compile-excluded walls reported separately.

It quantifies the two confounds of that metric: (a) wall-including-
compile mixes the one-off XLA compile into the sampling measurement
(the compiled program is reused across seeds here, so seed 1 carries
the compile and seeds 2-3 expose it), and (b) min-ESS over 5 params
from 64 x 60 draws is a noisy order statistic.

Usage: timeout 3600 python -u benchmarks/fleet_variance.py
"""

import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from celerite2_tpu import GaussianProcess, set_config, terms
    from celerite2_tpu.config import get_config
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

    prior = get_config()
    rows = []
    try:
        set_config(assoc_threshold=64)
        for seed in (1, 11, 21):
            stamps = []
            t0 = time.perf_counter()
            res = jax.block_until_ready(
                run_hmc(
                    logpost,
                    init,
                    jax.random.PRNGKey(seed),
                    num_warmup=60,
                    num_samples=60,
                    num_chains=64,
                    max_leapfrog=48,
                    chunk_size=20,
                    monitor=lambda step, stats: stamps.append(
                        time.perf_counter()
                    ),
                )
            )
            wall = time.perf_counter() - t0
            ess = float(
                np.min(np.asarray(effective_sample_size(res.samples)))
            )
            per_chunk = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
            wall_s = per_chunk * len(stamps)
            rows.append((seed, ess, wall, wall_s))
            print(
                f"seed={seed}: min_ess={ess:.0f} wall={wall:.0f}s "
                f"(sampling {wall_s:.0f}s) -> "
                f"{ess / wall:.2f} ESS/s incl compile, "
                f"{ess / wall_s:.2f} excl",
                flush=True,
            )
    finally:
        set_config(**prior.__dict__)

    excl = np.asarray([e / ws for _, e, _, ws in rows])
    print(
        f"excl-compile ESS/s: mean {excl.mean():.2f} "
        f"sd {excl.std(ddof=1):.2f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
