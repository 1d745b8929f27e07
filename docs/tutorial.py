"""Runnable version of docs/tutorial.md (small sizes so it finishes in
about a minute on CPU; raise N / chain counts on a GPU).

    python docs/tutorial.py
"""

import numpy as np

import jax
import jax.numpy as jnp

import celerite2_tpu as c2
from celerite2_tpu import terms
from celerite2_tpu.gp import gp_loglik
from celerite2_tpu.inference import (
    fit_map,
    run_advi,
    run_hmc,
    run_nuts,
    run_smc,
    summary,
)

# ------------------------------------------------- 1. simulated data
rng = np.random.default_rng(42)
N = 300
t = np.sort(rng.uniform(0, 10, N))
yerr = rng.uniform(0.08, 0.22, N)
y = (
    0.2 * (t - 5.0)
    + np.sin(3.0 * t + 0.1 * (t - 5.0) ** 2)
    + yerr * rng.normal(size=N)
)
true_t = np.linspace(0, 10, 100)


# ------------------------------------------------ 2. a celerite model
def build_kernel(params):
    term1 = terms.SHOTerm(
        sigma=jnp.exp(params[0]), rho=jnp.exp(params[1]), Q=0.25
    )
    term2 = terms.SHOTerm(
        sigma=jnp.exp(params[2]),
        rho=jnp.exp(params[3]),
        tau=jnp.exp(params[4]),
    )
    return term1 + term2


p0 = jnp.zeros(5)
gp = c2.GaussianProcess(build_kernel(p0), t=t, yerr=yerr)
print("initial log likelihood:", float(gp.log_likelihood(y)))


def log_posterior(params):
    # gp_loglik runs factor+solve fused — the sampler hot path
    ll = gp_loglik(build_kernel(params), t, y, yerr=yerr)
    prior = -0.5 * jnp.sum((params / 5.0) ** 2)
    return ll + prior


# ----------------------------------------------------- 3. MAP fit
res = fit_map(log_posterior, p0, num_steps=200)
print("MAP params:", np.asarray(res.params))
print("MAP log prob:", float(res.log_prob))

# ------------------------------------------------- 4. NUTS posterior
post = run_nuts(
    log_posterior,
    res.params,
    jax.random.PRNGKey(0),
    num_warmup=300,
    num_samples=300,
    num_chains=2,
)
s = summary(post.samples)
print("posterior mean:", np.asarray(s["mean"]))
print("posterior sd:  ", np.asarray(s["sd"]))
print("R-hat:         ", np.asarray(s["rhat"]))
print("divergence rate:", float(post.diverging.mean()))

# --------------------------------------- 4b. fleet HMC (many chains)
# the fixed-trajectory ChEES sampler compiles a chain-count-independent
# program: use it for hundreds/thousands of chains (num_chains here is
# small only so the tutorial stays fast)
fleet = run_hmc(
    log_posterior,
    res.params,
    jax.random.PRNGKey(1),
    num_warmup=300,
    num_samples=300,
    num_chains=8,
    max_leapfrog=64,
)
print("fleet posterior mean:", np.asarray(summary(fleet.samples)["mean"]))

# --------------------------------------------- 4c. VI and SMC options
vi = run_advi(log_posterior, res.params, jax.random.PRNGKey(2),
              num_steps=800)
print("ADVI mean:", np.asarray(vi.mean))


def log_prior(q):
    return -0.5 * jnp.sum((q / 5.0) ** 2)


smc = run_smc(
    log_prior,
    lambda q: log_posterior(q) - log_prior(q),
    lambda key, n: 5.0 * jax.random.normal(key, (n, 5), res.params.dtype),
    jax.random.PRNGKey(3),
    num_particles=512,
    mutation_steps=5,
)
print("SMC log evidence:", float(smc.log_evidence))

# -------------------------------------------------- 5. prediction
gp = c2.GaussianProcess(build_kernel(res.params), t=t, yerr=yerr)
mu, var = gp.predict(y, t=true_t, return_var=True)
print("predictive mean range:", float(mu.min()), float(mu.max()))

kernel2 = terms.SHOTerm(
    sigma=jnp.exp(res.params[2]),
    rho=jnp.exp(res.params[3]),
    tau=jnp.exp(res.params[4]),
)
mu2 = gp.predict(y, t=true_t, kernel=kernel2)
print("component mean range: ", float(mu2.min()), float(mu2.max()))

# posterior-predictive draws WITHOUT the M x M Cholesky: pathwise
# (Matheron) conditioning samples the joint latent prior with the
# O(N+M) semiseparable factor and corrects it through the training
# solve — exact, and it scales to sampling entire light curves
cond = gp.condition(y, t=true_t)
draws = cond.sample_pathwise(jax.random.PRNGKey(7), shape=(4,))
print("pathwise draws:", draws.shape)

keys, bibtex = gp.citations
print("cite:", ", ".join(keys))

# ------------------------- 6. external PPLs (optional dependencies)
# numpyro: gp.numpyro_dist() returns a CeleriteNormal usable as an
# observed site (reference jax/distribution.py role).
# PyMC: one black-box likelihood Op wraps the jitted JAX density —
# kernels stay in THIS package's term DSL; with pymc.sampling.jax the
# whole model compiles to a single XLA program:
#
#   from celerite2_tpu.pymc_support import celerite_loglik_op
#   op = celerite_loglik_op(
#       lambda s, r, tau: terms.SHOTerm(sigma=s, rho=r, tau=tau),
#       t, y, yerr=yerr)
#   with pm.Model():
#       s = pm.HalfNormal("sigma", 1.0)
#       r = pm.HalfNormal("rho", 5.0)
#       tau = pm.HalfNormal("tau", 5.0)
#       pm.Potential("gp", op(s, r, tau))
#       idata = pm.sample()   # or pymc.sampling.jax.sample_numpyro_nuts
