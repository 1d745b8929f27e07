"""Adaptive-tempering Sequential Monte Carlo with HMC mutations.

The particle axis is embarrassingly parallel (vmap / pjit-shardable);
resampling is systematic.  The temperature ladder is chosen adaptively
so the effective sample size stays near a target fraction — the
standard likelihood-tempering SMC sampler, on-device end to end.

Cross-device collectives (when the particle axis is sharded): the ESS
and the resampling categorical are global reductions — see
celerite2_tpu/parallel for the mesh-aware wrapper.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["SMCResult", "run_smc"]


class SMCResult(NamedTuple):
    particles: jax.Array  # (P, dim) final posterior particles
    log_evidence: jax.Array  # () log marginal-likelihood estimate
    n_stages: jax.Array  # () tempering stages used
    final_beta: jax.Array  # () should be 1.0
    mutation_eps: jax.Array  # () adapted mutation step size


def _systematic_resample(key, log_weights, particles):
    P = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cum = jnp.cumsum(w)
    u = (jax.random.uniform(key, ()) + jnp.arange(P)) / P
    idx = jnp.searchsorted(cum, u, side="left")
    idx = jnp.clip(idx, 0, P - 1)
    return particles[idx]


def _find_next_beta(log_like, beta, *, target_frac=0.5, n_bisect=32):
    """Largest delta-beta whose incremental weights keep relative ESS
    above ``target_frac`` (bisection, branchless)."""
    P = log_like.shape[0]

    def rel_ess(delta):
        lw = delta * log_like
        lw = lw - jnp.max(lw)
        w = jnp.exp(lw)
        return (jnp.sum(w) ** 2) / (P * jnp.sum(w**2))

    lo = jnp.zeros(())
    hi = 1.0 - beta

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        ok = rel_ess(mid) >= target_frac
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = lax.fori_loop(0, n_bisect, body, (lo, hi))
    # if even the full jump keeps ESS high, go straight to beta = 1
    full_ok = rel_ess(1.0 - beta) >= target_frac
    delta = jnp.where(full_ok, 1.0 - beta, lo)
    return jnp.minimum(beta + delta, 1.0)


def _hmc_mutation(key, particles, logdensity, eps, scales, n_steps=10):
    """One fixed-length HMC pass over all particles (vmapped).

    ``scales (dim,)`` preconditions the momenta with the current
    particle-cloud spread (a free diagonal mass estimate — SMC carries
    the population, so no Welford warmup is needed)."""
    grad_fn = jax.grad(lambda q: -logdensity(q))

    def one(q, k):
        k1, k2 = jax.random.split(k)
        p = jax.random.normal(k1, q.shape, q.dtype)
        h0 = -logdensity(q) + 0.5 * jnp.sum(p**2)

        def leap(carry, _):
            q, p = carry
            p = p - 0.5 * eps * scales * grad_fn(q)
            q = q + eps * scales * p
            p = p - 0.5 * eps * scales * grad_fn(q)
            return (q, p), None

        (q1, p1), _ = lax.scan(leap, (q, p), None, length=n_steps)
        h1 = -logdensity(q1) + 0.5 * jnp.sum(p1**2)
        delta = h0 - h1
        delta = jnp.where(jnp.isfinite(delta), delta, -jnp.inf)
        accept = jnp.log(jax.random.uniform(k2, ())) < delta
        qn = jnp.where(accept, q1, q)
        return qn, accept

    keys = jax.random.split(key, particles.shape[0])
    return jax.vmap(one)(particles, keys)


def run_smc(
    log_prior: Callable,
    log_likelihood: Callable,
    sample_prior: Callable,
    key: jax.Array,
    *,
    num_particles: int = 1024,
    max_stages: int = 50,
    target_ess_frac: float = 0.5,
    mutation_steps: int = 10,
    mutation_eps: float = 0.1,
    mutation_target_accept: float = 0.65,
    particle_axis: Optional[jax.sharding.Sharding] = None,
) -> SMCResult:
    """Likelihood-tempered SMC: pi_beta ~ prior * likelihood^beta.

    ``sample_prior(key, num) -> (num, dim)`` provides the initial cloud.
    ``mutation_eps`` only seeds the mutation step size: each stage
    preconditions momenta with the particle cloud's per-dimension
    spread and nudges the step size toward ``mutation_target_accept``
    acceptance (Robbins-Monro on log eps).

    ``particle_axis`` (a Sharding, e.g. ``NamedSharding(mesh,
    P("chains"))``) lays the particle cloud out across the mesh; the
    program is written with global shapes and XLA's SPMD partitioner
    turns the global reductions (ESS, evidence, cloud spread, accept
    rate) into psums and the systematic-resampling gather into
    all_gather + local take — the SPMD counterpart of an MPI
    resampling exchange.  The sharding is re-pinned after resampling
    and mutation so the layout survives the whole tempering loop.
    """
    key, k0 = jax.random.split(key)
    particles = sample_prior(k0, num_particles)
    dtype = particles.dtype
    if particle_axis is not None:
        particles = jax.device_put(particles, particle_axis)

    def _pin(q):
        if particle_axis is None:
            return q
        return jax.lax.with_sharding_constraint(q, particle_axis)

    loglike_v = jax.vmap(log_likelihood)

    def temper(q, beta):
        return log_prior(q) + beta * log_likelihood(q)

    class Carry(NamedTuple):
        particles: jax.Array
        beta: jax.Array
        log_Z: jax.Array
        stage: jax.Array
        eps: jax.Array  # adapted mutation step size
        key: jax.Array

    def cond(c: Carry):
        return jnp.logical_and(c.beta < 1.0, c.stage < max_stages)

    def body(c: Carry):
        key, k_res, k_mut = jax.random.split(c.key, 3)
        ll = loglike_v(c.particles)
        beta_new = _find_next_beta(
            ll, c.beta, target_frac=target_ess_frac
        )
        delta = beta_new - c.beta
        lw = delta * ll
        # evidence increment: log mean of incremental weights
        log_Z = c.log_Z + jax.nn.logsumexp(lw) - jnp.log(lw.shape[0])
        particles = _pin(_systematic_resample(k_res, lw, c.particles))
        logdensity = lambda q: temper(q, beta_new)  # noqa: E731
        # population-preconditioned momenta: the resampled cloud's
        # per-dimension spread is a free mass-matrix estimate
        scales = jnp.std(particles, axis=0) + 1e-12
        particles, acc = _hmc_mutation(
            k_mut,
            particles,
            logdensity,
            c.eps,
            scales,
            n_steps=mutation_steps,
        )
        particles = _pin(particles)
        # per-stage step-size adaptation towards ~65% acceptance
        # (Robbins-Monro on log eps; clipped so one stage cannot jump
        # more than ~2.3x)
        rate = jnp.mean(acc.astype(dtype))
        eps = c.eps * jnp.exp(
            jnp.clip(rate - mutation_target_accept, -0.3, 0.3)
        )
        return Carry(
            particles=particles,
            beta=beta_new,
            log_Z=log_Z,
            stage=c.stage + 1,
            eps=eps,
            key=key,
        )

    out = lax.while_loop(
        cond,
        body,
        Carry(
            particles=particles,
            beta=jnp.zeros((), dtype),
            log_Z=jnp.zeros((), dtype),
            stage=jnp.zeros((), jnp.int32),
            eps=jnp.asarray(mutation_eps, dtype),
            key=key,
        ),
    )
    return SMCResult(
        particles=out.particles,
        log_evidence=out.log_Z,
        n_stages=out.stage,
        final_beta=out.beta,
        mutation_eps=out.eps,
    )
