"""Fleet-scale adaptive HMC (ChEES-style) — the fixed-trajectory path.

NUTS's data-dependent tree-doubling while-loops multiply XLA compile
time once the chains axis is vmapped (batched while-loops), which
blocks thousand-chain fleets.  This sampler removes every per-chain
dynamic loop:

* one **shared** jittered trajectory length per iteration (Halton
  sequence), so the leapfrog loop is a single ``lax.fori_loop`` with a
  *traced scalar* trip count OUTSIDE the chain batch — XLA compiles one
  batched leapfrog body regardless of the number of chains;
* the chain dimension is plain array batching (no per-chain ``vmap`` of
  control flow): the potential is evaluated with ``vmap(value_and_grad)``
  once per leapfrog step (one big fused batch);
* cross-chain adaptation — shared dual-averaging step size on the mean
  acceptance, pooled Welford diagonal mass, and ChEES trajectory-length
  adaptation (Hoffman, Radul & Sountsov 2021): maximize
  ``E[(||q' - m'||^2 - ||q - m||^2)^2]`` by Adam on ``log T`` with the
  per-chain gradient estimate
  ``accept_i * (||q'_i - m'||^2 - ||q_i - m||^2) * (q'_i - m') . v'_i``
  (v' = preconditioned endpoint velocity), acceptance-weighted across
  the fleet.  Cross-chain means become ``psum``s automatically when the
  chain axis is sharded over a mesh.

The reference delegates sampling to PyMC/numpyro
(/root/reference/docs/tutorials/first.ipynb NUTS cells); this module is
the framework's fleet path replacing that delegation at fleet scale
(BASELINE config 5).  For single/few-chain exploration with unknown
geometry, NUTS (inference/sampler.py) remains the reference-quality
default.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from celerite2_tpu.inference import adapt as _adapt

__all__ = ["HMCResult", "run_hmc"]


class HMCResult(NamedTuple):
    samples: jax.Array  # (C, num_samples, dim)
    log_prob: jax.Array  # (C, num_samples)
    accept_prob: jax.Array  # (C, num_samples)
    num_steps: jax.Array  # (num_samples,) shared per-iteration counts
    diverging: jax.Array  # (C, num_samples) bool
    step_size: jax.Array  # () shared
    trajectory_length: jax.Array  # () shared
    inv_mass: jax.Array  # (dim,) shared


class _AdamState(NamedTuple):
    m: jax.Array
    v: jax.Array
    count: jax.Array


def _adam_init(dtype):
    z = jnp.zeros((), dtype)
    return _AdamState(m=z, v=z, count=z)


def _adam_step(state: _AdamState, grad, *, lr=0.025, b1=0.9, b2=0.999):
    count = state.count + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad**2
    mh = m / (1 - b1**count)
    vh = v / (1 - b2**count)
    update = lr * mh / (jnp.sqrt(vh) + 1e-8)
    return _AdamState(m=m, v=v, count=count), update


def _halton(n, base=2):
    """Radical-inverse (van der Corput) sequence in (0, 1)."""
    seq = np.zeros(n)
    for i in range(n):
        f, r = 1.0, 0.0
        k = i + 1
        while k > 0:
            f /= base
            r += f * (k % base)
            k //= base
        seq[i] = r
    return seq


def _welford_batch(state: _adapt.WelfordState, X):
    """Pooled Welford update with a (C, dim) batch (Chan et al. merge)."""
    C = X.shape[0]
    mean_b = jnp.mean(X, axis=0)
    m2_b = jnp.sum((X - mean_b) ** 2, axis=0)
    count = state.count + C
    delta = mean_b - state.mean
    mean = state.mean + delta * (C / count)
    m2 = state.m2 + m2_b + delta**2 * (state.count * C / count)
    return _adapt.WelfordState(mean=mean, m2=m2, count=count)


class _HMCCarry(NamedTuple):
    q: jax.Array  # (C, dim)
    logp: jax.Array  # (C,)
    g: jax.Array  # (C, dim) grad of potential
    da: _adapt.DualAveragingState  # shared step size
    adam: _AdamState  # shared log-trajectory-length
    log_T: jax.Array  # () shared trajectory length
    wf: _adapt.WelfordState  # pooled mass estimate
    inv_mass: jax.Array  # (dim,)
    eps_frozen: jax.Array  # ()
    key: jax.Array


def _hmc_segment(
    logdensity_fn: Callable,
    carry: _HMCCarry,
    sched,
    *,
    max_leapfrog: int,
    target_accept: float,
    divergence_threshold: float = 1000.0,
):
    """One jittable scan over a segment of iterations.

    ``sched = (is_warm, in_slow, win_end, freeze, u)`` — static per-step
    flags plus the Halton jitter, all (S,) arrays.
    """
    dim = carry.q.shape[-1]
    dtype = carry.q.dtype

    def potential(x):
        return -logdensity_fn(x)

    vg = jax.vmap(jax.value_and_grad(potential))

    def step(carry: _HMCCarry, inp):
        warm, slow, at_end, freeze, u = inp
        q, logp, g = carry.q, carry.logp, carry.g
        inv_mass = carry.inv_mass
        key, k_mom, k_acc = jax.random.split(carry.key, 3)

        eps = jnp.where(
            warm, jnp.exp(carry.da.log_eps), carry.eps_frozen
        ).astype(dtype)
        T = jnp.exp(carry.log_T)
        # shared jittered step count for this iteration (traced scalar)
        n_steps = jnp.clip(
            jnp.ceil(u.astype(dtype) * T / eps).astype(jnp.int32),
            1,
            max_leapfrog,
        )

        p0 = jax.random.normal(k_mom, q.shape, dtype) / jnp.sqrt(inv_mass)
        h0 = -logp + 0.5 * jnp.sum(inv_mass * p0**2, axis=-1)

        # batched leapfrog with a dynamic (shared) trip count
        def leap(_, state):
            qq, pp, gg = state
            pp = pp - 0.5 * eps * gg
            qq = qq + eps * inv_mass * pp
            _, gg = vg(qq)
            pp = pp - 0.5 * eps * gg
            return (qq, pp, gg)

        q1, p1, g1 = lax.fori_loop(0, n_steps, leap, (q, p0, g))
        pot1, g1 = vg(q1)
        h1 = pot1 + 0.5 * jnp.sum(inv_mass * p1**2, axis=-1)

        delta = h1 - h0
        diverging = jnp.logical_or(
            ~jnp.isfinite(h1), delta > divergence_threshold
        )
        accept_prob = jnp.where(
            diverging, 0.0, jnp.minimum(1.0, jnp.exp(-delta))
        )
        take = (
            jax.random.uniform(k_acc, h1.shape, dtype)
            < accept_prob
        )
        q_new = jnp.where(take[:, None], q1, q)
        logp_new = jnp.where(take, -pot1, logp)
        g_new = jnp.where(take[:, None], g1, g)

        # ---- shared adaptation (warmup only, branchless)
        da_upd = _adapt.da_update(
            carry.da, jnp.mean(accept_prob), target=target_accept
        )
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(warm, new, old), da_upd, carry.da
        )

        # ChEES gradient for log T (u-scaled chain rule); proposals, not
        # accepted states, drive the criterion.  Divergent proposals may
        # hold inf/nan positions — replace them with the current state
        # (their accept weight is zero, but inf would still poison the
        # cross-chain means: 0 * inf = nan)
        ok1 = jnp.isfinite(h1)
        q1s = jnp.where(ok1[:, None], q1, q)
        v1s = jnp.where(
            ok1[:, None], inv_mass * p1, jnp.zeros_like(p1)
        )  # preconditioned endpoint velocity
        m0 = jnp.mean(q, axis=0)
        m1 = jnp.mean(q1s, axis=0)
        r0 = jnp.sum((q - m0) ** 2, axis=-1)
        r1 = jnp.sum((q1s - m1) ** 2, axis=-1)
        per_chain = (r1 - r0) * jnp.sum((q1s - m1) * v1s, axis=-1)
        wsum = jnp.sum(accept_prob) + 1e-6
        chees_grad = u * jnp.sum(accept_prob * per_chain) / wsum
        # normalize scale so Adam's lr is geometry-free (paper sec. 4)
        chees_grad = chees_grad / (jnp.abs(chees_grad) + 1e-6)
        adam_upd, dlogT = _adam_step(carry.adam, chees_grad)
        log_T_new = carry.log_T + dlogT
        # keep T within the static leapfrog budget
        log_T_new = jnp.clip(
            log_T_new,
            jnp.log(eps),
            jnp.log(eps * max_leapfrog),
        )
        # belt-and-braces: never let a stray non-finite wipe the state
        log_T_new = jnp.where(
            jnp.isfinite(log_T_new), log_T_new, carry.log_T
        )
        adam = jax.tree_util.tree_map(
            lambda new, old: jnp.where(warm, new, old),
            adam_upd,
            carry.adam,
        )
        log_T = jnp.where(warm, log_T_new, carry.log_T)

        # pooled Welford mass across all chains
        wf_upd = _welford_batch(carry.wf, q_new)
        wf = jax.tree_util.tree_map(
            lambda new, old: jnp.where(slow, new, old), wf_upd, carry.wf
        )
        inv_mass = jnp.where(
            at_end, _adapt.welford_variance(wf), carry.inv_mass
        )
        wf_reset = _adapt.welford_init(dim, dtype)
        wf = jax.tree_util.tree_map(
            lambda r, old: jnp.where(at_end, r, old), wf_reset, wf
        )
        da_reset = _adapt.da_init(jnp.exp(da.log_eps))
        da = jax.tree_util.tree_map(
            lambda r, old: jnp.where(at_end, r, old), da_reset, da
        )
        eps_done = jnp.exp(
            jnp.where(da.count > 0, da.log_eps_avg, da.log_eps)
        )
        eps_frozen = jnp.where(freeze, eps_done, carry.eps_frozen)

        out = (q_new, logp_new, accept_prob, n_steps, diverging)
        return (
            _HMCCarry(
                q=q_new,
                logp=logp_new,
                g=g_new,
                da=da,
                adam=adam,
                log_T=log_T,
                wf=wf,
                inv_mass=inv_mass,
                eps_frozen=eps_frozen,
                key=key,
            ),
            out,
        )

    return lax.scan(step, carry, sched)


def run_hmc(
    logdensity_fn: Callable,
    init_params: jax.Array,
    key: jax.Array,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: Optional[int] = None,
    max_leapfrog: int = 1024,
    target_accept: float = 0.8,
    thin: int = 1,
    chain_axis: Optional[jax.sharding.Sharding] = None,
    initial_step_size: float = 0.1,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor=None,
) -> HMCResult:
    """Adaptive fixed-trajectory HMC over a chain fleet.

    Same surface as :func:`celerite2_tpu.inference.run_nuts`; the
    documented fleet path — compile time is flat in the number of
    chains.  ``init_params``: (dim,) (jittered to ``num_chains``) or
    (C, dim).  Pass ``chain_axis`` (a Sharding) to lay chains out
    across a device mesh; the cross-chain adaptation means become
    cross-device reductions automatically.
    """
    init_params = jnp.asarray(init_params)
    if init_params.ndim == 1:
        C = num_chains or 1
        key, kj = jax.random.split(key)
        jitter = 0.1 * jax.random.normal(
            kj, (C, init_params.shape[0]), init_params.dtype
        )
        q0 = init_params[None, :] + jitter
    else:
        q0 = init_params
        C = q0.shape[0]
    dim = q0.shape[1]
    dtype = q0.dtype

    if chain_axis is not None:
        q0 = jax.device_put(q0, chain_axis)

    total = num_warmup + num_samples * thin
    in_slow, win_end = (
        np.asarray(x) for x in _adapt.build_schedule(num_warmup)
    )
    pad = np.zeros(num_samples * thin, dtype=bool)
    sched = (
        np.concatenate([np.ones(num_warmup, bool), pad]),  # is_warm
        np.concatenate([in_slow.astype(bool), pad]),  # in_slow
        np.concatenate([win_end.astype(bool), pad]),  # win_end
        np.eye(1, total, max(num_warmup - 1, 0), dtype=bool)[0],  # freeze
        _halton(total),  # trajectory jitter
    )

    def potential(x):
        return -logdensity_fn(x)

    logp0, g0 = jax.vmap(jax.value_and_grad(potential))(q0)
    eps0 = jnp.asarray(initial_step_size, dtype)
    carry = _HMCCarry(
        q=q0,
        logp=-logp0,
        g=g0,
        da=_adapt.da_init(eps0),
        adam=_adam_init(dtype),
        log_T=jnp.log(eps0),  # ChEES grows T from one step
        wf=_adapt.welford_init(dim, dtype),
        inv_mass=jnp.ones((dim,), dtype),
        eps_frozen=eps0,
        key=key,
    )

    from celerite2_tpu.inference.chunked import drive_chunks

    def segment(c, s):
        return _hmc_segment(
            logdensity_fn,
            c,
            s,
            max_leapfrog=max_leapfrog,
            target_accept=target_accept,
        )

    def seg_stats(c, outs):
        _, _, accs_s, steps_s, divs_s = outs
        return dict(
            mean_accept=float(jnp.mean(accs_s)),
            divergences=int(jnp.sum(divs_s)),
            mean_leapfrogs=float(jnp.mean(steps_s)),
            step_size=float(jnp.exp(c.da.log_eps)),
            trajectory_length=float(jnp.exp(c.log_T)),
        )

    carry, outs = drive_chunks(
        segment,
        carry,
        sched,
        chunk_size=chunk_size,
        checkpoint=checkpoint,
        monitor=monitor,
        stat_fn=seg_stats,
    )
    qs, logps, accs, steps, divs = outs

    sel = slice(num_warmup + thin - 1, total, thin)
    return HMCResult(
        samples=jnp.swapaxes(qs[sel], 0, 1),
        log_prob=jnp.swapaxes(logps[sel], 0, 1),
        accept_prob=jnp.swapaxes(accs[sel], 0, 1),
        num_steps=steps[sel],
        diverging=jnp.swapaxes(divs[sel], 0, 1),
        step_size=carry.eps_frozen,
        trajectory_length=jnp.exp(carry.log_T),
        inv_mass=carry.inv_mass,
    )
