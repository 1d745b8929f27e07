"""The NUTS chain runner: all chains, warmup and sampling in one scan.

``run_nuts`` drives ``C`` chains as one compiled program: the chain axis
is a ``vmap`` axis, so sharding it over a device mesh (pjit) is how the
framework scales to thousands of chains (SURVEY.md section 2.4 item 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from celerite2_tpu.inference import adapt as _adapt
from celerite2_tpu.inference.nuts import NUTSInfo, nuts_kernel

__all__ = ["NUTSResult", "run_nuts", "warmup_and_sample"]


class NUTSResult(NamedTuple):
    samples: jax.Array  # (C, num_samples, dim)
    log_prob: jax.Array  # (C, num_samples)
    accept_prob: jax.Array  # (C, num_samples)
    num_steps: jax.Array  # (C, num_samples)
    diverging: jax.Array  # (C, num_samples) bool
    step_size: jax.Array  # (C,)
    inv_mass: jax.Array  # (C, dim) diagonal metric or (C, dim, dim) dense


def _find_reasonable_step_size(logdensity_fn, q, key, inv_mass):
    """Double/halve eps until the one-step acceptance crosses 0.5
    (standard NUTS initialization heuristic)."""

    def potential(x):
        return -logdensity_fn(x)

    grad_fn = jax.grad(potential)
    p = _adapt.mass_momentum(key, inv_mass, q.dtype)
    h0 = potential(q) + _adapt.mass_kinetic(inv_mass, p)

    def accept_at(eps):
        g = grad_fn(q)
        p1 = p - 0.5 * eps * g
        q1 = q + eps * _adapt.mass_matvec(inv_mass, p1)
        p1 = p1 - 0.5 * eps * grad_fn(q1)
        h1 = potential(q1) + _adapt.mass_kinetic(inv_mass, p1)
        return jnp.where(jnp.isfinite(h1), jnp.exp(h0 - h1), 0.0)

    a0 = accept_at(jnp.asarray(1.0, q.dtype))
    direction = jnp.where(a0 > 0.5, 1.0, -1.0)

    def cond(state):
        eps, i = state
        a = accept_at(eps)
        keep = jnp.where(direction > 0, a > 0.5, a < 0.5)
        return jnp.logical_and(keep, i < 60)

    def body(state):
        eps, i = state
        return eps * jnp.where(direction > 0, 2.0, 0.5), i + 1

    eps, _ = lax.while_loop(
        cond, body, (jnp.asarray(1.0, q.dtype), jnp.zeros((), jnp.int32))
    )
    return eps


def warmup_and_sample(
    logdensity_fn: Callable,
    q0: jax.Array,
    key: jax.Array,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
):
    """Single-chain warmup + sampling."""
    outs = _run_chains(
        logdensity_fn,
        q0[None],
        key[None],
        num_warmup=num_warmup,
        num_samples=num_samples,
        max_depth=max_depth,
        target_accept=target_accept,
        thin=thin,
    )
    return tuple(o[0] for o in outs)


def _run_chains(
    logdensity_fn: Callable,
    q0: jax.Array,
    keys: jax.Array,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    dense_mass: bool = False,
):
    """All chains in ONE scan over steps with a vmapped step body.

    Two structural choices keep XLA compile time bounded:
      * warmup and sampling share a single ``lax.scan`` whose
        adaptation updates are masked by a static per-step schedule
        (separate scans instantiate the large NUTS tree program twice);
      * chains are vmapped over the *step body* inside the scan,
        ``scan(vmap(step))``, NOT ``vmap(scan(step))`` — vmapping the
        whole sampler batches every while-loop of the tree program.
    """
    C, dim = q0.shape
    dtype = q0.dtype
    total = num_warmup + num_samples * thin

    # static per-step schedule as numpy: concrete values captured in
    # traced code must be HLO literals (utils.misc.asarr)
    in_slow, win_end = (
        np.asarray(x) for x in _adapt.build_schedule(num_warmup)
    )
    pad = np.zeros(num_samples * thin, dtype=bool)
    in_slow = np.concatenate([in_slow.astype(bool), pad])
    win_end = np.concatenate([win_end.astype(bool), pad])
    is_warm = np.concatenate(
        [np.ones(num_warmup, dtype=bool), pad]
    )
    last_warm = np.zeros(total, dtype=bool)
    if num_warmup > 0:
        last_warm[num_warmup - 1] = True

    keys, keys_eps = jax.vmap(jax.random.split, out_axes=1)(keys)
    if dense_mass:
        inv_mass0 = jnp.broadcast_to(
            jnp.eye(dim, dtype=dtype), (C, dim, dim)
        )
    else:
        inv_mass0 = jnp.ones((C, dim), dtype)
    eps0 = jax.vmap(
        lambda q, k, m: _find_reasonable_step_size(
            logdensity_fn, q, k, m
        )
    )(q0, keys_eps, inv_mass0)
    da0 = jax.vmap(_adapt.da_init)(eps0)

    def step_one(inp, carry):
        q, da, wf, inv_mass, eps_frozen, key = carry
        warm, slow, at_end, freeze = inp
        key, k = jax.random.split(key)
        eps = jnp.where(warm, jnp.exp(da.log_eps), eps_frozen)
        q, logp, info = nuts_kernel(
            logdensity_fn, q, k, eps, inv_mass, max_depth=max_depth
        )

        # ---- adaptation (warmup steps only, branchless)
        da_upd = _adapt.da_update(
            da, info.accept_prob, target=target_accept
        )
        da = jax.tree_util.tree_map(
            lambda new, old: jnp.where(warm, new, old), da_upd, da
        )
        wf_upd = _adapt.welford_update(wf, q)
        wf = jax.tree_util.tree_map(
            lambda new, old: jnp.where(slow, new, old), wf_upd, wf
        )
        # at the end of a slow window: set mass, reset welford, re-init
        # dual averaging around the current step size
        new_inv_mass = _adapt.welford_variance(wf)
        inv_mass = jnp.where(at_end, new_inv_mass, inv_mass)
        wf_reset = _adapt.welford_init(dim, dtype, dense=dense_mass)
        wf = jax.tree_util.tree_map(
            lambda r, old: jnp.where(at_end, r, old), wf_reset, wf
        )
        da_reset = _adapt.da_init(jnp.exp(da.log_eps))
        da = jax.tree_util.tree_map(
            lambda r, old: jnp.where(at_end, r, old), da_reset, da
        )
        # freeze the averaged step size when warmup ends
        eps_done = jnp.exp(
            jnp.where(da.count > 0, da.log_eps_avg, da.log_eps)
        )
        eps_frozen = jnp.where(freeze, eps_done, eps_frozen)

        out = (q, logp, info.accept_prob, info.num_steps, info.diverging)
        return (q, da, wf, inv_mass, eps_frozen, key), out

    def step(carry, inp):
        import functools

        return jax.vmap(functools.partial(step_one, inp))(carry)

    wf0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape),
        _adapt.welford_init(dim, dtype, dense=dense_mass),
    )
    carry = (q0, da0, wf0, inv_mass0, eps0, keys)

    def segment(carry, sched_slice):
        return lax.scan(step, carry, sched_slice)

    def seg_stats(carry, outs):
        _, da, _, _, eps_frozen, _ = carry
        _, _, accs_s, steps_s, divs_s = outs
        return dict(
            mean_accept=float(jnp.mean(accs_s)),
            divergences=int(jnp.sum(divs_s)),
            mean_leapfrogs=float(jnp.mean(steps_s)),
            step_size=float(jnp.mean(jnp.exp(da.log_eps))),
        )

    from celerite2_tpu.inference.chunked import drive_chunks

    carry, outs = drive_chunks(
        segment,
        carry,
        (is_warm, in_slow, win_end, last_warm),
        chunk_size=chunk_size,
        checkpoint=checkpoint,
        monitor=monitor,
        stat_fn=seg_stats,
    )
    _, _, _, inv_mass, eps_final, _ = carry

    # keep every thin-th post-warmup draw, chain-major
    sel = slice(num_warmup + thin - 1, total, thin)
    samples, logps, accs, steps, divs = (
        jnp.swapaxes(o[sel], 0, 1) for o in outs
    )
    return (
        samples,
        logps,
        accs,
        steps,
        divs,
        eps_final,
        inv_mass,
    )


def run_nuts(
    logdensity_fn: Callable,
    init_params: jax.Array,
    key: jax.Array,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: Optional[int] = None,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    chain_axis: Optional[jax.sharding.Sharding] = None,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    dense_mass: bool = False,
) -> NUTSResult:
    """Run NUTS over one or many chains.

    ``dense_mass=True`` adapts a full (dim, dim) covariance metric
    during the slow windows (role of PyMC/numpyro ``dense_mass``);
    momenta are drawn via a small-dim unrolled Cholesky (no solver
    custom call).  Default is the diagonal metric.

    ``init_params``: (dim,) or (C, dim).  If (dim,) and ``num_chains``
    is given, chains start from jittered copies.  Pass ``chain_axis``
    (a Sharding) to lay chains out across a device mesh.

    ``chunk_size`` splits the run into separately-executed segments
    (one compiled program reused); between segments ``monitor(step,
    stats)`` receives live acceptance/divergence/step-size stats and
    ``checkpoint`` (a ``CheckpointManager``) persists the run so a
    killed job resumes bit-compatibly from the last completed chunk.
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

    keys = jax.random.split(key, C)
    if chain_axis is not None:
        q0 = jax.device_put(q0, chain_axis)
        keys = jax.device_put(keys, chain_axis)

    samples, logps, accs, steps, divs, eps, inv_mass = _run_chains(
        logdensity_fn,
        q0,
        keys,
        num_warmup=num_warmup,
        num_samples=num_samples,
        max_depth=max_depth,
        target_accept=target_accept,
        thin=thin,
        chunk_size=chunk_size,
        checkpoint=checkpoint,
        monitor=monitor,
        dense_mass=dense_mass,
    )
    return NUTSResult(
        samples=samples,
        log_prob=logps,
        accept_prob=accs,
        num_steps=steps,
        diverging=divs,
        step_size=eps,
        inv_mass=inv_mass,
    )
