"""The No-U-Turn sampler, written as pure vmappable JAX.

The reference delegates NUTS to PyMC / numpyro (docs/tutorials/
first.ipynb); here sampling is a first-class on-device component so
thousands of chains run as one pjit program (SURVEY.md section 7.5).

Design notes (accelerator-first):

* **Iterative tree doubling** — no recursion; each doubling builds its
  subtree leaf-by-leaf under ``lax.while_loop`` with a static bound, so
  the whole sampler is one compiled program.
* **O(max_depth) memory U-turn checks** — the recursive sampler checks
  the no-U-turn condition on every balanced subtree.  Building leaves
  left-to-right, the subtree of size 2^k ends at leaf i iff
  (i+1) % 2^k == 0 and starts at leaf s = i+1-2^k, which is divisible by
  2^k.  Storing each even leaf s in checkpoint slot ctz(s) (slot D for
  s = 0) guarantees the start state is still present when its subtree
  closes, so D+1 checkpoints suffice instead of 2^D leaves.
* **Multinomial leaf sampling** within subtrees and biased progressive
  sampling across doublings (the modern NUTS variant).
* All state is a flat pytree of arrays, so ``jax.vmap`` scales to
  thousands of chains and ``pjit`` shards them over a mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from celerite2_tpu.inference.adapt import (
    mass_kinetic,
    mass_matvec,
    mass_momentum,
)

__all__ = ["NUTSInfo", "nuts_kernel", "build_nuts_step"]


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array  # mean leaf acceptance statistic
    num_steps: jax.Array  # leapfrog steps taken
    diverging: jax.Array  # bool
    energy: jax.Array  # -logp + kinetic at the accepted state
    turning: jax.Array  # bool: trajectory ended by U-turn


def _leapfrog(grad_fn, q, p, g, eps, inv_mass, direction):
    """One leapfrog step; ``g`` is grad of potential at q."""
    e = eps * direction
    p = p - 0.5 * e * g
    q = q + e * mass_matvec(inv_mass, p)
    g_new = grad_fn(q)
    p = p - 0.5 * e * g_new
    return q, p, g_new


def _ctz(x):
    """Count trailing zeros of a positive int32 (x <= 2^20): the lowest
    set bit is a power of two, so log2 of it is exact in f32."""
    low = (x & -x).astype(jnp.float32)
    return jnp.log2(low).astype(jnp.int32)


def _is_uturn(q_minus, q_plus, p_minus, p_plus, inv_mass):
    dq = q_plus - q_minus
    return jnp.logical_or(
        jnp.dot(dq, mass_matvec(inv_mass, p_minus),
                precision="highest") < 0,
        jnp.dot(dq, mass_matvec(inv_mass, p_plus),
                precision="highest") < 0,
    )


class _TreeState(NamedTuple):
    # proposal (multinomial over the whole trajectory)
    q_cand: jax.Array
    g_cand: jax.Array
    logp_cand: jax.Array
    logw_tree: jax.Array  # logsumexp of leaf weights in the whole tree
    # endpoints of the whole trajectory
    q_left: jax.Array
    p_left: jax.Array
    g_left: jax.Array
    q_right: jax.Array
    p_right: jax.Array
    g_right: jax.Array
    # statistics
    sum_accept: jax.Array
    n_leaves: jax.Array
    diverging: jax.Array
    turning: jax.Array


def nuts_kernel(
    logdensity_fn: Callable,
    q: jax.Array,
    key: jax.Array,
    step_size,
    inv_mass,
    *,
    max_depth: int = 10,
    divergence_threshold: float = 1000.0,
):
    """One NUTS transition.  Returns ``(q_new, logp_new, info)``."""
    dim = q.shape[0]
    D = max_depth

    def potential(x):
        return -logdensity_fn(x)

    pot_and_grad = jax.value_and_grad(potential)
    grad_fn = jax.grad(potential)

    key_mom, key_dirs, key_tree = jax.random.split(key, 3)

    pot0, g0 = pot_and_grad(q)
    p0 = mass_momentum(key_mom, inv_mass, q.dtype)
    h0 = pot0 + mass_kinetic(inv_mass, p0)

    init = _TreeState(
        q_cand=q,
        g_cand=g0,
        logp_cand=-pot0,
        logw_tree=jnp.zeros((), q.dtype),
        q_left=q,
        p_left=p0,
        g_left=g0,
        q_right=q,
        p_right=p0,
        g_right=g0,
        sum_accept=jnp.zeros((), q.dtype),
        n_leaves=jnp.zeros((), jnp.int32),
        diverging=jnp.zeros((), bool),
        turning=jnp.zeros((), bool),
    )

    directions = jax.random.rademacher(key_dirs, (D,), dtype=jnp.int32)
    leaf_keys = jax.random.split(key_tree, D + 1)

    def build_subtree(tree: _TreeState, depth: int):
        """Extend the trajectory by 2^depth leaves in one direction."""
        direction = directions[depth]
        fwd = direction > 0
        n_target = jnp.int32(2**depth)

        # checkpoints for the O(log) U-turn scheme (slot D+1 extras)
        q_ck = jnp.zeros((D + 1, dim), q.dtype)
        p_ck = jnp.zeros((D + 1, dim), q.dtype)

        # subtree-local accumulators
        class Carry(NamedTuple):
            i: jax.Array
            q: jax.Array
            p: jax.Array
            g: jax.Array
            q_ck: jax.Array
            p_ck: jax.Array
            logw_sub: jax.Array
            q_prop: jax.Array
            g_prop: jax.Array
            logp_prop: jax.Array
            sum_acc: jax.Array
            stop: jax.Array  # divergence or internal U-turn
            diverged: jax.Array

        q_start = jnp.where(fwd, tree.q_right, tree.q_left)
        p_start = jnp.where(fwd, tree.p_right, tree.p_left)
        g_start = jnp.where(fwd, tree.g_right, tree.g_left)

        carry0 = Carry(
            i=jnp.zeros((), jnp.int32),
            q=q_start,
            p=p_start,
            g=g_start,
            q_ck=q_ck,
            p_ck=p_ck,
            logw_sub=-jnp.inf,
            q_prop=tree.q_cand,
            g_prop=tree.g_cand,
            logp_prop=tree.logp_cand,
            sum_acc=jnp.zeros((), q.dtype),
            # entering already-terminated: exit immediately (saves the
            # leapfrogs that the outer mask would discard anyway)
            stop=jnp.logical_or(tree.turning, tree.diverging),
            diverged=jnp.zeros((), bool),
        )

        def cond(c: Carry):
            return jnp.logical_and(c.i < n_target, ~c.stop)

        def body(c: Carry):
            q1, p1, g1 = _leapfrog(
                grad_fn,
                c.q,
                c.p,
                c.g,
                step_size,
                inv_mass,
                direction.astype(q.dtype),
            )
            pot1 = potential(q1)
            h1 = pot1 + mass_kinetic(inv_mass, p1)
            delta = h1 - h0
            diverged = jnp.logical_or(
                ~jnp.isfinite(h1), delta > divergence_threshold
            )
            logw = jnp.where(diverged, -jnp.inf, -delta)
            accept = jnp.minimum(1.0, jnp.exp(-delta))
            accept = jnp.where(jnp.isfinite(accept), accept, 0.0)

            # progressive multinomial sampling within the subtree
            new_logw_sub = jnp.logaddexp(c.logw_sub, logw)
            take = (
                jnp.log(
                    jax.random.uniform(
                        jax.random.fold_in(leaf_keys[depth], c.i),
                        dtype=q.dtype,
                    )
                )
                < logw - new_logw_sub
            )
            q_prop = jnp.where(take, q1, c.q_prop)
            g_prop = jnp.where(take, g1, c.g_prop)
            logp_prop = jnp.where(take, -pot1, c.logp_prop)

            # store even leaves in checkpoint slot ctz(i) (slot D if i=0)
            i = c.i
            slot = jnp.where(i == 0, D, _ctz(jnp.maximum(i, 1)))
            is_even = (i % 2) == 0
            q_ck = jnp.where(
                is_even,
                c.q_ck.at[slot].set(q1),
                c.q_ck,
            )
            p_ck = jnp.where(
                is_even,
                c.p_ck.at[slot].set(p1),
                c.p_ck,
            )

            # close balanced subtrees ending at leaf i
            turning = jnp.zeros((), bool)
            ip1 = i + 1
            for k in range(1, D + 1):
                size = jnp.int32(2**k)
                closes = (ip1 % size) == 0
                s = ip1 - size
                s_slot = jnp.where(s == 0, D, _ctz(jnp.maximum(s, 1)))
                qs = q_ck[s_slot]
                ps = p_ck[s_slot]
                # endpoints in time order along the integration direction
                ut = _is_uturn(
                    jnp.where(fwd, qs, q1),
                    jnp.where(fwd, q1, qs),
                    jnp.where(fwd, ps, p1),
                    jnp.where(fwd, p1, ps),
                    inv_mass,
                )
                turning = jnp.logical_or(
                    turning, jnp.logical_and(closes, ut)
                )

            stop = jnp.logical_or(diverged, turning)
            return Carry(
                i=i + 1,
                q=q1,
                p=p1,
                g=g1,
                q_ck=q_ck,
                p_ck=p_ck,
                logw_sub=new_logw_sub,
                q_prop=q_prop,
                g_prop=g_prop,
                logp_prop=logp_prop,
                sum_acc=c.sum_acc + accept,
                stop=stop,
                diverged=jnp.logical_or(c.diverged, diverged),
            )

        c = lax.while_loop(cond, body, carry0)

        # update trajectory endpoints
        q_left = jnp.where(fwd, tree.q_left, c.q)
        p_left = jnp.where(fwd, tree.p_left, c.p)
        g_left = jnp.where(fwd, tree.g_left, c.g)
        q_right = jnp.where(fwd, c.q, tree.q_right)
        p_right = jnp.where(fwd, c.p, tree.p_right)
        g_right = jnp.where(fwd, c.g, tree.g_right)

        subtree_ok = ~c.stop  # full 2^depth leaves, no divergence/U-turn

        # biased progressive sampling across the doubling
        accept_new = (
            jnp.log(
                jax.random.uniform(
                    jax.random.fold_in(leaf_keys[D], depth), dtype=q.dtype
                )
            )
            < c.logw_sub - tree.logw_tree
        )
        use_new = jnp.logical_and(subtree_ok, accept_new)
        q_cand = jnp.where(use_new, c.q_prop, tree.q_cand)
        g_cand = jnp.where(use_new, c.g_prop, tree.g_cand)
        logp_cand = jnp.where(use_new, c.logp_prop, tree.logp_cand)

        # U-turn across the full doubled trajectory
        full_turn = _is_uturn(q_left, q_right, p_left, p_right, inv_mass)

        return _TreeState(
            q_cand=q_cand,
            g_cand=g_cand,
            logp_cand=logp_cand,
            logw_tree=jnp.logaddexp(tree.logw_tree, c.logw_sub),
            q_left=q_left,
            p_left=p_left,
            g_left=g_left,
            q_right=q_right,
            p_right=p_right,
            g_right=g_right,
            sum_accept=tree.sum_accept + c.sum_acc,
            n_leaves=tree.n_leaves + c.i,
            diverging=jnp.logical_or(tree.diverging, c.diverged),
            turning=jnp.logical_or(
                jnp.logical_or(tree.turning, c.stop), full_turn
            ),
        )

    # static unroll over depth keeps `depth` concrete for 2**depth
    tree = init
    for d in range(D):
        keep_going = jnp.logical_and(~tree.turning, ~tree.diverging)
        new_tree = build_subtree(tree, d)
        tree = jax.tree_util.tree_map(
            lambda new, old: jnp.where(keep_going, new, old),
            new_tree,
            tree,
        )

    accept_stat = tree.sum_accept / jnp.maximum(tree.n_leaves, 1)
    info = NUTSInfo(
        accept_prob=accept_stat,
        num_steps=tree.n_leaves,
        diverging=tree.diverging,
        energy=-tree.logp_cand,
        turning=tree.turning,
    )
    return tree.q_cand, tree.logp_cand, info


def build_nuts_step(logdensity_fn, *, max_depth=10):
    """Partial application helper returning a (q, key, eps, inv_mass) ->
    (q', logp, info) transition usable under vmap/scan."""

    def step(q, key, step_size, inv_mass):
        return nuts_kernel(
            logdensity_fn,
            q,
            key,
            step_size,
            inv_mass,
            max_depth=max_depth,
        )

    return step
