"""Hand-derived adjoints vs finite differences / autodiff-of-reference.

Pattern of reference python/test/test_backprop.py:9-42 (fd Jacobians,
atol 1e-3) plus jax.test_util.check_grads as in test_jax_ops.py:18-37.
The strongest oracle available here: autodiff through the *dense*
linear-algebra formulation, which exercises every input including the
time gradients ``bt`` (reference reverse.hpp:70-74, internal.hpp:236-240).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

from celerite2_tpu import ops
from celerite2_tpu.config import set_config
from celerite2_tpu.testing import get_matrices


@pytest.fixture(
    autouse=True,
    # the assoc arm re-derives every gradient through the prefix
    # engine's much larger graphs (~3x the compile time of the scan
    # arm); the fast tier keeps the scan-arm oracle checks, and
    # test_assoc_geometry.py covers the engine paths
    params=["scan", pytest.param("assoc", marks=pytest.mark.slow)],
)
def _backend(request):
    set_config(backend=request.param)
    yield
    set_config(backend="auto")


def _dense_L(t, c, U, W):
    tau = t[:, None] - t[None, :]
    trans = jnp.exp(-c[None, None, :] * jnp.abs(tau)[:, :, None])
    L = jnp.einsum("nj,mj,nmj->nm", U, W, trans)
    N = t.shape[0]
    return jnp.tril(L, k=-1) + jnp.eye(N, dtype=t.dtype)


def _args(size=30):
    t, c, a, U, V, Y = get_matrices(size=size)
    return tuple(map(jnp.asarray, (t, c, a, U, V, Y)))


def test_factor_grads_vs_dense():
    t, c, a, U, V, Y = _args()

    def via_ops(t, c, a, U, V):
        d, W = ops.factor(t, c, a, U, V)
        return jnp.sum(jnp.log(d)) + jnp.sum(jnp.sin(W))

    def via_dense(t, c, a, U, V):
        # log det is representation-independent: compare the structured
        # factor's d-gradients against autodiff through dense Cholesky.
        K = ops.to_dense(t, c, a, U, V)
        L = jnp.linalg.cholesky(K)
        return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

    g1 = jax.grad(
        lambda *args: jnp.sum(jnp.log(ops.factor(*args)[0])),
        argnums=(0, 1, 2, 3, 4),
    )(t, c, a, U, V)
    g2 = jax.grad(via_dense, argnums=(0, 1, 2, 3, 4))(t, c, a, U, V)
    for x1, x2, name in zip(g1, g2, ["t", "c", "a", "U", "V"]):
        np.testing.assert_allclose(
            x1, x2, rtol=1e-6, atol=1e-8, err_msg=f"grad wrt {name}"
        )

    # and the full (d, W)-dependent function via finite differences
    check_grads(via_ops, (t, c, a, U, V), order=1, modes=["rev"],
                atol=1e-4, rtol=1e-4)


def test_solve_lower_grads():
    t, c, a, U, V, Y = _args()
    d, W = ops.factor(t, c, a, U, V)

    def via_ops(t, c, U, W, Y):
        return jnp.sum(jnp.square(ops.solve_lower(t, c, U, W, Y)))

    def via_dense(t, c, U, W, Y):
        L = _dense_L(t, c, U, W)
        return jnp.sum(jnp.square(jnp.linalg.solve(L, Y)))

    g1 = jax.grad(via_ops, argnums=(0, 1, 2, 3, 4))(t, c, U, W, Y)
    g2 = jax.grad(via_dense, argnums=(0, 1, 2, 3, 4))(t, c, U, W, Y)
    for x1, x2, name in zip(g1, g2, ["t", "c", "U", "W", "Y"]):
        np.testing.assert_allclose(
            x1, x2, rtol=1e-6, atol=1e-8, err_msg=f"grad wrt {name}"
        )


def test_solve_upper_grads():
    t, c, a, U, V, Y = _args()
    d, W = ops.factor(t, c, a, U, V)

    def via_ops(t, c, U, W, Y):
        return jnp.sum(jnp.square(ops.solve_upper(t, c, U, W, Y)))

    def via_dense(t, c, U, W, Y):
        L = _dense_L(t, c, U, W)
        return jnp.sum(jnp.square(jnp.linalg.solve(L.T, Y)))

    g1 = jax.grad(via_ops, argnums=(0, 1, 2, 3, 4))(t, c, U, W, Y)
    g2 = jax.grad(via_dense, argnums=(0, 1, 2, 3, 4))(t, c, U, W, Y)
    for x1, x2, name in zip(g1, g2, ["t", "c", "U", "W", "Y"]):
        np.testing.assert_allclose(
            x1, x2, rtol=1e-6, atol=1e-8, err_msg=f"grad wrt {name}"
        )


def test_matmul_grads():
    t, c, a, U, V, Y = _args()

    def low_ops(t, c, U, V, Y):
        return jnp.sum(jnp.sin(ops.matmul_lower(t, c, U, V, Y)))

    def low_dense(t, c, U, V, Y):
        L = _dense_L(t, c, U, V) - jnp.eye(t.shape[0], dtype=t.dtype)
        return jnp.sum(jnp.sin(L @ Y))

    g1 = jax.grad(low_ops, argnums=(0, 1, 2, 3, 4))(t, c, U, V, Y)
    g2 = jax.grad(low_dense, argnums=(0, 1, 2, 3, 4))(t, c, U, V, Y)
    for x1, x2, name in zip(g1, g2, ["t", "c", "U", "V", "Y"]):
        np.testing.assert_allclose(
            x1, x2, rtol=1e-6, atol=1e-8, err_msg=f"lower grad wrt {name}"
        )

    def up_ops(t, c, U, V, Y):
        return jnp.sum(jnp.sin(ops.matmul_upper(t, c, U, V, Y)))

    def up_dense(t, c, U, V, Y):
        L = _dense_L(t, c, U, V) - jnp.eye(t.shape[0], dtype=t.dtype)
        return jnp.sum(jnp.sin(L.T @ Y))

    g1 = jax.grad(up_ops, argnums=(0, 1, 2, 3, 4))(t, c, U, V, Y)
    g2 = jax.grad(up_dense, argnums=(0, 1, 2, 3, 4))(t, c, U, V, Y)
    for x1, x2, name in zip(g1, g2, ["t", "c", "U", "V", "Y"]):
        np.testing.assert_allclose(
            x1, x2, rtol=1e-6, atol=1e-8, err_msg=f"upper grad wrt {name}"
        )


def test_grads_under_jit_and_vmap():
    t, c, a, U, V, Y = _args(size=20)

    @jax.jit
    def loglike(a):
        d, W = ops.factor(t, c, a, U, V)
        z = ops.solve_lower(t, c, U, W, Y)
        return -0.5 * (jnp.sum(jnp.log(d)) + jnp.sum(z**2 / d[:, None]))

    g = jax.grad(loglike)(a)
    assert np.all(np.isfinite(g))

    gv = jax.vmap(jax.grad(loglike))(jnp.stack([a, a * 1.1]))
    np.testing.assert_allclose(gv[0], g, rtol=1e-10)
