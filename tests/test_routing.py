"""Config validation and tier routing of the op dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celerite2_tpu import terms
from celerite2_tpu.config import Config, get_config, set_config
from celerite2_tpu.gp import gp_loglik
from celerite2_tpu.ops.dispatch import _backend


@pytest.fixture
def restore_config():
    prior = get_config()
    yield
    set_config(**dataclasses.asdict(prior))


def test_config_field_count():
    assert len(dataclasses.fields(Config)) == 8


@pytest.mark.parametrize("backend", ["pallas", "cuda", "Scan"])
def test_unknown_backend_raises(restore_config, backend):
    before = get_config()
    with pytest.raises(ValueError, match="backend"):
        set_config(backend=backend)
    assert get_config() == before


@pytest.mark.parametrize(
    "field",
    ["block_size", "pallas_threshold", "planes", "planes_max_planes",
     "fused_slab"],
)
def test_removed_field_raises(restore_config, field):
    with pytest.raises(TypeError):
        set_config(**{field: 1})


def test_auto_routing(restore_config):
    set_config(backend="auto", assoc_threshold=1024)
    tracer_seen = []

    def probe(x):
        tracer_seen.append((_backend(1023, x), _backend(1024, x)))
        return x

    jax.jit(probe)(jnp.zeros(3))
    assert tracer_seen == [("scan", "assoc")]
    # eager (concrete) calls stay on the scan tier at any N
    assert _backend(10**6, np.zeros(3)) == "scan"
    set_config(assoc_threshold=64)
    assert _backend(64) == "assoc" and _backend(63) == "scan"


def _vmapped_value_and_grad(t, y, yerr, thetas):
    def ll(theta):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )
        return gp_loglik(k, t, y, yerr=yerr)

    return jax.jit(jax.vmap(jax.value_and_grad(ll)))(thetas)


@pytest.mark.parametrize("engine", ["two_level", "associative_scan"])
def test_vmapped_loglik_grad_assoc_vs_scan(restore_config, engine):
    """A batch of chains (vmap) takes the assoc tier's batched paths;
    value and gradient must equal the scan tier's."""
    rng = np.random.default_rng(3)
    N = 150
    t = jnp.asarray(np.sort(rng.uniform(0, 30, N)))
    yerr = jnp.full(N, 0.2)
    y = jnp.asarray(np.sin(np.asarray(t)) + 0.2 * rng.normal(size=N))
    thetas = jnp.asarray(
        np.log([[1.0, 3.0, 2.0], [0.7, 5.0, 1.0], [1.4, 2.0, 4.0]])
    )
    set_config(backend="scan")
    v_ref, g_ref = _vmapped_value_and_grad(t, y, yerr, thetas)
    set_config(backend="assoc", engine=engine, engine_block=16)
    v, g = _vmapped_value_and_grad(t, y, yerr, thetas)
    np.testing.assert_allclose(v, v_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-8, atol=1e-10)
