"""MAP fitting and checkpoint/restore."""

import jax
import jax.numpy as jnp
import numpy as np

from celerite2_tpu import terms
from celerite2_tpu.gp import gp_compute, gp_log_likelihood
from celerite2_tpu.inference import fit_map, restore_state, save_state


def test_fit_map_quadratic():
    mu = jnp.asarray([1.0, -2.0, 3.0])

    def logp(x):
        return -0.5 * jnp.sum((x - mu) ** 2 * jnp.asarray([1.0, 4.0, 0.25]))

    res = fit_map(logp, jnp.zeros(3), num_steps=100)
    np.testing.assert_allclose(np.asarray(res.params), np.asarray(mu), atol=1e-6)
    assert bool(res.converged)


def test_fit_map_gp_hyperparams():
    rng = np.random.default_rng(10)
    N = 120
    t = np.sort(rng.uniform(0, 20, N))
    yerr = np.full(N, 0.3)

    import celerite2_tpu as c2

    true_kernel = terms.SHOTerm(sigma=1.2, rho=4.0, tau=3.0)
    gp = c2.GaussianProcess(true_kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(2)))

    def logp(theta):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        )
        return gp_log_likelihood(gp_compute(k, t, yerr=yerr), y)

    init = jnp.log(jnp.asarray([1.0, 3.0, 2.0]))
    res = fit_map(logp, init, num_steps=200)
    # MAP improves on the init and is finite
    assert float(res.log_prob) > float(logp(init))
    assert np.all(np.isfinite(np.asarray(res.params)))
    # objective increased monotonically-ish (final > first)
    tr = np.asarray(res.trace)
    assert tr[-1] >= tr[0]


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "q": jnp.arange(12.0).reshape(3, 4),
        "key": jax.random.PRNGKey(0),
        "step": jnp.asarray(7),
    }
    path = str(tmp_path / "ckpt")
    save_state(path, state)
    restored = restore_state(path, template=state)
    for k in state:
        np.testing.assert_array_equal(
            np.asarray(restored[k]), np.asarray(state[k])
        )


def test_chunked_nuts_resumes_bit_compatibly(tmp_path):
    """A chunked NUTS run killed mid-way resumes from the last chunk and
    produces exactly the samples of an uninterrupted chunked run."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from celerite2_tpu.inference import CheckpointManager, run_nuts

    def logp(q):
        return -0.5 * jnp.sum(q**2)

    kwargs = dict(
        num_warmup=40,
        num_samples=40,
        num_chains=2,
        max_depth=5,
        chunk_size=20,
    )
    key = jax.random.PRNGKey(0)
    init = jnp.zeros(2)

    ref = run_nuts(logp, init, key, **kwargs)

    # run 1: only the first two chunks complete (simulated kill)
    class Killed(Exception):
        pass

    calls = []

    def dying_monitor(step, stats):
        calls.append(step)
        if len(calls) == 2:
            raise Killed

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    try:
        run_nuts(
            logp, init, key, **kwargs, checkpoint=mgr,
            monitor=dying_monitor,
        )
        raise AssertionError("monitor should have killed the run")
    except Killed:
        pass
    mgr.close()

    # run 2: restart with a fresh manager over the same directory
    mgr2 = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    res = run_nuts(logp, init, key, **kwargs, checkpoint=mgr2)
    mgr2.close()

    np.testing.assert_array_equal(
        np.asarray(res.samples), np.asarray(ref.samples)
    )
    np.testing.assert_array_equal(
        np.asarray(res.log_prob), np.asarray(ref.log_prob)
    )


def test_chunked_hmc_monitor_stats(tmp_path):
    """run_hmc chunking emits live stats through sampling_monitor."""
    import jax
    import jax.numpy as jnp

    from celerite2_tpu.inference import run_hmc
    from celerite2_tpu.utils.observe import sampling_monitor

    def logp(q):
        return -0.5 * jnp.sum(q**2)

    with sampling_monitor(log_every=0) as (emit, records):
        run_hmc(
            logp,
            jnp.zeros(2),
            jax.random.PRNGKey(0),
            num_warmup=30,
            num_samples=30,
            num_chains=4,
            max_leapfrog=16,
            chunk_size=20,
            monitor=emit,
        )
    assert len(records) == 3  # ceil(60 / 20)
    steps = [s for s, _ in records]
    assert steps == [20, 40, 60]
    for _, stats in records:
        assert 0.0 <= stats["mean_accept"] <= 1.0
        assert stats["step_size"] > 0


def test_drive_chunks_retries_after_worker_crash():
    """A chunk whose device execution raises mid-run is retried from the
    host snapshot and the run completes with exactly the fault-free
    results (unattended survival of device faults).

    The fault is injected through an io_callback that raises on one
    specific invocation — the same surface (a runtime error escaping the
    executed computation) as a real device fault.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import io_callback

    from celerite2_tpu.inference.chunked import drive_chunks

    calls = {"n": 0, "fail_at": -1}

    def passthrough(x):
        calls["n"] += 1
        if calls["n"] == calls["fail_at"]:
            raise RuntimeError("injected device fault")
        return np.asarray(x)

    def seg_fn(carry, sched):
        (steps,) = sched

        def body(c, s):
            c = c + s
            return c, c

        carry, outs = jax.lax.scan(body, carry, steps)
        carry = io_callback(
            passthrough,
            jax.ShapeDtypeStruct(carry.shape, carry.dtype),
            carry,
            ordered=True,
        )
        return carry, outs

    sched = (np.arange(1.0, 13.0, dtype=np.float32),)
    carry0 = jnp.zeros(())

    ref_carry, ref_outs = drive_chunks(
        seg_fn, carry0, sched, chunk_size=4
    )

    # fault on the third segment execution; expect one retry, same result
    calls["n"] = 0
    calls["fail_at"] = 3
    retries = []
    carry, outs = drive_chunks(
        seg_fn,
        carry0,
        sched,
        chunk_size=4,
        max_retries=2,
        on_retry=lambda i, k, e: retries.append((i, k)),
    )
    assert retries == [(2, 1)]
    np.testing.assert_array_equal(np.asarray(carry), np.asarray(ref_carry))
    np.testing.assert_array_equal(np.asarray(outs), np.asarray(ref_outs))

    # retries exhausted -> the original error surfaces
    calls["n"] = 0
    calls["fail_at"] = 2
    try:
        drive_chunks(seg_fn, carry0, sched, chunk_size=4, max_retries=0)
        raise AssertionError("expected the injected crash to surface")
    except Exception as exc:  # noqa: BLE001 - runtime wraps the error
        assert "injected device fault" in str(exc)
