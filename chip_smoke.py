"""On-card smoke test of the GP hot path.

    python chip_smoke.py           # phases 0-5 on one GPU
    python chip_smoke.py --four    # only the four-GPU path and its reference

Drives the library through its user entry points at full width:
log-likelihood + gradient of a SHOTerm model at N=1e5 (the sampler inner
loop), the GaussianProcess API, the ChEES-HMC fleet and the f64 island.
Each phase prints one JSON line and checks its results against the
plain reference (the ``scan`` tier, in float64 where stated).  The last
line is ``{"ok": true, "device": {...}}``.  The script exits non-zero and
prints no result when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Full-width sizes (the bench.py headline and fleet).
N_HOT = 100_000
CHAIN_LEN = 100
N_PREDICT = 1_000
N_FLEET, FLEET_CHAINS, FLEET_STEPS = 30_000, 64, 20
N_ISLAND = 10_000
N_FOUR, FOUR_CHAINS = 400_000, 256

# Parity bounds against the reference (see README "Tests").
TOL_F32_VALUE = 1e-3
TOL_F32_GRAD = 1e-2
TOL_F64 = 1e-9
TOL_ISLAND = 1e-6
TOL_PREDICT = 1e-3
TOL_TRANSITION = 1e-5


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def progress(msg: str) -> None:
    """A timestamped progress note on stderr (stdout carries results)."""
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def card_lines() -> list[str]:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpu(count: int = 1):
    """The first ``count`` devices, which must be GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r})"
        )
    if len(devs) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}"
        )
    return devs[:count]


@contextlib.contextmanager
def configured(**fields):
    """``set_config(**fields)`` for the block, then the prior config."""
    from celerite2_tpu.config import get_config, set_config

    prior = get_config()
    set_config(**fields)
    try:
        yield
    finally:
        set_config(**dataclasses.asdict(prior))


def rel(a, ref) -> float:
    """Norm-relative difference ||a - ref|| / ||ref||."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def check(name: str, err: float, bound: float) -> None:
    if not err <= bound:
        raise AssertionError(f"{name}: relative error {err!r} > {bound!r}")


def _block(x):
    import jax

    return jax.block_until_ready(x)


# ------------------------------------------------------------- models


def bench_data(n: int, seed: int = 42):
    """The bench.py headline data: t, yerr, y, theta (float64 numpy)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1000, n))
    yerr = np.full(n, 0.25)
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=n)
    theta = np.log([1.0, 5.0, 3.0])
    return t, yerr, y, theta


def sho_kernel(theta):
    import jax.numpy as jnp

    from celerite2_tpu import terms

    return terms.SHOTerm(
        sigma=jnp.exp(theta[0]), rho=jnp.exp(theta[1]), tau=jnp.exp(theta[2])
    )


def sho_loglik(theta, t, yerr, y):
    from celerite2_tpu.gp import gp_loglik

    return gp_loglik(sho_kernel(theta), t, y, yerr=yerr)


def fleet_model(n: int):
    """The bench.py fleet: two SHOTerms (J=4), data drawn from the prior."""
    import jax
    import jax.numpy as jnp

    from celerite2_tpu import GaussianProcess, terms
    from celerite2_tpu.gp import gp_loglik

    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 300, n)).astype(np.float32)
    yerr = np.full(n, 0.2, np.float32)
    kernel = terms.SHOTerm(sigma=1.0, rho=8.0, tau=20.0) + terms.SHOTerm(
        sigma=0.6, rho=2.0, Q=0.3
    )
    gp = GaussianProcess(kernel, t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(5)), np.float32)

    def logpost(theta):
        k = terms.SHOTerm(
            sigma=jnp.exp(theta[0]),
            rho=jnp.exp(theta[1]),
            tau=jnp.exp(theta[2]),
        ) + terms.SHOTerm(
            sigma=jnp.exp(theta[3]), rho=jnp.exp(theta[4]), Q=0.3
        )
        return gp_loglik(k, t, y, yerr=yerr) - 0.5 * jnp.sum(
            (theta / 2.0) ** 2
        )

    init = np.asarray(
        [0.0, np.log(5.0), np.log(10.0), -0.5, np.log(3.0)], np.float32
    )
    return logpost, init


def _tiers(compiled) -> list[str]:
    """``op.tier`` scopes present in a compiled program: the routing
    ``ops/dispatch.py:_backend`` chose while tracing it."""
    text = compiled.as_text()
    return sorted(set(re.findall(r"celerite2\.(\w+\.(?:scan|assoc))", text)))


def _chained(chain_len: int):
    """``chain_len`` dependent value+grad evaluations inside one jit, the
    way a sampler consumes the log-density (bench.py)."""
    import jax

    def many(theta, t, yerr, y):
        def body(carry, _):
            v, g = jax.value_and_grad(sho_loglik)(carry, t, yerr, y)
            return carry + 1e-9 * g, v

        _, vs = jax.lax.scan(body, theta, None, length=chain_len)
        return vs[-1]

    return jax.jit(many)


def _timed_compile(fn, *args):
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def reference_f64(theta, t, yerr, y, *, backend="scan"):
    """Value and gradient in float64 on the given tier."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True), configured(backend=backend):
        args = tuple(jnp.asarray(x, jnp.float64) for x in (theta, t, yerr, y))
        v, g = jax.jit(jax.value_and_grad(sho_loglik))(*args)
        return float(v), np.asarray(g)


# ------------------------------------------------------------- phases


def phase_hot_f32(n: int = N_HOT, chain_len: int = CHAIN_LEN, reps: int = 3):
    """Phase 1: jit(value_and_grad(gp_loglik)) in float32, config defaults,
    against the scan tier in float64."""
    import jax
    import jax.numpy as jnp

    t, yerr, y, theta = bench_data(n)
    with jax.enable_x64(False), configured():
        args = tuple(jnp.asarray(x, jnp.float32) for x in (theta, t, yerr, y))
        vg = jax.jit(jax.value_and_grad(sho_loglik))
        compiled, compile_s = _timed_compile(vg, *args)
        v, g = _block(compiled(*args))
        many, chain_compile_s = _timed_compile(_chained(chain_len), *args)
        np.asarray(_block(many(*args)))  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(_block(many(*args)))
        ms = 1e3 * (time.perf_counter() - t0) / (reps * chain_len)
        tiers = _tiers(compiled)
        auto = "+".join(sorted({scope.split(".")[-1] for scope in tiers}))
    v_ref, g_ref = reference_f64(theta, t, yerr, y)
    err_v = abs(float(v) - v_ref) / abs(v_ref)
    err_g = rel(g, g_ref)
    record = dict(
        phase="hot_f32", n=n, auto_tier=auto, tiers=tiers,
        compile_s=compile_s, chain_compile_s=chain_compile_s,
        chain_len=chain_len, ms_per_eval=ms, value=float(v),
        value_ref_f64=v_ref, value_rel_err=err_v, grad_rel_err=err_g,
    )
    emit(**record)
    check("hot_f32 value", err_v, TOL_F32_VALUE)
    check("hot_f32 grad", err_g, TOL_F32_GRAD)
    return record


def phase_hot_f64(n: int = N_HOT):
    """Phase 2: the same model in float64, auto routing vs the scan tier."""
    import jax
    import jax.numpy as jnp

    t, yerr, y, theta = bench_data(n)
    with jax.enable_x64(True), configured():
        args = tuple(jnp.asarray(x, jnp.float64) for x in (theta, t, yerr, y))
        vg = jax.jit(jax.value_and_grad(sho_loglik))
        compiled, compile_s = _timed_compile(vg, *args)
        v, g = _block(compiled(*args))
        tiers = _tiers(compiled)
    v_ref, g_ref = reference_f64(theta, t, yerr, y)
    err_v = abs(float(v) - v_ref) / abs(v_ref)
    err_g = rel(g, g_ref)
    record = dict(
        phase="hot_f64", n=n, tiers=tiers, compile_s=compile_s,
        value_rel_err=err_v, grad_rel_err=err_g,
    )
    emit(**record)
    check("hot_f64 value", err_v, TOL_F64)
    check("hot_f64 grad", err_g, TOL_F64)
    return record


def _eager_loglik(kernel, t, yerr, y):
    """Wall times of an eager GaussianProcess build and log_likelihood:
    first call (with its compiles) and a warm repeat."""
    from celerite2_tpu import GaussianProcess

    out = {}
    for label in ("first", "warm"):
        t0 = time.perf_counter()
        gp = GaussianProcess(kernel, t=t, yerr=yerr)
        _block(gp.state.d)
        t1 = time.perf_counter()
        ll = float(gp.log_likelihood(y))
        t2 = time.perf_counter()
        out[label] = dict(compute_s=t1 - t0, log_likelihood_s=t2 - t1)
    return gp, ll, out


def phase_gp_api(n: int = N_HOT, m: int = N_PREDICT, draws: int = 8):
    """Phase 3: GaussianProcess log_likelihood, predict and pathwise
    sampling, called eagerly as a user would."""
    import jax

    from celerite2_tpu import GaussianProcess, terms

    t, yerr, y, _ = bench_data(n)
    t32, yerr32, y32 = (np.asarray(x, np.float32) for x in (t, yerr, y))
    grid = np.linspace(t32[0], t32[-1], m).astype(np.float32)
    kernel = terms.SHOTerm(sigma=1.0, rho=5.0, tau=3.0)
    eager, gps = {}, {}
    with jax.enable_x64(False):
        # eager calls route to the scan tier under the default config;
        # the assoc numbers show what that routing costs or saves
        for backend in ("scan", "assoc"):
            with configured(backend=backend):
                gps[backend], ll_b, eager[backend] = _eager_loglik(
                    kernel, t32, yerr32, y32
                )
            eager[backend]["value"] = ll_b
        gp, ll = gps["scan"], eager["scan"]["value"]
        with configured():
            t0 = time.perf_counter()
            mu, var = _block(gp.predict(y32, t=grid, return_var=True))
            predict_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            samples = _block(
                gp.condition(y32, t=grid).sample_pathwise(
                    jax.random.PRNGKey(0), shape=(draws,)
                )
            )
            sample_s = time.perf_counter() - t0
    with jax.enable_x64(True), configured(backend="scan"):
        gp64 = GaussianProcess(
            kernel, t=t32.astype(np.float64), yerr=yerr32.astype(np.float64)
        )
        mu_ref = np.asarray(gp64.predict(y32.astype(np.float64), t=grid))
    finite = bool(
        np.isfinite(ll)
        and np.all(np.isfinite(np.asarray(mu)))
        and np.all(np.isfinite(np.asarray(var)))
        and np.all(np.isfinite(np.asarray(samples)))
    )
    err_mu = rel(mu, mu_ref)
    record = dict(
        phase="gp_api", n=n, m=m, eager=eager, predict_s=predict_s,
        sample_pathwise_s=sample_s, sample_shape=list(np.shape(samples)),
        finite=finite, mean_rel_err=err_mu,
    )
    emit(**record)
    if not finite:
        raise AssertionError("gp_api: non-finite output")
    if np.shape(samples) != (draws, m) or np.shape(var) != (m,):
        raise AssertionError("gp_api: wrong output shapes")
    check("gp_api eager assoc vs scan",
          abs(eager["assoc"]["value"] - eager["scan"]["value"])
          / abs(eager["scan"]["value"]), TOL_F32_VALUE)
    check("gp_api mean", err_mu, TOL_PREDICT)
    return record


def phase_fleet(
    n: int = N_FLEET, chains: int = FLEET_CHAINS, steps: int = FLEET_STEPS,
    max_leapfrog: int = 48,
):
    """Phase 4: the ChEES-HMC fleet (run_hmc) as in bench.py."""
    import jax

    from celerite2_tpu.inference import run_hmc

    chunk = max(steps // 2, 1)
    with jax.enable_x64(False), configured():
        logpost, init = fleet_model(n)
        stamps = []
        t0 = time.perf_counter()
        res = _block(
            run_hmc(
                logpost, init, jax.random.PRNGKey(1),
                num_warmup=steps, num_samples=steps, num_chains=chains,
                max_leapfrog=max_leapfrog, chunk_size=chunk,
                monitor=lambda step, stats: stamps.append(
                    time.perf_counter()
                ),
            )
        )
        wall = time.perf_counter() - t0
    # the first chunk carries the one-off compile; later chunks run the
    # same compiled segment
    per_chunk = (stamps[-1] - stamps[0]) / max(len(stamps) - 1, 1)
    compile_s = (stamps[0] - t0) - per_chunk
    sampling_s = per_chunk * len(stamps)
    samples = np.asarray(res.samples)
    accept = float(np.mean(np.asarray(res.accept_prob)))
    finite = bool(np.all(np.isfinite(samples)))
    record = dict(
        phase="fleet", n=n, chains=chains, warmup=steps, samples=steps,
        chunks=len(stamps), wall_s=wall, compile_s=compile_s,
        sampling_s=sampling_s, mean_accept=accept, finite=finite,
        samples_shape=list(samples.shape),
    )
    emit(**record)
    if not finite:
        raise AssertionError("fleet: non-finite samples")
    if not 0.0 < accept < 1.0:
        raise AssertionError(f"fleet: mean acceptance {accept!r}")
    return record


def _island_problem(n: int):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
    yerr = np.full(n, 0.05, np.float32)
    y = (0.8 * np.sin(2.0 * t) + 0.05 * rng.normal(size=n)).astype(
        np.float32
    )
    theta = np.log([1.0, 2.0, 0.5, 3.0, 2.0]).astype(np.float32)
    return theta, t, yerr, y


def island_loglik(theta, t, yerr, y):
    import jax.numpy as jnp

    from celerite2_tpu import terms
    from celerite2_tpu.gp import gp_loglik

    k = terms.Matern32Term(
        sigma=jnp.exp(theta[0]), rho=jnp.exp(theta[1])
    ) + terms.SHOTerm(
        sigma=jnp.exp(theta[2]), rho=jnp.exp(theta[3]), tau=jnp.exp(theta[4])
    )
    return gp_loglik(k, t, y, yerr=yerr)


def phase_island(n: int = N_ISLAND, reps: int = 20):
    """Phase 5: core_dtype="float64" (the f64 island) in a float32
    process, against the same model run entirely in float64."""
    import jax
    import jax.numpy as jnp

    data = _island_problem(n)
    with jax.enable_x64(False), configured(core_dtype="float64"):
        args = tuple(jnp.asarray(x) for x in data)
        vg = jax.jit(jax.value_and_grad(island_loglik))
        compiled, compile_s = _timed_compile(vg, *args)
        v, g = _block(compiled(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            _block(compiled(*args))
        ms = 1e3 * (time.perf_counter() - t0) / reps
    with jax.enable_x64(True), configured(backend="scan"):
        args64 = tuple(jnp.asarray(x, jnp.float64) for x in data)
        v_ref, g_ref = jax.jit(jax.value_and_grad(island_loglik))(*args64)
    err_v = abs(float(v) - float(v_ref)) / abs(float(v_ref))
    err_g = rel(g, g_ref)
    record = dict(
        phase="island", n=n, dtype_out=str(np.asarray(v).dtype),
        compile_s=compile_s, ms_per_eval=ms, value_rel_err=err_v,
        grad_rel_err=err_g,
    )
    emit(**record)
    check("island value", err_v, TOL_ISLAND)
    check("island grad", err_g, TOL_ISLAND)
    return record


def _hmc_samples(logpost, q0, device, axis):
    """Samples of a short run_hmc from one shared state and key (sample
    0 is the first transition), float32, on ``device`` or ``axis``."""
    import jax

    from celerite2_tpu.inference import run_hmc

    t0 = time.perf_counter()
    with jax.enable_x64(False), jax.default_device(device):
        samples = np.asarray(_block(run_hmc(
            logpost, q0, jax.random.PRNGKey(3), num_warmup=0,
            num_samples=4, max_leapfrog=8, chain_axis=axis,
        ).samples))
    return samples, time.perf_counter() - t0


def phase_four(
    n: int = N_FOUR, chains: int = FOUR_CHAINS, n_fleet: int = N_FLEET,
    devices=None, reps: int = 10,
):
    """Four devices: the sequence-sharded log-density on a (1, 4) mesh
    against single-device gp_loglik, and a chain-sharded run_hmc against
    the same call on one device.

    The two run_hmc calls run in worker threads while the main thread
    checks the sharded log-density: their compiles dominate the phase,
    and XLA compiles without holding the GIL.
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from celerite2_tpu.parallel import make_mesh, make_sharded_logdensity

    devices = list(devices if devices is not None else jax.devices()[:4])
    seq_mesh = make_mesh(chains=1, seq=4, devices=devices)
    chain_mesh = make_mesh(chains=4, seq=1, devices=devices)
    sharding = NamedSharding(chain_mesh, P("chains"))
    t, yerr, y, theta = bench_data(n)

    with jax.enable_x64(False), configured():
        logpost, init = fleet_model(n_fleet)
    q0 = np.broadcast_to(init, (chains, init.shape[0])).copy()
    with ThreadPoolExecutor(max_workers=2) as pool:
        hmc = {
            label: pool.submit(_hmc_samples, logpost, q0, devices[0], axis)
            for label, axis in (("sharded", sharding), ("one_device", None))
        }

        # x64 parity: sequence-sharded vs one device
        with jax.enable_x64(True), configured():
            logd = make_sharded_logdensity(sho_kernel, t, y, yerr, seq_mesh)
            v, g = _block(
                jax.jit(jax.value_and_grad(logd))(jnp.asarray(theta))
            )
            with jax.default_device(devices[0]):
                v1, g1 = _block(
                    jax.jit(jax.value_and_grad(sho_loglik))(
                        *(jnp.asarray(x) for x in (theta, t, yerr, y))
                    )
                )
        err_v = abs(float(v) - float(v1)) / abs(float(v1))
        err_g = rel(g, g1)
        progress(f"four: x64 parity value {err_v!r} grad {err_g!r}")

        # float32: finite, timed
        with jax.enable_x64(False), configured():
            t32, y32, e32 = (np.asarray(x, np.float32) for x in (t, y, yerr))
            logd32 = make_sharded_logdensity(
                sho_kernel, t32, y32, e32, seq_mesh
            )
            vg32 = jax.jit(jax.value_and_grad(logd32))
            th32 = jnp.asarray(theta, jnp.float32)
            compiled, compile_s = _timed_compile(vg32, th32)
            v32, g32 = _block(compiled(th32))
            t0 = time.perf_counter()
            for _ in range(reps):
                _block(compiled(th32))
            ms = 1e3 * (time.perf_counter() - t0) / reps
        finite32 = bool(np.isfinite(float(v32)) and np.all(np.isfinite(g32)))
        progress(f"four: f32 sharded {ms!r} ms/eval, finite {finite32}")
        runs = {label: fut.result() for label, fut in hmc.items()}

    finite_fleet = bool(np.all(np.isfinite(runs["sharded"][0])))
    err_tr = rel(runs["sharded"][0][:, 0], runs["one_device"][0][:, 0])
    record = dict(
        phase="four", devices=len(devices), n=n,
        seq_value_rel_err_x64=err_v, seq_grad_rel_err_x64=err_g,
        seq_f32_compile_s=compile_s, seq_f32_ms_per_eval=ms,
        seq_f32_finite=finite32, fleet_chains=chains, fleet_n=n_fleet,
        fleet_wall_s={k: r[1] for k, r in runs.items()},
        fleet_finite=finite_fleet, first_transition_rel_err=err_tr,
    )
    emit(**record)
    check("four seq value x64", err_v, TOL_F64)
    check("four seq grad x64", err_g, TOL_F64)
    if not (finite32 and finite_fleet):
        raise AssertionError("four: non-finite output")
    check("four first transition", err_tr, TOL_TRANSITION)
    return record


PHASES = {
    "hot_f32": phase_hot_f32,
    "hot_f64": phase_hot_f64,
    "gp_api": phase_gp_api,
    "fleet": phase_fleet,
    "island": phase_island,
    "four": phase_four,
}


def selected_phases(four: bool) -> list[str]:
    """Phase names a run executes: ``--four`` runs only the four-device
    path (and what it is compared with)."""
    if four:
        return ["four"]
    return [name for name in PHASES if name != "four"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU path and its single-GPU reference",
    )
    args = parser.parse_args(argv)
    count = 4 if args.four else 1

    import jax

    from celerite2_tpu.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache(os.path.join(HERE, ".jax_cache"))
    devs = require_gpu(count)
    cards = card_lines()
    emit(
        phase="device", platform=devs[0].platform,
        kind=devs[0].device_kind, count=len(devs),
        jax_version=jax.__version__, compilation_cache=cache,
    )
    for line in cards:
        print(line, flush=True)
    for name in selected_phases(args.four):
        progress(f"phase {name}")
        PHASES[name]()
    emit(ok=True, device=dict(
        platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(jax.devices()),
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
