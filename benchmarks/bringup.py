"""GPU timings of the plain XLA paths of the log-likelihood hot path.

    python benchmarks/bringup.py [--out chiprun_out/bringup.json]

At N=1e5 in float32, for J=2 (one SHOTerm) and J=4 (two SHOTerms),
times log-likelihood + gradient chained in-graph (the way a sampler
consumes it) on the assoc tier with each prefix engine and on the scan
tier, and counts device kernel launches per evaluation from a
``jax.profiler`` trace.  Prints one JSON line per variant; the full
record, with the per-line trace summary, goes to ``--out``.  Fails when
JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 100_000
SCAN_TRACE_N = 10_000  # scan launches scale with N; trace a smaller run
VARIANTS = (
    ("associative_scan", dict(backend="assoc", engine="associative_scan")),
    ("two_level", dict(backend="assoc", engine="two_level")),
    ("scan", dict(backend="scan")),
)


def loglik(theta, t, yerr, y):
    import jax.numpy as jnp

    from celerite2_tpu import terms
    from celerite2_tpu.gp import gp_loglik

    k = terms.SHOTerm(
        sigma=jnp.exp(theta[0]), rho=jnp.exp(theta[1]), tau=jnp.exp(theta[2])
    )
    if theta.shape[0] == 5:
        k = k + terms.SHOTerm(
            sigma=jnp.exp(theta[3]), rho=jnp.exp(theta[4]), Q=0.3
        )
    return gp_loglik(k, t, y, yerr=yerr)


def data(n, J):
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000, n))
    yerr = np.full(n, 0.25)
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=n)
    theta = np.log([1.0, 5.0, 3.0] + ([0.5, 2.0] if J == 4 else []))
    return tuple(np.asarray(x, np.float32) for x in (theta, t, yerr, y))


def chained(chain_len):
    import jax

    def many(theta, t, yerr, y):
        def body(carry, _):
            v, g = jax.value_and_grad(loglik)(carry, t, yerr, y)
            return carry + 1e-9 * g, v

        _, vs = jax.lax.scan(body, theta, None, length=chain_len)
        return vs[-1]

    return jax.jit(many)


def device_events(trace_dir):
    """Per-line event counts and durations on the GPU planes of the one
    ``.xplane.pb`` under ``trace_dir``."""
    import jax

    (path,) = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    lines = []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines.append(dict(
                plane=plane.name, line=line.name, events=len(evs),
                busy_ns=int(sum(e.duration_ns for e in evs)),
            ))
    return lines


def kernel_launches(lines):
    """Kernel launches: events on the stream lines of device 0 (the
    derived "XLA Ops"/"XLA Modules" lines repeat them)."""
    return sum(
        ln["events"] for ln in lines
        if ln["plane"] == "/device:GPU:0" and ln["line"].startswith("Stream")
    )


def measure(name, fields, J, n, chain_len, reps, trace_evals, trace_n):
    import jax

    from celerite2_tpu.config import get_config, set_config

    prior = get_config()
    set_config(**fields)
    try:
        args = data(n, J)
        fn = chained(chain_len)
        t0 = time.perf_counter()
        fn = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        np.asarray(jax.block_until_ready(fn(*args)))
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(jax.block_until_ready(fn(*args)))
        ms = 1e3 * (time.perf_counter() - t0) / (reps * chain_len)

        targs = data(trace_n, J)
        tfn = chained(trace_evals)
        np.asarray(jax.block_until_ready(tfn(*targs)))
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                np.asarray(jax.block_until_ready(tfn(*targs)))
            lines = device_events(d)
    finally:
        set_config(**prior.__dict__)
    launches = kernel_launches(lines)
    return dict(
        variant=name, J=J, n=n, chain_len=chain_len, reps=reps,
        compile_s=compile_s, ms_per_eval=ms, trace_n=trace_n,
        trace_evals=trace_evals, launches_per_eval=launches / trace_evals,
        trace_lines=lines,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "bringup.json"))
    args = parser.parse_args(argv)

    import jax

    from celerite2_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache(os.path.join(ROOT, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bringup: no GPU found (platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(dict(device=dev.device_kind, card=card,
                          jax=jax.__version__)), flush=True)
    records = []
    for J in (2, 4):
        for name, fields in VARIANTS:
            if name == "scan":
                rec = measure(name, fields, J, N, 1, 1, 1, SCAN_TRACE_N)
            else:
                rec = measure(name, fields, J, N, 50, 3, 5, N)
            records.append(rec)
            short = {k: v for k, v in rec.items() if k != "trace_lines"}
            print(json.dumps(short), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=dev.device_kind, card=card, records=records),
                  f, indent=1)


if __name__ == "__main__":
    main()
