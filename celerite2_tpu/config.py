"""Typed runtime configuration for celerite2-tpu.

The reference library configures itself through C++ macros
(``CELERITE_MAX_WIDTH``, ``CELERITE2_FAST_RUN`` — /root/reference
c++/include/celerite2/terms.hpp:10-12, python/celerite2/driver.hpp:36) and
import-time global flag mutation (forcing ``jax_enable_x64`` —
python/celerite2/jax/__init__.py:7-19).  Here everything lives in a single
dataclass that is read at trace time; nothing is mutated on import.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# The reference caps the celerite width at 32 (terms.hpp:10-12).  We keep the
# same contract: ops are specialized per (padded) J and J-padding keeps the
# number of XLA recompiles bounded, mirroring the reference's UNWRAP_CASES
# J-bucketing (driver.hpp:27-101).
MAX_WIDTH = 32

# Pad J to one of these buckets before handing matrices to the fast kernels.
J_BUCKETS = (1, 2, 4, 8, 16, 32)


_BACKENDS = ("auto", "scan", "assoc")
_ENGINES = ("auto", "two_level", "associative_scan")


@dataclasses.dataclass(frozen=True)
class Config:
    """Global solver configuration.

    Attributes:
        backend: which op implementation family to use.
            - "auto": "assoc" above ``assoc_threshold`` rows for traced
              calls, else "scan".
            - "scan": plain ``lax.scan`` recursions (always correct;
              the reference tier, and the cheapest for small N).
            - "assoc": parallel prefix-composition formulations
              (log-depth; see ``engine``).
        assoc_threshold: minimum N for "auto" to pick assoc.  Lower
            it (e.g. to 64) for long production runs at moderate N.
        engine_block: rows per level of the ``two_level`` prefix engine
            (sequential steps ~ engine_block * log_block(N); each step
            batches over N/engine_block blocks).
        engine: prefix-composition engine of the assoc tier.  "auto"
            means ``lax.associative_scan``; "two_level" selects the
            recursive blocked scan (``ops.assoc.two_level_prefix``).
        bucket_widths: round J up to the next ``J_BUCKETS`` entry before
            entering the kernels (zero columns are exact no-ops in the
            recursions), bounding XLA recompiles across kernel widths —
            the analogue of the reference's UNWRAP_CASES switch
            (driver.hpp:27-101).  Widths above ``MAX_WIDTH`` skip
            bucketing.
        fused_forward: run the log-likelihood forward as ONE
            Kalman-element engine pass on the assoc tier instead of
            factor-then-solve.  Off by default; the scan tier always
            fuses (one data sweep instead of two).
        paired_reverse: one paired engine pass for the log-likelihood
            reverse instead of solve-rev + factor-rev.  Off by default.
        core_dtype: the f64 ISLAND for stiff kernels (see below).
    """

    backend: Literal["auto", "scan", "assoc"] = "auto"
    assoc_threshold: int = 1024
    engine_block: int = 32
    engine: Literal["auto", "two_level", "associative_scan"] = "auto"
    bucket_widths: bool = True
    fused_forward: bool = False
    paired_reverse: bool = False
    # f64 ISLAND for stiff kernels: when "float64", gp_loglik (and the
    # factorization inside gp_compute) upcast inputs + kernel params
    # and run under jax.enable_x64 even in an f32 process, then
    # downcast the outputs.  Fixes the catastrophic f32 cancellation of
    # eps-regularized terms (Matern32Term: the d(ll)/d(eps) gradient
    # comes out with the WRONG SIGN and ~30x magnitude in f32 —
    # measured; the reference mandates f64 globally for the same
    # reason, jax/ops.py:84).  Per-model opt-in rather than global.
    #
    # COMPOSITION CONTRACT: the island works under jit, grad, and
    # vmap(grad) — MAP fits, VI gradient steps, user loops.  It does
    # NOT survive vmapped lax control flow AROUND the island (e.g. the
    # NUTS/HMC samplers' per-chain while-loops): jaxpr-level batching
    # re-binds the island's f64 ops under the process's x64-off config
    # and silently truncates them (then fails with a dtype error).
    # For full sampler runs on stiff models, scope the WHOLE call
    # instead:  with jax.enable_x64(True): run_nuts(...)  (see
    # benchmarks/configs.py config4).
    core_dtype: Literal["float64"] | None = None

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.engine not in _ENGINES:
            raise ValueError(
                f"engine must be one of {_ENGINES}, got {self.engine!r}"
            )


_config = Config()


def _register_trace_state():
    """Register the config fingerprint in JAX's trace context.

    JAX's jit trace cache is keyed by function identity + the trace
    context; this library's config is read at TRACE time (tier
    routing, engine choices), so without this hook a ``set_config``
    after a function was first jitted would silently reuse the stale
    trace — re-jitting the same callable after ``set_config(...)``
    would return the executable traced under the old config.  Registering a state with
    ``include_in_jit_key``/``include_in_trace_context`` makes every
    config change part of the cache key, so traces under different
    configs coexist (no cache clearing) and lookups always match the
    live config.
    """
    try:
        from jax._src import config as _jcfg

        name = "celerite2_tpu_config_fingerprint"
        if name in _jcfg.config_states:
            return _jcfg.config_states[name]
        return _jcfg.State(
            name,
            repr(_config),
            "celerite2_tpu config fingerprint (participates in the "
            "jit trace-cache key so set_config() invalidates stale "
            "traces)",
            include_in_jit_key=True,
            include_in_trace_context=True,
        )
    except Exception:  # pragma: no cover - private-API drift fallback
        return None


_trace_state = _register_trace_state()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Replace fields of the global config; returns the new config.

    Unknown fields raise ``TypeError`` and unknown ``backend``/``engine``
    values raise ``ValueError``; nothing is silently re-routed.

    The new fingerprint enters JAX's trace-cache key, so jitted
    functions traced under a previous config retrace (once per
    distinct config) instead of silently reusing stale routing.
    """
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    if _trace_state is not None:
        _trace_state.set_global(repr(_config))
    return _config


def pad_width(j: int) -> int:
    """Round ``j`` up to the nearest J bucket (bounded recompiles)."""
    for b in J_BUCKETS:
        if j <= b:
            return b
    raise ValueError(
        f"celerite width J={j} exceeds the maximum supported width "
        f"{MAX_WIDTH}"
    )
