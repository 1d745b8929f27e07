"""Test configuration.

Tests run on CPU with 8 virtual devices (for sharding tests) and float64
enabled (the reference's precision contract is float64 —
jax/__init__.py:7-19; correctness tiers compare at 1e-8..1e-12).

Platform and device count are set through ``jax.config`` before any
device is touched, so they hold even when jax was imported earlier in
the process.  Tests marked ``gpu`` need a CUDA card and skip on CPU;
README.md names the command that runs them on the card.
"""

import os

import jax

from celerite2_tpu.utils.cache import enable_compilation_cache

# CPU unless the caller names another platform: the ``gpu``-marked
# tests run on the card with JAX_PLATFORMS=cuda (see README.md).
if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# The suite is compile-bound (unrolled J-specialized kernels); persist
# compiled executables across runs so only the first run pays.
enable_compilation_cache(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 ".jax_cache")
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
