"""Persistent XLA compilation cache location.

One rule for every script and test entry point of this repository:

* if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it; use
  that directory and set no other;
* otherwise use a fixed directory that the caller names inside its
  checkout (the path is part of the cache key, so it must not move
  between runs: never a tempdir, a pid or a timestamp).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compilation_cache_dir(default_dir: str, environ=None) -> str:
    """The cache directory the rule above selects."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or os.path.abspath(default_dir)


def enable_compilation_cache(default_dir: str) -> str:
    """Turn on JAX's persistent compilation cache; returns its path."""
    import jax

    path = compilation_cache_dir(default_dir)
    jax.config.update("jax_enable_compilation_cache", True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
