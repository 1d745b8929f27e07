"""Small shared utilities.

Equivalent of the reference's ``celerite2::utils::search_sorted``
(/root/reference/c++/include/celerite2/utils.hpp:13-26) and the
``LinAlgError`` raised by its bindings (driver.hpp:13-19).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def asarr(x):
    """Normalize a value for use inside (possibly) traced code.

    Traced values pass through untouched; anything concrete becomes a
    **numpy** array, which XLA embeds as an HLO literal.  Never convert
    concrete values with ``jnp.asarray`` at trace time: that creates a
    committed device-array constant that the compiled program captures
    instead of a literal.
    """
    if isinstance(x, jax.core.Tracer):
        return x
    x = np.asarray(x)
    if x.dtype == np.float64 and not jax.config.jax_enable_x64:
        x = x.astype(np.float32)  # avoid per-op truncation warnings
    return x


def atleast_1d(x):
    """``asarr`` + promote scalars to rank 1 (trace-safe, see asarr)."""
    x = asarr(x)
    return jnp.atleast_1d(x) if isinstance(x, jax.core.Tracer) else (
        np.atleast_1d(x)
    )


class LinAlgError(Exception):
    """Raised when the celerite matrix is not positive definite.

    Mirrors the error contract of the reference bindings
    (driver.cpp:62, driver.hpp:13-19): raised eagerly by the NumPy-style
    API; traced code paths use the ``quiet`` semantics (log_det -> -inf)
    instead.
    """


def search_sorted(a, v, *, side: str = "right"):
    """Vectorized sorted search; jnp.searchsorted with the celerite
    convention (first index where ``a[i] > v``)."""
    return jnp.searchsorted(a, v, side=side)


def as_f(x, dtype=None):
    """Convert to a floating-point jnp array (weak promotion preserved)."""
    x = jnp.asarray(x, dtype=dtype)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.result_type(float))
    return x
