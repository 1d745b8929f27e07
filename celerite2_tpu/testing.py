"""Shared test fixtures and cross-backend comparators (role of
reference python/celerite2/testing.py: get_matrices:10-49,
check_tensor_term:71-180, check_gp_models:183-201).  Where the
reference compares NumPy/JAX/PyMC backends, this framework compares its
op-implementation tiers (scan / assoc) against each other."""

from __future__ import annotations

import numpy as np


def get_matrices(
    size=100,
    J=None,
    kernel=None,
    vector=False,
    conditional=False,
    include_dense=False,
    no_diag=False,
    seed=721,
):
    """Deterministic random celerite system (cf. reference
    testing.py:10-49).  Returns numpy arrays; tests promote to jnp."""
    random = np.random.default_rng(seed)
    t = np.sort(random.uniform(0, 10, size))
    if no_diag:
        diag = np.zeros_like(t)
    else:
        diag = random.uniform(0.1, 0.3, len(t))

    from celerite2_tpu.models.terms import SHOTerm

    if kernel is None:
        kernel = SHOTerm(S0=5.0, w0=0.1, Q=3.45) + SHOTerm(
            S0=1.0, w0=2.5, Q=0.2
        )
    c, a, U, V = (np.asarray(x) for x in kernel.get_celerite_matrices(t, diag))

    nrhs = 1 if vector else 4
    Y = random.normal(size=(len(t), nrhs))
    if vector:
        Y = Y[:, 0]

    out = [t, c, a, U, V, Y]

    if conditional:
        t2 = np.sort(random.uniform(-2, 12, 75))
        c2, a2, U2, V2 = (
            np.asarray(x)
            for x in kernel.get_celerite_matrices(t2, np.zeros_like(t2))
        )
        out += [t2, U2, V2]

    if include_dense:
        K = np.asarray(kernel.to_dense(t, diag))
        out.append(K)
        if conditional:
            tau = t[:, None] - t2[None, :]
            out.append(np.asarray(kernel.get_value(tau)))

    return tuple(out)


def check_term(term, ref_term, x=None, tau=None, omega=None, atol=1e-8):
    """Compare two Term implementations over the full term surface
    (coefficient matrices, kernel values, PSD, dense matmul) — the
    analogue of the reference's cross-backend ``check_tensor_term``
    (testing.py:71-180)."""
    import jax.numpy as jnp

    random = np.random.default_rng(40582)
    if x is None:
        x = np.sort(random.uniform(0, 10, 50))
    if tau is None:
        tau = x[:, None] - x[None, :]
    if omega is None:
        omega = np.linspace(-10, 10, 100)
    diag = random.uniform(0.1, 0.4, len(x))

    np.testing.assert_allclose(
        np.asarray(term.get_value(tau)),
        np.asarray(ref_term.get_value(tau)),
        atol=atol,
    )
    np.testing.assert_allclose(
        np.asarray(term.get_psd(omega)),
        np.asarray(ref_term.get_psd(omega)),
        atol=atol,
    )
    np.testing.assert_allclose(
        np.asarray(term.to_dense(x, diag)),
        np.asarray(ref_term.to_dense(x, diag)),
        atol=atol,
    )
    y = random.normal(size=(len(x), 3))
    np.testing.assert_allclose(
        np.asarray(term.dot(x, diag, y)),
        np.asarray(ref_term.dot(x, diag, y)),
        atol=atol,
    )
    del jnp


def check_gp_backends(kernel, backends=("scan", "assoc"), *, size=120,
                      atol=1e-8):
    """Full GP-surface parity across op backends (analogue of the
    reference's ``check_gp_models``, testing.py:183-201)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from celerite2_tpu import GaussianProcess
    from celerite2_tpu.config import get_config, set_config

    random = np.random.default_rng(1986)
    t = np.sort(random.uniform(0, 10, size))
    yerr = random.uniform(0.1, 0.3, size)
    y = np.sin(t) + yerr * random.normal(size=size)
    t_new = np.linspace(-1, 11, 60)

    results = {}
    prior = get_config()
    try:
        for backend in backends:
            set_config(backend=backend, assoc_threshold=1)
            gp = GaussianProcess(kernel, t=t, yerr=yerr)
            cond = gp.condition(y, t=t_new)
            results[backend] = dict(
                loglike=np.asarray(gp.log_likelihood(y)),
                mean=np.asarray(cond.mean),
                variance=np.asarray(cond.variance),
                sample=np.asarray(
                    gp.sample(jax.random.PRNGKey(0), size=2)
                ),
                apply_inverse=np.asarray(gp.apply_inverse(y)),
            )
    finally:
        # restore whatever config the caller had, not hard-coded defaults
        set_config(**dataclasses.asdict(prior))

    ref = results[backends[0]]
    for backend in backends[1:]:
        for name, val in results[backend].items():
            np.testing.assert_allclose(
                val, ref[name], atol=atol,
                err_msg=f"{backend} vs {backends[0]}: {name}",
            )
    del jnp
    return results
