"""API-surface edge coverage: convolution/legacy terms through the full
GP, recompute, citations, observability helpers (the long tail of the
reference's python test suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import celerite2_tpu as c2
from celerite2_tpu import terms
from celerite2_tpu.citation import CITATIONS, get_citations
from celerite2_tpu.utils.observe import Timer, roofline


def _data(n=80, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    yerr = np.full(n, 0.2)
    y = np.sin(t) + yerr * rng.normal(size=n)
    return t, yerr, y


def test_convolution_term_gp_end_to_end():
    """Exposure-time integrated kernel through the full GP surface
    (reference terms.py:333-482 + test_celerite2 conditioning)."""
    t, yerr, y = _data()
    base = terms.SHOTerm(sigma=1.3, rho=2.5, tau=1.7)
    kernel = terms.TermConvolution(base, delta=0.08)
    gp = c2.GaussianProcess(kernel, t=t, yerr=yerr)
    ll = float(gp.log_likelihood(y))
    assert np.isfinite(ll)
    # conditioning at new points works and variance is positive-ish
    ts = np.linspace(0, 10, 25)
    mu, var = gp.predict(y, t=ts, return_var=True)
    assert np.all(np.isfinite(np.asarray(mu)))
    assert np.all(np.asarray(var) > -1e-6)
    # the convolved kernel must differ from the base one
    gp2 = c2.GaussianProcess(base, t=t, yerr=yerr)
    assert abs(ll - float(gp2.log_likelihood(y))) > 1e-6


def test_original_celerite_term():
    """Coefficient-passthrough wrapper (reference terms.py:815-826)."""

    class FakeV1Term:
        def get_all_coefficients(self):
            return (
                np.array([1.1]),
                np.array([0.6]),
                np.array([0.4]),
                np.array([0.2]),
                np.array([0.5]),
                np.array([2.0]),
            )

    term = terms.OriginalCeleriteTerm(FakeV1Term())
    ref = terms.RealTerm(a=1.1, c=0.6) + terms.ComplexTerm(
        a=0.4, b=0.2, c=0.5, d=2.0
    )
    t, yerr, y = _data()
    tau = t[:3, None] - t[None, :3]
    np.testing.assert_allclose(
        np.asarray(term.get_value(tau)),
        np.asarray(ref.get_value(tau)),
        rtol=1e-12,
    )
    gp = c2.GaussianProcess(term, t=t, yerr=yerr)
    gp2 = c2.GaussianProcess(ref, t=t, yerr=yerr)
    np.testing.assert_allclose(
        float(gp.log_likelihood(y)), float(gp2.log_likelihood(y)),
        rtol=1e-10,
    )


def test_recompute_and_state_reuse():
    t, yerr, y = _data()
    gp = c2.GaussianProcess(
        terms.SHOTerm(sigma=1.0, rho=3.0, tau=2.0), t=t, yerr=yerr
    )
    ll0 = float(gp.log_likelihood(y))
    gp.recompute()
    np.testing.assert_allclose(float(gp.log_likelihood(y)), ll0,
                               rtol=1e-12)
    with pytest.raises(RuntimeError):
        c2.GaussianProcess(
            terms.SHOTerm(sigma=1.0, rho=3.0, tau=2.0)
        ).log_likelihood(y)


def test_citations():
    t, yerr, y = _data(20)
    gp = c2.GaussianProcess(
        terms.SHOTerm(sigma=1.0, rho=3.0, tau=2.0), t=t, yerr=yerr
    )
    keys, bibtex = gp.citations
    assert all(k in CITATIONS for k in keys)
    assert "Foreman-Mackey" in bibtex
    assert get_citations("nonexistent-key") == bibtex


def test_observe_helpers():
    r = roofline(100_000, 4, backend="scan")
    assert r.flops > 0 and r.bytes > 0 and r.intensity > 0
    assert r.seconds_at(flops_per_s=1e12, bytes_per_s=1e11) > 0
    with Timer() as tm:
        jnp.sum(jnp.arange(10)).block_until_ready()
    assert tm.elapsed > 0


def test_weight_matrix_rhs_paths():
    """apply_inverse / dot_tril with matrix right-hand sides
    (reference test_celerite2.py apply_inverse suite)."""
    t, yerr, y = _data()
    gp = c2.GaussianProcess(
        terms.SHOTerm(sigma=1.0, rho=3.0, tau=2.0), t=t, yerr=yerr
    )
    Y = np.stack([y, 0.5 * y], axis=1)
    Z = np.asarray(gp.apply_inverse(Y))
    assert Z.shape == Y.shape
    np.testing.assert_allclose(Z[:, 1], 0.5 * Z[:, 0], rtol=1e-8)
    L = np.asarray(gp.dot_tril(Y))
    assert L.shape == Y.shape


def test_set_config_invalidates_jit_trace_cache():
    """Round-4 regression: JAX's trace cache is keyed by function
    identity, and this library's config is read at trace time — so
    re-jitting the same callable after ``set_config`` must RETRACE
    under the new config (the fingerprint participates in the trace
    context), not silently reuse the stale executable."""
    from celerite2_tpu.config import get_config, set_config

    seen = []

    def f(x):
        seen.append(get_config().backend)
        return x + 1

    prior = get_config()
    try:
        set_config(backend="scan")
        jax.jit(f)(1.0)
        set_config(backend="assoc")
        jax.jit(f)(1.0)
        # flipping back must not retrace a third time (both traces
        # coexist in the cache under their own fingerprints)
        set_config(backend="scan")
        jax.jit(f)(1.0)
    finally:
        set_config(**prior.__dict__)
    assert seen == ["scan", "assoc"]
