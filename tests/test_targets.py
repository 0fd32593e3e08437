"""Tests for analytic targets: energy/log-density consistency, exact-sample
moments, gradient sanity.  Replaces the reference's 'sampling is the test'
approach (SURVEY §4) with direct checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.targets import (
    GMM,
    Gaussian,
    GaussianFunnel,
    RoughWell,
    gen_ring,
    gmm_axes,
    random_tilted_gaussian,
    scg_2d,
)


def test_gaussian_energy_matches_quadratic(key):
    g = Gaussian.create(jnp.array([1.0, -2.0]), jnp.array([[2.0, 0.3], [0.3, 0.5]]))
    x = jax.random.normal(key, (7, 2))
    d = np.asarray(x) - np.asarray(g.mu)
    prec = np.linalg.inv(np.asarray(g.sigma))
    expected = 0.5 * np.einsum("ni,ij,nj->n", d, prec, d)
    np.testing.assert_allclose(g.energy(x), expected, rtol=1e-4, atol=1e-5)


def test_gaussian_sample_moments(key):
    g = Gaussian.create(jnp.array([1.0, -2.0]), jnp.array([[2.0, 0.3], [0.3, 0.5]]))
    s = g.sample(key, 200_000)
    np.testing.assert_allclose(jnp.mean(s, 0), g.mu, atol=0.02)
    np.testing.assert_allclose(jnp.cov(np.asarray(s).T), g.sigma, atol=0.03)


def test_gaussian_log_density_normalized(key):
    """log_density integrates to ~1 on a grid (1-D marginal check in 2-D)."""
    g = Gaussian.create(jnp.zeros(2), jnp.eye(2))
    xs = jnp.linspace(-6, 6, 301)
    grid = jnp.stack(jnp.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    p = jnp.exp(g.log_density(grid))
    dx = float(xs[1] - xs[0])
    np.testing.assert_allclose(jnp.sum(p) * dx * dx, 1.0, atol=1e-3)


def test_scg_2d_conditioning():
    g = scg_2d()
    evals = np.linalg.eigvalsh(np.asarray(g.sigma))
    np.testing.assert_allclose(sorted(evals), [0.01, 100.0], rtol=1e-3)


def test_tilted_gaussian(key):
    g = random_tilted_gaussian(key, dim=4)
    assert g.mu.shape == (4,)
    # symmetric positive definite
    s = np.asarray(g.sigma)
    np.testing.assert_allclose(s, s.T, atol=1e-5)
    assert np.all(np.linalg.eigvalsh(s) > 0)


def test_rough_well_energy():
    rw = RoughWell(dim=3, eps=0.1)
    x = jnp.zeros((2, 3))
    # E(0) = 0.5*0 + eps * sum cos(0) = eps * dim
    np.testing.assert_allclose(rw.energy(x), 0.1 * 3, rtol=1e-5)


def test_gmm_energy_vs_brute_force(key):
    gmm = gmm_axes(dim=2, sep=2.0, var=0.25)
    x = jax.random.normal(key, (9, 2)) * 2
    # brute force with scipy-style formula
    from scipy.stats import multivariate_normal

    pdfs = sum(
        float(p) * multivariate_normal(mean=np.asarray(m), cov=np.asarray(s)).pdf(np.asarray(x))
        for p, m, s in zip(gmm.pis, gmm.mus, gmm.sigmas)
    )
    np.testing.assert_allclose(gmm.energy(x), -np.log(pdfs), rtol=1e-4, atol=1e-4)


def test_gmm_sampling_modes(key):
    gmm = gmm_axes(dim=2, sep=3.0, var=0.05)
    s = np.asarray(gmm.sample(key, 40_000))
    frac_right = np.mean(s[:, 0] > 0)
    assert 0.47 < frac_right < 0.53
    np.testing.assert_allclose(np.abs(s[:, 0]).mean(), 3.0, atol=0.05)


def test_gmm_arrangements(key):
    """Reference mean-arrangement zoo (mog_model.py:1040-1112):
    single_axis / axes (one per axis) / diagonal."""
    from l2hmc.targets import gmm_diagonal, gmm_one_per_axis, gmm_single_axis

    sa = gmm_single_axis(4, sep=2.0, var=0.1)
    np.testing.assert_allclose(
        np.asarray(sa.mus), [[2, 0, 0, 0], [-2, 0, 0, 0]])
    # gmm_axes stays the backward-compatible alias of single_axis
    np.testing.assert_allclose(np.asarray(gmm_axes(4, sep=2.0).mus),
                               np.asarray(sa.mus))

    ax = gmm_one_per_axis(3, sep=1.5, var=0.1)
    np.testing.assert_allclose(
        np.asarray(ax.mus), 1.5 * np.eye(3))
    ax5 = gmm_one_per_axis(3, sep=1.5, num_modes=5)
    assert ax5.mus.shape == (5, 3)
    np.testing.assert_allclose(np.asarray(ax5.mus[3]), [1.5, 0, 0])

    dg = gmm_diagonal(3, sep=2.0, var=0.1)
    np.testing.assert_allclose(
        np.asarray(dg.mus), [[2, 2, 2], [-2, -2, -2]])

    # each is a proper normalized mixture: sampling hits every mode
    for t in (sa, ax, dg):
        s = np.asarray(t.sample(key, 20_000))
        modes = np.argmin(
            ((s[:, None, :] - np.asarray(t.mus)[None]) ** 2).sum(-1), axis=1)
        counts = np.bincount(modes, minlength=len(t.mus)) / len(s)
        np.testing.assert_allclose(counts, 1.0 / len(t.mus), atol=0.03)
        assert np.isfinite(np.asarray(t.energy(jnp.asarray(s[:64])))).all()


def test_ring(key):
    ring = gen_ring(r=2.0, var=0.1, nb_mixtures=6)
    assert ring.mus.shape == (6, 2)
    np.testing.assert_allclose(jnp.linalg.norm(ring.mus, axis=-1), 2.0, rtol=1e-5)
    s = ring.sample(key, 10_000)
    r = jnp.linalg.norm(s, axis=-1)
    np.testing.assert_allclose(jnp.mean(r), 2.0, atol=0.2)


def test_funnel(key):
    f = GaussianFunnel(dim=5)
    s = f.sample(key, 50_000)
    assert s.shape == (50_000, 5)
    np.testing.assert_allclose(jnp.std(s[:, 0]), 2.0, atol=0.05)
    e = f.energy(s)
    assert jnp.all(jnp.isfinite(e))
    # clipped energy stays finite for extreme v
    extreme = jnp.array([[20.0, 1.0, 1.0, 1.0, 1.0], [-20.0, 1.0, 1.0, 1.0, 1.0]])
    assert jnp.all(jnp.isfinite(f.energy(extreme)))


def test_targets_jit_and_grad(key):
    """Targets must flow through jit and grad (pytree registration)."""
    for target in [scg_2d(), gmm_axes(2), GaussianFunnel(dim=3), RoughWell(dim=3, eps=0.1)]:
        d = target.mus.shape[-1] if isinstance(target, GMM) else (
            target.mu.shape[-1] if isinstance(target, Gaussian) else target.dim
        )
        x = jax.random.normal(key, (4, d))
        e = jax.jit(lambda t, x: t.energy(x))(target, x)
        assert e.shape == (4,)
        g = jax.grad(lambda x: jnp.sum(target.energy(x)))(x)
        assert jnp.all(jnp.isfinite(g))
