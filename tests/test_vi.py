"""VI baseline tests: mean-field on isotropic targets, full-rank recovering
the SCG covariance exactly (Gaussian family oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics.vi import (
    fit_fullrank,
    fit_meanfield,
    fullrank_covariance,
    fullrank_sample,
    meanfield_sample,
)
from l2hmc.targets import scg_2d


def test_meanfield_isotropic_gaussian(key):
    scales = jnp.array([1.0, 4.0, 0.25])
    energy = lambda x: 0.5 * jnp.sum(scales * x * x, axis=-1)
    params, elbos = fit_meanfield(energy, 3, key, num_steps=1500)
    # sigma_i = 1/sqrt(scales_i)
    np.testing.assert_allclose(
        jnp.exp(params.log_sigma), 1.0 / jnp.sqrt(scales), rtol=0.1
    )
    np.testing.assert_allclose(params.mu, 0.0, atol=0.1)
    # ELBO converges to log Z = 0.5*sum log(2 pi / scales)
    log_z = 0.5 * float(jnp.sum(jnp.log(2 * jnp.pi / scales)))
    np.testing.assert_allclose(float(elbos[-100:].mean()), log_z, atol=0.1)


def test_fullrank_recovers_scg_covariance(key):
    target = scg_2d()
    params, elbos = fit_fullrank(
        target.energy, 2, key, num_steps=12000, num_samples=128, lr=3e-2
    )
    cov = fullrank_covariance(params)
    # ill-conditioned (kappa=1e4) covariance: stochastic ELBO recovers the
    # dominant structure; correlation must be ~1 and scale within 20%
    np.testing.assert_allclose(np.asarray(cov), np.asarray(target.sigma), rtol=0.2, atol=0.3)
    corr = float(cov[0, 1] / jnp.sqrt(cov[0, 0] * cov[1, 1]))
    assert corr > 0.95


def test_vi_samplers(key):
    scales = jnp.array([1.0, 4.0])
    energy = lambda x: 0.5 * jnp.sum(scales * x * x, axis=-1)
    params, _ = fit_meanfield(energy, 2, key, num_steps=1000)
    s = meanfield_sample(params, key, 20000)
    np.testing.assert_allclose(s.var(axis=0), 1.0 / scales, rtol=0.15)
