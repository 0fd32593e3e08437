"""Tests for the baseline samplers (Metropolis, Ising, NUTS, AIS, SMC) and
the SU(N) scaffolding: each validated against an exact/analytic anchor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import u1
from l2hmc.lattice.ising import ising_chain, ising_energy
from l2hmc.lattice.metropolis import metropolis_chain, metropolis_sweep
from l2hmc.lattice.sun import (
    generators,
    is_unitary,
    random_sun,
    sun_action,
    sun_plaquette,
)
from l2hmc.dynamics.ais import ais_log_weights, log_mean_exp
from l2hmc.dynamics.nuts import nuts_chain, nuts_transition
from l2hmc.dynamics.smc import smc_beta_ladder, systematic_resample
from l2hmc.dynamics.hmc import hmc_transition
from l2hmc.targets import Gaussian


def test_metropolis_plaquette_matches_oracle(key):
    """Checkerboard Metropolis on U(1) 8x8 at beta=2: <P> -> I1/I0(2)."""
    plaqs, charges = jax.jit(
        lambda k: metropolis_chain(
            k, u1.LatticeShape(8, 8), 2.0, num_sweeps=600, batch=8,
            proposal_scale=1.0,
        )
    )(key)
    plaq = float(np.asarray(plaqs)[300:].mean())
    exact = float(u1.u1_plaq_exact(2.0))
    assert abs(plaq - exact) < 0.02, f"plaq {plaq} vs {exact}"
    # charges are integers and fluctuate
    q = np.asarray(charges)[300:]
    assert q.std() > 0.1


def test_metropolis_thermalize_reaches_oracle(key):
    """`thermalize` (the --eval_init metropolis warm start) drives cold
    flat configs to the exact plaquette at beta=4 on 8x8."""
    from l2hmc.lattice.metropolis import thermalize

    shape = u1.LatticeShape(8, 8)
    x0 = jnp.zeros((8, shape.x_dim))  # cold start
    x = jax.jit(lambda x, k: thermalize(k, x, shape, 4.0, 500))(x0, key)
    plaq = float(np.asarray(u1.observables(x, shape)["plaqs"]).mean())
    exact = float(u1.u1_plaq_exact(4.0))
    assert abs(plaq - exact) < 0.02, f"plaq {plaq} vs {exact}"


def test_metropolis_local_action_consistent(key):
    """Accepting a proposal changes the global Wilson action by exactly the
    local delta used in the accept test (validates the staple algebra)."""
    from l2hmc.lattice.metropolis import local_action

    shape = u1.LatticeShape(6, 6)
    links = u1.to_links(u1.random_links(key, 1, shape), shape)
    for mu in (0, 1):
        theta_old = links[..., mu]
        bump = jnp.zeros_like(theta_old).at[0, 2, 3].set(0.7)
        theta_new = theta_old + bump
        links_new = links.at[..., mu].set(theta_new)
        global_delta = float(
            u1.wilson_action(links_new)[0] - u1.wilson_action(links)[0]
        )
        local_delta = float(
            (local_action(links, mu, theta_new) - local_action(links, mu, theta_old))[0, 2, 3]
        )
        np.testing.assert_allclose(global_delta, local_delta, rtol=1e-4, atol=1e-5)


def test_ising_high_low_temperature(key):
    """Ising sanity: ordered at low T (|m| ~ 1), disordered at high T."""
    e_hot, m_hot = jax.jit(lambda k: ising_chain(k, 16, 0.2, 300, batch=4))(key)
    e_cold, m_cold = jax.jit(lambda k: ising_chain(k, 16, 1.0, 300, batch=4))(
        jax.random.fold_in(key, 1)
    )
    assert float(np.asarray(m_cold)[200:].mean()) > 0.9
    assert float(np.asarray(m_hot)[200:].mean()) < 0.3


def test_sun_generators_and_elements(key):
    for n in (2, 3):
        g = generators(n)
        # Hermitian, traceless
        np.testing.assert_allclose(
            np.asarray(g), np.conj(np.swapaxes(np.asarray(g), -1, -2)), atol=1e-6
        )
        np.testing.assert_allclose(
            np.trace(np.asarray(g), axis1=-2, axis2=-1), 0.0, atol=1e-6
        )
        un = random_sun(key, n, (5,), scale=0.3)
        assert bool(is_unitary(un))
        np.testing.assert_allclose(np.linalg.det(np.asarray(un)), 1.0, atol=1e-4)


def test_sun_action_gauge_invariance(key):
    """SU(2) Wilson action invariant under random gauge transformation."""
    lt = lx = 4
    links = random_sun(key, 2, (lt, lx, 2), scale=0.5)
    g = random_sun(jax.random.fold_in(key, 1), 2, (lt, lx), scale=0.5)
    dagger = lambda m: jnp.conjugate(jnp.swapaxes(m, -1, -2))
    # U_mu(n) -> g(n) U_mu(n) g(n+mu)^+
    g_tp = jnp.roll(g, -1, axis=0)
    g_xp = jnp.roll(g, -1, axis=1)
    transformed = jnp.stack(
        [g @ links[..., 0, :, :] @ dagger(g_tp), g @ links[..., 1, :, :] @ dagger(g_xp)],
        axis=2,
    )
    np.testing.assert_allclose(
        float(sun_action(links, 2.0)), float(sun_action(transformed, 2.0)),
        rtol=1e-4, atol=1e-4,
    )


def test_sun_cold_action_zero():
    eye2 = jnp.tile(jnp.eye(2, dtype=jnp.complex64), (4, 4, 2, 1, 1))
    np.testing.assert_allclose(float(sun_action(eye2, 3.0)), 0.0, atol=1e-5)


def test_nuts_gaussian_moments(key):
    """NUTS on an anisotropic Gaussian recovers the marginal variances."""
    scales = jnp.array([1.0, 4.0, 0.25])
    pot = lambda x: 0.5 * jnp.sum(scales * x * x, axis=-1)
    x0 = jax.random.normal(key, (64, 3)) / jnp.sqrt(scales)
    xs, acc, uturn = jax.jit(
        lambda k: nuts_chain(pot, x0, 1.0, k, 300, eps0=0.3, max_steps=16,
                             adapt_steps=100)
    )(key)
    est = np.asarray(xs)[150:].reshape(-1, 3).var(axis=0)
    np.testing.assert_allclose(est, 1.0 / np.asarray(scales), rtol=0.15)
    assert float(np.asarray(acc)[150:].mean()) > 0.4  # step size adapted sanely


def test_ais_gaussian_logz(key):
    """AIS between two Gaussians: log Z ratio is analytic.

    E0 = 0.5 x^2 (Z0 = sqrt(2 pi)), E1 = 0.5 x^2 / s^2 (Z1 = s sqrt(2 pi))
    => log(Z1/Z0) = log(s) per dimension.
    """
    d, s = 2, 2.0
    e0 = lambda x: 0.5 * jnp.sum(x * x, axis=-1)
    e1 = lambda x: 0.5 * jnp.sum(x * x, axis=-1) / (s * s)
    x0 = jax.random.normal(key, (512, d))
    logw = jax.jit(
        lambda k, x: ais_log_weights(k, x, e0, e1, num_betas=200, eps=0.3,
                                     num_leapfrog=5)
    )(jax.random.fold_in(key, 1), x0)
    logz = float(log_mean_exp(logw))
    np.testing.assert_allclose(logz, d * np.log(s), atol=0.1)


def test_systematic_resample_unbiased(key):
    log_w = jnp.log(jnp.array([0.1, 0.2, 0.3, 0.4]))
    counts = np.zeros(4)
    for i in range(200):
        idx = systematic_resample(jax.random.fold_in(key, i), log_w)
        counts += np.bincount(np.asarray(idx), minlength=4)
    freq = counts / counts.sum()
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_smc_logz_gaussian(key):
    """SMC over a beta ladder on U = 0.5 x^2: Z(b) = (2 pi / b)^(d/2)
    => log Z(4)/Z(1) = -(d/2) log 4."""
    d = 2
    pot = lambda x: 0.5 * jnp.sum(x * x, axis=-1)

    def move(x, b, k, _):
        # scale eps with 1/sqrt(beta): the target tightens as beta grows
        def one(x, kk):
            return hmc_transition(pot, x, b, kk, 0.4 / jnp.sqrt(b), 5).x_out, None

        x, _ = jax.lax.scan(one, x, jax.random.split(k, 4))
        return x

    x0 = jax.random.normal(key, (1024, d))  # exact samples at beta=1
    betas = jnp.linspace(1.0, 4.0, 31)
    final, ess_trace = smc_beta_ladder(
        jax.random.fold_in(key, 1), x0, pot, betas, move
    )
    np.testing.assert_allclose(
        float(final.log_z), -(d / 2) * np.log(4.0), atol=0.1
    )
    # particles should now look like beta=4 samples: var = 1/4
    np.testing.assert_allclose(
        np.asarray(final.x).var(axis=0), 0.25, rtol=0.2
    )
