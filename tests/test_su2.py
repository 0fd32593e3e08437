"""SU(2) quaternion lattice + Lie-group HMC tests, anchored to the complex
matrix implementation and the exact single-plaquette expectation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import su2
from l2hmc.lattice.sun import sun_action, sun_plaquette
from l2hmc.dynamics.su2_hmc import su2_hmc_chain, su2_hmc_transition


def test_quaternion_algebra(key):
    a = su2.qnormalize(jax.random.normal(key, (5, 4)))
    b = su2.qnormalize(jax.random.normal(jax.random.fold_in(key, 1), (5, 4)))
    # product matches matrix product
    ma, mb = su2.to_matrix(a), su2.to_matrix(b)
    np.testing.assert_allclose(
        np.asarray(su2.to_matrix(su2.qmul(a, b))), np.asarray(ma @ mb),
        rtol=1e-5, atol=1e-6,
    )
    # dagger
    dag = lambda m: np.conj(np.swapaxes(np.asarray(m), -1, -2))
    np.testing.assert_allclose(
        np.asarray(su2.to_matrix(su2.qconj(a))), dag(ma), rtol=1e-5, atol=1e-6
    )
    # unitarity of to_matrix
    np.testing.assert_allclose(
        np.asarray(ma) @ dag(ma), np.tile(np.eye(2), (5, 1, 1)), atol=1e-5
    )


def test_q_exp(key):
    theta = 0.7 * jax.random.normal(key, (4, 3))
    q = su2.q_exp(theta)
    np.testing.assert_allclose(jnp.linalg.norm(q, axis=-1), 1.0, rtol=1e-6)
    # matches scipy matrix exponential of i theta.sigma/2
    from scipy.linalg import expm

    PAULI = np.array(
        [[[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]]
    )
    for i in range(4):
        h = sum(theta[i, k] * PAULI[k] for k in range(3)) / 2.0
        np.testing.assert_allclose(
            np.asarray(su2.to_matrix(q[i])), expm(1j * np.asarray(h)),
            rtol=1e-5, atol=1e-5,
        )


def test_action_matches_matrix_form(key):
    links_q = su2.random_links(key, 3, 4, 4)
    links_m = su2.to_matrix(links_q)
    np.testing.assert_allclose(
        np.asarray(su2.wilson_action(links_q, 2.0)),
        np.asarray(sun_action(links_m, 2.0)),
        rtol=1e-4, atol=1e-4,
    )


def test_action_gauge_invariance(key):
    links = su2.random_links(key, 2, 4, 4)
    g = su2.qnormalize(jax.random.normal(jax.random.fold_in(key, 3), (2, 4, 4, 4)))
    g_tp = jnp.roll(g, -1, axis=1)
    g_xp = jnp.roll(g, -1, axis=2)
    transformed = jnp.stack(
        [
            su2.qmul(su2.qmul(g, links[..., 0, :]), su2.qconj(g_tp)),
            su2.qmul(su2.qmul(g, links[..., 1, :]), su2.qconj(g_xp)),
        ],
        axis=-2,
    )
    np.testing.assert_allclose(
        np.asarray(su2.wilson_action(links, 2.0)),
        np.asarray(su2.wilson_action(transformed, 2.0)),
        rtol=1e-4, atol=1e-3,
    )


def test_cold_action_zero():
    np.testing.assert_allclose(
        float(su2.wilson_action(su2.cold_links(2, 4, 4), 3.0).sum()), 0.0,
        atol=1e-5,
    )


def test_hmc_reversibility_volume(key):
    """Leapfrog energy drift small at small eps => acceptance ~ 1."""
    links = su2.random_links(key, 8, 4, 4, scale=0.3)
    out = su2_hmc_transition(links, 2.0, key, eps=0.02, num_steps=5)
    assert float(out.accept_prob.mean()) > 0.98


def test_su2_hmc_matches_exact_plaquette(key):
    """SU(2) HMC on 6x6 at beta=2: <Re tr P / 2> -> exact single-plaquette
    value (2-D factorization)."""
    plaqs, probs = jax.jit(
        lambda k: su2_hmc_chain(k, 6, 6, 2.0, num_samples=600, batch=16,
                                eps=0.12, num_steps=5)
    )(key)
    plaq = float(np.asarray(plaqs)[300:].mean())
    exact = su2.su2_plaq_exact(2.0)
    acc = float(np.asarray(probs).mean())
    assert acc > 0.6, f"acceptance {acc}"
    assert abs(plaq - exact) < 0.02, f"plaq {plaq:.5f} vs exact {exact:.5f}"
