"""Tests for the Wilson-action ops (analytic VJP vs autodiff) and the
small-matrix group math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import u1
from l2hmc.ops import wilson


def _random_links(key, b=4, lt=8, lx=8):
    return jax.random.uniform(key, (b, lt, lx, 2), minval=-np.pi, maxval=np.pi)


def test_analytic_forward_matches_reference(key):
    links = _random_links(key)
    np.testing.assert_allclose(
        wilson.wilson_action(links), u1.wilson_action(links), rtol=1e-5, atol=1e-5
    )


def test_analytic_vjp_matches_autodiff(key):
    links = _random_links(key)

    g_analytic = jax.grad(lambda l: jnp.sum(wilson.wilson_action(l)))(links)
    g_auto = jax.grad(lambda l: jnp.sum(u1.wilson_action(l)))(links)
    np.testing.assert_allclose(g_analytic, g_auto, rtol=1e-4, atol=1e-5)


def test_analytic_vjp_weighted_cotangent(key):
    """Non-uniform per-sample cotangents (as in beta * S with batch weights)."""
    links = _random_links(key)
    w = jnp.arange(1.0, 5.0)

    g_analytic = jax.grad(lambda l: jnp.sum(w * wilson.wilson_action(l)))(links)
    g_auto = jax.grad(lambda l: jnp.sum(w * u1.wilson_action(l)))(links)
    np.testing.assert_allclose(g_analytic, g_auto, rtol=1e-4, atol=1e-5)


def test_potential_fn_flat_contract(key):
    shape = u1.LatticeShape(8, 8)
    pot_fast = wilson.make_potential_fn(shape)
    pot_ref = u1.make_potential_fn(shape)
    x = u1.random_links(key, 6, shape)
    np.testing.assert_allclose(pot_fast(x), pot_ref(x), rtol=1e-5, atol=1e-5)
    g1 = jax.grad(lambda x: jnp.sum(pot_fast(x)))(x)
    g2 = jax.grad(lambda x: jnp.sum(pot_ref(x)))(x)
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-5)


def test_second_order_through_analytic_vjp(key):
    """Training differentiates through grad-of-action (second order); the
    custom VJP must support it.  custom_vjp is not forward-differentiable,
    so the dynamics takes grads of the *first* grad via another vjp —
    emulate that pattern here."""
    shape = u1.LatticeShape(4, 4)
    pot = wilson.make_potential_fn(shape)
    x = u1.random_links(key, 2, shape)

    def inner(x):
        g = jax.grad(lambda y: jnp.sum(pot(y)))(x)
        return jnp.sum(jnp.square(g))

    h = jax.grad(inner)(x)
    # compare against pure autodiff
    pot_ref = u1.make_potential_fn(shape)

    def inner_ref(x):
        g = jax.grad(lambda y: jnp.sum(pot_ref(y)))(x)
        return jnp.sum(jnp.square(g))

    h_ref = jax.grad(inner_ref)(x)
    np.testing.assert_allclose(h, h_ref, rtol=1e-3, atol=1e-4)


class TestSUMatrixOps:
    """Matmul-only small-matrix group math vs generic linalg."""

    def test_expm_su2_matches_pade(self):
        import jax
        from l2hmc.lattice.sun import generators
        from l2hmc.ops.su_matrix import expm_su2

        key = jax.random.PRNGKey(0)
        gens = generators(2)
        a = 0.7 * jax.random.normal(key, (64, 3))
        h = jnp.einsum("bk,kij->bij", a.astype(jnp.complex64), gens)
        ref = jax.scipy.linalg.expm(1j * h)
        np.testing.assert_allclose(
            np.asarray(expm_su2(h)), np.asarray(ref), atol=2e-6)

    def test_expm_taylor_matches_pade_su3(self):
        import jax
        from l2hmc.lattice.sun import generators
        from l2hmc.ops.su_matrix import expm_taylor

        key = jax.random.PRNGKey(1)
        gens = generators(3)
        a = 0.5 * jax.random.normal(key, (32, 8))
        h = jnp.einsum("bk,kij->bij", a.astype(jnp.complex64), gens)
        ref = jax.scipy.linalg.expm(1j * h)
        np.testing.assert_allclose(
            np.asarray(expm_taylor(h)), np.asarray(ref), atol=5e-6)

    def test_polar_reunitarize_projects_to_sun(self):
        import jax
        from l2hmc.lattice.sun import is_unitary, random_sun
        from l2hmc.ops.su_matrix import _det_small, polar_reunitarize

        key = jax.random.PRNGKey(2)
        u = random_sun(key, 3, (16,), scale=0.8)
        drift = u + 1e-3 * jax.random.normal(
            jax.random.fold_in(key, 1), u.shape, jnp.float32)
        fixed = polar_reunitarize(drift)
        assert bool(is_unitary(fixed, atol=1e-5))
        det = np.asarray(_det_small(fixed))
        np.testing.assert_allclose(det, np.ones_like(det), atol=1e-5)
        # projection moves the drifted matrix back near the original
        assert float(jnp.max(jnp.abs(fixed - u))) < 5e-3
