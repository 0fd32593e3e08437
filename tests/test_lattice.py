"""Unit tests for the U(1) lattice core.

These formalize the reference's implicit oracles (SURVEY §4): the analytic
plaquette anchor, gauge invariance of the Wilson action, and integer
topological charge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import (
    LatticeShape,
    avg_plaquette,
    make_potential_fn,
    observables,
    plaq_sums,
    project_angle,
    project_angle_approx,
    random_links,
    to_flat,
    to_links,
    topological_charge,
    u1_plaq_exact,
    wilson_action,
    wrap,
)

SHAPE = LatticeShape(8, 8)


def test_shapes():
    assert SHAPE.num_links == 128
    assert SHAPE.num_plaquettes == 64
    x = jnp.zeros((4, SHAPE.num_links))
    links = to_links(x, SHAPE)
    assert links.shape == (4, 8, 8, 2)
    assert to_flat(links).shape == (4, 128)
    assert plaq_sums(links).shape == (4, 8, 8)


def test_cold_lattice_observables():
    """Cold start: all angles zero => S=0, <P>=1, Q=0."""
    x = jnp.zeros((3, SHAPE.num_links))
    obs = observables(x, SHAPE)
    np.testing.assert_allclose(obs["actions"], 0.0, atol=1e-6)
    np.testing.assert_allclose(obs["plaqs"], 1.0, atol=1e-6)
    np.testing.assert_allclose(obs["charges"], 0.0, atol=1e-6)


def test_gauge_invariance(key):
    """Wilson action is invariant under local gauge transformations.

    A U(1) gauge transformation with site angles a(t,x) maps
    U_mu(n) -> a(n) + U_mu(n) - a(n + mu).  The action, plaquettes, and
    charge must not change.  (The reference never tests this; it is the
    defining property of the theory.)
    """
    k1, k2 = jax.random.split(key)
    links = jax.random.uniform(k1, (5, 8, 8, 2), minval=-np.pi, maxval=np.pi)
    alpha = jax.random.uniform(k2, (5, 8, 8), minval=-np.pi, maxval=np.pi)
    transformed = jnp.stack(
        [
            alpha + links[..., 0] - jnp.roll(alpha, -1, axis=-2),  # time dir
            alpha + links[..., 1] - jnp.roll(alpha, -1, axis=-1),  # space dir
        ],
        axis=-1,
    )
    np.testing.assert_allclose(
        wilson_action(links), wilson_action(transformed), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        avg_plaquette(links), avg_plaquette(transformed), rtol=1e-5, atol=1e-5
    )


def test_topological_charge_is_integer(key):
    links = jax.random.uniform(key, (16, 8, 8, 2), minval=-np.pi, maxval=np.pi)
    q = topological_charge(links)
    np.testing.assert_allclose(q, jnp.round(q), atol=1e-4)


def test_project_angle():
    x = jnp.array([0.1, np.pi + 0.1, -np.pi - 0.1, 2 * np.pi + 0.3, -7.0])
    y = project_angle(x)
    assert jnp.all(y >= -np.pi) and jnp.all(y < np.pi)
    np.testing.assert_allclose(jnp.cos(y), jnp.cos(x), atol=1e-6)
    np.testing.assert_allclose(jnp.sin(y), jnp.sin(x), atol=1e-6)


def test_project_angle_approx_matches_reference_series():
    """The Fourier surrogate must equal sum_{n=1}^{N-1} (-2/n)(-1)^n sin(nx)
    (reference gauge_model.py:94-108) and roughly track the exact projection
    away from the discontinuity."""
    x = jnp.linspace(-2.5, 2.5, 41)
    y = project_angle_approx(x, n_terms=5)
    expected = sum(
        (-2.0 / n) * ((-1.0) ** n) * np.sin(n * np.asarray(x)) for n in range(1, 5)
    )
    np.testing.assert_allclose(y, expected, rtol=1e-5, atol=1e-5)
    # Tracks the identity (= exact projection on (-pi, pi)) loosely.
    mask = np.abs(np.asarray(x)) < 2.0
    assert np.max(np.abs(np.asarray(y)[mask] - np.asarray(x)[mask])) < 0.5


def test_u1_plaq_exact_values():
    """Analytic anchor I1(beta)/I0(beta) (scipy ground truth).

    Note: BASELINE.md quotes 0.7847 / 0.8463 for beta=3/4, but the actual
    Bessel ratios are 0.80999 / 0.86352 (scipy.special.i1/i0); only the
    beta=2 figure there is correct.  We anchor to the true ratios.
    """
    np.testing.assert_allclose(float(u1_plaq_exact(2.0)), 0.69777, atol=2e-4)
    np.testing.assert_allclose(float(u1_plaq_exact(3.0)), 0.80999, atol=2e-4)
    np.testing.assert_allclose(float(u1_plaq_exact(4.0)), 0.86352, atol=2e-4)


def test_potential_fn_and_grad(key):
    pot = make_potential_fn(SHAPE)
    x = random_links(key, 4, SHAPE)
    e = pot(x)
    assert e.shape == (4,)
    assert jnp.all(e >= 0)  # 1 - cos >= 0
    g = jax.grad(lambda x: jnp.sum(pot(x)))(x)
    assert g.shape == x.shape
    assert jnp.all(jnp.isfinite(g))
    # Gradient vanishes at the cold configuration (action minimum).
    g0 = jax.grad(lambda x: jnp.sum(pot(x)))(jnp.zeros_like(x))
    np.testing.assert_allclose(g0, 0.0, atol=1e-6)


def test_wrap():
    x = jnp.array([[0.5, 4.0, -4.0, 7.0]])
    w = wrap(x)
    assert jnp.all(w >= -np.pi) and jnp.all(w < np.pi)
    np.testing.assert_allclose(jnp.exp(1j * np.asarray(w)), np.exp(1j * np.asarray(x)), atol=1e-5)


def test_action_shift_invariance(key):
    """Action invariant under global shift of all plaquette angles by 2*pi."""
    x = random_links(key, 3, SHAPE)
    links = to_links(x, SHAPE)
    # adding 2*pi to a single link changes every cos by nothing
    bumped = links.at[:, 0, 0, 0].add(2 * np.pi)
    np.testing.assert_allclose(
        wilson_action(links), wilson_action(bumped), rtol=1e-5, atol=1e-4
    )


def test_wilson_loop_1x1_is_plaquette(key):
    from l2hmc.lattice import wilson_loop_sums

    links = to_links(random_links(key, 2, SHAPE), SHAPE)
    np.testing.assert_allclose(
        np.asarray(wilson_loop_sums(links, 1, 1)), np.asarray(plaq_sums(links)),
        rtol=1e-6,
    )


def test_wilson_loop_stokes_identity(key):
    """Box-sum of plaquette angles == explicit boundary-link sum (abelian
    Stokes), at every site, for a generic random configuration."""
    from l2hmc.lattice import wilson_loop_sums

    r, t = 3, 2
    links = to_links(random_links(key, 2, SHAPE), SHAPE)
    u0, u1 = links[..., 0], links[..., 1]
    # telescoped boundary form of sum_{i<t,j<r} P(t0+i, x0+j)
    side_u0 = sum(
        jnp.roll(u0, (-i, 0), axis=(-2, -1))
        - jnp.roll(u0, (-i, -r), axis=(-2, -1))
        for i in range(t)
    )
    side_u1 = sum(
        jnp.roll(u1, (-t, -j), axis=(-2, -1))
        - jnp.roll(u1, (0, -j), axis=(-2, -1))
        for j in range(r)
    )
    np.testing.assert_allclose(
        np.asarray(wilson_loop_sums(links, r, t)),
        np.asarray(side_u0 + side_u1),
        rtol=1e-4, atol=1e-4,
    )


def test_wilson_loop_area_law(key):
    """Metropolis ensemble at beta=2 reproduces <W(RxT)> = (I1/I0)^{RT} and
    the Creutz ratio -log(I1/I0)."""
    from l2hmc.lattice import creutz_ratio, wilson_loop, wilson_loop_exact
    from l2hmc.lattice.metropolis import metropolis_sweep

    beta = 2.0
    links = to_links(random_links(key, 16, SHAPE), SHAPE)

    def body(ls, k):
        out, _ = metropolis_sweep(ls, beta, k, 1.0)
        return out, jnp.stack(
            [wilson_loop(out, 2, 2), wilson_loop(out, 1, 1),
             wilson_loop(out, 1, 2), wilson_loop(out, 2, 1)]
        )

    keys = jax.random.split(jax.random.fold_in(key, 7), 400)
    _, ws = jax.lax.scan(body, links, keys)
    w22, w11, w12, w21 = np.asarray(ws)[200:].mean(axis=(0, 2))
    assert abs(w22 - float(wilson_loop_exact(beta, 4))) < 0.02, w22
    assert abs(w12 - float(wilson_loop_exact(beta, 2))) < 0.02, w12
    chi = float(creutz_ratio(w22, w11, w12, w21))
    exact_chi = -float(np.log(u1_plaq_exact(beta)))
    assert abs(chi - exact_chi) < 0.06, (chi, exact_chi)


def test_improved_action_reduces_to_wilson(key):
    """c1=0 improved action == Wilson action exactly."""
    from l2hmc.lattice.u1 import improved_action

    links = jax.random.uniform(key, (4, 6, 6, 2), minval=-np.pi, maxval=np.pi)
    np.testing.assert_allclose(
        np.asarray(improved_action(links, c1=0.0)),
        np.asarray(wilson_action(links)),
        rtol=1e-6,
    )


def test_improved_action_gauge_invariance(key):
    """Rectangle sums close, so the improved action is gauge invariant."""
    from l2hmc.lattice.u1 import improved_action

    k1, k2 = jax.random.split(key)
    links = jax.random.uniform(k1, (3, 8, 8, 2), minval=-np.pi, maxval=np.pi)
    alpha = jax.random.uniform(k2, (3, 8, 8), minval=-np.pi, maxval=np.pi)
    transformed = jnp.stack(
        [
            alpha + links[..., 0] - jnp.roll(alpha, -1, axis=-2),
            alpha + links[..., 1] - jnp.roll(alpha, -1, axis=-1),
        ],
        axis=-1,
    )
    np.testing.assert_allclose(
        np.asarray(improved_action(links)),
        np.asarray(improved_action(transformed)),
        rtol=1e-5, atol=1e-4,
    )


def test_improved_action_strong_coupling(key):
    """HMC under the improved action at beta=0.2: <cos P> = c0*beta/2 + O(beta^2).

    At leading strong-coupling order the rectangle term cannot contribute to
    the plaquette expectation (cos P cos R integrates to zero over any link
    both loops share), so the improved theory's plaquette is the Wilson
    result at coupling c0*beta.  Anchors the sign/normalization of the
    rectangle sums against an analytic value.
    """
    from l2hmc.dynamics.hmc import hmc_chain
    from l2hmc.lattice.u1 import make_improved_potential_fn, wrap

    beta, c1 = 0.2, -1.0 / 12.0
    shape = LatticeShape(6, 6)
    potential = make_improved_potential_fn(shape, c1)
    x0 = random_links(key, 64, shape)
    xs, probs = hmc_chain(
        potential, x0, beta, jax.random.fold_in(key, 3),
        eps=0.5, num_leapfrog=5, num_samples=400, wrap_fn=wrap,
    )
    assert float(jnp.mean(probs)) > 0.6
    plaqs = jax.vmap(lambda x: avg_plaquette(to_links(x, shape)))(xs[150:])
    measured = float(jnp.mean(plaqs))
    expected = (1.0 - 8.0 * c1) * beta / 2.0
    assert abs(measured - expected) < 0.012, (measured, expected)


def test_topological_susceptibility_exact_oracle(key):
    """Long Metropolis run reproduces the exact finite-volume <Q^2>.

    The quadrature oracle (convolution of the one-plaquette density on
    2 pi Z) is the analytic anchor for BASELINE.json's "<Q^2> within MC
    error" target; charge tunneling is fast at beta=2 on 4x4, so the MC
    estimate is tight.
    """
    from l2hmc.lattice.metropolis import metropolis_sweep
    from l2hmc.lattice.u1 import topological_susceptibility_exact

    shape = LatticeShape(4, 4)
    beta = 2.0
    links = to_links(random_links(key, 64, shape), shape)

    def body(ls, k):
        out, _ = metropolis_sweep(ls, beta, k, 1.0)
        return out, topological_charge(out)

    keys = jax.random.split(jax.random.fold_in(key, 11), 2000)
    _, qs = jax.lax.scan(body, links, keys)
    q = np.asarray(qs)[400:]
    measured = float((q * q).mean())
    exact = topological_susceptibility_exact(beta, shape.num_plaquettes)
    assert abs(measured - exact) < 0.04, (measured, exact)
