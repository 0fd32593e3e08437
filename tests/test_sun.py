"""SU(N) matrix-representation Lie-group HMC tests.

Covers the generalization of the quaternion SU(2) path to arbitrary N in
matrix form: reunitarization, energy conservation, oracle agreement for
SU(3) (the reference ships only SU(3) operators with no sampler —
``lattice/gauge_generators.py:83-152``), and cross-checks the Weyl-measure
quadrature oracle against the closed-form SU(2) Bessel ratio.
"""

import jax
import jax.numpy as jnp
import numpy as np

from l2hmc.lattice import su2
from l2hmc.lattice.sun import is_unitary, random_sun
from l2hmc.dynamics.sun_hmc import (
    _reunitarize,
    sun_hmc_chain,
    sun_hmc_transition,
    sun_plaq_exact,
)


def test_exact_oracle_su2_matches_bessel():
    """Weyl quadrature at N=2 must agree with I2/I1-style closed form."""
    for beta in (1.0, 2.0, 4.0):
        np.testing.assert_allclose(
            sun_plaq_exact(2, beta), su2.su2_plaq_exact(beta), atol=1e-4
        )


def test_reunitarize_projects_to_sun(key):
    u = random_sun(key, 3, (4,), scale=0.5)
    drifted = u * 1.01 + 0.01  # off the group
    proj = _reunitarize(drifted)
    assert bool(is_unitary(proj))
    np.testing.assert_allclose(
        np.asarray(jnp.linalg.det(proj)), np.ones(4), rtol=1e-4, atol=1e-4
    )
    # projection of an exact group element is (nearly) the identity map
    np.testing.assert_allclose(
        np.asarray(_reunitarize(u)), np.asarray(u), rtol=1e-4, atol=1e-4
    )


def test_su3_energy_conservation(key):
    """Small-eps leapfrog conserves H => acceptance ~ 1."""
    links = random_sun(key, 3, (4, 4, 4, 2), scale=0.3)
    out = sun_hmc_transition(links, 3.0, key, eps=0.02, num_steps=5, n=3)
    assert float(out.accept_prob.mean()) > 0.98


def test_su3_hmc_matches_exact_plaquette(key):
    """SU(3) HMC on 4x4 at beta=4: <Re tr P / 3> -> Weyl-measure exact
    single-plaquette value (2-D factorization over plaquettes)."""
    plaqs, probs = sun_hmc_chain(
        key, 3, 4, 4, 4.0, num_samples=300, batch=8, eps=0.1, num_steps=5
    )
    plaq = float(np.asarray(plaqs)[150:].mean())
    exact = sun_plaq_exact(3, 4.0)
    acc = float(np.asarray(probs).mean())
    assert acc > 0.6, f"acceptance {acc}"
    assert abs(plaq - exact) < 0.03, f"plaq {plaq:.5f} vs exact {exact:.5f}"
