"""d-dimensional SU(N) lattice tests (the working 4-D path).

The reference's 4-D SU(3) support is truncated scaffolding
(``lattice/gauge_generators.py:83-152``, ``lattice/lattice_old.py:5-118``);
these tests pin the working generalization: d=2 consistency with the
oracle-tested 2-D module, exact gauge invariance of Wilson and
rectangle-improved actions in 4-D, the c1=0 reduction, and a 4-D SU(2)
HMC run against the strong-coupling expansion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import sun, sun_nd


@pytest.fixture
def key():
    return jax.random.PRNGKey(7)


def test_nd_action_matches_2d(key):
    """d=2 wilson_action_nd must equal the 2-D module's sun_action."""
    links = sun_nd.random_links_nd(key, 3, batch=2, dims=(4, 4), scale=0.5)
    s_nd = sun_nd.wilson_action_nd(links, beta=2.0)
    s_2d = sun.sun_action(links, beta=2.0)
    np.testing.assert_allclose(np.asarray(s_nd), np.asarray(s_2d), rtol=1e-5)


def test_improved_reduces_to_wilson(key):
    links = sun_nd.random_links_nd(key, 2, batch=2, dims=(3, 3, 3, 3), scale=0.5)
    s_w = sun_nd.wilson_action_nd(links, beta=1.5)
    s_i = sun_nd.improved_action_nd(links, beta=1.5, c1=0.0)
    np.testing.assert_allclose(np.asarray(s_w), np.asarray(s_i), rtol=1e-5)


def test_gauge_invariance_4d(key):
    """Wilson and improved actions are exactly gauge invariant in 4-D."""
    k1, k2 = jax.random.split(key)
    links = sun_nd.random_links_nd(k1, 3, batch=2, dims=(3, 3, 3, 3), scale=0.5)
    g = sun.random_sun(k2, 3, (2, 3, 3, 3, 3), scale=1.0)
    gauged = sun_nd.gauge_transform_nd(links, g)
    for fn in (
        lambda u: sun_nd.wilson_action_nd(u, 2.0),
        lambda u: sun_nd.improved_action_nd(u, 2.0, c1=-1.0 / 12.0),
    ):
        a, b = np.asarray(fn(links)), np.asarray(fn(gauged))
        np.testing.assert_allclose(a, b, rtol=2e-4)


def test_gauge_transform_stays_in_sun(key):
    k1, k2 = jax.random.split(key)
    links = sun_nd.random_links_nd(k1, 2, batch=1, dims=(3, 3, 3), scale=0.5)
    g = sun.random_sun(k2, 2, (1, 3, 3, 3), scale=1.0)
    gauged = sun_nd.gauge_transform_nd(links, g)
    assert bool(sun.is_unitary(gauged, atol=1e-4))


def test_4d_su2_hmc_strong_coupling(key):
    """4-D SU(2) HMC at beta=0.5: <Re tr P/2> = beta/4 + O(beta^3).

    The O(beta^3) correction is ~1e-3 here (the 2-D exact value at this
    beta is 0.1237 vs leading order 0.125), so a 0.012 tolerance tests
    the sampler, not the truncation.
    """
    plaqs, probs = sun_nd.sun_nd_hmc_chain(
        key, n=2, dims=(3, 3, 3, 3), beta=0.5, num_samples=200,
        batch=8, eps=0.25, num_steps=4,
    )
    acc = float(jnp.mean(probs))
    measured = float(jnp.mean(plaqs[80:]))
    expected = sun_nd.sun_plaq_strong_coupling(2, 0.5)
    assert acc > 0.6, acc
    assert abs(measured - expected) < 0.012, (measured, expected)


def test_4d_su3_improved_hmc_runs(key):
    """4-D SU(3) with the rectangle-improved action: accepts and stays
    finite (the config class the reference's truncated scaffolding aims
    at)."""
    plaqs, probs = sun_nd.sun_nd_hmc_chain(
        key, n=3, dims=(3, 3, 3, 3), beta=1.0, num_samples=25,
        batch=2, eps=0.08, num_steps=3, c1=-1.0 / 12.0,
    )
    assert np.isfinite(np.asarray(plaqs)).all()
    assert float(jnp.mean(probs[5:])) > 0.5


def test_pair_actions_match_complex(key):
    """The float32 (re,im)-pair forms equal the complex forms exactly."""
    from l2hmc.ops import cmat

    links = sun_nd.random_links_nd(key, 3, batch=2, dims=(3, 3, 3), scale=0.5)
    pairs = cmat.to_pairs(links)
    np.testing.assert_allclose(
        np.asarray(sun_nd.wilson_action_nd_pairs(pairs, 2.0)),
        np.asarray(sun_nd.wilson_action_nd(links, 2.0)), rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(sun_nd.improved_action_nd_pairs(pairs, 2.0, -1 / 12)),
        np.asarray(sun_nd.improved_action_nd(links, 2.0, -1 / 12)), rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(sun_nd.avg_plaq_nd_pairs(pairs)),
        np.asarray(sun_nd.avg_plaq_nd(links)), rtol=2e-5)


def test_pair_group_ops_match_complex(key):
    from l2hmc.lattice.sun import generators
    from l2hmc.ops import cmat, su_matrix

    for n in (2, 3):
        gens = generators(n)
        a = 0.4 * jax.random.normal(jax.random.fold_in(key, n), (32, gens.shape[0]))
        h = jnp.einsum("bk,kij->bij", a.astype(jnp.complex64), gens)
        want = su_matrix.expm_ih(h)
        got = cmat.from_pairs(cmat.cexpm(cmat.to_pairs(h)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=5e-6)
        drift = want + 2e-3
        np.testing.assert_allclose(
            np.asarray(cmat.from_pairs(cmat.polar_reunitarize(cmat.to_pairs(drift)))),
            np.asarray(su_matrix.polar_reunitarize(drift)), atol=5e-6)


def test_pair_hmc_trajectory_matches_complex(key):
    """Same PRNG keys => the pair and complex HMC chains follow the same
    trajectory (representation equivalence, not just same distribution)."""
    kwargs = dict(n=2, dims=(3, 3, 3), beta=1.0, num_samples=10,
                  batch=4, eps=0.15, num_steps=3)
    p_c, a_c = sun_nd.sun_nd_hmc_chain(key, real_pairs=False, **kwargs)
    p_p, a_p = sun_nd.sun_nd_hmc_chain(key, real_pairs=True, **kwargs)
    np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_c), atol=2e-4)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_c), atol=2e-4)


def test_pair_hmc_shards_over_chain_axis():
    """4-D SU(N) chains shard over the mesh data axis (embarrassingly
    parallel batch; XLA partitions the whole transition, no collectives on
    the hot path)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("data",))
    key = jax.random.PRNGKey(0)
    links = sun_nd.random_links_nd_pairs(key, 2, 16, (3, 3, 3), scale=0.5)
    sharded = jax.device_put(
        links, NamedSharding(mesh, P("data", None, None, None, None, None, None)))
    action = lambda u: sun_nd.wilson_action_nd_pairs(u, 1.0)

    f = jax.jit(lambda u, k: sun_nd.sun_nd_hmc_transition_pairs(
        u, k, 0.15, 2, action))
    out_sharded = f(sharded, key)
    out_single = f(links, key)
    np.testing.assert_allclose(
        np.asarray(out_sharded.accept_prob),
        np.asarray(out_single.accept_prob), atol=1e-4)
    # result keeps the batch sharding
    assert len(out_sharded.links.sharding.device_set) == 8
