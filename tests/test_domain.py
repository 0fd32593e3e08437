"""Lattice-domain decomposition tests: sharded Wilson action == replicated,
halo-exchanged gradients == autodiff, observables agree, on an 8-way mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from l2hmc.lattice import u1
from l2hmc.parallel.domain import make_domain_action
from l2hmc.parallel.mesh import get_mesh

SHAPE = u1.LatticeShape(16, 16)


@pytest.fixture(scope="module")
def mesh():
    return get_mesh(num_data=1, num_space=8)


@pytest.fixture
def sharded_links(mesh, key):
    links = jax.random.uniform(key, (4, 16, 16, 2), minval=-np.pi, maxval=np.pi)
    return jax.device_put(links, NamedSharding(mesh, P(None, "space", None, None)))


def test_domain_action_matches_replicated(mesh, sharded_links):
    dom = make_domain_action(mesh, SHAPE)
    a_sharded = jax.jit(dom["action"])(sharded_links)
    a_ref = u1.wilson_action(jax.device_get(sharded_links))
    np.testing.assert_allclose(np.asarray(a_sharded), np.asarray(a_ref), rtol=1e-5, atol=1e-4)


def test_domain_gradient_matches_autodiff(mesh, sharded_links):
    dom = make_domain_action(mesh, SHAPE)
    g_sharded = jax.jit(jax.grad(lambda l: jnp.sum(dom["action"](l))))(sharded_links)
    g_ref = jax.grad(lambda l: jnp.sum(u1.wilson_action(l)))(
        jax.device_get(sharded_links)
    )
    np.testing.assert_allclose(
        np.asarray(g_sharded), np.asarray(g_ref), rtol=1e-4, atol=1e-5
    )


def test_domain_weighted_gradient(mesh, sharded_links):
    dom = make_domain_action(mesh, SHAPE)
    w = jnp.arange(1.0, 5.0)
    g_sharded = jax.jit(jax.grad(lambda l: jnp.sum(w * dom["action"](l))))(sharded_links)
    g_ref = jax.grad(lambda l: jnp.sum(w * u1.wilson_action(l)))(
        jax.device_get(sharded_links)
    )
    np.testing.assert_allclose(
        np.asarray(g_sharded), np.asarray(g_ref), rtol=1e-4, atol=1e-5
    )


def test_domain_observables(mesh, sharded_links):
    dom = make_domain_action(mesh, SHAPE)
    obs_sharded = jax.jit(dom["observables"])(sharded_links)
    links = jax.device_get(sharded_links)
    obs_ref = u1.observables(u1.to_flat(jnp.asarray(links)), SHAPE)
    for k in ("actions", "plaqs", "charges"):
        np.testing.assert_allclose(
            np.asarray(obs_sharded[k]), np.asarray(obs_ref[k]), rtol=1e-4, atol=1e-4
        )


def test_domain_end_to_end_hmc(mesh, key):
    """HMC on the domain-sharded action samples the right plaquette."""
    from l2hmc.dynamics.hmc import hmc_chain

    dom = make_domain_action(mesh, SHAPE)
    batch = 8

    def potential(x):
        return dom["action"](x.reshape(batch, 16, 16, 2))

    x0 = jax.device_put(
        u1.random_links(key, batch, SHAPE),
        NamedSharding(mesh, P(None, None)),
    )
    xs, probs = jax.jit(
        lambda x0, k: hmc_chain(potential, x0, 2.0, k, 0.15, 10, 400,
                                wrap_fn=u1.wrap)
    )(x0, jax.random.fold_in(key, 1))
    final_links = np.asarray(xs)[200:].reshape(-1, 16, 16, 2)
    plaq = float(u1.avg_plaquette(jnp.asarray(final_links)).mean())
    exact = float(u1.u1_plaq_exact(2.0))
    assert abs(plaq - exact) < 0.03, f"plaq {plaq} vs {exact}"
    assert float(np.asarray(probs).mean()) > 0.5


def test_full_transition_domain_sharded_matches_replicated(key):
    """The COMPLETE transition (periodic CNN nets + Wilson VJP + MH) under
    `lattice_sharding` (batch over 'data', flat lattice over 'space') is
    bit-identical (to f32 roundoff) to the replicated run: GSPMD inserts
    the conv/roll halo exchanges and per-chain reduction psums itself."""
    from l2hmc.parallel.mesh import lattice_sharding, replicated
    from l2hmc.train.gauge import GaugeConfig, build_dynamics, init_train_state

    mesh = get_mesh(num_data=2, num_space=4)
    cfg = GaugeConfig(time_size=8, space_size=8, num_chains=4, num_steps=2,
                      network_arch="conv", num_filters=4, num_hidden=32)
    state = init_train_state(cfg, key)
    _, dyn, _ = build_dynamics(cfg)
    rep = replicated(mesh)
    xsh = lattice_sharding(mesh)

    params = jax.device_put(state.params, rep)
    x_sharded = jax.device_put(state.x, xsh)
    f = jax.jit(lambda p, x, k: dyn["transition"](p, x, 2.0, k),
                in_shardings=(rep, xsh, rep))
    out = f(params, x_sharded, key)
    out_ref = jax.jit(lambda p, x, k: dyn["transition"](p, x, 2.0, k))(
        state.params, state.x, key)
    np.testing.assert_allclose(
        np.asarray(out.x_out), np.asarray(out_ref.x_out), atol=5e-6)
    np.testing.assert_allclose(
        np.asarray(out.accept_prob), np.asarray(out_ref.accept_prob), atol=5e-6)
