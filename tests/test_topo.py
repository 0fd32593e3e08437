"""Instanton-hop (winding proposal) tests: exactness of the move family
that wins the topological channel.

The hop is only useful if it is *exact* — a biased global move would
corrupt every observable while "improving" tunneling.  These tests pin:
the winding field's uniform field strength, dQ = nu, the closed-form
action difference against a direct evaluation, and (slow tier) the
composite local+hop chain against the analytic plaquette and <Q^2>
oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics import topo
from l2hmc.dynamics.hmc import hmc_chain, hmc_transition
from l2hmc.lattice import u1

SHAPE = u1.LatticeShape(8, 8)


def test_winding_field_uniform_plaquettes():
    for nu in (1, -1, 2):
        w = topo.winding_field(SHAPE, nu)
        p = np.asarray(u1.plaq_sums(u1.to_links(w, SHAPE)))
        delta = 2 * np.pi * nu / SHAPE.num_plaquettes
        # every plaquette delta mod 2pi (the corner carries the -2pi nu wrap)
        wrapped = np.mod(p - delta + np.pi, 2 * np.pi) - np.pi
        assert np.allclose(wrapped, 0.0, atol=1e-4)
        # winding number of the pure field is exactly nu
        q = float(u1.topological_charge(u1.to_links(w, SHAPE)))
        assert abs(q - nu) < 1e-4


def test_hop_changes_charge_by_nu(key):
    # generic = no plaquette within delta of the +-pi branch cut (configs
    # with boundary plaquettes legitimately pick up extra charge — the
    # move stays exact; dQ == nu is the *generic* statement)
    x = u1.random_links(key, 8, SHAPE) * 0.1
    w = topo.winding_field(SHAPE, 1)
    nu = jnp.array([1.0, -1.0, 2.0, -2.0, 1.0, -1.0, 1.0, -1.0])
    x1 = u1.wrap(x + nu[:, None] * w[None, :])
    dq = u1.topological_charge(u1.to_links(x1, SHAPE)) - u1.topological_charge(
        u1.to_links(x, SHAPE))
    assert np.allclose(np.asarray(dq), np.asarray(nu), atol=1e-3)


def test_hop_delta_s_matches_direct_action(key):
    x = u1.random_links(key, 16, SHAPE)  # hot configs: generic angles
    w = topo.winding_field(SHAPE, 1)
    nu = jnp.array([1.0, -1.0] * 8)
    ds = topo.hop_delta_s(x, SHAPE, nu)
    direct = u1.wilson_action(u1.to_links(x + nu[:, None] * w[None, :], SHAPE)) \
        - u1.wilson_action(u1.to_links(x, SHAPE))
    assert np.allclose(np.asarray(ds), np.asarray(direct), atol=1e-4)


def test_hop_detailed_balance_pairwise(key):
    """p(x) q(nu) a(x->x') == p(x') q(-nu) a(x'->x) for the hop."""
    beta = 2.0
    x = u1.random_links(key, 8, SHAPE) * 0.5
    nu = jnp.ones((8,))
    ds_fwd = topo.hop_delta_s(x, SHAPE, nu)
    w = topo.winding_field(SHAPE, 1)
    x1 = x + w[None, :]  # unwrapped: action is 2pi-periodic anyway
    ds_bwd = topo.hop_delta_s(x1, SHAPE, -nu)
    # reverse action difference is exactly the negative of the forward one
    assert np.allclose(np.asarray(ds_fwd), -np.asarray(ds_bwd), atol=1e-4)
    # flow balance: e^{-beta S(x)} min(1, e^{-beta dS}) symmetric in x<->x'
    a_fwd = np.minimum(1.0, np.exp(-beta * np.asarray(ds_fwd)))
    a_bwd = np.minimum(1.0, np.exp(-beta * np.asarray(ds_bwd)))
    s_x = np.asarray(u1.wilson_action(u1.to_links(x, SHAPE)))
    s_x1 = np.asarray(u1.wilson_action(u1.to_links(x1, SHAPE)))
    lhs = np.exp(-beta * (s_x - s_x.min())) * a_fwd
    rhs = np.exp(-beta * (s_x1 - s_x.min())) * a_bwd
    assert np.allclose(lhs, rhs, rtol=1e-3)


def test_instanton_hop_runs_and_counts(key):
    x = u1.random_links(key, 32, SHAPE) * 0.1
    out = topo.instanton_hop(x, 2.0, key, SHAPE)
    assert out.x_out.shape == x.shape
    # accepted chains changed Q by nu; rejected are untouched
    dq = np.asarray(
        u1.topological_charge(u1.to_links(out.x_out, SHAPE))
        - u1.topological_charge(u1.to_links(x, SHAPE)))
    assert np.allclose(dq, np.asarray(out.nu), atol=1e-3)
    rej = np.asarray(out.accept_mask) == 0.0
    assert np.allclose(np.asarray(out.x_out)[rej], np.asarray(x)[rej])
    # wrapped output
    assert float(jnp.max(jnp.abs(out.x_out))) <= np.pi + 1e-5


def test_hop_acceptance_rises_with_volume(key):
    """The signature property: delta ~ 1/V makes hops CHEAPER at large L
    (where diffusive tunneling freezes)."""
    beta = 4.0
    accs = []
    for L in (8, 16):
        shape = u1.LatticeShape(L, L)
        pot = u1.make_potential_fn(shape)
        x = u1.random_links(key, 64, shape)
        xs, _ = hmc_chain(pot, x, beta, jax.random.fold_in(key, L), 0.1, 5,
                          300, wrap_fn=u1.wrap)
        out = topo.instanton_hop(xs[-1], beta, jax.random.fold_in(key, 2),
                                 shape)
        accs.append(float(out.accept_prob.mean()))
    assert accs[1] > accs[0] - 0.05  # non-decreasing (within noise)
    assert accs[1] > 0.3             # and genuinely open at 16x16 beta=4


def test_hop_eval_chunk_metrics(key):
    from l2hmc.train.gauge import GaugeConfig, init_train_state

    cfg = GaugeConfig(time_size=8, space_size=8, num_chains=4, num_steps=2,
                      hmc=True, network_arch="zero", eps_init=0.15,
                      eps_trainable=False)
    state = init_train_state(cfg, key)
    chunk = topo.make_hop_eval_chunk(cfg, 5, n_hops=2)
    x, m = chunk(state.params, state.x, 2.0, key)
    for k in ("accept_prob", "plaqs", "charges", "hop_accept", "hop_dq"):
        assert m[k].shape == (5, 4), k


def test_composite_chain_stationary_on_oracles(key):
    """HMC + hop chain reproduces BOTH analytic anchors at 8x8 beta=2.

    A wrong hop (bad dS, bad winding field, asymmetric proposal) would
    bias <Q^2> hard — the hop dominates charge movement here.
    """
    beta = 2.0
    pot = u1.make_potential_fn(SHAPE)
    x = u1.random_links(key, 128, SHAPE)
    xs, _ = hmc_chain(pot, x, beta, jax.random.fold_in(key, 1), 0.15, 5, 400,
                      wrap_fn=u1.wrap)
    x = xs[-1]

    @jax.jit
    def run(x, key):
        def body(x, k):
            k1, k2 = jax.random.split(k)
            out = hmc_transition(pot, x, beta, k1, 0.15, 5)
            h = topo.instanton_hop(u1.wrap(out.x_out), beta, k2, SHAPE)
            obs = u1.observables(h.x_out, SHAPE)
            return h.x_out, (obs["plaqs"], obs["charges"])

        return jax.lax.scan(body, x, jax.random.split(key, 800))

    _, (pl, q) = run(x, jax.random.fold_in(key, 2))
    plaq = float(pl.mean())
    q2 = float((q ** 2).mean())
    assert abs(plaq - float(u1.u1_plaq_exact(beta))) < 3e-3
    q2_exact = u1.topological_susceptibility_exact(beta, SHAPE.num_plaquettes)
    assert abs(q2 - q2_exact) / q2_exact < 0.08
    # and the channel is actually unlocked: hops tunnel orders of magnitude
    # above the diffusive rate (HMC alone: ~0.2/step at this beta/volume)
    assert float(jnp.abs(jnp.diff(q, axis=0)).mean()) > 0.4
