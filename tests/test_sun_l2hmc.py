"""Trainable SU(N) L2HMC tests: exact-inverse kernel, HMC limit at init,
and training actually improving mixing while preserving the stationary
distribution (Weyl-measure plaquette oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from l2hmc.dynamics.sun_hmc import sun_plaq_exact
from l2hmc.dynamics.sun_l2hmc import (
    SUNL2HMCConfig,
    init_sun_l2hmc,
    make_sun_dynamics,
    make_sun_train_step,
    plaq_trace_distance,
)
from l2hmc.lattice.sun import random_sun, sun_plaquette


CFG = SUNL2HMCConfig(n=2, num_steps=3, eps_init=0.15, hidden=16)


def _random_params(key, cfg):
    params = init_sun_l2hmc(key, cfg)
    return params._replace(net=params.net._replace(
        w_s=0.3 * jax.random.normal(jax.random.fold_in(key, 1), params.net.w_s.shape),
        w_t=0.3 * jax.random.normal(jax.random.fold_in(key, 2), params.net.w_t.shape),
        w_q=0.3 * jax.random.normal(jax.random.fold_in(key, 3), params.net.w_q.shape),
    ))


def test_reversibility_and_logdet_antisymmetry(key):
    """backward(forward(u, p)) == (u, p) with cancelling log-Jacobians,
    for generic (non-zero) network heads."""
    params = _random_params(key, CFG)
    dyn = make_sun_dynamics(CFG, 2.0)
    u = random_sun(jax.random.fold_in(key, 4), 2, (4, 4, 4, 2), scale=0.4)
    p = jax.random.normal(jax.random.fold_in(key, 5), u.shape[:-2] + (3,))
    d = jnp.ones(4)
    u1, p1, ld1 = dyn["integrate"](params, u, p, d)
    u2, p2, ld2 = dyn["integrate"](params, u1, p1, -d)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u), atol=2e-5)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p), atol=2e-5)
    np.testing.assert_allclose(np.asarray(ld1 + ld2), 0.0, atol=1e-4)


def test_hmc_limit_at_init(key):
    """Zero-initialized heads => plain Lie-group HMC: zero log-Jacobian and
    ~1 acceptance at small eps."""
    cfg = CFG._replace(eps_init=0.02)
    params = init_sun_l2hmc(key, cfg)
    dyn = make_sun_dynamics(cfg, 2.0)
    u = random_sun(jax.random.fold_in(key, 4), 2, (8, 4, 4, 2), scale=0.3)
    out = dyn["transition"](params, u, key)
    np.testing.assert_allclose(np.asarray(out["sumlogdet"]), 0.0, atol=1e-6)
    assert float(out["accept_prob"].mean()) > 0.98


def test_training_beats_hmc_mixing(key):
    """A few hundred ESJD steps: jump distance well above the plain-HMC
    kernel it starts from, acceptance healthy, plaquette on the oracle."""
    beta, B = 2.0, 16
    cfg = CFG
    params = init_sun_l2hmc(key, cfg)
    opt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(optax.warmup_exponential_decay_schedule(0.0, 1e-3, 50, 1000, 0.96)),
    )
    train_step, dyn = make_sun_train_step(cfg, beta, opt)
    u = random_sun(jax.random.fold_in(key, 9), 2, (B, 4, 4, 2), scale=0.5)
    opt_state = opt.init(params)

    @jax.jit
    def chunk(params, opt_state, u, k):
        def body(c, kk):
            params, opt_state, u = c
            params, opt_state, u, m = train_step(params, opt_state, u, kk)
            return (params, opt_state, u), m

        keys = jax.random.split(k, 125)
        (params, opt_state, u), ms = jax.lax.scan(
            body, (params, opt_state, u), keys
        )
        return params, opt_state, u, ms

    k = key
    for _ in range(2):
        k, sub = jax.random.split(k)
        params, opt_state, u, ms = chunk(params, opt_state, u, sub)

    @jax.jit
    def evaluate(params, u, k):
        def body(u, kk):
            out = dyn["transition"](params, u, kk)
            plaq = jnp.mean(
                jnp.trace(sun_plaquette(out["x_out"]), axis1=-2, axis2=-1).real
                / 2.0, axis=(-2, -1),
            )
            return out["x_out"], (
                plaq_trace_distance(u, out["x_out"]), out["accept_prob"], plaq
            )

        keys = jax.random.split(k, 300)
        return jax.lax.scan(body, u, keys)

    _, (dists, accs, plaqs) = evaluate(params, u, jax.random.fold_in(k, 77))
    esjd = float(dists[100:].mean())
    acc = float(accs.mean())
    plaq = float(plaqs[100:].mean())
    # plain HMC at the init eps=0.15 measures ESJD ~0.11 on this system
    assert esjd > 0.15, f"trained ESJD {esjd}"
    assert acc > 0.7, f"acceptance {acc}"
    assert abs(plaq - sun_plaq_exact(2, beta)) < 0.025, plaq


def test_pair_representation_matches_complex(key):
    """real_pairs=True follows the same trajectory as the complex kernel
    under the same keys (the pair form must be the same sampler, not just
    similar)."""
    from l2hmc.ops import cmat

    cfg_c = SUNL2HMCConfig(n=2, num_steps=2, eps_init=0.12, hidden=8)
    cfg_p = cfg_c._replace(real_pairs=True)
    params = init_sun_l2hmc(key, cfg_c)
    dyn_c = make_sun_dynamics(cfg_c, 2.0)
    dyn_p = make_sun_dynamics(cfg_p, 2.0)
    u = random_sun(jax.random.fold_in(key, 1), 2, (4, 4, 4, 2), scale=0.5)
    up = cmat.to_pairs(u)
    kk = jax.random.fold_in(key, 2)
    out_c = dyn_c["transition"](params, u, kk)
    out_p = dyn_p["transition"](params, up, kk)
    np.testing.assert_allclose(
        np.asarray(out_p["accept_prob"]), np.asarray(out_c["accept_prob"]),
        atol=3e-4)
    np.testing.assert_allclose(
        np.asarray(cmat.from_pairs(out_p["x_out"])), np.asarray(out_c["x_out"]),
        atol=3e-4)


def test_pair_training_step_runs(key):
    """One ESJD train step in pair mode: finite loss, kernel stays on the
    group."""
    from l2hmc.lattice import sun_nd
    from l2hmc.lattice.sun import is_unitary
    from l2hmc.ops import cmat

    cfg = SUNL2HMCConfig(n=3, num_steps=2, eps_init=0.1, hidden=8,
                         real_pairs=True)
    params = init_sun_l2hmc(key, cfg)
    opt = optax.adam(1e-3)
    train_step, dyn = make_sun_train_step(cfg, 2.0, opt)
    u = sun_nd.random_links_nd_pairs(key, 3, 4, (4, 4), scale=0.5)
    opt_state = opt.init(params)
    params, opt_state, u, m = train_step(params, opt_state, u, key)
    assert np.isfinite(float(m["loss"]))
    assert bool(is_unitary(cmat.from_pairs(u), atol=1e-4))
