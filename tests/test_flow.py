"""Gauge-equivariant normalizing flow (dynamics/flow.py) property tests.

Exactness properties the construction guarantees: triangular Jacobian
(accumulated logdet == autodiff slogdet on link space), identity at init,
exact gauge equivariance, uniform-target exactness of the independence-MH
chain, and reverse-KL training improving the importance-weight ESS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics import flow as F
from l2hmc.lattice import u1


def _cfg(**kw):
    d = dict(time_size=4, space_size=4, num_layers=8, n_mix=3,
             hidden_channels=8)
    d.update(kw)
    return F.FlowConfig(**d)


def _randomized_params(key, cfg):
    """init_flow zero-inits the output conv (identity flow); perturb it so
    the flow is non-trivial for the Jacobian/equivariance checks."""
    params = F.init_flow(key, cfg)
    for i, p in enumerate(params):
        key, k = jax.random.split(key)
        p["c2"]["w"] = 0.3 * jax.random.normal(k, p["c2"]["w"].shape)
    return params


def test_rejects_sizes_not_divisible_by_4():
    """The mod-4 stripe invariants break on L % 4 != 0 (a side-effect
    stripe wraps into the context -> non-triangular Jacobian); the config
    must refuse rather than silently bias the density."""
    with pytest.raises(ValueError):
        _cfg(time_size=6, space_size=6)
    with pytest.raises(ValueError):
        _cfg(time_size=4, space_size=10)


def test_identity_at_init(key):
    cfg = _cfg()
    params = F.init_flow(key, cfg)
    z = jax.random.uniform(key, (3, 4, 4, 2), minval=-np.pi, maxval=np.pi)
    x, logdet = F.flow_forward(params, z, cfg)
    np.testing.assert_allclose(x, z, atol=1e-6)
    np.testing.assert_allclose(logdet, 0.0, atol=1e-6)


def test_logdet_matches_autodiff_jacobian_depth2(key):
    """Deeper conditioners must not disturb the triangular structure."""
    cfg = _cfg(num_layers=4, conditioner_depth=2)
    params = _randomized_params(key, cfg)

    def flat_flow(zf):
        x, _ = F.flow_forward(params, zf.reshape(1, 4, 4, 2), cfg)
        return x.reshape(-1)

    z = jax.random.uniform(key, (32,), minval=-np.pi, maxval=np.pi)
    jac = jax.jacfwd(flat_flow)(z)
    sign, logabsdet = np.linalg.slogdet(np.asarray(jac))
    _, logdet = F.flow_forward(params, z.reshape(1, 4, 4, 2), cfg)
    assert sign == 1.0
    np.testing.assert_allclose(float(logdet[0]), logabsdet, atol=1e-4)


def test_logdet_matches_autodiff_jacobian(key):
    cfg = _cfg()
    params = _randomized_params(key, cfg)

    def flat_flow(zf):
        x, _ = F.flow_forward(params, zf.reshape(1, 4, 4, 2), cfg)
        return x.reshape(-1)

    z = jax.random.uniform(key, (32,), minval=-np.pi, maxval=np.pi)
    jac = jax.jacfwd(flat_flow)(z)
    sign, logabsdet = np.linalg.slogdet(np.asarray(jac))
    _, logdet = F.flow_forward(params, z.reshape(1, 4, 4, 2), cfg)
    assert sign == 1.0
    np.testing.assert_allclose(float(logdet[0]), logabsdet, atol=1e-4)


def test_gauge_equivariance(key):
    cfg = _cfg(time_size=4, space_size=8)
    params = _randomized_params(key, cfg)
    kz, kg = jax.random.split(key)
    z = jax.random.uniform(kz, (2, 4, 8, 2), minval=-np.pi, maxval=np.pi)
    g = jax.random.uniform(kg, (4, 8), minval=-np.pi, maxval=np.pi)

    # U(1) gauge transform: u0(t,x) += g(t,x) - g(t+1,x);
    # u1(t,x) += g(t,x) - g(t,x+1)  (plaq_sums invariant by construction)
    u0 = z[..., 0] + g - jnp.roll(g, -1, axis=0)
    u1_ = z[..., 1] + g - jnp.roll(g, -1, axis=1)
    zg = u1.wrap(jnp.stack([u0, u1_], axis=-1))
    np.testing.assert_allclose(u1.plaq_sums(zg) % (2 * np.pi),
                               u1.plaq_sums(z) % (2 * np.pi), atol=1e-4)

    x, logdet = F.flow_forward(params, z, cfg)
    xg, logdetg = F.flow_forward(params, zg, cfg)
    # densities (logdets) identical; outputs identical up to the SAME
    # gauge transformation, so plaquette fields match exactly
    np.testing.assert_allclose(logdet, logdetg, atol=1e-4)
    np.testing.assert_allclose(
        np.cos(u1.plaq_sums(xg)), np.cos(u1.plaq_sums(x)), atol=1e-4)


def test_independence_mh_uniform_target_accepts_everything(key):
    """At beta=0 the target IS the base distribution and the identity flow
    proposes exactly from it -> every MH step accepts with probability 1."""
    cfg = _cfg()
    params = F.init_flow(key, cfg)
    k1, k2 = jax.random.split(key)
    x0, logq0 = F.sample_and_logq(params, k1, 8, cfg)
    _, _, accs = F.independence_mh_chain(params, k2, x0, logq0, 0.0, 20, cfg)
    np.testing.assert_allclose(np.asarray(accs), 1.0, atol=1e-6)


def test_reverse_kl_training_improves_ess(key):
    import optax

    cfg = _cfg(num_layers=8, hidden_channels=8, n_mix=3)
    beta = 1.0
    params = F.init_flow(key, cfg)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, k):
        (_, aux), grads = jax.value_and_grad(
            lambda p: F.reverse_kl_loss(p, k, 64, beta, cfg),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, aux

    k = key
    _, aux0 = F.reverse_kl_loss(params, k, 256, beta, cfg)
    for i in range(150):
        k, sub = jax.random.split(k)
        params, opt_state, aux = step(params, opt_state, sub)
    k, sub = jax.random.split(k)
    _, aux1 = F.reverse_kl_loss(params, sub, 256, beta, cfg)
    assert float(aux1["ess_frac"]) > float(aux0["ess_frac"]) * 1.5, (
        float(aux0["ess_frac"]), float(aux1["ess_frac"]))
    assert float(aux1["loss"]) < float(aux0["loss"])


def test_inverse_roundtrip_and_density(key):
    """flow_inverse undoes flow_forward to bisection tolerance, and
    logq_of at generated samples matches the forward-accumulated logq."""
    cfg = _cfg(time_size=4, space_size=8)
    params = _randomized_params(key, cfg)
    z = jax.random.uniform(key, (4, 4, 8, 2), minval=-np.pi, maxval=np.pi)
    x, logdet = F.flow_forward(params, z, cfg)
    z_rec, logdet_inv = F.flow_inverse(params, x, cfg)
    # compare on the circle (wrap-safe)
    np.testing.assert_allclose(np.cos(z_rec - z), 1.0, atol=1e-6)
    np.testing.assert_allclose(logdet_inv, -logdet, atol=1e-4)

    x2, logq = F.sample_and_logq(params, key, 4, cfg)
    np.testing.assert_allclose(F.logq_of(params, x2, cfg), logq, atol=1e-4)


def test_hybrid_chain_uniform_target_accepts_everything(key):
    """beta=0 + identity flow: q(current) == q(proposal) == base, target
    uniform -> the hybrid's flow accept probability is exactly 1."""
    cfg = _cfg()
    params = F.init_flow(key, cfg)
    links0 = jax.random.uniform(key, (8, 4, 4, 2), minval=-np.pi,
                                maxval=np.pi)
    _, _, _, f_acc, _ = F.flow_hmc_hybrid_chain(
        params, key, links0, 0.0, 10, 2, 0.3, 3, cfg)
    np.testing.assert_allclose(np.asarray(f_acc), 1.0, atol=1e-5)


def test_hybrid_chain_stationary_on_oracle(key):
    """An ARBITRARY (untrained, randomized) flow must leave the target
    invariant — the MH correction via logq_of carries the exactness, so a
    wrong inverse/density would bias the plaquette off the oracle."""
    cfg = _cfg()
    params = _randomized_params(key, cfg)
    beta = 1.0
    links0 = jnp.zeros((64, 4, 4, 2))
    _, _, plaqs, f_acc, _ = jax.jit(
        lambda k, l: F.flow_hmc_hybrid_chain(
            params, k, l, beta, 300, 2, 0.4, 4, cfg))(key, links0)
    measured = float(jnp.mean(np.asarray(plaqs)[100:]))
    exact = float(u1.u1_plaq_exact(beta))
    assert abs(measured - exact) < 0.02, (measured, exact)
    assert 0.0 < float(jnp.mean(f_acc))  # some flow moves actually accept


def test_logq_of_gradient_matches_finite_differences(key):
    """The bisection inverse is piecewise constant in the parameters; the
    Newton polish must supply the exact implicit-function derivative, or
    forward-KL (max-likelihood) training silently optimizes the wrong
    thing."""
    cfg = _cfg(num_layers=2, hidden_channels=4, n_mix=2)
    params = _randomized_params(key, cfg)
    x = jax.random.uniform(key, (2, 4, 4, 2), minval=-np.pi, maxval=np.pi)

    def loss(w_elem):
        p = jax.tree.map(lambda a: a, params)
        p[0]["c2"]["w"] = params[0]["c2"]["w"].at[0, 0, 0, 0].set(w_elem)
        return jnp.mean(F.logq_of(p, x, cfg))

    w0 = float(params[0]["c2"]["w"][0, 0, 0, 0])
    g_auto = float(jax.grad(loss)(jnp.asarray(w0)))
    eps = 1e-3
    g_fd = (float(loss(jnp.asarray(w0 + eps)))
            - float(loss(jnp.asarray(w0 - eps)))) / (2 * eps)
    np.testing.assert_allclose(g_auto, g_fd, rtol=2e-2, atol=1e-4)


def test_forward_kl_training_raises_likelihood(key):
    """A few max-likelihood steps on fixed 'data' must increase mean logq
    of that data (end-to-end check that gradients flow through the
    inverse)."""
    import optax

    cfg = _cfg(num_layers=4, hidden_channels=4, n_mix=2)
    params = F.init_flow(key, cfg)
    x = jax.random.uniform(key, (32, 4, 4, 2), minval=-1.0, maxval=1.0)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        l, grads = jax.value_and_grad(
            lambda p: F.forward_kl_loss(p, x, cfg))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, l

    l0 = float(F.forward_kl_loss(params, x, cfg))
    for _ in range(30):
        params, opt_state, l = step(params, opt_state)
    assert float(l) < l0 - 0.5, (l0, float(l))


def test_reweighted_plaquette_on_oracle(key):
    """Even the UNTRAINED (identity) flow gives an unbiased self-normalized
    importance estimate of the plaquette at small beta/volume."""
    cfg = _cfg()
    params = F.init_flow(key, cfg)
    x, log_w, log_z = F.importance_weights(params, key, 4096, 0.5, cfg)
    plaq = float(jnp.sum(jnp.exp(log_w) * u1.avg_plaquette(x)))
    exact = float(u1.u1_plaq_exact(0.5))
    assert abs(plaq - exact) < 0.02, (plaq, exact)
    # direct log Z vs the factorized analytic value
    log_z_exact = u1.log_z_exact_factorized(cfg.shape, 0.5)
    assert abs(float(log_z) - log_z_exact) < 0.3, (float(log_z), log_z_exact)
