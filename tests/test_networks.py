"""Network tests: shapes, init scaling, head semantics, and — the property
the reference never had — periodic (toroidal) equivariance of the CNN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.networks.nets import (
    ConvNetSpec,
    MLPNetSpec,
    make_conv_net,
    make_mlp_net,
    make_zero_net,
    periodic_pad_2d,
)


def test_mlp_shapes_and_heads(key):
    spec = MLPNetSpec(x_dim=16, num_hidden=32, factor=2.0)
    init, apply = make_mlp_net(spec)
    params = init(key)
    v = jax.random.normal(key, (5, 16))
    x = jax.random.normal(jax.random.fold_in(key, 1), (5, 16))
    t = jnp.tile(jnp.array([[1.0, 0.0]]), (5, 1))
    s, tr, q = apply(params, v, x, t)
    assert s.shape == tr.shape == q.shape == (5, 16)
    # scale head bounded by exp(coeff_scale)=1 at init (tanh * exp(0))
    assert jnp.max(jnp.abs(s)) <= 1.0 + 1e-6
    # heads are near zero at init (0.001 factor init)
    assert float(jnp.std(s)) < 0.1
    assert float(jnp.std(tr)) < 0.1
    assert float(jnp.std(q)) < 0.1


def test_mlp_head_formulas(key):
    """scale = tanh(.)*exp(coeff_scale): scaling coeff_scale scales output."""
    spec = MLPNetSpec(x_dim=8, num_hidden=16)
    init, apply = make_mlp_net(spec)
    params = init(key)
    v = jax.random.normal(key, (3, 8))
    x = jax.random.normal(jax.random.fold_in(key, 2), (3, 8))
    t = jnp.zeros((3, 2))
    s1, _, q1 = apply(params, v, x, t)
    params2 = {**params, "coeff_scale": params["coeff_scale"] + 1.0}
    s2, _, _ = apply(params2, v, x, t)
    np.testing.assert_allclose(s2, s1 * np.e, rtol=1e-5, atol=1e-6)


def test_zero_net(key):
    init, apply = make_zero_net(8)
    s, t, q = apply(init(key), jnp.ones((2, 8)), jnp.ones((2, 8)), jnp.zeros((2, 2)))
    assert float(jnp.sum(jnp.abs(s) + jnp.abs(t) + jnp.abs(q))) == 0.0


def test_periodic_pad():
    x = jnp.arange(2 * 4 * 4 * 1, dtype=jnp.float32).reshape(2, 4, 4, 1)
    y = periodic_pad_2d(x, 3)  # pad 1 both sides
    assert y.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(y[:, 0, 1:5], x[:, -1])
    np.testing.assert_allclose(y[:, -1, 1:5], x[:, 0])
    y2 = periodic_pad_2d(x, 2)  # pad 0 left, 1 right
    assert y2.shape == (2, 5, 5, 1)
    np.testing.assert_allclose(y2[:, -1, :4], x[:, 0])


@pytest.mark.parametrize("lt,lx", [(8, 8), (16, 16), (6, 10)])
def test_conv_shapes(key, lt, lx):
    spec = ConvNetSpec(time_size=lt, space_size=lx, num_filters=4, num_hidden=32)
    init, apply = make_conv_net(spec)
    params = init(key)
    d = spec.x_dim
    v = jax.random.normal(key, (3, d))
    x = jax.random.normal(jax.random.fold_in(key, 1), (3, d))
    t = jnp.zeros((3, 2))
    s, tr, q = apply(params, v, x, t)
    assert s.shape == tr.shape == q.shape == (3, d)


def test_conv_translation_covariant_trunk(key):
    """The conv stack with periodic padding must commute with lattice
    translations (up to the stride-2 coset): translating the input field by
    the stride shifts the conv features identically.  This is the toroidal
    geometry property the reference's zero-padding breaks."""
    from l2hmc.networks.nets import _grouped_conv, _conv_init

    p = _conv_init(key, 3, 3, 2, 4)
    img = jax.random.normal(key, (1, 8, 8, 2))
    out = _grouped_conv(img, p["w"], p["b"], 1)
    shifted = jnp.roll(img, shift=(2, 3), axis=(1, 2))
    out_shifted = _grouped_conv(shifted, p["w"], p["b"], 1)
    np.testing.assert_allclose(
        out_shifted, jnp.roll(out, shift=(2, 3), axis=(1, 2)), rtol=1e-4, atol=1e-5
    )


def test_conv_jit_and_grad(key):
    spec = ConvNetSpec(time_size=8, space_size=8, num_filters=4, num_hidden=32)
    init, apply = make_conv_net(spec)
    params = init(key)
    d = spec.x_dim

    def loss(params):
        v = jnp.ones((2, d))
        x = jnp.ones((2, d))
        t = jnp.zeros((2, 2))
        s, tr, q = apply(params, v, x, t)
        return jnp.sum(s**2) + jnp.sum(tr**2) + jnp.sum(q**2)

    g = jax.jit(jax.grad(loss))(params)
    assert all(jnp.all(jnp.isfinite(l)) for l in jax.tree_util.tree_leaves(g))


def test_bf16_compute_close_to_f32(key):
    spec32 = MLPNetSpec(x_dim=32, num_hidden=64, use_bf16=False)
    spec16 = MLPNetSpec(x_dim=32, num_hidden=64, use_bf16=True)
    init, apply32 = make_mlp_net(spec32)
    _, apply16 = make_mlp_net(spec16)
    params = init(key)
    v = jax.random.normal(key, (4, 32))
    x = jax.random.normal(jax.random.fold_in(key, 3), (4, 32))
    t = jnp.zeros((4, 2))
    for a, b in zip(apply32(params, v, x, t), apply16(params, v, x, t)):
        np.testing.assert_allclose(a, b, atol=0.05, rtol=0.1)


def test_lrn_variant(key):
    """ConvNet2D parity: LRN between conv stages (conv_net.py:466-478)."""
    from l2hmc.networks.nets import local_response_norm

    x = jax.random.normal(key, (2, 4, 4, 8))
    y = local_response_norm(x)
    assert y.shape == x.shape
    # matches the definitional formula for the middle channel
    sq = np.asarray(x) ** 2
    c = 4
    window = sq[..., max(0, c - 5):c + 6].sum(-1)
    expected = np.asarray(x)[..., c] / (2.0 + 1e-4 * window) ** 0.75
    np.testing.assert_allclose(np.asarray(y)[..., c], expected, rtol=1e-5)

    spec = ConvNetSpec(time_size=8, space_size=8, num_filters=4, num_hidden=32,
                       use_lrn=True)
    init, apply = make_conv_net(spec)
    params = init(key)
    s, t, q = apply(params, jnp.ones((2, 128)), jnp.ones((2, 128)), jnp.zeros((2, 2)))
    assert np.isfinite(np.asarray(s)).all()


# ---------------------------------------------------------------------------
# Local (weight-shared per-link) conditioner
# ---------------------------------------------------------------------------


def _roll_links_flat(flat, lt, lx, n_ch, st, sx):
    """Translate a flat per-link field (or cos/sin feature field) on the
    torus: reshape to images, roll both spatial axes, flatten back."""
    b = flat.shape[0]
    if n_ch == 2:
        img = flat.reshape(b, lt, lx, 2)
        return jnp.roll(img, (st, sx), axis=(1, 2)).reshape(b, -1)
    cos_p, sin_p = jnp.split(flat, 2, axis=-1)
    out = []
    for part in (cos_p, sin_p):
        img = part.reshape(b, lt, lx, 2)
        out.append(jnp.roll(img, (st, sx), axis=(1, 2)).reshape(b, -1))
    return jnp.concatenate(out, axis=-1)


def test_local_net_shapes_and_identity_init(key):
    from l2hmc.networks.nets import LocalNetSpec, make_local_net

    spec = LocalNetSpec(time_size=6, space_size=4, channels=8, factor=2.0)
    init, apply = make_local_net(spec)
    params = init(key)
    d = spec.x_dim
    v = jax.random.normal(key, (3, d))
    x = jax.random.normal(jax.random.fold_in(key, 1), (3, d))
    t = jnp.tile(jnp.array([[1.0, 0.0]]), (3, 1))
    s, tr, q = apply(params, v, x, t)
    assert s.shape == tr.shape == q.shape == (3, d)
    # near-identity init (0.001-factor head)
    assert float(jnp.std(s)) < 0.05
    assert float(jnp.std(tr)) < 0.05
    # no dense trunk: parameter count is volume-independent
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    spec_big = LocalNetSpec(time_size=32, space_size=32, channels=8, factor=2.0)
    init_big, _ = make_local_net(spec_big)
    n_params_big = sum(
        p.size for p in jax.tree_util.tree_leaves(init_big(key)))
    assert n_params == n_params_big


def test_local_net_translation_equivariance(key):
    """Rolling the input fields on the torus rolls the S/T/Q outputs —
    the property the dense-trunk nets structurally lack."""
    from l2hmc.networks.nets import LocalNetSpec, make_local_net

    lt, lx = 6, 4
    spec = LocalNetSpec(time_size=lt, space_size=lx, channels=8,
                        x_channels=4)
    init, apply = make_local_net(spec)
    params = init(key)
    d = 2 * lt * lx
    v = jax.random.normal(key, (2, d))
    x = jax.random.normal(jax.random.fold_in(key, 1), (2, 2 * d))
    t = jnp.tile(jnp.array([[0.3, 0.7]]), (2, 1))
    s0, t0, q0 = apply(params, v, x, t)
    st_, sx_ = 2, 3
    vr = _roll_links_flat(v, lt, lx, 2, st_, sx_)
    xr = _roll_links_flat(x, lt, lx, 4, st_, sx_)
    s1, t1, q1 = apply(params, vr, xr, t)
    for a, b in ((s0, s1), (t0, t1), (q0, q1)):
        a_img = a.reshape(2, lt, lx, 2)
        b_img = b.reshape(2, lt, lx, 2)
        np.testing.assert_allclose(
            np.asarray(jnp.roll(a_img, (st_, sx_), axis=(1, 2))),
            np.asarray(b_img), atol=1e-5)


def test_local_flat_net_identity_init_and_equivariance(key):
    """Flat-layout stencil edition (r4): same API and properties as the
    image local net — near-identity init, volume-independent params,
    exact translation equivariance — with zero flat<->NHWC round trips."""
    from l2hmc.networks.nets import LocalNetSpec, make_local_flat_net

    lt, lx = 6, 4
    spec = LocalNetSpec(time_size=lt, space_size=lx, channels=8,
                        x_channels=4)
    init, apply = make_local_flat_net(spec)
    params = init(key)
    d = 2 * lt * lx
    v = jax.random.normal(key, (2, d))
    x = jax.random.normal(jax.random.fold_in(key, 1), (2, 2 * d))
    t = jnp.tile(jnp.array([[0.3, 0.7]]), (2, 1))
    s0, t0, q0 = apply(params, v, x, t)
    assert s0.shape == t0.shape == q0.shape == (2, d)
    assert float(jnp.std(s0)) < 0.05 and float(jnp.std(q0)) < 0.05
    # volume-independent parameter count
    big = LocalNetSpec(time_size=32, space_size=32, channels=8,
                       x_channels=4)
    init_big, _ = make_local_flat_net(big)
    assert (sum(p.size for p in jax.tree_util.tree_leaves(params))
            == sum(p.size for p in
                   jax.tree_util.tree_leaves(init_big(key))))
    # translation equivariance on the torus
    st_, sx_ = 2, 3
    vr = _roll_links_flat(v, lt, lx, 2, st_, sx_)
    xr = _roll_links_flat(x, lt, lx, 4, st_, sx_)
    s1, t1, q1 = apply(params, vr, xr, t)
    for a, b in ((s0, s1), (t0, t1), (q0, q1)):
        np.testing.assert_allclose(
            np.asarray(jnp.roll(a.reshape(2, lt, lx, 2), (st_, sx_),
                                axis=(1, 2))),
            np.asarray(b.reshape(2, lt, lx, 2)), atol=1e-5)


def test_local_net_trains_on_gauge(key):
    """Short 8x8 training run with the local conditioner: loss falls and
    acceptance stays alive (the dead-gradient trap would pin it at 0)."""
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_train_chunk,
    )

    cfg = GaugeConfig(
        time_size=8, space_size=8, num_chains=16, num_steps=2,
        network_arch="local", num_filters=8, beta_init=2.0, beta_final=2.0,
        train_steps=200, eps_init=0.2, eps_trainable=False)
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 50)
    losses, accs = [], []
    kk = key
    for _ in range(4):
        kk, sub = jax.random.split(kk)
        state, m = chunk(state, sub)
        losses.append(float(np.asarray(m["loss"]).mean()))
        accs.append(float(np.asarray(m["accept_prob"]).mean()))
    assert losses[-1] < losses[0]
    assert accs[-1] > 0.2
