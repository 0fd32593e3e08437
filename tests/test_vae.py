"""VAE + L2HMC posterior sampler tests on the bundled digits dataset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.train.vae import (
    VAEConfig,
    build_vae,
    load_digits_binarized,
    make_vae_train_step,
)

CFG = VAEConfig(data_dim=64, latent_dim=6, enc_hidden=64, dec_hidden=64,
                num_steps=3, mh_steps=2, sampler_hidden=32)


def test_digits_dataset():
    x = load_digits_binarized()
    assert x.shape[1] == 64
    assert set(np.unique(x)) <= {0.0, 1.0}
    assert x.shape[0] > 1000


def test_vae_training_improves_elbo(key):
    x = load_digits_binarized()
    init_state, train_step, fns = make_vae_train_step(CFG)
    state = init_state(key)

    elbos = []
    for i in range(60):
        key, kb, ks = jax.random.split(key, 3)
        idx = jax.random.randint(kb, (128,), 0, x.shape[0])
        batch = jnp.asarray(x[np.asarray(idx)])
        state, aux = train_step(state, batch, ks)
        elbos.append(float(aux["elbo"]))
    assert elbos[-1] > elbos[0] + 5.0, f"ELBO did not improve: {elbos[0]} -> {elbos[-1]}"
    assert np.isfinite(elbos).all()
    assert 0.0 <= float(aux["accept_prob"]) <= 1.0


def test_posterior_sampler_conditions_on_data(key):
    """The aux-conditioned sampler must produce different dynamics for
    different data (conditioning actually wired through)."""
    init, fns = build_vae(CFG)
    params = init(key)
    # give aux weights some magnitude so conditioning is visible at init
    # (aux rows are the trailing aux_dim rows of the fused input embedding)
    xnet = dict(params.dynamics.xnet)
    xnet["in_w"] = xnet["in_w"].at[-CFG.data_dim :].add(0.3)
    params = params._replace(dynamics=params.dynamics._replace(xnet=xnet))

    x1 = jnp.zeros((8, 64))
    x2 = jnp.ones((8, 64))
    z1, p1, _ = fns["sample_posterior"](params, x1, key)
    z2, p2, _ = fns["sample_posterior"](params, x2, key)
    assert not np.allclose(np.asarray(z1), np.asarray(z2))


def test_ais_log_likelihood_finite(key):
    from l2hmc.train.vae import ais_log_likelihood

    x = load_digits_binarized()[:16]
    init, fns = build_vae(CFG)
    params = init(key)
    logp = ais_log_likelihood(CFG, fns, params, jnp.asarray(x), key,
                              num_betas=30, eps=0.2)
    assert logp.shape == (16,)
    assert np.isfinite(np.asarray(logp)).all()
    # untrained decoder: log p(x) should be worse than -D log 2 baseline-ish
    assert np.asarray(logp).mean() < 0.0


def test_ais_linear_gaussian_exact(key):
    """AIS log-likelihood against a closed form.

    With a linear-Gaussian decoder p(x|z) = N(x; W z, sigma^2 I) and prior
    z ~ N(0, I), the marginal is exact: p(x) = N(x; 0, W W^T + sigma^2 I).
    ``ais_log_likelihood`` must reproduce it with NO additive normalization
    (the (2pi)^(d/2) prior normalizers cancel — see the note in vae.py).
    """
    from l2hmc.train.vae import VAEParams, ais_log_likelihood

    d_lat, d_obs, sigma = 2, 3, 0.8
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.normal(size=(d_lat, d_obs)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(64, d_obs)) * 1.5, jnp.float32)

    def posterior_energy(dec_params, x_batch):
        Wd = dec_params

        def energy(z):
            resid = x_batch - z @ Wd
            loglik = (
                -0.5 * jnp.sum(resid * resid, axis=-1) / sigma**2
                - 0.5 * d_obs * jnp.log(2 * jnp.pi * sigma**2)
            )
            return -loglik + 0.5 * jnp.sum(z * z, axis=-1)

        return energy

    cfg = VAEConfig(data_dim=d_obs, latent_dim=d_lat)
    fns = {"posterior_energy": posterior_energy}
    params = VAEParams(encoder=None, decoder=W, dynamics=None)
    logw = np.asarray(ais_log_likelihood(
        cfg, fns, params, x, key, num_betas=300, eps=0.25))

    cov = np.asarray(W.T @ W) + sigma**2 * np.eye(d_obs)
    xn = np.asarray(x)
    sign, logdet = np.linalg.slogdet(cov)
    exact = (
        -0.5 * np.einsum("bi,ij,bj->b", xn, np.linalg.inv(cov), xn)
        - 0.5 * logdet - 0.5 * d_obs * np.log(2 * np.pi)
    )
    # AIS is a lower-bound estimator with O(1/num_betas) bias; per-datum
    # chains so average over the batch for the comparison
    assert abs(logw.mean() - exact.mean()) < 0.25, (
        f"AIS {logw.mean():.3f} vs exact {exact.mean():.3f}"
    )


def test_normal_kl():
    """normal_kl (func_utils.py:77-96 parity) against the closed form and
    the zero case."""
    from l2hmc.train.vae import normal_kl

    rng = np.random.default_rng(1)
    qm = jnp.asarray(rng.normal(size=(5, 3)), jnp.float32)
    qs = jnp.asarray(rng.uniform(0.5, 2.0, size=(5, 3)), jnp.float32)
    pm = jnp.asarray(rng.normal(size=(5, 3)), jnp.float32)
    ps = jnp.asarray(rng.uniform(0.5, 2.0, size=(5, 3)), jnp.float32)

    got = np.asarray(normal_kl(qm, qs, pm, ps))
    expect = np.sum(
        np.log(np.asarray(ps) / np.asarray(qs))
        + (np.asarray(qs) ** 2 + (np.asarray(qm) - np.asarray(pm)) ** 2)
        / (2 * np.asarray(ps) ** 2)
        - 0.5,
        axis=-1,
    )
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(normal_kl(qm, qs, qm, qs)), 0.0, atol=1e-6)
    assert (got >= 0).all()


def test_random_lf_composition_trains(key):
    """The chain_operator-based sampling path (reference
    random_lf_composition, utils/sampler.py:61-93) runs and trains."""
    cfg = VAEConfig(data_dim=64, latent_dim=4, enc_hidden=32, dec_hidden=32,
                    sampler_hidden=16, num_steps=2, mh_steps=1,
                    random_lf_composition=3)
    x = load_digits_binarized()[:128]
    init_state, train_step, fns = make_vae_train_step(cfg)
    state = init_state(key)
    z, probs, jumps = fns["sample_posterior"](state.params, jnp.asarray(x), key)
    assert z.shape == (128, 4)
    assert np.isfinite(np.asarray(z)).all()
    for i in range(3):
        key, sub = jax.random.split(key)
        state, aux = train_step(state, jnp.asarray(x), sub)
    assert np.isfinite(float(aux["loss"]))
    assert 0.0 <= float(aux["accept_prob"]) <= 1.0


def test_posterior_sampler_autocovariance(key):
    """eval_sampler.py parity: mixing diagnostics of the trained posterior
    sampler are finite and acceptance is healthy."""
    from l2hmc.train.vae import (
        VAEConfig, build_vae, posterior_sampler_autocovariance,
    )

    cfg = VAEConfig(data_dim=64, latent_dim=4, enc_hidden=32, dec_hidden=32,
                    sampler_hidden=16, num_steps=3)
    init, fns = build_vae(cfg)
    params = init(key)
    x = (jax.random.uniform(jax.random.fold_in(key, 1), (16, 64)) > 0.5
         ).astype(jnp.float32)
    out = posterior_sampler_autocovariance(cfg, fns, params, x,
                                           jax.random.fold_in(key, 2),
                                           num_transitions=60)
    assert np.isfinite(out["ess_per_step"])
    assert 0.0 < out["accept_prob"] <= 1.0
    assert np.isfinite(np.asarray(out["autocorrelation"])).all()
