"""VAE with an L2HMC posterior sampler.

Rebuild of the reference VAE suite (``vae/mnist_vae.py:67-350`` — Python-2
era, SURVEY §2.4) in JAX:

- encoder/decoder MLPs (``mnist_vae.py:92-111``),
- posterior energy ``E(z|x) = BCE(decoder(z), x) + 0.5 |z|^2``
  (``mnist_vae.py:122-126``),
- an L2HMC sampler over latents *conditioned on the data batch* through the
  ``aux`` network input (``mnist_vae.py:130-178``), initialized at the
  encoder posterior sample,
- ``MH`` sequential transitions building the sampler loss
  (``mnist_vae.py:185-224``),
- three optimizers: ELBO (encoder), sampler (dynamics nets), decoder
  likelihood at the sampled latents (``mnist_vae.py:254-265``) — here one
  optax ``multi_transform`` over parameter groups inside a single jitted
  step,
- AIS log-likelihood evaluation (``vae/eval_vae.py`` + ``utils/ais.py``)
  via :mod:`l2hmc.dynamics.ais`.

Dataset: the environment has no MNIST files and no egress; the default
dataset is sklearn's bundled 8x8 digits, binarized like the reference
binarizes MNIST (``utils/func_utils.py:63-71``).  Any ``(N, D)`` array of
{0,1} pixels works the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from l2hmc.dynamics.l2hmc import (
    DynamicsConfig,
    DynamicsParams,
    init_dynamics_params,
    make_dynamics,
)
from l2hmc.networks.nets import MLPNetSpec, make_mlp_net, _dense, _dense_init


def load_digits_binarized(threshold: float = 0.5):
    """Bundled 8x8 digits, scaled to [0,1] and binarized
    (reference binarization: ``utils/func_utils.py:98-109``)."""
    from sklearn.datasets import load_digits

    x = load_digits().data.astype(np.float32) / 16.0
    return (x > threshold).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    data_dim: int = 64
    latent_dim: int = 8
    enc_hidden: int = 256
    dec_hidden: int = 256
    # sampler
    num_steps: int = 5          # leapfrog steps per transition
    mh_steps: int = 2           # sequential transitions (hps.MH)
    eps_init: float = 0.1
    sampler_hidden: int = 64
    # > 0: each MH step composes a random number (1..N) of full leapfrog
    # integrations before its single accept — the reference's
    # ``random_lf_composition`` mode (``utils/sampler.py:61-93``,
    # ``vae/mnist_vae.py:185-224``); 0 = plain sequential transitions
    random_lf_composition: int = 0
    # optimization
    lr_elbo: float = 1e-3
    lr_sampler: float = 1e-3
    lr_decoder: float = 1e-3


class VAEParams(NamedTuple):
    encoder: Any
    decoder: Any
    dynamics: DynamicsParams


class VAEState(NamedTuple):
    params: VAEParams
    opt_state: Any
    step: jax.Array


def _mlp_init(key, dims):
    ks = jax.random.split(key, len(dims) - 1)
    return [
        _dense_init(k, din, dout, 1.0)
        for k, din, dout in zip(ks, dims[:-1], dims[1:])
    ]


def _mlp_apply(layers, x, final_linear=True):
    for i, p in enumerate(layers):
        x = _dense(p, x)
        if i < len(layers) - 1 or not final_linear:
            x = jax.nn.relu(x)
    return x


def build_vae(cfg: VAEConfig):
    """Return (init, fns) where fns holds pure encoder/decoder/energy/sampler."""

    dyn_cfg = DynamicsConfig(
        x_dim=cfg.latent_dim, num_steps=cfg.num_steps, use_log_eps=True,
    )
    xnet_init, xnet_apply = make_mlp_net(MLPNetSpec(
        cfg.latent_dim, cfg.sampler_hidden, factor=2.0, bounded_q=True,
        aux_dim=cfg.data_dim,
    ))
    vnet_init, vnet_apply = make_mlp_net(MLPNetSpec(
        cfg.latent_dim, cfg.sampler_hidden, factor=1.0, bounded_q=True,
        aux_dim=cfg.data_dim,
    ))

    def encoder_apply(p, x):
        h = _mlp_apply(p, x)
        mu, logvar = jnp.split(h, 2, axis=-1)
        return mu, logvar

    def decoder_apply(p, z):
        return _mlp_apply(p, z)  # logits

    def bce(logits, x):
        """Per-sample Bernoulli negative log-likelihood."""
        return jnp.sum(
            jnp.maximum(logits, 0) - logits * x + jnp.log1p(jnp.exp(-jnp.abs(logits))),
            axis=-1,
        )

    def make_posterior_energy(dec_params, x_batch):
        """E(z | x) = -log p(x|z) - log p(z) (``mnist_vae.py:122-126``)."""

        def energy(z):
            logits = decoder_apply(dec_params, z)
            return bce(logits, x_batch) + 0.5 * jnp.sum(z * z, axis=-1)

        return energy

    def init(key) -> VAEParams:
        k1, k2, k3 = jax.random.split(key, 3)
        enc = _mlp_init(k1, [cfg.data_dim, cfg.enc_hidden, 2 * cfg.latent_dim])
        dec = _mlp_init(k2, [cfg.latent_dim, cfg.dec_hidden, cfg.data_dim])
        dyn_params = init_dynamics_params(k3, dyn_cfg, xnet_init, vnet_init, cfg.eps_init)
        return VAEParams(encoder=enc, decoder=dec, dynamics=dyn_params)

    def sample_posterior(params: VAEParams, x_batch, key, dec_params=None):
        """Encoder sample refined by ``mh_steps`` L2HMC transitions.

        Returns ``(z, accept_probs, jump_dists)``.
        """
        dec = params.decoder if dec_params is None else dec_params
        energy = make_posterior_energy(dec, x_batch)
        dyn = make_dynamics(dyn_cfg, energy, xnet_apply, vnet_apply)

        k0, key = jax.random.split(key)
        mu, logvar = encoder_apply(params.encoder, x_batch)
        z = mu + jnp.exp(0.5 * logvar) * jax.random.normal(k0, mu.shape)

        probs, jumps = [], []
        for i in range(cfg.mh_steps):
            key, sub = jax.random.split(key)
            if cfg.random_lf_composition > 0:
                out = dyn["chain_operator"](
                    params.dynamics, z, 1.0, sub,
                    max_compositions=cfg.random_lf_composition, aux=x_batch)
            else:
                out = dyn["transition"](params.dynamics, z, 1.0, sub, aux=x_batch)
            probs.append(out.accept_prob)
            jumps.append(jnp.sum(jnp.square(out.x_proposed - z), axis=-1))
            z = out.x_out
        return z, jnp.stack(probs), jnp.stack(jumps)

    fns = {
        "encoder": encoder_apply,
        "decoder": decoder_apply,
        "bce": bce,
        "posterior_energy": make_posterior_energy,
        "sample_posterior": sample_posterior,
        "dyn_cfg": dyn_cfg,
        "xnet_apply": xnet_apply,
        "vnet_apply": vnet_apply,
    }
    return init, fns


def make_vae_train_step(cfg: VAEConfig):
    init, fns = build_vae(cfg)

    def elbo_parts(params: VAEParams, x, key):
        mu, logvar = fns["encoder"](params.encoder, x)
        z = mu + jnp.exp(0.5 * logvar) * jax.random.normal(key, mu.shape)
        logits = fns["decoder"](params.decoder, z)
        rec = fns["bce"](logits, x)
        kl = 0.5 * jnp.sum(jnp.exp(logvar) + mu * mu - 1.0 - logvar, axis=-1)
        return rec, kl

    def loss_fn(params: VAEParams, x, key):
        k_elbo, k_smp, k_dec = jax.random.split(key, 3)
        # (1) ELBO loss -> encoder + decoder (mnist_vae.py:254-257)
        rec, kl = elbo_parts(params, x, k_elbo)
        elbo_loss = jnp.mean(rec + kl)

        # (2) sampler loss on the dynamics nets: squared-jump objective
        # against the posterior energy (mnist_vae.py:185-224); decoder
        # treated as fixed via stop_gradient.
        dec_sg = jax.tree.map(jax.lax.stop_gradient, params.decoder)
        enc_sg = jax.tree.map(jax.lax.stop_gradient, params.encoder)
        params_sg = VAEParams(encoder=enc_sg, decoder=dec_sg, dynamics=params.dynamics)
        z_s, probs, jumps = fns["sample_posterior"](params_sg, x, k_smp, dec_params=dec_sg)
        v = jnp.mean(jumps * probs, axis=0) + 1e-4
        scale = 1.0
        sampler_loss = jnp.mean(scale / v - v / scale)

        # (3) decoder likelihood at the refined latents (mnist_vae.py:258-262)
        z_sg = jax.lax.stop_gradient(z_s)
        dec_ll = jnp.mean(fns["bce"](fns["decoder"](params.decoder, z_sg), x))

        total = elbo_loss + sampler_loss + dec_ll
        aux = {
            "elbo": -elbo_loss,
            "sampler_loss": sampler_loss,
            "decoder_nll": dec_ll,
            "accept_prob": jnp.mean(probs),
        }
        return total, aux

    # per-group learning rates via multi_transform (the reference's three
    # optimizers collapse into one labeled update)
    tx = optax.multi_transform(
        {
            "encoder": optax.adam(cfg.lr_elbo),
            "decoder": optax.adam(cfg.lr_decoder),
            "dynamics": optax.chain(optax.zero_nans(), optax.adam(cfg.lr_sampler)),
        },
        VAEParams(encoder="encoder", decoder="decoder", dynamics="dynamics"),
    )

    def init_state(key) -> VAEState:
        params = init(key)
        return VAEState(params=params, opt_state=tx.init(params), step=jnp.asarray(0))

    def train_step(state: VAEState, batch, key):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, key
        )
        grads = grads._replace(
            dynamics=grads.dynamics._replace(
                masks=jnp.zeros_like(grads.dynamics.masks)
            )
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        aux["loss"] = loss
        return VAEState(params=params, opt_state=opt_state, step=state.step + 1), aux

    return init_state, jax.jit(train_step), fns


def ais_log_likelihood(
    cfg: VAEConfig, fns, params: VAEParams, x_batch, key,
    num_betas: int = 100, eps: float = 0.2,
):
    """Per-datum log p(x) lower-bound estimate via AIS from the prior to the
    posterior energy (``vae/eval_vae.py:64`` + ``utils/ais.py:30-82``).

    AIS chains run per-datum: energy_init = prior only, energy_final =
    posterior energy; log Z_final = log p(x).
    """
    from l2hmc.dynamics.ais import ais_log_weights

    e1 = fns["posterior_energy"](params.decoder, x_batch)

    def e0(z):
        return 0.5 * jnp.sum(z * z, axis=-1)

    k0, key = jax.random.split(key)
    z0 = jax.random.normal(k0, (x_batch.shape[0], cfg.latent_dim))
    logw = ais_log_weights(key, z0, e0, e1, num_betas=num_betas, eps=eps,
                           num_leapfrog=5)
    # AIS weights estimate log(Z1/Z0) per chain (one chain per datum).
    # Z0 = integral exp(-|z|^2/2) dz = (2pi)^(d/2), and
    # Z1 = integral p(x|z) exp(-|z|^2/2) dz = (2pi)^(d/2) * p(x),
    # so the (2pi)^(d/2) factors cancel exactly and logw estimates
    # log p(x_i) with NO additive normalization — verified against the
    # closed-form linear-Gaussian decoder in tests/test_vae.py.
    return logw


def normal_kl(q_means, q_stddevs, p_means, p_stddevs):
    """KL(q || p) between diagonal normals, summed over the last axis
    (``utils/func_utils.py:77-96``; the reference's VAE-lineage helper).

    The ``log(2 pi)`` terms cancel between the entropy and cross-entropy.
    """
    q_entropy = 0.5 + jnp.log(q_stddevs)
    cross = (
        0.5 * jnp.square(q_stddevs / p_stddevs)
        + 0.5 * jnp.square((q_means - p_means) / p_stddevs)
        + jnp.log(p_stddevs)
    )
    return jnp.sum(cross - q_entropy, axis=-1)


def posterior_sampler_autocovariance(
    cfg: VAEConfig, fns, params: VAEParams, x_batch, key,
    num_transitions: int = 200,
):
    """Mixing diagnostics of the trained posterior sampler.

    Parity with ``vae/eval_sampler.py`` (autocovariance evaluation of the
    trained L2HMC sampler): runs a scan-resident chain of transitions on a
    fixed data batch and returns per-coordinate autocorrelation, ESS, and
    acceptance.
    """
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics.l2hmc import make_dynamics

    energy = fns["posterior_energy"](params.decoder, x_batch)
    dyn = make_dynamics(fns["dyn_cfg"], energy,
                        fns["xnet_apply"], fns["vnet_apply"])

    k0, key = jax.random.split(key)
    mu, logvar = fns["encoder"](params.encoder, x_batch)
    z0 = mu + jnp.exp(0.5 * logvar) * jax.random.normal(k0, mu.shape)

    def body(z, k):
        out = dyn["transition"](params.dynamics, z, 1.0, k, aux=x_batch)
        return out.x_out, (out.x_out, out.accept_prob)

    keys = jax.random.split(key, num_transitions)
    _, (zs, probs) = jax.lax.scan(body, z0, keys)
    zs = np.asarray(zs)                       # (T, batch, latent_dim)
    acf = stats.autocorr_fft(zs[:, 0, 0])
    ess = float(np.mean([
        stats.calc_ess(zs[:, b, d])
        for b in range(min(4, zs.shape[1]))
        for d in range(min(4, zs.shape[2]))
    ]))
    return {
        "autocorrelation": acf,
        "ess_per_step": ess,
        "accept_prob": float(np.asarray(probs).mean()),
    }
