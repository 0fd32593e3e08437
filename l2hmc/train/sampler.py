"""Generic L2HMC sampler trainer for analytic targets.

Rebuild of the MoG/SCG experiment path (``mog_model.py:135-1022`` +
``utils/dynamics.py:34-319``): MLP S/T/Q networks, ``eps = exp(alpha)``
trainable log-step, squared-jump loss with auxiliary chains, temperature
annealing ``T -> T*factor`` with dynamic schedule adaptation from measured
tunneling rates, and the tunneling/acceptance/distance diagnostics
(``mog_model.py:423-487``).

The temperature enters as the reference does (``utils/dynamics.py:227-236``):
the energy is scaled ``U/T``, i.e. the dynamics run at ``beta = 1/T``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from l2hmc.dynamics.l2hmc import (
    DynamicsConfig,
    DynamicsParams,
    get_eps,
    init_dynamics_params,
    make_dynamics,
)
from l2hmc.networks.nets import MLPNetSpec, make_mlp_net
from l2hmc.train import losses, schedules


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static config (reference defaults from ``mog_model.py`` argparse)."""

    x_dim: int
    num_chains: int = 200
    num_steps: int = 10
    eps_init: float = 0.1
    num_hidden: int = 10
    hmc: bool = False
    metric: str = "l2"
    loss_scale: float = 0.1
    aux_weight: float = 1.0
    lr_init: float = 1e-3
    lr_decay_steps: int = 1000
    lr_decay_rate: float = 0.96
    clip_value: float = 1.0
    train_steps: int = 5000
    # temperature annealing (mog_model.py:940-952)
    use_annealing: bool = False
    temp_init: float = 10.0
    annealing_steps: int = 100
    annealing_factor: float = 0.98


class SamplerTrainState(NamedTuple):
    params: DynamicsParams
    opt_state: Any
    x: jax.Array
    step: jax.Array
    temp: schedules.TemperatureSchedule


def build_sampler_dynamics(cfg: SamplerConfig, energy_fn):
    dyn_cfg = DynamicsConfig(
        x_dim=cfg.x_dim, num_steps=cfg.num_steps, hmc=cfg.hmc,
        use_log_eps=True,  # utils/dynamics.py:51-60 parametrization
    )
    # bounded_q=True: parity with the original MoG/SCG network's ScaleTanh
    # transformation head (utils/network.py:89-114).
    xi, xa = make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.num_hidden, factor=2.0, bounded_q=True))
    vi, va = make_mlp_net(MLPNetSpec(cfg.x_dim, cfg.num_hidden, factor=1.0, bounded_q=True))
    dyn = make_dynamics(dyn_cfg, energy_fn, xa, va)
    return dyn_cfg, dyn, (xi, vi)


def _make_optimizer(cfg: SamplerConfig):
    lr = schedules.make_lr_schedule(cfg.lr_init, cfg.lr_decay_steps, cfg.lr_decay_rate)
    # zero_nans: a single non-finite gradient step must not poison eps/params
    # (the reference's check_numerics would abort the run instead).
    parts = [optax.zero_nans()]
    if cfg.clip_value > 0:
        parts.append(optax.clip_by_global_norm(cfg.clip_value))
    parts.append(optax.adam(lr))
    return optax.chain(*parts)


def init_sampler_state(
    cfg: SamplerConfig, energy_fn, key: jax.Array, x_init=None
) -> SamplerTrainState:
    kp, kx = jax.random.split(key)
    dyn_cfg, dyn, (xi, vi) = build_sampler_dynamics(cfg, energy_fn)
    params = init_dynamics_params(kp, dyn_cfg, xi, vi, cfg.eps_init)
    tx = _make_optimizer(cfg)
    x = (
        x_init
        if x_init is not None
        else jax.random.normal(kx, (cfg.num_chains, cfg.x_dim), jnp.float32)
    )
    t0 = cfg.temp_init if cfg.use_annealing else 1.0
    return SamplerTrainState(
        params=params,
        opt_state=tx.init(params),
        x=x,
        step=jnp.asarray(0, jnp.int32),
        temp=schedules.init_temperature(t0, cfg.annealing_factor),
    )


def make_sampler_train_step(cfg: SamplerConfig, energy_fn):
    dyn_cfg, dyn, _ = build_sampler_dynamics(cfg, energy_fn)
    tx = _make_optimizer(cfg)
    metric_fn = losses.get_metric_fn(cfg.metric)

    def loss_fn(params, x, beta, key):
        kx, kz, kzi = jax.random.split(key, 3)
        out_x = dyn["transition"](params, x, beta, kx)
        z = jax.random.normal(kzi, x.shape, x.dtype)
        out_z = dyn["transition"](params, z, beta, kz)
        loss = losses.esjd_loss(
            x, out_x.x_proposed, out_x.accept_prob,
            z, out_z.x_proposed, out_z.accept_prob,
            metric_fn=metric_fn, loss_scale=cfg.loss_scale,
            aux_weight=cfg.aux_weight,
        )
        aux = {"x_out": out_x.x_out, "accept_prob": jnp.mean(out_x.accept_prob)}
        return loss, aux

    def train_step(state: SamplerTrainState, key: jax.Array):
        beta = 1.0 / state.temp.temperature
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.x, beta, key
        )
        grads = grads._replace(masks=jnp.zeros_like(grads.masks))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        temp = (
            schedules.temperature_step(state.temp, cfg.annealing_steps)
            if cfg.use_annealing
            else state.temp
        )
        metrics = {
            "loss": loss,
            "accept_prob": aux["accept_prob"],
            "eps": get_eps(params, dyn_cfg),
            "temperature": state.temp.temperature,
        }
        return (
            SamplerTrainState(params, opt_state, aux["x_out"], state.step + 1, temp),
            metrics,
        )

    return train_step


def make_sampler_train_chunk(cfg: SamplerConfig, energy_fn, chunk_size: int):
    step_fn = make_sampler_train_step(cfg, energy_fn)

    @jax.jit
    def chunk(state, key):
        keys = jax.random.split(key, chunk_size)
        return jax.lax.scan(step_fn, state, keys)

    return chunk


def make_sample_chain(cfg: SamplerConfig, energy_fn):
    """Post-training sampling: ``(params, x0, key, n) -> (T, chains, d)``."""
    _, dyn, _ = build_sampler_dynamics(cfg, energy_fn)

    def sample(params, x0, key, num_samples: int, beta=1.0):
        def body(x, k):
            out = dyn["transition"](params, x, beta, k)
            return out.x_out, (out.x_out, out.accept_prob)

        keys = jax.random.split(key, num_samples)
        _, (xs, probs) = jax.lax.scan(body, x0, keys)
        return xs, probs

    return jax.jit(sample, static_argnums=(3,))
