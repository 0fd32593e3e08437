"""Annealed importance sampling.

Rebuild of ``utils/ais.py:30-82``: HMC transitions at interpolated energies
``E_t = (1-b_t) E0 + b_t E1`` under a ``lax.scan``, accumulating importance
log-weights, with optional momentum refresh, finished by a log-mean-exp
estimate of log Z1/Z0 (used by the VAE path for log-likelihood evaluation,
``vae/eval_vae.py``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from l2hmc.dynamics.hmc import hmc_transition


def ais_log_weights(
    key: jax.Array,
    x0: jax.Array,
    energy_init: Callable[[jax.Array], jax.Array],
    energy_final: Callable[[jax.Array], jax.Array],
    num_betas: int = 100,
    eps: float = 0.1,
    num_leapfrog: int = 10,
) -> jax.Array:
    """Run AIS from ``energy_init`` to ``energy_final``.

    ``x0`` are exact samples from the initial distribution.  Returns
    per-chain log-weights ``(batch,)`` whose log-mean-exp estimates
    ``log(Z_final / Z_init)`` (``utils/ais.py:43-82``).
    """
    betas = jnp.linspace(0.0, 1.0, num_betas + 1)

    def energy_at(x, b):
        return (1.0 - b) * energy_init(x) + b * energy_final(x)

    def body(carry, inp):
        x, logw = carry
        b_prev, b_curr, k = inp
        # importance weight increment: E_{b_prev}(x) - E_{b_curr}(x)
        logw = logw + energy_at(x, b_prev) - energy_at(x, b_curr)
        # move under the current intermediate target (fresh momentum each
        # transition = "momentum refresh" semantics of the reference)
        out = hmc_transition(lambda y: energy_at(y, b_curr), x, 1.0, k, eps, num_leapfrog)
        return (out.x_out, logw), None

    keys = jax.random.split(key, num_betas)
    inp = (betas[:-1], betas[1:], keys)
    (x, logw), _ = jax.lax.scan(body, (x0, jnp.zeros(x0.shape[0])), inp)
    return logw


def log_mean_exp(logw: jax.Array) -> jax.Array:
    """``log Z`` estimate from AIS weights (``utils/ais.py:78-82``)."""
    return jax.scipy.special.logsumexp(logw) - jnp.log(logw.shape[0])
