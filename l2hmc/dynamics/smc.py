"""Sequential Monte Carlo over a beta ladder.

Not present in the reference code (its beta annealing is in-chain,
``gauge_model.py:1039-1046``) but required by BASELINE.json config 5:
an annealed particle ensemble over beta with importance reweighting,
systematic resampling, and MCMC (HMC or L2HMC) move steps.

The particle population lives on the chain batch axis — exactly the axis
`parallel.mesh` shards over 'data'.  Resampling is a gather by ancestor
index; under pjit the gather lowers to an all-to-all between devices, and
everything stays inside one jitted scan.  Log-weight
normalizations are global reductions (psum across the mesh).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SMCState(NamedTuple):
    x: jax.Array          # (n, d) particles
    log_w: jax.Array      # (n,) unnormalized log-weights
    log_z: jax.Array      # scalar accumulated log normalizer


def effective_sample_size(log_w: jax.Array) -> jax.Array:
    """ESS of normalized weights: 1 / sum(w^2)."""
    w = jax.nn.softmax(log_w)
    return 1.0 / jnp.sum(jnp.square(w))


def systematic_resample(key: jax.Array, log_w: jax.Array) -> jax.Array:
    """Systematic (low-variance) resampling -> ancestor indices (n,)."""
    n = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    pts = u0 + jnp.arange(n) / n
    return jnp.searchsorted(cum, pts)


def smc_beta_ladder(
    key: jax.Array,
    x0: jax.Array,
    potential_fn: Callable[[jax.Array], jax.Array],
    betas: jax.Array,
    move_fn: Callable[[jax.Array, jax.Array, jax.Array, jax.Array], jax.Array],
    ess_threshold: float = 0.5,
):
    """Anneal particles ``x0`` (drawn at ``betas[0]``) up the beta ladder.

    ``move_fn(x, beta, key, dummy) -> x`` applies one (or more) MCMC
    transitions targeting exp(-beta*U).  Resampling triggers when
    ESS < ess_threshold * n — branchless via ``lax.cond``-free select:
    we always compute the resampled indices and ``where``-select, keeping
    the scan fully static for XLA.

    Returns ``SMCState`` with the final particles and the accumulated
    ``log Z(beta_end)/Z(beta_0)`` estimate.
    """
    n = x0.shape[0]

    def body(state: SMCState, inp):
        b_prev, b_curr, k = inp
        kr, km = jax.random.split(k)
        # reweight: w *= exp(-(b_curr - b_prev) U(x))
        log_inc = -(b_curr - b_prev) * potential_fn(state.x)
        log_w = state.log_w + log_inc

        # adaptive resampling (selected, not branched)
        ess = effective_sample_size(log_w)
        do_resample = ess < ess_threshold * n
        idx = systematic_resample(kr, log_w)
        x_res = jnp.take(state.x, idx, axis=0)
        # log_z accumulates the mean weight at resampling time
        log_mean_w = jax.scipy.special.logsumexp(log_w) - jnp.log(n)
        x = jnp.where(do_resample, x_res, state.x)
        new_log_w = jnp.where(do_resample, jnp.zeros_like(log_w), log_w)
        log_z = state.log_z + jnp.where(do_resample, log_mean_w, 0.0)

        # MCMC move at the current temperature
        x = move_fn(x, b_curr, km, None)
        return SMCState(x=x, log_w=new_log_w, log_z=log_z), ess

    keys = jax.random.split(key, len(betas) - 1)
    init = SMCState(x=x0, log_w=jnp.zeros(n), log_z=jnp.asarray(0.0))
    final, ess_trace = jax.lax.scan(body, init, (betas[:-1], betas[1:], keys))
    # fold in the remaining weights
    log_z = final.log_z + jax.scipy.special.logsumexp(final.log_w) - jnp.log(n)
    return SMCState(x=final.x, log_w=final.log_w, log_z=log_z), ess_trace


def weighted_mean(log_w: jax.Array, values: jax.Array) -> jax.Array:
    """Importance-weighted ensemble mean ``sum(softmax(log_w) * values)``.

    The correct estimator for observables of the final SMC population:
    resampling triggers only when ESS dips below threshold, so the last
    rung's particles generally carry non-uniform residual weights — an
    unweighted mean is biased exactly when the final ESS is lowest.
    """
    return jnp.sum(jax.nn.softmax(log_w) * values)


def make_u1_hmc_move(potential_fn, wrap_fn, num_plaquettes: int,
                     leapfrog: int, moves_per_rung: int):
    """Standard SMC move kernel for U(1): ``moves_per_rung`` HMC
    transitions with the volume-scaled step ``(64/n_plaq)^(1/4) *
    0.4/sqrt(beta)`` (leapfrog error grows ~V*eps^4; the 8x8-tuned base
    rule loses acceptance at larger volumes).  Shared by
    ``benchmarks/smc_u1.py`` and ``benchmarks/config5_multihost.py``.
    """
    from l2hmc.dynamics.hmc import hmc_transition

    eps_scale = (64.0 / num_plaquettes) ** 0.25

    def move(x, b, k, _):
        def one(x, kk):
            out = hmc_transition(potential_fn, x, b, kk,
                                 eps_scale * 0.4 / jnp.sqrt(b), leapfrog)
            return wrap_fn(out.x_out), None

        x, _ = jax.lax.scan(one, x, jax.random.split(k, moves_per_rung))
        return x

    return move


def make_u1_fused_move(shape, leapfrog: int, moves_per_rung: int):
    """SMC move on the whole-chain HMC path (``dynamics/hmc.py
    hmc_chain_u1_fused``): all ``moves_per_rung`` HMC transitions of a
    rung are one call, which on a CUDA device is one kernel launch
    (``ops/u1_chain.cu``).  Same volume-scaled step rule as
    :func:`make_u1_hmc_move`; ``beta``/``eps`` are runtime scalars, so the
    call compiles once for the whole ladder scan.  Replicated particles
    only: the kernel is single-device, so the sharded config-5 population
    path keeps the XLA move.
    """
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused

    eps_scale = (64.0 / shape.num_plaquettes) ** 0.25

    def move(x, b, k, _):
        links = x.reshape(x.shape[0], shape.time_size, shape.space_size, 2)
        links, _, _, _ = hmc_chain_u1_fused(
            links, k, eps_scale * 0.4 / jnp.sqrt(b), b, leapfrog,
            moves_per_rung)
        return links.reshape(x.shape)

    return move


def u1_log_z_exact_factorized(num_plaquettes: int, beta_init, beta_final):
    """Analytic anchor: per-plaquette ``log[I0(b1)e^{-b1} / I0(b0)e^{-b0}]``
    times the plaquette count (2-D U(1) factorizes up to the global charge
    constraint)."""
    from scipy.special import i0e
    import numpy as np

    return num_plaquettes * float(
        np.log(i0e(beta_final)) - np.log(i0e(beta_init)))
