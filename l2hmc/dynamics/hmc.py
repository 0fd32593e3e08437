"""Plain Hamiltonian Monte Carlo baseline.

Rebuild of ``HMC/hmc.py:6-150`` (numpy/TF hybrid) as a pure jitted JAX
kernel: standard leapfrog + MH accept, same potential/kinetic/hamiltonian
conventions as the learned sampler so ESS comparisons are apples-to-apples.
Also the building block for AIS (``utils/ais.py``) and SMC transitions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

PotentialFn = Callable[[jax.Array], jax.Array]


class HMCOut(NamedTuple):
    x_out: jax.Array
    accept_prob: jax.Array
    accept_mask: jax.Array


def leapfrog(potential_fn: PotentialFn, x, v, beta, eps, num_steps: int):
    """Standard leapfrog: half-kick, K-1 full (drift,kick), drift, half-kick.

    Matches ``HMC/hmc.py:80-98``; vectorized over the chain batch.
    """
    grad = jax.grad(lambda x: jnp.sum(beta * potential_fn(x)))

    v = v - 0.5 * eps * grad(x)

    def body(carry, _):
        x, v = carry
        x = x + eps * v
        v = v - eps * grad(x)
        return (x, v), None

    (x, v), _ = jax.lax.scan(body, (x, v), None, length=num_steps - 1)
    x = x + eps * v
    v = v - 0.5 * eps * grad(x)
    return x, v


def hmc_transition(
    potential_fn: PotentialFn,
    x: jax.Array,
    beta,
    key: jax.Array,
    eps,
    num_steps: int,
) -> HMCOut:
    """One HMC transition for a batch of chains (``HMC/hmc.py:50-78``)."""
    kv, ka = jax.random.split(key)
    v = jax.random.normal(kv, x.shape, x.dtype)

    def hamiltonian(x, v):
        return beta * potential_fn(x) + 0.5 * jnp.sum(jnp.square(v), axis=-1)

    xp, vp = leapfrog(potential_fn, x, v, beta, eps, num_steps)
    dh = hamiltonian(x, v) - hamiltonian(xp, vp)
    prob = jnp.exp(jnp.minimum(dh, 0.0))
    prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
    accept = (jax.random.uniform(ka, prob.shape) < prob).astype(x.dtype)
    x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
    return HMCOut(x_out=x_out, accept_prob=prob, accept_mask=accept)


def hmc_chain_u1_fused(
    links: jax.Array,
    key: jax.Array,
    eps: float,
    beta: float,
    num_leapfrog: int,
    num_samples: int,
    hop: bool = False,
):
    """U(1) HMC chain, whole chain per call.

    ``links (B, Lt, Lx, 2)`` angles.  Returns ``(links_out, plaq_trace
    (T, B), charge_trace (T, B), accept_probs (T, B))``.  On a CUDA device
    the chain runs in one launch of the whole-chain kernel
    (``ops/leapfrog.py hmc_chain_cuda``); on every other platform, and for
    lattices too large for one block, it is the XLA scan
    :func:`hmc_chain_u1_xla`.  ``hop=True`` appends one exact instanton hop
    per transition (``dynamics/topo.py`` semantics).
    """
    from l2hmc.ops import leapfrog

    _, lt, lx, _ = links.shape

    def xla(l, k):
        return hmc_chain_u1_xla(l, k, eps, beta, num_leapfrog, num_samples,
                                hop=hop)

    if not leapfrog.kernel_fits(lt, lx):
        return xla(links, key)

    def kernel(l, k):
        return leapfrog.hmc_chain_cuda(l, k, eps, beta, num_leapfrog,
                                       num_samples, hop=hop)

    return jax.lax.platform_dependent(links, key, cuda=kernel, default=xla)


def hmc_chain_u1_xla(
    links: jax.Array,
    key: jax.Array,
    eps: float,
    beta: float,
    num_leapfrog: int,
    num_samples: int,
    hop: bool = False,
):
    """:func:`hmc_chain_u1_fused` as one ``lax.scan`` of
    :func:`hmc_transition` (Wilson force by autodiff), with the per-chain
    plaquette and charge of each output state taken inside the scan."""
    from l2hmc.dynamics import topo
    from l2hmc.lattice import u1

    b, lt, lx, _ = links.shape
    shape = u1.LatticeShape(lt, lx)
    pot = u1.make_potential_fn(shape)

    def body(x, k):
        if hop:
            k, k_hop = jax.random.split(k)
        out = hmc_transition(pot, x, beta, k, eps, num_leapfrog)
        x = u1.wrap(out.x_out)
        if hop:
            x = topo.instanton_hop(x, beta, k_hop, shape).x_out
        st = u1.to_links(x, shape)
        return x, (u1.avg_plaquette(st),
                   jnp.round(u1.topological_charge(st)), out.accept_prob)

    x_last, (plaqs, charges, probs) = jax.lax.scan(
        body, links.reshape(b, -1), jax.random.split(key, num_samples))
    return x_last.reshape(b, lt, lx, 2), plaqs, charges, probs


def hmc_chain(
    potential_fn: PotentialFn,
    x0: jax.Array,
    beta,
    key: jax.Array,
    eps,
    num_leapfrog: int,
    num_samples: int,
    wrap_fn: Callable[[jax.Array], jax.Array] | None = None,
):
    """Run ``num_samples`` HMC transitions under one ``lax.scan``.

    Returns ``(samples (T, batch, d), accept_probs (T, batch))``.  The whole
    chain stays on device; nothing crosses the host boundary per step
    (unlike the reference's per-step ``sess.run``, ``gauge_model.py:1379``).
    """

    def body(x, k):
        out = hmc_transition(potential_fn, x, beta, k, eps, num_leapfrog)
        x = out.x_out if wrap_fn is None else wrap_fn(out.x_out)
        return x, (x, out.accept_prob)

    keys = jax.random.split(key, num_samples)
    _, (xs, probs) = jax.lax.scan(body, x0, keys)
    return xs, probs
