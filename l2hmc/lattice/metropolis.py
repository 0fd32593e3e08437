"""Reference Metropolis link-update sampler for U(1).

Rebuild of the numpy per-link staple update in the reference
(``lattice/lattice.py:474-563``) as a vectorized, jittable checkerboard
sweep: a link's conditional action only involves the two plaquettes that
contain it, so links of equal (site parity, direction) are conditionally
independent and update simultaneously — a classic lattice-MCMC decomposition
into wide elementwise updates (the reference updates one link at a time in
a python loop).

Used as an independent correctness oracle for the HMC/L2HMC samplers: all
must agree on <plaquette> and charge statistics within MC error.

Derivation (orientation of :func:`l2hmc.lattice.u1.plaq_sums`):
``P(t,x) = u0(t,x) - u1(t,x) - u0(t,x+1) + u1(t+1,x)``.

- ``u0(t,x)`` appears in ``P(t,x) = theta + A`` and ``P(t,x-1) = B - theta``
- ``u1(t,x)`` appears in ``P(t,x) = C - theta`` and ``P(t-1,x) = D + theta``

with A, B, C, D sums of neighboring links (rolls below).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from l2hmc.lattice import u1


def _partial_plaqs(links: jax.Array, mu: int) -> Tuple[jax.Array, jax.Array]:
    """The two plaquette-angle remainders for each link in direction mu.

    Returns ``(r1, r2)`` such that the local action is
    ``-cos(theta + r1) - cos(r2 - theta)`` for mu=0 and
    ``-cos(r1 - theta) - cos(r2 + theta)`` for mu=1.
    """
    u0 = links[..., 0]
    u1_ = links[..., 1]
    if mu == 0:
        a = -u1_ - jnp.roll(u0, -1, axis=-1) + jnp.roll(u1_, -1, axis=-2)
        b = (
            jnp.roll(u0, 1, axis=-1)
            - jnp.roll(u1_, 1, axis=-1)
            + jnp.roll(jnp.roll(u1_, -1, axis=-2), 1, axis=-1)
        )
        return a, b
    c = u0 - jnp.roll(u0, -1, axis=-1) + jnp.roll(u1_, -1, axis=-2)
    # C above still contains u1(t+1,x) via the last roll — subtract nothing:
    # that is a *different* link from u1(t,x), so it stays.  But the middle
    # term of P(t,x) is the theta itself; C must exclude it:
    c = u0 - jnp.roll(u0, -1, axis=-1) + jnp.roll(u1_, -1, axis=-2)
    d = (
        jnp.roll(u0, 1, axis=-2)
        - jnp.roll(u1_, 1, axis=-2)
        - jnp.roll(jnp.roll(u0, -1, axis=-1), 1, axis=-2)
    )
    return c, d


def local_action(links: jax.Array, mu: int, theta: jax.Array) -> jax.Array:
    """Per-link local Wilson action (the two plaquettes holding the link)."""
    r1, r2 = _partial_plaqs(links, mu)
    if mu == 0:
        return -jnp.cos(theta + r1) - jnp.cos(r2 - theta)
    return -jnp.cos(r1 - theta) - jnp.cos(r2 + theta)


def metropolis_sweep(
    links: jax.Array, beta, key: jax.Array, proposal_scale: float = 1.0
) -> Tuple[jax.Array, jax.Array]:
    """One full checkerboard Metropolis sweep (4 sub-sweeps: mu x parity).

    Within a (mu, parity) class no two links share a plaquette, so the
    simultaneous update is exact Metropolis.
    """
    lt, lx = links.shape[-3], links.shape[-2]
    tt = jax.lax.broadcasted_iota(jnp.int32, (lt, lx), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (lt, lx), 1)
    parity = (tt + xx) % 2

    acc_sum = 0.0
    for mu in (0, 1):
        for par in (0, 1):
            key, kp, ka = jax.random.split(key, 3)
            theta_old = links[..., mu]
            prop = jax.random.uniform(
                kp, theta_old.shape, minval=-proposal_scale, maxval=proposal_scale
            )
            theta_new = theta_old + prop
            delta = beta * (
                local_action(links, mu, theta_new)
                - local_action(links, mu, theta_old)
            )
            u_rand = jax.random.uniform(ka, delta.shape)
            accept = (u_rand < jnp.exp(jnp.minimum(-delta, 0.0))) & (parity == par)
            links = links.at[..., mu].set(jnp.where(accept, theta_new, theta_old))
            acc_sum = acc_sum + 2.0 * jnp.mean(accept.astype(jnp.float32))
    return u1.wrap(links), acc_sum / 4.0


def metropolis_chain(
    key: jax.Array,
    shape: u1.LatticeShape,
    beta,
    num_sweeps: int,
    batch: int = 1,
    proposal_scale: float = 1.0,
    thin: int = 1,
):
    """Run ``num_sweeps`` sweeps, record observables every ``thin`` sweeps.

    Scan-resident; one device program for the whole chain.  Returns
    ``(plaqs (T, batch), charges (T, batch))``.
    """
    k0, key = jax.random.split(key)
    links = u1.to_links(u1.random_links(k0, batch, shape), shape)

    def body(links, k):
        def sweep_once(links, kk):
            out, _ = metropolis_sweep(links, beta, kk, proposal_scale)
            return out, None

        ks = jax.random.split(k, thin)
        links, _ = jax.lax.scan(sweep_once, links, ks)
        obs = u1.observables(u1.to_flat(links), shape)
        return links, (obs["plaqs"], obs["charges"])

    keys = jax.random.split(key, num_sweeps // thin)
    links, (plaqs, charges) = jax.lax.scan(body, links, keys)
    return plaqs, charges


def thermalize(
    key: jax.Array,
    x: jax.Array,
    shape: u1.LatticeShape,
    beta,
    num_sweeps: int,
) -> jax.Array:
    """Equilibrate flat configs ``x (batch, x_dim)`` with exact checkerboard
    Metropolis sweeps at ``beta``; returns updated flat configs.

    The standard lattice warm start for a sampler eval: chains left below
    equilibrium by a fast beta-annealing schedule relax in O(10^3) cheap
    local sweeps, where the global-update kernels need >10^4 transitions
    (seen at 64x64).
    """
    links = u1.to_links(x, shape)

    def body(links, k):
        out, _ = metropolis_sweep(links, beta, k)
        return out, None

    links, _ = jax.lax.scan(body, links, jax.random.split(key, num_sweeps))
    return u1.to_flat(links)
