"""Fused Wilson action + analytic gradient.

The hot inner loop of the gauge dynamics evaluates ``S(x)`` and ``dS/dx``
twice per leapfrog step (``dynamics/gauge_dynamics.py:698-709`` does it with
``tf.gradients``).  Autodiff of the roll/cos composition materializes a
transpose chain of rolls; but the gradient of the Wilson action is analytic
and *shares the plaquette computation with the forward pass*::

    P(t,x)        = u0 - u1 - roll(u0,-1,x) + roll(u1,-1,t)
    S             = sum(1 - cos P)
    dS/du0(t,x)   =  sin P(t,x) - sin P(t,x-1)
    dS/du1(t,x)   = -sin P(t,x) + sin P(t-1,x)

:func:`wilson_action` is the pure-JAX forward with that analytic VJP (it
saves the ``sin P`` residual; the backward is two rolls and two
subtractions).  XLA fuses the rolls and the trig into the surrounding scan
body.  Validated against autodiff in ``tests/test_ops.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _plaq_sums(u0: jax.Array, u1: jax.Array) -> jax.Array:
    return u0 - u1 - jnp.roll(u0, -1, axis=-1) + jnp.roll(u1, -1, axis=-2)


def _action_fwd_math(links: jax.Array):
    u0 = links[..., 0]
    u1 = links[..., 1]
    p = _plaq_sums(u0, u1)
    action = jnp.sum(1.0 - jnp.cos(p), axis=(-2, -1))
    return action, jnp.sin(p)


def _grad_from_sinp(sinp: jax.Array) -> jax.Array:
    """Analytic dS/dlinks from the sin-plaquette residual."""
    g0 = sinp - jnp.roll(sinp, 1, axis=-1)   # sin P(t,x) - sin P(t,x-1)
    g1 = -sinp + jnp.roll(sinp, 1, axis=-2)  # -sin P(t,x) + sin P(t-1,x)
    return jnp.stack([g0, g1], axis=-1)


@jax.custom_vjp
def wilson_action(links: jax.Array) -> jax.Array:
    """Total Wilson action per sample with analytic VJP.

    ``links (..., Lt, Lx, 2) -> (...,)``.  Drop-in for
    :func:`l2hmc.lattice.u1.wilson_action` on the training/sampling hot
    path.
    """
    action, _ = _action_fwd_math(links)
    return action


def _wilson_fwd(links):
    action, sinp = _action_fwd_math(links)
    return action, sinp


def _wilson_bwd(sinp, g):
    return (g[..., None, None, None] * _grad_from_sinp(sinp),)


wilson_action.defvjp(_wilson_fwd, _wilson_bwd)


def make_potential_fn(shape):
    """Flat-state potential ``U(x) -> per-sample S`` on the analytic-VJP path
    (drop-in for ``lattice.u1.make_potential_fn`` on the hot path)."""

    def potential(x: jax.Array) -> jax.Array:
        links = x.reshape(*x.shape[:-1], *shape.links_shape)
        return wilson_action(links)

    return potential
