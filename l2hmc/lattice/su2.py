"""SU(2) lattice gauge theory in the quaternion representation.

Goes beyond the reference, whose SU(N) support is init + plaquette
scaffolding with no runnable sampling path (SURVEY §7.4,
``lattice/gauge_generators.py``).  SU(2) group elements are stored as unit
quaternions ``a = (a0, a1, a2, a3)`` with ``U = a0*I + i a_k sigma_k`` —
all-real arithmetic, elementwise, with no complex support needed:

- product:  ``(a b)_0 = a0 b0 - a.b``, ``(a b)_k = a0 b_k + b0 a_k - (a x b)_k``
- dagger:   ``(a0, -a_vec)``
- Re tr U = ``2 a0``; exp(i theta n.sigma/2) = ``(cos(theta/2), sin(theta/2) n)``

Layout: links ``(..., Lt, Lx, 2, 4)`` float32.  Wilson action
``S = beta * sum (1 - Re tr P / 2)`` with the plaquette orientation of
:func:`l2hmc.lattice.sun.sun_plaquette` (validated against the complex
matrix form in tests).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def qmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Product of SU(2) elements in the ``U = a0 + i a.sigma`` convention.

    Note the cross-product SIGN: ``(a.sigma)(b.sigma) = a.b + i (a x b).sigma``
    gives ``(ab)_vec = a0 b_vec + b0 a_vec - a x b`` (opposite to Hamilton
    quaternions).
    """
    a0, av = a[..., :1], a[..., 1:]
    b0, bv = b[..., :1], b[..., 1:]
    s = a0 * b0 - jnp.sum(av * bv, axis=-1, keepdims=True)
    v = a0 * bv + b0 * av - jnp.cross(av, bv)
    return jnp.concatenate([s, v], axis=-1)


def qconj(a: jax.Array) -> jax.Array:
    """Dagger: ``(a0, -a_vec)``."""
    return jnp.concatenate([a[..., :1], -a[..., 1:]], axis=-1)


def q_exp(theta: jax.Array) -> jax.Array:
    """``exp(i theta . sigma / 2)`` for algebra coordinates ``theta (..., 3)``.

    Returns the unit quaternion ``(cos(|t|/2), sin(|t|/2) t_hat)``; the
    ``sinc`` form is smooth at 0 (autodiff-safe).
    """
    n2 = jnp.sum(theta * theta, axis=-1, keepdims=True)
    n = jnp.sqrt(n2 + 1e-24)
    half = 0.5 * n
    return jnp.concatenate(
        [jnp.cos(half), jnp.sinc(half / np.pi) * 0.5 * theta], axis=-1
    )


def qnormalize(a: jax.Array) -> jax.Array:
    return a / jnp.linalg.norm(a, axis=-1, keepdims=True)


def random_links(key: jax.Array, batch: int, lt: int, lx: int, scale=None) -> jax.Array:
    """Haar-random (scale=None) or near-identity SU(2) link field
    ``(batch, lt, lx, 2, 4)``."""
    if scale is None:
        g = jax.random.normal(key, (batch, lt, lx, 2, 4))
        return qnormalize(g)
    theta = scale * jax.random.normal(key, (batch, lt, lx, 2, 3))
    return q_exp(theta)


def cold_links(batch: int, lt: int, lx: int) -> jax.Array:
    a = jnp.zeros((batch, lt, lx, 2, 4), jnp.float32)
    return a.at[..., 0].set(1.0)


def plaquette(links: jax.Array) -> jax.Array:
    """``P(n) = U0(n) U1(n+0) U0(n+1)^+ U1(n)^+`` as quaternions
    (orientation of ``sun.sun_plaquette``).  links (..., Lt, Lx, 2, 4)."""
    u0 = links[..., 0, :]
    u1 = links[..., 1, :]
    # field shape (..., Lt, Lx, 4): time axis is -3, space axis is -2
    u1_tp = jnp.roll(u1, -1, axis=-3)   # t+1
    u0_xp = jnp.roll(u0, -1, axis=-2)   # x+1
    return qmul(qmul(u0, u1_tp), qmul(qconj(u0_xp), qconj(u1)))


def wilson_action(links: jax.Array, beta) -> jax.Array:
    """``beta * sum (1 - Re tr P / 2)`` per sample -> (...,)."""
    p0 = plaquette(links)[..., 0]       # Re tr P / 2 = a0
    return beta * jnp.sum(1.0 - p0, axis=(-2, -1))


def avg_plaquette(links: jax.Array) -> jax.Array:
    """``< Re tr P / 2 >`` per sample."""
    return jnp.mean(plaquette(links)[..., 0], axis=(-2, -1))


def su2_plaq_exact(beta: float, n_grid: int = 4096) -> float:
    """Single-plaquette (= 2-D infinite-volume) expectation of Re tr P / 2.

    Haar measure on SU(2) classes: ``dmu ~ sin^2(t) dt`` with
    ``Re tr U / 2 = cos t``, weight ``exp(beta cos t)``; quadrature anchor
    (equals ``I2(beta)/I1(beta)`` by Bessel identities).
    """
    t = np.linspace(0.0, np.pi, n_grid)
    w = np.sin(t) ** 2 * np.exp(beta * np.cos(t))
    return float(np.trapezoid(np.cos(t) * w, t) / np.trapezoid(w, t))


def to_matrix(a: jax.Array) -> jax.Array:
    """Quaternion -> complex 2x2 SU(2) matrix (for cross-validation)."""
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    row0 = jnp.stack([a0 + 1j * a3, a2 + 1j * a1], axis=-1)
    row1 = jnp.stack([-a2 + 1j * a1, a0 - 1j * a3], axis=-1)
    return jnp.stack([row0, row1], axis=-2)
