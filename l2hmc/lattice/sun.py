"""SU(2)/SU(3) group scaffolding.

Rebuild of the reference's group-theory helpers
(``lattice/gauge_generators.py:6-152``, ``lattice/matrices.py:3-142``,
``lattice/fields.py:4-83``) in JAX: generator constants, random
near-identity group elements via ``expm(i alpha.T)``, SU(N) plaquettes as
link-matrix products, and the Wilson action ``sum (1 - Re tr P / N)``.

The operators here are exact and tested (unitarity, det=1, gauge
invariance).  Unlike the reference (where SU(N) is dead scaffolding,
SURVEY §7.4), these feed working samplers: :mod:`l2hmc.dynamics.su2_hmc`
(quaternion SU(2)) and :mod:`l2hmc.dynamics.sun_hmc` (matrix SU(N)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Pauli matrices (lattice/matrices.py)
PAULI = np.array(
    [
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex64,
)

# Gell-Mann matrices (lattice/matrices.py)
GELL_MANN = np.array(
    [
        [[0, 1, 0], [1, 0, 0], [0, 0, 0]],
        [[0, -1j, 0], [1j, 0, 0], [0, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 0]],
        [[0, 0, 1], [0, 0, 0], [1, 0, 0]],
        [[0, 0, -1j], [0, 0, 0], [1j, 0, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 0], [0, 0, -1j], [0, 1j, 0]],
        [
            [1 / np.sqrt(3), 0, 0],
            [0, 1 / np.sqrt(3), 0],
            [0, 0, -2 / np.sqrt(3)],
        ],
    ],
    dtype=np.complex64,
)


def generators_np(n: int) -> np.ndarray:
    """Generator constants as NUMPY complex (host-side).

    Needed by the real-pair path (:mod:`l2hmc.ops.cmat`), which keeps
    complex arrays off the device entirely: the (re, im) split happens
    before anything reaches it.
    """
    if n == 2:
        return PAULI / 2.0
    if n == 3:
        return GELL_MANN / 2.0
    raise ValueError(f"SU({n}) not supported (N in {{2,3}})")


def generators(n: int) -> jax.Array:
    return jnp.asarray(generators_np(n))


def random_sun(key: jax.Array, n: int, shape=(), scale: float = 0.1) -> jax.Array:
    """Random near-identity SU(N) elements ``expm(i sum a_k T_k)``
    (``gauge_generators.py:6-48``).  Returns ``(*shape, n, n)`` complex."""
    gens = generators(n)
    k = gens.shape[0]
    alpha = scale * jax.random.normal(key, (*shape, k))
    h = jnp.einsum("...k,kij->...ij", alpha.astype(jnp.complex64), gens)
    return jax.scipy.linalg.expm(1j * h)


def sun_plaquette(links: jax.Array) -> jax.Array:
    """SU(N) plaquette field from links ``(..., Lt, Lx, 2, N, N)``.

    Standard orientation: ``P(n) = U0(n) U1(n+0) U0(n+1)^+ U1(n)^+`` with
    direction 0 = time (axis -4), 1 = space (axis -3) — matrix-product
    analog of ``lattice/lattice.py:459-472``.
    Returns ``(..., Lt, Lx, N, N)``.
    """
    u0 = links[..., 0, :, :]
    u1 = links[..., 1, :, :]
    u1_tp = jnp.roll(u1, -1, axis=-4)  # U1 at t+1 (one step along dir 0)
    u0_xp = jnp.roll(u0, -1, axis=-3)  # U0 at x+1 (one step along dir 1)
    dagger = lambda m: jnp.conjugate(jnp.swapaxes(m, -1, -2))
    return u0 @ u1_tp @ dagger(u0_xp) @ dagger(u1)


def sun_action(links: jax.Array, beta) -> jax.Array:
    """Wilson action ``beta sum (1 - Re tr P / N)`` per sample."""
    p = sun_plaquette(links)
    n = p.shape[-1]
    retr = jnp.trace(p, axis1=-2, axis2=-1).real / n
    return beta * jnp.sum(1.0 - retr, axis=(-2, -1))


def is_unitary(u: jax.Array, atol: float = 1e-5) -> jax.Array:
    n = u.shape[-1]
    eye = jnp.eye(n, dtype=u.dtype)
    err = jnp.abs(u @ jnp.conjugate(jnp.swapaxes(u, -1, -2)) - eye)
    return jnp.max(err) < atol
