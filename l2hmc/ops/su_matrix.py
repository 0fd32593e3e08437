"""Small-matrix group operations for SU(N) link fields.

Generic dense linear algebra (``jax.scipy.linalg.expm`` with its Pade + LU
solve, ``jnp.linalg.qr``) treats every tiny ``N x N`` matrix as a general
problem.  Everything here lowers to batched NxN matmuls and elementwise
ops only, with the lattice as the batch dimension.

- ``expm_ih``: ``exp(i H)`` for hermitian traceless H — closed form for
  N=2 (eigenvalues are +/-omega), Taylor + scaling-squaring for N>=3.
  Truncation error ~1e-7 for ||H|| <~ 1, i.e. at float32 noise; the HMC
  integrator only needs a deterministic volume-preserving map, and the MH
  accept evaluates the action exactly, so this does not bias sampling
  (same argument that covers Pade round-off).
- ``polar_reunitarize``: Newton-Schulz iteration to the unitary polar
  factor (replaces QR; quadratic convergence from near-unitary input),
  then the determinant phase is divided out (closed-form det for N<=3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _dag(m: jax.Array) -> jax.Array:
    return jnp.conjugate(jnp.swapaxes(m, -1, -2))


def expm_su2(h: jax.Array) -> jax.Array:
    """``exp(i H)`` for traceless hermitian 2x2 ``H`` — exact.

    Such H has eigenvalues ``+/-omega`` with ``omega^2 = -det H =
    |H_00|^2 + |H_01|^2``, so ``exp(iH) = cos(omega) I + i sinc(omega) H``.
    """
    om2 = (h[..., 0, 0].real ** 2 + jnp.abs(h[..., 0, 1]) ** 2)
    # cos(om) and sinc(om) are even in om, i.e. analytic in om2 — branch on
    # om2 with series fallbacks so jax.grad at H=0 stays finite (the HMC
    # force differentiates through this exactly at theta=0; a plain
    # sqrt(om2) would put an inf on the untaken where-branch).
    safe = om2 > 1e-12
    om = jnp.sqrt(jnp.where(safe, om2, 1.0))
    cos = jnp.where(safe, jnp.cos(om), 1.0 - om2 / 2.0)
    sinc = jnp.where(safe, jnp.sin(om) / om, 1.0 - om2 / 6.0)
    eye = jnp.eye(2, dtype=h.dtype)
    return cos[..., None, None] * eye + 1j * sinc[..., None, None] * h


def expm_taylor(h: jax.Array, order: int = 8, squarings: int = 2) -> jax.Array:
    """``exp(i H)`` by Taylor series + scaling-squaring, matmuls only.

    For ``||H|| <= 1`` (HMC position updates have ``||eps pi . T|| << 1``)
    the truncation error is ``~1/ (2^squarings)^order / order!`` — below
    float32 epsilon at the defaults.
    """
    a = (1j * h) / (2.0 ** squarings)
    eye = jnp.broadcast_to(jnp.eye(h.shape[-1], dtype=h.dtype), h.shape)
    # Horner: p = I + a(I + a/2 (I + a/3 (...)))
    p = eye + a / order
    for k in range(order - 1, 0, -1):
        p = eye + (a @ p) / k
    for _ in range(squarings):
        p = p @ p
    return p


def expm_ih(h: jax.Array) -> jax.Array:
    """``exp(i H)`` for batched traceless hermitian ``(..., N, N)``."""
    if h.shape[-1] == 2:
        return expm_su2(h)
    return expm_taylor(h)


def _det_small(u: jax.Array) -> jax.Array:
    """Closed-form determinant for N<=3 (no LU, no padding)."""
    n = u.shape[-1]
    if n == 1:
        return u[..., 0, 0]
    if n == 2:
        return u[..., 0, 0] * u[..., 1, 1] - u[..., 0, 1] * u[..., 1, 0]
    if n == 3:
        return (
            u[..., 0, 0] * (u[..., 1, 1] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 1])
            - u[..., 0, 1] * (u[..., 1, 0] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 0])
            + u[..., 0, 2] * (u[..., 1, 0] * u[..., 2, 1] - u[..., 1, 1] * u[..., 2, 0])
        )
    return jnp.linalg.det(u)


def polar_reunitarize(u: jax.Array, iters: int = 3) -> jax.Array:
    """Project near-unitary ``u`` to SU(N) via Newton-Schulz polar iteration.

    ``X <- X (3I - X^+ X) / 2`` converges quadratically to the unitary
    polar factor for ``||X^+X - I|| < 1`` (always true for drifted group
    elements); the determinant phase is then divided out.  Replaces
    QR-with-phase-fix without any padded linalg kernel.
    """
    n = u.shape[-1]
    eye = jnp.eye(n, dtype=u.dtype)
    x = u
    for _ in range(iters):
        x = x @ (1.5 * eye - 0.5 * (_dag(x) @ x))
    det = _det_small(x)
    phase = det / jnp.abs(det)
    # n-th root of the phase via angle division (principal branch)
    root = jnp.exp(-1j * jnp.angle(phase) / n)
    return x * root[..., None, None]
