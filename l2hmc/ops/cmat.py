"""Real-pair complex matrix algebra for link fields.

Represents a complex matrix field as a float32 pair ``(..., 2, N, N)`` —
axis -3 is (re, im) — and implements the group operations the samplers
need as pure real matmuls and elementwise ops, for runtimes without
complex dtypes.  XLA decomposes complex matmuls the same way; here the
decomposition is explicit.  Whether this form or complex64 is faster on
the GPU is an open measurement (ROADMAP C4); the CLIs take the complex
form.

Mirrors :mod:`l2hmc.ops.su_matrix` (the complex-dtype forms used on
CPU); ``tests/test_sun_nd.py`` pins the two representations against each
other exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_pairs(m: jax.Array) -> jax.Array:
    """complex ``(..., N, N)`` -> float32 pair ``(..., 2, N, N)``."""
    return jnp.stack([m.real, m.imag], axis=-3).astype(jnp.float32)


def gens_pair(n: int) -> jax.Array:
    """SU(N) generators as a float32 pair ``(k, 2, N, N)``.

    Built from the numpy constants on the host — a complex device array
    never exists."""
    from l2hmc.lattice.sun import generators_np

    g = generators_np(n)
    return jnp.asarray(np.stack([g.real, g.imag], axis=1), jnp.float32)


def from_pairs(p: jax.Array) -> jax.Array:
    """float32 pair ``(..., 2, N, N)`` -> complex64 ``(..., N, N)``."""
    return (p[..., 0, :, :] + 1j * p[..., 1, :, :]).astype(jnp.complex64)


def cmatmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Complex matmul on pairs: 4 real matmuls.

    Full f32 precision is load-bearing: a reduced-precision default
    (bfloat16 or TF32 multiplies) drifts links off the group faster than
    reunitarization corrects, and the accumulated Hamiltonian error drives
    HMC acceptance to zero.
    """
    hi = jax.lax.Precision.HIGHEST
    ar, ai = a[..., 0, :, :], a[..., 1, :, :]
    br, bi = b[..., 0, :, :], b[..., 1, :, :]
    mm = lambda x, y: jnp.matmul(x, y, precision=hi)
    return jnp.stack([mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)],
                     axis=-3)


def cdag(a: jax.Array) -> jax.Array:
    """Conjugate transpose on pairs."""
    at = jnp.swapaxes(a, -1, -2)
    return jnp.stack([at[..., 0, :, :], -at[..., 1, :, :]], axis=-3)


def ceye(n: int, like: jax.Array) -> jax.Array:
    """Identity as a pair, broadcast to ``like``'s batch shape."""
    eye = jnp.stack([jnp.eye(n, dtype=like.dtype),
                     jnp.zeros((n, n), like.dtype)], axis=0)
    return jnp.broadcast_to(eye, like.shape)


def retrace_over_n(p: jax.Array) -> jax.Array:
    """``Re tr P / N`` from a pair field."""
    n = p.shape[-1]
    return jnp.trace(p[..., 0, :, :], axis1=-2, axis2=-1) / n


def cexpm_ih(h: jax.Array, order: int = 8, squarings: int = 2) -> jax.Array:
    """``exp(i H)`` for a hermitian pair field — Taylor + squaring.

    ``M = iH`` has ``M_re = -H_im``, ``M_im = H_re``; then the same Horner
    scheme as :func:`l2hmc.ops.su_matrix.expm_taylor`.
    """
    scale = 1.0 / (2.0 ** squarings)
    m = jnp.stack([-h[..., 1, :, :], h[..., 0, :, :]], axis=-3) * scale
    eye = ceye(h.shape[-1], h)
    p = eye + m / order
    for k in range(order - 1, 0, -1):
        p = eye + cmatmul(m, p) / k
    for _ in range(squarings):
        p = cmatmul(p, p)
    return p


def cexpm_ih_su2(h: jax.Array) -> jax.Array:
    """Exact ``exp(i H)`` for traceless hermitian 2x2 pairs.

    Same even-in-omega formulation as ``su_matrix.expm_su2`` so the HMC
    force's ``jax.grad`` at H=0 stays finite.
    """
    hr, hi = h[..., 0, :, :], h[..., 1, :, :]
    om2 = hr[..., 0, 0] ** 2 + hr[..., 0, 1] ** 2 + hi[..., 0, 1] ** 2
    safe = om2 > 1e-12
    om = jnp.sqrt(jnp.where(safe, om2, 1.0))
    cos = jnp.where(safe, jnp.cos(om), 1.0 - om2 / 2.0)[..., None, None]
    sinc = jnp.where(safe, jnp.sin(om) / om, 1.0 - om2 / 6.0)[..., None, None]
    eye = jnp.eye(2, dtype=h.dtype)
    # exp(iH) = cos I + sinc * iH;  (iH)_re = -H_im, (iH)_im = H_re
    return jnp.stack([cos * eye - sinc * hi, sinc * hr], axis=-3)


def cexpm(h: jax.Array) -> jax.Array:
    """``exp(i H)`` dispatch: closed form for N=2, Taylor otherwise."""
    if h.shape[-1] == 2:
        return cexpm_ih_su2(h)
    return cexpm_ih(h)


def _cs_mul(a, b):
    """Complex scalar multiply on (re, im) tuples."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cdet_small(p: jax.Array):
    """Closed-form determinant of a pair field, N<=3; returns (re, im)."""
    n = p.shape[-1]
    e = lambda i, j: (p[..., 0, i, j], p[..., 1, i, j])
    if n == 1:
        return e(0, 0)
    if n == 2:
        a = _cs_mul(e(0, 0), e(1, 1))
        b = _cs_mul(e(0, 1), e(1, 0))
        return (a[0] - b[0], a[1] - b[1])
    if n == 3:
        def minor(i0, i1, j0, j1):
            a = _cs_mul((p[..., 0, i0, j0], p[..., 1, i0, j0]),
                        (p[..., 0, i1, j1], p[..., 1, i1, j1]))
            b = _cs_mul((p[..., 0, i0, j1], p[..., 1, i0, j1]),
                        (p[..., 0, i1, j0], p[..., 1, i1, j0]))
            return (a[0] - b[0], a[1] - b[1])

        t0 = _cs_mul(e(0, 0), minor(1, 2, 1, 2))
        t1 = _cs_mul(e(0, 1), minor(1, 2, 0, 2))
        t2 = _cs_mul(e(0, 2), minor(1, 2, 0, 1))
        return (t0[0] - t1[0] + t2[0], t0[1] - t1[1] + t2[1])
    raise NotImplementedError("pair determinant implemented for N <= 3")


def polar_reunitarize(u: jax.Array, iters: int = 3) -> jax.Array:
    """Newton-Schulz projection of a near-unitary pair field to SU(N)."""
    n = u.shape[-1]
    eye = ceye(n, u)
    x = u
    for _ in range(iters):
        x = cmatmul(x, 1.5 * eye - 0.5 * cmatmul(cdag(x), x))
    dr, di = cdet_small(x)
    ang = jnp.arctan2(di, dr) / n
    cr, ci = jnp.cos(-ang)[..., None, None], jnp.sin(-ang)[..., None, None]
    xr, xi = x[..., 0, :, :], x[..., 1, :, :]
    return jnp.stack([cr * xr - ci * xi, cr * xi + ci * xr], axis=-3)
