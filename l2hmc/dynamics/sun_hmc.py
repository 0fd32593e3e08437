"""Lie-group HMC for SU(N) lattice gauge theory (matrix representation).

Generalizes :mod:`l2hmc.dynamics.su2_hmc` to any SU(N) with the same
design: momenta are algebra coefficients, the position update is a left
translation by ``expm(i eps pi . T)``, and the force is the autodiff
gradient of the action with respect to left-translation coordinates at the
identity.  ``jax.scipy.linalg.expm`` (Pade, differentiable) handles the
exponential; everything is batched over ``(B, Lt, Lx, 2)`` link fields of
``N x N`` complex matrices.

Exact anchor: the 2-D SU(N) theory factorizes over plaquettes; the
single-plaquette expectation ``<Re tr P / N>`` is a class-function integral
evaluated by quadrature over the maximal torus with the Weyl measure
(``sun_plaq_exact``), giving an oracle for any N.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from l2hmc.lattice.sun import generators, sun_action, random_sun


def _algebra_to_matrix(theta: jax.Array, gens: jax.Array) -> jax.Array:
    """theta (..., k) -> hermitian (..., N, N)."""
    return jnp.einsum("...k,kij->...ij", theta.astype(jnp.complex64), gens)


def _left_translate(links: jax.Array, theta: jax.Array, gens: jax.Array) -> jax.Array:
    h = _algebra_to_matrix(theta, gens)
    rot = jax.scipy.linalg.expm(1j * h)
    return rot @ links


def _reunitarize(u: jax.Array) -> jax.Array:
    """Project back to U(N) via QR with phase fix (controls expm drift), then
    to SU(N) by dividing out the determinant phase."""
    q, r = jnp.linalg.qr(u)
    d = jnp.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / jnp.abs(d))[..., None, :]
    det = jnp.linalg.det(q)
    n = u.shape[-1]
    return q * (det ** (-1.0 / n))[..., None, None]


class SUNHMCOut(NamedTuple):
    links: jax.Array
    accept_prob: jax.Array


def sun_hmc_transition(
    links: jax.Array, beta, key: jax.Array, eps, num_steps: int, n: int
) -> SUNHMCOut:
    """One HMC transition for SU(N) link fields ``(B, Lt, Lx, 2, N, N)``."""
    gens = generators(n)
    k = gens.shape[0]
    kv, ka = jax.random.split(key)
    pi = jax.random.normal(kv, links.shape[:-2] + (k,), jnp.float32)

    def kinetic(p):
        return 0.5 * jnp.sum(p * p, axis=(-4, -3, -2, -1))

    def force(u):
        def s_of_theta(theta):
            return jnp.sum(sun_action(_left_translate(u, theta, gens), beta))

        zero = jnp.zeros(u.shape[:-2] + (k,), jnp.float32)
        return jax.grad(s_of_theta)(zero)

    h0 = sun_action(links, beta) + kinetic(pi)

    def leapfrog(carry, _):
        u, p = carry
        p = p - 0.5 * eps * force(u)
        u = _reunitarize(_left_translate(u, eps * p, gens))
        p = p - 0.5 * eps * force(u)
        return (u, p), None

    (u_new, pi_new), _ = jax.lax.scan(leapfrog, (links, pi), None, length=num_steps)

    h1 = sun_action(u_new, beta) + kinetic(pi_new)
    prob = jnp.exp(jnp.minimum(h0 - h1, 0.0))
    prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
    accept = jax.random.uniform(ka, prob.shape) < prob
    out = jnp.where(accept[:, None, None, None, None, None], u_new, links)
    return SUNHMCOut(links=out, accept_prob=prob)


def sun_hmc_chain(
    key: jax.Array,
    n: int,
    lt: int,
    lx: int,
    beta,
    num_samples: int,
    batch: int = 8,
    eps: float = 0.1,
    num_steps: int = 5,
):
    """Scan-resident SU(N) HMC chain; returns (<Re tr P / N> trace, accept)."""
    k0, key = jax.random.split(key)
    links = random_sun(k0, n, (batch, lt, lx, 2), scale=0.5)

    def avg_plaq(u):
        from l2hmc.lattice.sun import sun_plaquette

        p = sun_plaquette(u)
        return jnp.mean(
            jnp.trace(p, axis1=-2, axis2=-1).real / n, axis=(-2, -1)
        )

    def body(u, kk):
        out = sun_hmc_transition(u, beta, kk, eps, num_steps, n)
        return out.links, (avg_plaq(out.links), out.accept_prob)

    keys = jax.random.split(key, num_samples)
    _, (plaqs, probs) = jax.lax.scan(body, links, keys)
    return plaqs, probs


def sun_plaq_exact(n: int, beta: float, n_grid: int = 200) -> float:
    """Single-plaquette ``<Re tr P / N>`` for 2-D SU(N) by quadrature.

    Weyl integration over the maximal torus: eigenphases ``t_1..t_{n-1}``
    (``t_n = -sum``), Haar class measure ``|prod_{i<j} (e^{i t_i} -
    e^{i t_j})|^2``, weight ``exp((beta/n) Re tr U)`` for the action
    convention ``S = beta (1 - Re tr P / n)``.
    """
    if n == 2:
        t = np.linspace(0, np.pi, 4096)
        w = np.sin(t) ** 2 * np.exp(beta * np.cos(t))
        return float(np.trapezoid(np.cos(t) * w, t) / np.trapezoid(w, t))
    if n != 3:
        raise NotImplementedError("oracle implemented for N in {2, 3}")
    t = np.linspace(-np.pi, np.pi, n_grid)
    t1, t2 = np.meshgrid(t, t, indexing="ij")
    t3 = -t1 - t2
    z = np.stack([np.exp(1j * t1), np.exp(1j * t2), np.exp(1j * t3)])
    vdm = (
        np.abs(z[0] - z[1]) ** 2
        * np.abs(z[0] - z[2]) ** 2
        * np.abs(z[1] - z[2]) ** 2
    )
    retr = np.cos(t1) + np.cos(t2) + np.cos(t3)
    w = vdm * np.exp(beta * retr / n)
    return float((retr / n * w).sum() / w.sum())
