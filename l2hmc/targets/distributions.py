"""Analytic target distributions.

Pure-JAX rebuild of the reference target zoo (``utils/distributions.py:56-243``):
Gaussian, random tilted (strongly-correlated) Gaussian, rough well, Gaussian
mixture, Gaussian funnel, ring of Gaussians.  Each target is a pytree
(a frozen dataclass registered with ``jax.tree_util``) exposing

- ``energy(x)``      per-sample energy, shape ``(batch,)`` for ``x (batch, d)``
- ``log_density(x)`` exact log density where tractable
- ``sample(key, n)`` exact samples where tractable

so targets flow through ``jit``/``vmap``/``pjit`` like any other array data.
The L1->L3 contract matches the reference's ``get_energy_function()``
(``utils/distributions.py:63,107,151,190``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls):
    """Frozen dataclass whose fields are pytree children, except those
    declared with :func:`_static` (hashable, part of the treedef)."""
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


def _static(**kwargs):
    return dataclasses.field(metadata=dict(static=True), **kwargs)


def quadratic_gaussian(x: jax.Array, mu: jax.Array, prec: jax.Array) -> jax.Array:
    """``0.5 (x-mu)^T prec (x-mu)`` per sample (``utils/distributions.py:32-39``).

    One matmul + rowwise dot instead of the reference's full
    ``(x-mu) S (x-mu)^T`` batch-by-batch matrix (whose off-diagonal work is
    thrown away by ``diag_part``).
    """
    d = x - mu
    return 0.5 * jnp.einsum("...i,ij,...j->...", d, prec, d)


@_pytree_dataclass
class Gaussian:
    """Multivariate Gaussian target (``utils/distributions.py:56-79``)."""

    mu: jax.Array
    sigma: jax.Array  # covariance
    prec: jax.Array  # inverse covariance
    chol: jax.Array  # cholesky(sigma)
    log_norm: jax.Array  # log Z = 0.5*(d log 2pi + log det sigma)

    @classmethod
    def create(cls, mu, sigma) -> "Gaussian":
        mu = jnp.asarray(mu, jnp.float32)
        sigma = jnp.asarray(sigma, jnp.float32)
        prec = jnp.linalg.inv(sigma)
        chol = jnp.linalg.cholesky(sigma)
        sign, logdet = jnp.linalg.slogdet(sigma)
        log_norm = 0.5 * (mu.shape[-1] * jnp.log(2 * jnp.pi) + logdet)
        return cls(mu=mu, sigma=sigma, prec=prec, chol=chol, log_norm=log_norm)

    def energy(self, x: jax.Array) -> jax.Array:
        return quadratic_gaussian(x, self.mu, self.prec)

    def log_density(self, x: jax.Array) -> jax.Array:
        return -self.energy(x) - self.log_norm

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        z = jax.random.normal(key, (n, self.mu.shape[-1]), dtype=jnp.float32)
        return self.mu + z @ self.chol.T


def random_tilted_gaussian(
    key, dim: int, log_min: float = -2.0, log_max: float = 2.0
) -> Gaussian:
    """Rotated ill-conditioned Gaussian — the paper's strongly-correlated
    Gaussian target (``utils/distributions.py:47-54,82-98``).

    Eigenvalues are log-uniform in ``10^[log_min, log_max]``; the rotation is
    a Haar-random orthogonal matrix (QR of a Gaussian matrix).
    """
    k1, k2 = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int) else key)
    # Haar orthogonal via QR decomposition with sign fix.
    a = jax.random.normal(k1, (dim, dim))
    q, r = jnp.linalg.qr(a)
    q = q * jnp.sign(jnp.diagonal(r))
    lam = jnp.exp(
        jnp.log(10.0) * jax.random.uniform(k2, (dim,), minval=log_min, maxval=log_max)
    )
    sigma = (q.T * lam) @ q + 1e-6 * jnp.eye(dim)
    return Gaussian.create(jnp.zeros((dim,)), sigma)


def scg_2d() -> Gaussian:
    """The canonical 2-D strongly-correlated Gaussian of the L2HMC paper:
    covariance eigenvalues {100, 0.01} rotated 45 degrees (SCGExperiment)."""
    theta = np.pi / 4
    r = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
        dtype=np.float32,
    )
    sigma = r @ np.diag(np.array([100.0, 0.01], np.float32)) @ r.T
    return Gaussian.create(np.zeros(2, np.float32), sigma)


@_pytree_dataclass
class RoughWell:
    """Quadratic well + fast cosine ripples (``utils/distributions.py:101-121``)."""

    dim: int = _static()
    eps: float = _static()
    easy: bool = _static(default=False)

    def energy(self, x: jax.Array) -> jax.Array:
        n = jnp.sum(jnp.square(x), axis=-1)
        scale = self.eps if self.easy else self.eps * self.eps
        return 0.5 * n + self.eps * jnp.sum(jnp.cos(x / scale), axis=-1)

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        # Gaussian approximation, valid for small eps (reference comment).
        return jax.random.normal(key, (n, self.dim), dtype=jnp.float32)


@_pytree_dataclass
class GMM:
    """Gaussian mixture with exact sampling/log-density
    (``utils/distributions.py:124-181``).

    Components stacked on a leading axis -> the per-component energies are a
    single batched einsum followed by logsumexp, not a python loop.
    """

    mus: jax.Array      # (k, d)
    sigmas: jax.Array   # (k, d, d)
    precs: jax.Array    # (k, d, d)
    chols: jax.Array    # (k, d, d)
    pis: jax.Array      # (k,)
    log_consts: jax.Array  # (k,)  log(pi_i / sqrt((2pi)^d det sigma_i))

    @classmethod
    def create(cls, mus, sigmas, pis) -> "GMM":
        mus = jnp.asarray(mus, jnp.float32)
        sigmas = jnp.asarray(sigmas, jnp.float32)
        pis = jnp.asarray(pis, jnp.float32)
        pis = pis / jnp.sum(pis)
        d = mus.shape[-1]
        precs = jnp.linalg.inv(sigmas)
        chols = jnp.linalg.cholesky(sigmas)
        sign, logdets = jnp.linalg.slogdet(sigmas)
        log_consts = jnp.log(pis) - 0.5 * (d * jnp.log(2 * jnp.pi) + logdets)
        return cls(
            mus=mus, sigmas=sigmas, precs=precs, chols=chols, pis=pis,
            log_consts=log_consts,
        )

    def _component_logps(self, x: jax.Array) -> jax.Array:
        d = x[..., None, :] - self.mus  # (..., k, d)
        quad = 0.5 * jnp.einsum("...ki,kij,...kj->...k", d, self.precs, d)
        return self.log_consts - quad

    def energy(self, x: jax.Array) -> jax.Array:
        return -jax.scipy.special.logsumexp(self._component_logps(x), axis=-1)

    def log_density(self, x: jax.Array) -> jax.Array:
        return -self.energy(x)

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        kc, kz = jax.random.split(key)
        comp = jax.random.choice(kc, self.pis.shape[0], shape=(n,), p=self.pis)
        z = jax.random.normal(kz, (n, self.mus.shape[-1]), dtype=jnp.float32)
        mu = self.mus[comp]
        chol = self.chols[comp]
        return mu + jnp.einsum("nij,nj->ni", chol, z)


@_pytree_dataclass
class GaussianFunnel:
    """Neal's funnel with clipped-energy stabilization
    (``utils/distributions.py:184-228``)."""

    dim: int = _static()
    sigma: float = _static(default=2.0)
    clip: float = _static(default=8.0)  # 4*sigma

    def energy(self, x: jax.Array) -> jax.Array:
        v = x[..., 0]
        log_p_v = jnp.square(v / self.sigma)
        s = jnp.exp(v)
        sum_sq = jnp.sum(jnp.square(x[..., 1:]), axis=-1)
        n = x.shape[-1] - 1
        def e_at(scale):
            return 0.5 * (log_p_v + sum_sq / scale + n * jnp.log(2.0 * jnp.pi * scale))
        e = e_at(s)
        e_hi = e_at(jnp.exp(self.clip))
        e_lo = e_at(jnp.exp(-self.clip))
        e = jnp.where(v > self.clip, e_hi, e)
        e = jnp.where(v < -self.clip, e_lo, e)
        return e

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        kv, kz = jax.random.split(key)
        # Reference sampler (utils/distributions.py:216-223): v ~ sigma*N(0,1),
        # x_{1:} ~ exp(v/2) * N(0,1).
        v = self.sigma * jax.random.normal(kv, (n, 1), dtype=jnp.float32)
        z = jax.random.normal(kz, (n, self.dim - 1), dtype=jnp.float32)
        return jnp.concatenate([v, jnp.exp(v / 2.0) * z], axis=-1)

    def log_density(self, x: jax.Array) -> jax.Array:
        return -self.energy(x)


def gen_ring(r: float = 1.0, var: float = 1.0, nb_mixtures: int = 2) -> GMM:
    """Ring of equally-weighted Gaussians (``utils/distributions.py:231-243``)."""
    t = np.arange(nb_mixtures)
    mus = np.stack(
        [r * np.cos(2 * np.pi * t / nb_mixtures),
         r * np.sin(2 * np.pi * t / nb_mixtures)], axis=-1
    ).astype(np.float32)
    sigmas = np.tile(var * np.eye(2, dtype=np.float32), (nb_mixtures, 1, 1))
    pis = np.full((nb_mixtures,), 1.0 / nb_mixtures, np.float32)
    return GMM.create(mus, sigmas, pis)


def gmm_axes(dim: int, sep: float = 2.0, var: float = 0.1) -> GMM:
    """Two-component mixture separated along the first axis.

    NOTE on naming vs the reference: this matches the reference's
    ``single_axis`` arrangement (``mog_model.py:1086-1096`` — pair at
    ``+-centers`` on one axis), which is the configuration the MoG
    tunneling experiments actually use.  The reference's ``axes``
    arrangement (one mode per coordinate axis) is ``gmm_one_per_axis``.
    Kept under this name for backward compatibility with round-1 runs.
    """
    return gmm_single_axis(dim, sep=sep, var=var)


def gmm_single_axis(dim: int, sep: float = 2.0, var: float = 0.1) -> GMM:
    """Pair of Gaussians at ``+-sep`` along the first axis — the reference's
    ``single_axis`` arrangement (``mog_model.py:1086-1096``; the reference
    fixes ``rand_axis = 0`` too)."""
    mus = np.zeros((2, dim), np.float32)
    mus[0, 0] = sep
    mus[1, 0] = -sep
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (2, 1, 1))
    return GMM.create(mus, sigmas, np.array([0.5, 0.5], np.float32))


def gmm_one_per_axis(
    dim: int, sep: float = 2.0, var: float = 0.1, num_modes: int = 0
) -> GMM:
    """One Gaussian centered at ``sep`` on each coordinate axis — the
    reference's default ``axes`` arrangement (``mog_model.py:1040-1068``:
    ``means = diag(centers)``; if ``num_modes < dim`` the first
    ``num_modes`` axes are reused cyclically)."""
    num_modes = num_modes or dim
    mus = np.zeros((num_modes, dim), np.float32)
    for i in range(num_modes):
        mus[i, i % dim] = sep
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (num_modes, 1, 1))
    pis = np.full((num_modes,), 1.0 / num_modes, np.float32)
    return GMM.create(mus, sigmas, pis)


def gmm_diagonal(dim: int, sep: float = 2.0, var: float = 0.1) -> GMM:
    """Pair of Gaussians at ``+-sep * (1, ..., 1)`` — the reference's
    ``diagonal`` arrangement (``mog_model.py:1098-1103``: rows alternate
    ``+centers`` / ``-centers`` in every coordinate)."""
    mus = np.stack(
        [np.full((dim,), sep, np.float32), np.full((dim,), -sep, np.float32)]
    )
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (2, 1, 1))
    return GMM.create(mus, sigmas, np.array([0.5, 0.5], np.float32))
