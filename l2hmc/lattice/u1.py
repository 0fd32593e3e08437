"""2-D U(1) lattice gauge theory.

Pure-functional rebuild of the live lattice in the reference
(``lattice/lattice.py:61-563`` and the graph-side duplicates in
``gauge_model.py:659-726``): Wilson action, plaquette / topological-charge
observables, the analytic average-plaquette oracle, and the differentiable
Fourier-series surrogate of the angle projection used by the topological
loss (``gauge_model.py:78-108``).

Design notes:

- Link field layout is ``(..., Lt, Lx, 2)`` angles in float32.  The flat
  layout used by the dynamics is ``(..., 2*Lt*Lx)``; :func:`to_links` /
  :func:`to_flat` convert.  All functions broadcast over arbitrary leading
  batch axes, so ``jax.vmap`` is never required (but composes fine).
- The action is a handful of rolls + cos + reduce — XLA fuses this into one
  elementwise kernel.  The analytic-VJP form (action + grad from one
  plaquette pass) lives in ``l2hmc.ops.wilson`` for the hot path.
- No data-dependent control flow: everything traces once under ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class LatticeShape:
    """Static U(1) lattice geometry (hashable: usable as a jit static arg)."""

    time_size: int
    space_size: int
    dim: int = 2  # number of link directions == lattice dimensionality

    @property
    def links_shape(self) -> Tuple[int, int, int]:
        return (self.time_size, self.space_size, self.dim)

    @property
    def num_links(self) -> int:
        return self.time_size * self.space_size * self.dim

    @property
    def num_plaquettes(self) -> int:
        return self.time_size * self.space_size

    @property
    def x_dim(self) -> int:
        """Flat state dimensionality seen by the dynamics."""
        return self.num_links


def to_links(x: jax.Array, shape: LatticeShape) -> jax.Array:
    """Reshape flat state ``(..., num_links)`` to ``(..., Lt, Lx, 2)``."""
    return x.reshape(*x.shape[:-1], *shape.links_shape)


def to_flat(links: jax.Array) -> jax.Array:
    """Reshape ``(..., Lt, Lx, 2)`` links to flat ``(..., num_links)``."""
    return links.reshape(*links.shape[:-3], -1)


def plaq_sums(links: jax.Array) -> jax.Array:
    """Sum of link angles around each elementary plaquette.

    ``links`` has shape ``(..., Lt, Lx, 2)``; the result ``(..., Lt, Lx)``.

    Matches the reference orientation (``lattice/lattice.py:300-303``,
    ``gauge_model.py:671-675``)::

        P(t, x) = U0(t, x) - U1(t, x) - U0(t, x+1) + U1(t+1, x)

    where axis -3 is time and axis -2 is space, both periodic.
    """
    u0 = links[..., 0]
    u1 = links[..., 1]
    return (
        u0
        - u1
        - jnp.roll(u0, shift=-1, axis=-1)
        + jnp.roll(u1, shift=-1, axis=-2)
    )


def wilson_action(links: jax.Array) -> jax.Array:
    """Total Wilson action ``S = sum(1 - cos(P))`` per sample.

    Reference: ``lattice/lattice.py:337-362``. Input ``(..., Lt, Lx, 2)``,
    output ``(...,)``.  Multiply by ``beta`` to get the potential energy.
    """
    return jnp.sum(1.0 - jnp.cos(plaq_sums(links)), axis=(-2, -1))


def avg_plaquette(links: jax.Array) -> jax.Array:
    """Average plaquette ``<cos P>`` per sample (``lattice/lattice.py:285-298``)."""
    p = plaq_sums(links)
    return jnp.mean(jnp.cos(p), axis=(-2, -1))


def project_angle(x: jax.Array) -> jax.Array:
    """Project angles to ``[-pi, pi)`` (exact, non-differentiable at edges).

    Reference: ``gauge_model.py:78-80``.
    """
    return x - TWO_PI * jnp.floor((x + np.pi) / TWO_PI)


def project_angle_approx(x: jax.Array, n_terms: int = 5) -> jax.Array:
    """Differentiable Fourier-series surrogate of :func:`project_angle`.

    ``y = sum_{n=1}^{N-1} (-2/n) (-1)^n sin(n x)`` — reference
    ``gauge_model.py:94-108`` (note the reference's ``range(1, N)`` keeps
    ``N-1`` terms; we reproduce that).
    """
    # Static unroll: n_terms is tiny (default 5) and static, so this is a
    # fixed fused elementwise expression under jit.
    y = jnp.zeros_like(x)
    for n in range(1, n_terms):
        y = y + (-2.0 / n) * ((-1.0) ** n) * jnp.sin(n * x)
    return y


def topological_charge(links: jax.Array) -> jax.Array:
    """Exact (non-differentiable) topological charge per sample.

    ``Q = sum proj(P) / 2pi`` — reference ``gauge_model.py:703-717``.
    Returns float; near-integer by construction.
    """
    return jnp.sum(project_angle(plaq_sums(links)), axis=(-2, -1)) / TWO_PI


def topological_charge_approx(links: jax.Array, n_terms: int = 5) -> jax.Array:
    """Differentiable topological charge via the Fourier surrogate."""
    p = plaq_sums(links)
    return jnp.sum(project_angle_approx(p, n_terms), axis=(-2, -1)) / TWO_PI


def charge_diff(x1: jax.Array, x2: jax.Array, shape: LatticeShape) -> jax.Array:
    """|Q(x1) - Q(x2)| with exact projection (``gauge_model.py:719-726``)."""
    q1 = topological_charge(to_links(x1, shape))
    q2 = topological_charge(to_links(x2, shape))
    return jnp.abs(q1 - q2)


def charge_diff_approx(
    x1: jax.Array, x2: jax.Array, shape: LatticeShape, n_terms: int = 5
) -> jax.Array:
    """|Q(x1) - Q(x2)| with the differentiable surrogate (loss path)."""
    q1 = topological_charge_approx(to_links(x1, shape), n_terms)
    q2 = topological_charge_approx(to_links(x2, shape), n_terms)
    return jnp.abs(q1 - q2)


def u1_plaq_exact(beta) -> jax.Array:
    """Analytic infinite-volume average plaquette ``I1(beta)/I0(beta)``.

    The correctness oracle printed next to the measured plaquette in the
    reference (``lattice/lattice.py:31-33``).  Uses exponentially-scaled
    Bessel functions so large beta stays finite: ``I1(b)/I0(b) = i1e/i0e``.
    """
    beta = jnp.asarray(beta, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return jax.scipy.special.i1e(beta) / jax.scipy.special.i0e(beta)


def log_z_exact_factorized(shape: LatticeShape, beta) -> float:
    """Absolute ``log Z(beta) = n_links log 2pi + n_plaq log(I0(beta)e^-beta)``
    for the Lebesgue link measure on ``(-pi, pi]^{n_links}`` — the 2-D U(1)
    partition function factorizes over plaquettes up to the global-charge
    constraint (exact anchor for flow/AIS normalizer estimates; the ratio
    form lives in ``dynamics/smc.py u1_log_z_exact_factorized``)."""
    import numpy as np
    from scipy.special import i0e

    return float(shape.num_links * np.log(2.0 * np.pi)
                 + shape.num_plaquettes * np.log(i0e(beta)))


def make_potential_fn(shape: LatticeShape):
    """Return ``U(x) -> per-sample Wilson action`` on flat states.

    The L1->L3 interface contract of the reference
    (``lattice/lattice.py:274-283``): dynamics consume a pure energy
    function of the flat state.  Multiply by beta at the call site (the
    dynamics own beta, reference ``dynamics/gauge_dynamics.py:674-680``).
    """

    def potential(x: jax.Array) -> jax.Array:
        return wilson_action(to_links(x, shape))

    return potential


def random_links(key: jax.Array, n: int, shape: LatticeShape, method: str = "uniform") -> jax.Array:
    """Batch of ``n`` random flat link configurations in ``[-pi, pi)``.

    Mirrors the 'hot' initialization of ``lattice/lattice.py:152-157``.
    ``method='zeros'`` gives a cold start.
    """
    if method == "zeros":
        return jnp.zeros((n, shape.num_links), dtype=jnp.float32)
    return jax.random.uniform(
        key, (n, shape.num_links), minval=-np.pi, maxval=np.pi, dtype=jnp.float32
    )


def wrap(x: jax.Array) -> jax.Array:
    """Wrap angles into ``[-pi, pi)``.

    The reference re-wraps on the *host* every training step
    (``gauge_model.py:1180``: ``np.mod(samples, 2*pi)``); we keep the wrap
    inside the jitted step (device-side, fused) as SURVEY §7.2(4) directs.
    """
    return project_angle(x)


def wilson_loop_sums(links: jax.Array, r: int, t: int) -> jax.Array:
    """Angle around every ``t x r`` (time x space) Wilson loop.

    For U(1) in 2-D the loop angle telescopes exactly into the sum of the
    plaquette angles it encloses (abelian Stokes), so an ``(t, r)`` box-sum
    of :func:`plaq_sums` gives the rectangle operator the reference's
    legacy lattice computed link-by-link (``lattice/gauge_lattice.py:581-604``)
    — here vectorized over all sites and the whole batch.

    Input ``(..., Lt, Lx, 2)``; output ``(..., Lt, Lx)``.
    """
    p = plaq_sums(links)
    box = jnp.zeros_like(p)
    for i in range(t):
        for j in range(r):
            box = box + jnp.roll(p, shift=(-i, -j), axis=(-2, -1))
    return box


def wilson_loop(links: jax.Array, r: int, t: int) -> jax.Array:
    """Per-sample expectation ``<W(t x r)> = <cos(loop angle)>``."""
    return jnp.mean(jnp.cos(wilson_loop_sums(links, r, t)), axis=(-2, -1))


def wilson_loop_exact(beta, area: int) -> jax.Array:
    """Exact 2-D area law ``<W> = (I1/I0)^area`` (infinite volume).

    In 2-D the plaquette angles factorize, so a loop of area A averages to
    the single-plaquette expectation to the power A — the string-tension
    oracle extending :func:`u1_plaq_exact` (area 1) to all rectangles.
    """
    return u1_plaq_exact(beta) ** area


def creutz_ratio(w_rt, w_r1t1, w_r1t, w_rt1) -> jax.Array:
    """Creutz ratio ``chi = -log(W(R,T) W(R-1,T-1) / (W(R-1,T) W(R,T-1)))``.

    Estimates the string tension; exactly ``-log(I1/I0)`` per unit area in
    2-D U(1) — so it doubles as a correctness anchor at any (R, T).
    """
    return -jnp.log(w_rt * w_r1t1 / (w_r1t * w_rt1))


def topological_susceptibility_exact(
    beta: float, num_plaq: int, qmax: int | None = None,
    n_phi: int = 4097, n_k: int = 20001,
) -> float:
    """Exact finite-volume ``<Q^2>`` of 2-D U(1) Wilson theory by quadrature.

    On the torus the plaquette angles are iid under ``exp(beta cos phi)``
    subject to the single global constraint ``sum_p proj(phi_p) = 2 pi Q``
    (link contributions telescope to zero around the torus), so the charge
    distribution is the V-fold convolution of the one-plaquette density
    evaluated on ``2 pi Z``::

        P(Q) ∝ ∫ dk  [c(k)/c(0)]^V  cos(2 pi Q k),
        c(k) = ∫_{-pi}^{pi} dphi  e^{beta cos phi} cos(k phi).

    This turns BASELINE.json's "<Q^2> within MC error" north star into a
    test against an *analytic* anchor — the reference only ever eyeballed
    charge histograms (``gauge_model.py:1473-1533``).  Returns ``<Q^2>``;
    divide by ``num_plaq`` for the susceptibility density.
    """
    phi = np.linspace(-np.pi, np.pi, n_phi)
    w = np.exp(beta * (np.cos(phi) - 1.0))        # scaled: overflow-safe
    c0 = np.trapezoid(w, phi)
    sig2 = np.trapezoid(phi * phi * w, phi) / c0  # single-plaquette <phi^2>
    v = float(num_plaq)
    k_max = 10.0 / np.sqrt(sig2 * v) + 2.0
    k = np.linspace(0.0, k_max, n_k)
    chat = np.empty_like(k)
    for lo in range(0, n_k, 2048):                # chunked: O(MB) not O(GB)
        kk = k[lo:lo + 2048]
        chat[lo:lo + 2048] = np.trapezoid(
            w[None, :] * np.cos(np.outer(kk, phi)), phi, axis=1
        ) / c0
    pow_v = np.real((chat.astype(np.complex128)) ** num_plaq)
    if qmax is None:
        qmax = int(np.ceil(5.0 * np.sqrt(sig2 * v) / (2.0 * np.pi)) + 3)
    qs = np.arange(-qmax, qmax + 1)
    probs = np.array(
        [np.trapezoid(pow_v * np.cos(2.0 * np.pi * q * k), k) for q in qs]
    )
    probs = np.maximum(probs, 0.0)
    return float(np.sum(qs * qs * probs) / np.sum(probs))


# ---------------------------------------------------------------------------
# Rectangle-improved (Symanzik) action
# ---------------------------------------------------------------------------


def rect_sums(links: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Angle sums around the 2x1 (time-long) and 1x2 (space-long) rectangles.

    The reference carries rectangle-improved staple scaffolding
    (``lattice/gauge_generators.py:83-152``, truncated mid-function) and a
    link-by-link rectangle operator (``lattice/gauge_lattice.py:581-604``)
    but never a runnable improved action; this is the working vectorized
    form.  With the same orientation conventions as :func:`plaq_sums`::

        R_t(n) = u0(n) + u0(n+e0) + u1(n+2e0) - u0(n+e0+e1) - u0(n+e1) - u1(n)
        R_x(n) = u0(n) + u1(n+e0) + u1(n+e0+e1) - u0(n+2e1) - u1(n+e1) - u1(n)

    Input ``(..., Lt, Lx, 2)``; output two arrays ``(..., Lt, Lx)``.
    """
    u0 = links[..., 0]
    u1 = links[..., 1]
    r = lambda a, st, sx: jnp.roll(a, shift=(-st, -sx), axis=(-2, -1))
    rect_t = (
        u0 + r(u0, 1, 0) + r(u1, 2, 0) - r(u0, 1, 1) - r(u0, 0, 1) - u1
    )
    rect_x = (
        u0 + r(u1, 1, 0) + r(u1, 1, 1) - r(u0, 0, 2) - r(u1, 0, 1) - u1
    )
    return rect_t, rect_x


def improved_action(links: jax.Array, c1: float = -1.0 / 12.0) -> jax.Array:
    """Tree-level Symanzik-improved action per sample.

    ``S = c0 sum(1 - cos P) + c1 sum(1 - cos R)`` over both rectangle
    orientations, with the normalization ``c0 = 1 - 8 c1`` so the continuum
    limit keeps the Wilson coupling convention.  ``c1 = -1/12`` is the
    tree-level Luscher-Weisz coefficient; ``c1 = 0`` reduces exactly to
    :func:`wilson_action`.
    """
    c0 = 1.0 - 8.0 * c1
    s = c0 * jnp.sum(1.0 - jnp.cos(plaq_sums(links)), axis=(-2, -1))
    if c1 != 0.0:
        rect_t, rect_x = rect_sums(links)
        s = s + c1 * (
            jnp.sum(1.0 - jnp.cos(rect_t), axis=(-2, -1))
            + jnp.sum(1.0 - jnp.cos(rect_x), axis=(-2, -1))
        )
    return s


def make_improved_potential_fn(shape: LatticeShape, c1: float = -1.0 / 12.0):
    """``U(x) -> per-sample improved action`` on flat states.

    Same L1->L3 contract as :func:`make_potential_fn`; gradients via
    autodiff (the rolls/trig fuse into the scan body the same way the
    Wilson form does).
    """

    def potential(x: jax.Array) -> jax.Array:
        return improved_action(to_links(x, shape), c1)

    return potential


# ---------------------------------------------------------------------------
# Observables bundle (one fused pass for the metrics table)
# ---------------------------------------------------------------------------


def observables(x: jax.Array, shape: LatticeShape, beta=None):
    """Compute {action, avg_plaquette, topological charge} in one pass.

    Replaces the reference's separate observable ops
    (``gauge_model.py:256-266``) with a single fused computation: one
    plaq-sum evaluation feeds all three reductions.
    """
    links = to_links(x, shape)
    p = plaq_sums(links)
    cos_p = jnp.cos(p)
    out = {
        "actions": jnp.sum(1.0 - cos_p, axis=(-2, -1)),
        "plaqs": jnp.mean(cos_p, axis=(-2, -1)),
        "charges": jnp.round(
            jnp.sum(project_angle(p), axis=(-2, -1)) / TWO_PI
        ),
    }
    if beta is not None:
        out["plaqs_exact"] = u1_plaq_exact(beta)
    return out
