"""Topological-charge ensemble moves for 2-D U(1): instanton hops.

The fork exists for topological mixing (reference charge loss +
``charge_diff_op``, ``gauge_model.py:783-795,849-851``), but every kernel
in the single-kernel L2HMC family is limited the same way: every kernel in that family moves Q *diffusively*
— an accepted trajectory changes Q by ~1 only when the whole field
happens to slide over the instanton barrier, at a rate that collapses
with beta and volume (topological freezing).

This module adds the move family that changes the game: an **exact
global winding proposal**.  On the 2-D U(1) torus there is a classical
constant-field-strength configuration ``w`` with winding number 1 —
every plaquette angle exactly ``delta = 2 pi / V`` (the corner plaquette
``delta - 2 pi``, same value mod 2 pi).  Proposing ``x' = x + nu w``
with a sign-symmetric random ``nu``:

- changes Q by exactly ``nu`` (generic configurations),
- is volume-preserving and symmetric (Jacobian 1, q(x'|x) = q(x|x')),
  so plain Metropolis ``min(1, e^{-beta dS})`` is exact,
- costs ONE plaquette-field evaluation — no gradients, no integrator:
  because the shift is uniform mod 2 pi, the action difference has the
  closed form ``dS = (1 - cos d) sum cos P + sin d sum sin P``,
- gets CHEAPER with volume: ``delta ~ 1/V`` so ``dS ~ N(O(beta/V) V,
  O(beta/V) sqrt(V)) -> 0`` — acceptance *rises* toward 1 as the
  lattice grows, exactly where diffusive tunneling freezes out.

Interleaving one hop per local transition (HMC or the trained champion
kernel) turns the topological channel from a diffusive random walk into
near-free +-1 jumps.  This is the abelian ancestor of the "winding
transformation" / instanton-update line of work (Albandea et al.,
arXiv:2106.14234; the flow-based Q-jump idea of dynamics/flow.py is its
learned generalization) — here it is exact and closed-form.

Nothing in this module approximates: the MH test uses the exact Wilson
action difference, and a composite (local + hop) chain remains exactly
p-stationary (tested against the plaquette and <Q^2> oracles).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from l2hmc.lattice import u1

TWO_PI = 2.0 * np.pi


def winding_field(shape: u1.LatticeShape, nu: int = 1) -> jax.Array:
    """Flat link field ``w`` of winding number ``nu`` with uniform field
    strength: every plaquette angle is ``2 pi nu / V`` (the (Lt-1, Lx-1)
    corner reads ``2 pi nu / V - 2 pi nu``, identical mod 2 pi).

    Construction (orientation of :func:`l2hmc.lattice.u1.plaq_sums`:
    ``P = u0 - u1 - u0(x+1) + u1(t+1)``):

    - ``w1(t, x) = delta * t``                     (time-gradient in u1)
    - ``w0(Lt-1, x) = -delta * Lt * x``            (seam row of u0)

    with ``delta = 2 pi nu / (Lt Lx)``.  Adding ``w`` to any ``x`` shifts
    every plaquette by ``delta`` mod 2 pi and hence Q by ``nu``.
    """
    lt, lx = shape.time_size, shape.space_size
    delta = TWO_PI * nu / (lt * lx)
    w = np.zeros((lt, lx, 2), dtype=np.float32)
    w[:, :, 1] = delta * np.arange(lt, dtype=np.float32)[:, None]
    w[lt - 1, :, 0] = -delta * lt * np.arange(lx, dtype=np.float32)
    return jnp.asarray(w.reshape(-1))


def hop_delta_s(x: jax.Array, shape: u1.LatticeShape, nu: jax.Array) -> jax.Array:
    """Exact Wilson action difference ``S(x + nu w) - S(x)`` per sample.

    Uses the uniform-shift identity (every plaquette moves by
    ``d = 2 pi nu / V`` mod 2 pi)::

        dS = (1 - cos d) sum_p cos P_p  +  sin d  sum_p sin P_p

    One plaquette-field pass serves any per-chain ``nu`` — no second
    action evaluation.  ``x`` is flat ``(..., num_links)``; ``nu``
    broadcasts against the batch.
    """
    p = u1.plaq_sums(u1.to_links(x, shape))
    sum_cos = jnp.sum(jnp.cos(p), axis=(-2, -1))
    sum_sin = jnp.sum(jnp.sin(p), axis=(-2, -1))
    d = TWO_PI * nu.astype(x.dtype) / shape.num_plaquettes
    return (1.0 - jnp.cos(d)) * sum_cos + jnp.sin(d) * sum_sin


class HopOut(NamedTuple):
    x_out: jax.Array       # (batch, num_links), wrapped
    accept_prob: jax.Array  # (batch,) MH probability min(1, e^{-beta dS})
    accept_mask: jax.Array  # (batch,) 0/1
    nu: jax.Array          # (batch,) signed winding actually applied (0 if rejected)


def instanton_hop(
    x: jax.Array,
    beta,
    key: jax.Array,
    shape: u1.LatticeShape,
    nu_max: int = 1,
) -> HopOut:
    """One Metropolis winding hop for a batch of chains.

    Proposes ``x' = x + nu w`` with ``nu`` uniform over the sign-symmetric
    set ``{-nu_max, ..., -1, +1, ..., +nu_max}`` and accepts with the
    exact ``min(1, e^{-beta dS})``.  Cost: one plaquette-field pass plus
    an elementwise link add — roughly ``1/(2K)`` of a K-step leapfrog
    transition, with no gradient.
    """
    k_nu, k_acc = jax.random.split(key)
    mag = jax.random.randint(k_nu, x.shape[:-1], 1, nu_max + 1)
    sign = jax.random.rademacher(jax.random.fold_in(k_nu, 1), x.shape[:-1])
    nu = (mag * sign).astype(x.dtype)

    ds = hop_delta_s(x, shape, nu)
    prob = jnp.exp(jnp.minimum(-beta * ds, 0.0))
    prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
    accept = (jax.random.uniform(k_acc, prob.shape) < prob).astype(x.dtype)

    w1 = winding_field(shape, 1)
    x_prop = u1.wrap(x + nu[..., None] * w1[None, :])
    x_out = accept[..., None] * x_prop + (1.0 - accept[..., None]) * x
    return HopOut(x_out=x_out, accept_prob=prob, accept_mask=accept,
                  nu=nu * accept)


# ---------------------------------------------------------------------------
# Composite eval chain: local transitions (HMC / trained L2HMC) + hops
# ---------------------------------------------------------------------------


def make_hop_eval_chunk(cfg, chunk_size: int, n_hops: int = 1,
                        nu_max: int = 1):
    """Sampling chunk interleaving the configured dynamics kernel with
    ``n_hops`` instanton hops per step.

    Drop-in twin of ``train.gauge.make_eval_chunk`` (same metrics keys so
    the campaign harnesses and ``trace_stats`` reuse directly), plus
    ``hop_accept`` (mean hop MH probability) and ``hop_dq`` (mean |nu|
    accepted per step).  The composite kernel is exactly p-stationary:
    both component moves satisfy detailed balance for the same target.
    """
    from l2hmc.train.gauge import build_dynamics

    _, dyn, _ = build_dynamics(cfg)
    shape = cfg.shape

    @jax.jit
    def chunk(params, x, beta, key):
        def body(x, k):
            k_t, k_h = jax.random.split(k)
            out = dyn["transition"](params, x, beta, k_t)
            x_new = u1.wrap(out.x_out)

            def hop_body(x, kh):
                h = instanton_hop(x, beta, kh, shape, nu_max)
                return h.x_out, (h.accept_prob, jnp.abs(h.nu))

            x_new, (hp, hdq) = jax.lax.scan(
                hop_body, x_new, jax.random.split(k_h, n_hops))
            obs = u1.observables(x_new, shape)
            step_metrics = {
                "accept_prob": out.accept_prob,
                "actions": obs["actions"],
                "plaqs": obs["plaqs"],
                "charges": obs["charges"],
                "wloop22": u1.wilson_loop(u1.to_links(x_new, shape), 2, 2),
                "hop_accept": jnp.mean(hp, axis=0),
                "hop_dq": jnp.mean(hdq, axis=0),
            }
            return x_new, step_metrics

        keys = jax.random.split(key, chunk_size)
        return jax.lax.scan(body, x, keys)

    return chunk
