"""Parallel tempering (replica exchange) over a beta ladder.

Replica exchange is an ensemble mechanism against topological freezing:
chains at low beta tunnel freely, and neighbor swaps carry their
decorrelated topology up the ladder to the target coupling.  The reference has no ensemble machinery at all (its
beta "annealing" is an in-chain schedule, ``gauge_model.py:1039-1046``);
SMC (``dynamics/smc.py``) is this repo's sequential ensemble — this
module adds the stationary one.

Layout: the ladder is STACKED into the batch axis.  A state is
``(R, C, d)`` — R rungs x C chains — and every rung's local transition
runs as ONE flat ``(R*C, d)`` HMC kernel with per-sample ``beta`` and
``eps`` vectors (broadcasting does the rest; no vmap, no per-rung
dispatch).  Swaps are elementwise selects between adjacent rung slices —
a pure data movement XLA fuses into the step.  Total device cost of a
PT round ~= one HMC round at R x C chains, which is exactly the
"all rungs' wall-clock counted" accounting the campaign uses.

Exactness: each rung's HMC transition is p_beta_i-stationary, and the
swap move satisfies detailed balance for the product measure
``prod_i e^{-beta_i U(x_i)}`` with acceptance
``min(1, exp((beta_i - beta_j)(U_i - U_j)))`` — standard replica
exchange (Swendsen-Wang 1986 / Geyer 1991), tested here against the
per-rung plaquette oracles and the exact <Q^2>.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PotentialFn = Callable[[jax.Array], jax.Array]


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Static ladder description (hashable: closes over jit).

    ``betas`` descending, ``betas[0]`` = the target coupling whose rung
    is measured; ``eps`` per-rung leapfrog step (coarser at lower beta —
    the acceptance cliff relaxes as the action flattens).
    """

    betas: Tuple[float, ...]
    eps: Tuple[float, ...]
    num_steps: int = 5

    def __post_init__(self):
        if len(self.betas) != len(self.eps):
            raise ValueError("betas and eps must have equal length")
        if list(self.betas) != sorted(self.betas, reverse=True):
            raise ValueError("betas must be descending (target first)")

    @property
    def num_rungs(self) -> int:
        return len(self.betas)


class PTOut(NamedTuple):
    x: jax.Array            # (R, C, d)
    accept_prob: jax.Array  # (R, C) local HMC acceptance
    swap_mask: jax.Array    # (R-1, C) 1 where pair (i, i+1) swapped
    swap_prob: jax.Array    # (R-1, C) swap MH probability (0 for off-parity pairs)


def pt_transition(
    potential_fn: PotentialFn,
    x: jax.Array,
    cfg: PTConfig,
    key: jax.Array,
    parity: jax.Array,
) -> PTOut:
    """One PT round: per-rung HMC + one alternating-parity swap phase.

    ``parity`` is 0/1 (alternate it per round: even pairs (0,1),(2,3)...
    then odd pairs (1,2),(3,4)...), traced so rounds share one compile.
    """
    from l2hmc.dynamics.hmc import hmc_transition

    r, c, d = x.shape
    betas = jnp.asarray(cfg.betas, x.dtype)
    eps = jnp.asarray(cfg.eps, x.dtype)
    k_hmc, k_swap = jax.random.split(key)

    # --- local phase: ONE flat kernel over all rungs -------------------
    beta_flat = jnp.repeat(betas, c)                 # (R*C,)
    eps_flat = jnp.repeat(eps, c)[:, None]           # (R*C, 1)
    out = hmc_transition(potential_fn, x.reshape(r * c, d), beta_flat,
                         k_hmc, eps_flat, cfg.num_steps)
    x = out.x_out.reshape(r, c, d)
    accept = out.accept_prob.reshape(r, c)

    # --- swap phase: adjacent-rung exchange at the given parity --------
    u = potential_fn(x.reshape(r * c, d)).reshape(r, c)
    d_beta = betas[:-1] - betas[1:]                  # (R-1,)
    d_u = u[:-1] - u[1:]                             # (R-1, C)
    # pair i is active when i % 2 == parity
    active = (jnp.arange(r - 1) % 2 == parity)[:, None]
    log_alpha = d_beta[:, None] * d_u
    prob = jnp.where(active, jnp.exp(jnp.minimum(log_alpha, 0.0)), 0.0)
    swap = (jax.random.uniform(k_swap, prob.shape) < prob).astype(x.dtype)

    # apply swaps pairwise; same-parity pairs are disjoint so a single
    # gather-free select pass per neighbor suffices
    take_upper = jnp.pad(swap, ((0, 1), (0, 0)))     # rung i takes i+1
    take_lower = jnp.pad(swap, ((1, 0), (0, 0)))     # rung i takes i-1
    x_up = jnp.concatenate([x[1:], x[-1:]], axis=0)
    x_dn = jnp.concatenate([x[:1], x[:-1]], axis=0)
    x = (take_upper[..., None] * x_up
         + take_lower[..., None] * x_dn
         + (1.0 - take_upper - take_lower)[..., None] * x)
    return PTOut(x=x, accept_prob=accept, swap_mask=swap, swap_prob=prob)


def make_pt_chunk(
    potential_fn: PotentialFn,
    cfg: PTConfig,
    chunk_size: int,
    wrap_fn=None,
    observables_fn=None,
):
    """Jitted scan of ``chunk_size`` PT rounds.

    Returns ``chunk(x, key, round0) -> (x, metrics)`` where metrics holds
    per-round rung-0 observables (via ``observables_fn(x_rung0)`` -> dict)
    plus local/swap acceptance summaries.  ``round0`` threads the global
    round counter so the swap parity keeps alternating across chunks.
    """

    @jax.jit
    def chunk(x, key, round0):
        def body(carry, inp):
            x, rnd = carry
            k = inp
            out = pt_transition(potential_fn, x, cfg, k, rnd % 2)
            x = out.x if wrap_fn is None else wrap_fn(out.x)
            m = {
                "accept_prob": jnp.mean(out.accept_prob, axis=1),  # (R,)
                "swap_rate": jnp.sum(out.swap_mask, axis=1)
                / jnp.maximum(jnp.sum(out.swap_prob > 0, axis=1), 1),
            }
            if observables_fn is not None:
                m.update(observables_fn(x[0]))
            return (x, rnd + 1), m

        (x, _), metrics = jax.lax.scan(
            body, (x, round0), jax.random.split(key, chunk_size))
        return x, metrics

    return chunk
