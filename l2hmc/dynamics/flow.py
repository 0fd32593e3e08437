"""Gauge-equivariant normalizing-flow sampler for 2-D U(1) lattice gauge theory.

Beyond the reference (which has no flow models): the plaquette-coupling
flow of Kanwar et al. (arXiv:2003.06413 / the MLMC line in PAPERS.md),
built from periodic convolutions for the conditioners and purely
elementwise circular diffeomorphisms for the transforms, forward-only
evaluation (sampling, reverse-KL training, independence-Metropolis and
importance reweighting never need the inverse), everything jit/scan-friendly
with static shapes.

Construction (exactly invertible, exactly gauge-equivariant):

- A coupling layer picks an "active" stripe of plaquettes
  ``x ≡ k (mod 4)`` (or ``t ≡ k (mod 4)``), transforms each active
  plaquette angle ``P -> h(P | ctx)`` with a mixture-of-NCP circle
  diffeomorphism, and realizes the change on ONE link of each active
  plaquette: ``U0(t,x) += h(P)-P`` (stripes in x, using the plaquette
  convention ``P(t,x) = U0(t,x) - U1(t,x) - U0(t,x+1) + U1(t+1,x)``,
  ``lattice/u1.py plaq_sums``), or ``U1(t,x) -= h(P)-P`` (stripes in t).
- The updated link also sits in the neighboring "side-effect" plaquette
  (stripe ``k-1``), which is neither active nor conditioning, so the
  Jacobian on link space is triangular with diagonal ``h'(P)`` on the
  updated links: ``logdet = sum_active log h'(P)``.
- The conditioner sees only gauge-invariant features ``(cos P, sin P)``
  of the context stripes ``k+1, k+2`` (masked to zero elsewhere), through
  a 2-layer periodic CNN whose last layer is zero-initialized — the flow
  starts exactly at the identity.
- NCP ("non-compact projection") kernel: ``phi -> 2 atan(e^s tan(phi/2))``
  evaluated in the atan2 form ``2 atan2(e^s sin(phi/2), cos(phi/2))``
  (stable at ±pi), fixing ±pi with derivative
  ``e^s / (cos^2(phi/2) + e^{2s} sin^2(phi/2))``.  A convex mixture of
  NCPs is again a circle diffeomorphism fixing ±pi; a learned per-site
  rotation follows (derivative 1).

The base density is uniform on links (the beta=0 theory), so the model
density ``q`` is gauge-invariant by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from l2hmc.lattice import u1
from l2hmc.networks.nets import _conv_init, _conv2d_periodic

_TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# Circle diffeomorphism: mixture of NCPs + rotation.
# ---------------------------------------------------------------------------


def ncp_mixture(phi: jax.Array, scales: jax.Array, logits: jax.Array,
                offset: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """``phi (...,)`` angles; ``scales/logits (..., n_mix)``; ``offset (...,)``.

    Returns ``(phi_out, log_deriv)`` with ``phi_out`` wrapped to (-pi, pi].
    """
    half = 0.5 * phi[..., None]
    s, c = jnp.sin(half), jnp.cos(half)
    es = jnp.exp(scales)
    ncp = 2.0 * jnp.arctan2(es * s, c)
    # derivative of each component: e^s / (cos^2 + e^{2s} sin^2)
    denom = c * c + es * es * s * s
    w = jax.nn.softmax(logits, axis=-1)
    out = jnp.sum(w * ncp, axis=-1)
    deriv = jnp.sum(w * es / denom, axis=-1)
    return u1.wrap(out + offset), jnp.log(deriv)


def ncp_mixture_inverse(phi_out: jax.Array, scales: jax.Array,
                        logits: jax.Array, offset: jax.Array,
                        iters: int = 40) -> Tuple[jax.Array, jax.Array]:
    """Invert :func:`ncp_mixture` by bisection + one Newton polish (the
    mixture is strictly increasing on (-pi, pi) with fixed endpoints; 40
    halvings reach f32 resolution).  Returns ``(phi_in,
    log_deriv_at_phi_in)``.

    The bisection runs under ``stop_gradient`` (its literal autodiff is
    zero — the iterates are piecewise constant in the parameters); the
    final Newton step ``phi -= (h(phi) - target) / h'(phi)`` is taken
    WITH autodiff, which both sharpens the root and realizes the exact
    implicit-function derivative ``d phi_in / d theta = -(dh/dtheta)/h'``
    — so ``logq_of`` is correctly differentiable and can train the flow
    by maximum likelihood on external (e.g. HMC) samples.
    """
    half_w = jax.nn.softmax(logits, axis=-1)
    es = jnp.exp(scales)

    def h_and_deriv(phi):
        half = 0.5 * phi[..., None]
        s, c = jnp.sin(half), jnp.cos(half)
        val = jnp.sum(half_w * 2.0 * jnp.arctan2(es * s, c), axis=-1)
        deriv = jnp.sum(half_w * es / (c * c + es * es * s * s), axis=-1)
        return val, deriv

    target = u1.wrap(phi_out - offset)

    def body(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        go_hi = h_and_deriv(mid)[0] < target
        return (jnp.where(go_hi, mid, lo), jnp.where(go_hi, hi, mid)), None

    lo = jnp.full_like(target, -np.pi)
    hi = jnp.full_like(target, np.pi)
    (lo, hi), _ = jax.lax.scan(
        body,
        (jax.lax.stop_gradient(lo), jax.lax.stop_gradient(hi)),
        None, length=iters)
    phi0 = jax.lax.stop_gradient(0.5 * (lo + hi))
    val, deriv = h_and_deriv(phi0)
    phi_in = phi0 - (val - target) / deriv
    _, deriv_in = h_and_deriv(phi_in)
    return phi_in, jnp.log(deriv_in)


# ---------------------------------------------------------------------------
# Coupling layers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    time_size: int = 8
    space_size: int = 8
    num_layers: int = 16          # multiple of 8: 4 offsets x 2 orientations
    n_mix: int = 6                # NCP mixture components
    hidden_channels: int = 32     # conditioner CNN width
    kernel_size: int = 3
    conditioner_depth: int = 1    # hidden conv layers in each conditioner

    def __post_init__(self):
        # The mod-4 stripe pattern relies on active / side-effect / context
        # stripes staying distinct around the periodic boundary; on sizes
        # not divisible by 4 the wraparound puts a side-effect plaquette in
        # the context and the Jacobian silently stops being triangular
        # (measured: 6x6 biases the plaquette by +0.07).
        if self.time_size % 4 or self.space_size % 4:
            raise ValueError(
                "FlowConfig requires lattice sides divisible by 4 "
                f"(got {self.time_size}x{self.space_size}): the mod-4 "
                "coupling stripes wrap inconsistently otherwise")

    @property
    def shape(self) -> u1.LatticeShape:
        return u1.LatticeShape(self.time_size, self.space_size)

    @property
    def layer_plan(self):
        """Layer i: (axis, offset) — axis 1 = stripes in x (update U0),
        axis 0 = stripes in t (update U1).  Offsets rotate 0..3."""
        plan = []
        for i in range(self.num_layers):
            axis = 1 if (i // 4) % 2 == 0 else 0
            plan.append((axis, i % 4))
        return tuple(plan)


def _stripe_masks(lt: int, lx: int, axis: int, offset: int):
    """(active, context) 0/1 masks of shape (Lt, Lx) for stripe period 4.

    The side-effect stripe (offset-1) and the active stripe are excluded
    from the context; stripes offset+1 and offset+2 condition.
    """
    idx = jnp.arange(lt)[:, None] if axis == 0 else jnp.arange(lx)[None, :]
    pos = jnp.broadcast_to(idx % 4, (lt, lx))
    active = (pos == offset).astype(jnp.float32)
    ctx = ((pos == (offset + 1) % 4) | (pos == (offset + 2) % 4)).astype(
        jnp.float32)
    return active, ctx


def init_flow(key: jax.Array, cfg: FlowConfig):
    """Per-layer conditioner params.  Output conv zero-init -> identity flow.

    Param names: ``c1`` first hidden conv, ``h2..hD`` extra hidden convs
    (``conditioner_depth > 1``), ``c2`` the zero-init output conv — so
    depth-1 checkpoints keep their historical {c1, c2} structure.
    """
    params = []
    out_ch = 2 * cfg.n_mix + 1
    k = cfg.kernel_size
    for _ in range(cfg.num_layers):
        layer = {}
        key, sub = jax.random.split(key)
        layer["c1"] = _conv_init(sub, k, k, 2, cfg.hidden_channels)
        for d in range(2, cfg.conditioner_depth + 1):
            key, sub = jax.random.split(key)
            layer[f"h{d}"] = _conv_init(sub, k, k, cfg.hidden_channels,
                                        cfg.hidden_channels)
        key, sub = jax.random.split(key)
        out = _conv_init(sub, k, k, cfg.hidden_channels, out_ch)
        layer["c2"] = {"w": jnp.zeros_like(out["w"]), "b": out["b"]}
        params.append(layer)
    return params


def _conditioner(layer_params, p: jax.Array, ctx: jax.Array,
                 cfg: FlowConfig):
    """Per-site transform parameters from gauge-invariant context features
    (identical in the forward and inverse directions: the layer never
    touches its own context stripes)."""
    feats = jnp.stack([jnp.cos(p), jnp.sin(p)], axis=-1) * ctx[..., None]
    h = jax.nn.gelu(_conv2d_periodic(layer_params["c1"], feats))
    for d in range(2, cfg.conditioner_depth + 1):
        h = jax.nn.gelu(_conv2d_periodic(layer_params[f"h{d}"], h))
    out = _conv2d_periodic(layer_params["c2"], h)  # (B, Lt, Lx, 2*n_mix+1)
    return (out[..., :cfg.n_mix], out[..., cfg.n_mix:2 * cfg.n_mix],
            out[..., -1])


def _coupling_forward(layer_params, links: jax.Array, axis: int,
                      offset: int, cfg: FlowConfig):
    """One coupling layer on ``links (B, Lt, Lx, 2)``.

    Returns ``(links_out, logdet (B,))``.
    """
    lt, lx = cfg.time_size, cfg.space_size
    active, ctx = _stripe_masks(lt, lx, axis, offset)

    p = u1.plaq_sums(links)                       # (B, Lt, Lx)
    scales, logits, t_off = _conditioner(layer_params, p, ctx, cfg)
    p_new, log_deriv = ncp_mixture(p, scales, logits, t_off)
    delta = (u1.wrap(p_new - p)) * active          # only active sites move
    logdet = jnp.sum(log_deriv * active, axis=(-2, -1))

    u0, u1_ = links[..., 0], links[..., 1]
    if axis == 1:       # stripes in x: realize on U0 (coefficient +1 in P)
        u0 = u0 + delta
    else:               # stripes in t: realize on U1 (coefficient -1 in P)
        u1_ = u1_ - delta
    links = jnp.stack([u1.wrap(u0), u1.wrap(u1_)], axis=-1)
    return links, logdet


def flow_forward(params, links: jax.Array, cfg: FlowConfig):
    """Push ``links (B, Lt, Lx, 2)`` through all layers.

    Returns ``(links_out, logdet (B,))`` — logdet of d(out)/d(in).
    """
    logdet = jnp.zeros(links.shape[0])
    for lp, (axis, offset) in zip(params, cfg.layer_plan):
        links, ld = _coupling_forward(lp, links, axis, offset, cfg)
        logdet = logdet + ld
    return links, logdet


def _coupling_inverse(layer_params, links: jax.Array, axis: int,
                      offset: int, cfg: FlowConfig):
    """Invert one coupling layer.  The conditioner sees only context
    stripes, which the layer does not touch, so its outputs are recomputed
    identically from the layer's OUTPUT; the active plaquette angles are
    inverted by bisection and the link shift subtracted.

    Returns ``(links_in, logdet_inv (B,))`` with
    ``logdet_inv = -sum_active log h'(P_in)``.
    """
    lt, lx = cfg.time_size, cfg.space_size
    active, ctx = _stripe_masks(lt, lx, axis, offset)

    p_out = u1.plaq_sums(links)
    scales, logits, t_off = _conditioner(layer_params, p_out, ctx, cfg)
    p_in, log_deriv = ncp_mixture_inverse(u1.wrap(p_out), scales, logits,
                                          t_off)
    delta = u1.wrap(u1.wrap(p_out) - p_in) * active
    logdet_inv = -jnp.sum(log_deriv * active, axis=(-2, -1))

    u0, u1_ = links[..., 0], links[..., 1]
    if axis == 1:
        u0 = u0 - delta
    else:
        u1_ = u1_ + delta
    links = jnp.stack([u1.wrap(u0), u1.wrap(u1_)], axis=-1)
    return links, logdet_inv


def flow_inverse(params, links: jax.Array, cfg: FlowConfig):
    """Pull ``links`` back through all layers (reversed order).

    Returns ``(z, logdet_inv (B,))``; ``flow_inverse(flow_forward(z)) == z``
    to bisection tolerance (tested)."""
    logdet_inv = jnp.zeros(links.shape[0])
    for lp, (axis, offset) in zip(reversed(params),
                                  reversed(cfg.layer_plan)):
        links, ld = _coupling_inverse(lp, links, axis, offset, cfg)
        logdet_inv = logdet_inv + ld
    return links, logdet_inv


def logq_of(params, links: jax.Array, cfg: FlowConfig) -> jax.Array:
    """Model log-density at ARBITRARY states (via the numerical inverse):
    ``log q(x) = log q0 + logdet_inv(x)``.  For flow-generated samples this
    matches the logq returned by :func:`sample_and_logq` (tested)."""
    _, logdet_inv = flow_inverse(params, links, cfg)
    return -cfg.shape.num_links * np.log(_TWO_PI) + logdet_inv


# ---------------------------------------------------------------------------
# Density, training, sampling.
# ---------------------------------------------------------------------------


def sample_and_logq(params, key: jax.Array, batch: int, cfg: FlowConfig):
    """Draw ``batch`` configurations and their model log-density.

    ``log q(x) = log q0(z) - logdet`` with uniform base
    ``log q0 = -num_links log 2pi``.
    """
    z = jax.random.uniform(key, (batch, cfg.time_size, cfg.space_size, 2),
                           minval=-np.pi, maxval=np.pi)
    x, logdet = flow_forward(params, z, cfg)
    logq0 = -cfg.shape.num_links * np.log(_TWO_PI)
    return x, logq0 - logdet


def reverse_kl_loss(params, key: jax.Array, batch: int, beta,
                    cfg: FlowConfig):
    """``E_q[log q + beta S]`` (reverse KL up to log Z) and diagnostics."""
    x, logq = sample_and_logq(params, key, batch, cfg)
    logp = -beta * u1.wilson_action(x)            # unnormalized
    loss = jnp.mean(logq - logp)
    logw = jax.lax.stop_gradient(logp - logq)
    ess = jnp.exp(2 * jax.scipy.special.logsumexp(logw)
                  - jax.scipy.special.logsumexp(2 * logw)) / batch
    return loss, {"loss": loss, "ess_frac": ess,
                  "plaq": jnp.mean(u1.avg_plaquette(x))}


def importance_weights(params, key: jax.Array, batch: int, beta,
                       cfg: FlowConfig):
    """Samples + self-normalized log-weights for reweighted observables,
    plus the direct partition-function estimate
    ``log Z = logmeanexp(-beta S - log q)`` (the flow's unique diagnostic:
    kernel MCMC has no normalizer access; SMC only gets ratios)."""
    x, logq = sample_and_logq(params, key, batch, cfg)
    logw = -beta * u1.wilson_action(x) - logq
    log_z = jax.scipy.special.logsumexp(logw) - jnp.log(batch)
    return x, logw - jax.scipy.special.logsumexp(logw), log_z


def forward_kl_loss(params, x_p: jax.Array, cfg: FlowConfig) -> jax.Array:
    """``-E_p[log q]`` — maximum likelihood on samples from the TARGET
    (e.g. an exact HMC chain), which minimizes KL(p||q): the
    mass-covering divergence that governs acceptance of flow proposals
    FROM p-typical states (the hybrid chain's bottleneck).
    Differentiable through the numerical inverse via the Newton-polish
    implicit gradient in :func:`ncp_mixture_inverse`."""
    return -jnp.mean(logq_of(params, x_p, cfg))


def independence_mh_chain(params, key: jax.Array, x0: jax.Array,
                          logq0: jax.Array, beta, num_steps: int,
                          cfg: FlowConfig):
    """Flow-proposal independence Metropolis (Albergo et al. 1904.12072).

    ``x0 (B, Lt, Lx, 2)`` with its model log-density ``logq0 (B,)`` (e.g.
    from :func:`sample_and_logq`).  Accept ``x'`` with
    ``min(1, [p(x') q(x)] / [p(x) q(x')])``; only forward evaluations.

    Returns ``(x_final, plaq_trace (T, B), accept_trace (T, B))``.
    """

    def body(carry, k):
        x, logq, logp = carry
        kp, ka = jax.random.split(k)
        xp, logqp = sample_and_logq(params, kp, x.shape[0], cfg)
        logpp = -beta * u1.wilson_action(xp)
        log_acc = (logpp - logp) + (logq - logqp)
        acc = (jnp.log(jax.random.uniform(ka, log_acc.shape)) < log_acc)
        accf = acc.astype(x.dtype)
        x = jnp.where(acc[:, None, None, None], xp, x)
        logq = jnp.where(acc, logqp, logq)
        logp = jnp.where(acc, logpp, logp)
        return (x, logq, logp), (u1.avg_plaquette(x), accf)

    logp0 = -beta * u1.wilson_action(x0)
    keys = jax.random.split(key, num_steps)
    (x, _, _), (plaqs, accs) = jax.lax.scan(body, (x0, logq0, logp0), keys)
    return x, plaqs, accs


def flow_hmc_hybrid_chain(params, key: jax.Array, links0: jax.Array, beta,
                          num_rounds: int, hmc_per_round: int, hmc_eps,
                          hmc_leapfrog: int, cfg: FlowConfig):
    """Hybrid kernel: each round runs ``hmc_per_round`` HMC transitions
    (local moves, fast plaquette decorrelation) then ONE flow independence
    proposal (global move — in particular a fresh topological sector).

    The flow accept from an HMC-evolved state requires ``q`` at that state,
    which is where :func:`flow_inverse` earns its keep — both the current
    state's and the proposal's densities are exact, so the composite chain
    is exactly p-stationary (each component kernel is).

    Returns ``(links, q_trace (R, B), plaq_trace (R, B),
    flow_accept (R, B), hmc_accept (R,))``.
    """
    from l2hmc.dynamics.hmc import hmc_transition

    b, lt, lx, _ = links0.shape
    shape = u1.LatticeShape(lt, lx)
    pot = u1.make_potential_fn(shape)

    def one_round(links, k):
        kh, kp, ka = jax.random.split(k, 3)

        def hmc_body(x, kk):
            out = hmc_transition(pot, x, beta, kk, hmc_eps, hmc_leapfrog)
            return u1.wrap(out.x_out), out.accept_prob

        x, h_probs = jax.lax.scan(
            lambda x, kk: hmc_body(x, kk), links.reshape(b, -1),
            jax.random.split(kh, hmc_per_round))
        links = x.reshape(b, lt, lx, 2)

        xp, logqp = sample_and_logq(params, kp, b, cfg)
        logq = logq_of(params, links, cfg)
        log_acc = (-beta * u1.wilson_action(xp) + beta * u1.wilson_action(links)
                   + logq - logqp)
        acc = jnp.log(jax.random.uniform(ka, (b,))) < log_acc
        links = jnp.where(acc[:, None, None, None], xp, links)
        return links, (u1.topological_charge(links),
                       u1.avg_plaquette(links),
                       acc.astype(jnp.float32), jnp.mean(h_probs))

    keys = jax.random.split(key, num_rounds)
    links, (qs, plaqs, f_acc, h_acc) = jax.lax.scan(one_round, links0, keys)
    return links, qs, plaqs, f_acc, h_acc
