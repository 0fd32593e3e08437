"""L2HMC augmented-leapfrog transition kernel.

Rebuild of the algorithmic core (L3 of SURVEY §1): the neural-augmented
leapfrog integrator with exact log-Jacobian accumulation and the
Metropolis-Hastings accept step, covering both reference engines —
``dynamics/gauge_dynamics.py:42-709`` (gauge path) and
``utils/dynamics.py:34-319`` (MoG/VAE path: ``eps = exp(alpha)``
parametrization, temperature scaling, aux conditioning, HMC degeneration).

Semantics (exact parity with the reference update equations):

forward momentum half-step  (``gauge_dynamics.py:486-508``)::

    g            = d/dx [ beta * U(x) ]
    s, t, q      = VNet(x, g, tau)
    v'           = v * exp(eps/2 * s) - eps/2 * (exp(eps*q) * g - t)
    logdet      += eps/2 * sum(s)

forward position step, hold-mask m (``gauge_dynamics.py:511-534``)::

    s, t, q      = XNet(v, m*x, tau)
    x'           = m*x + (1-m) * (x*exp(eps*s) + eps*(exp(eps*q)*v + t))
    logdet      += eps * sum((1-m)*s)

backward sub-steps are the exact inverses (``gauge_dynamics.py:539-596``);
one leapfrog step is V-X(m)-X(1-m)-V forward and V-X(1-m)-X(m)-V backward,
with the step index (masks + sinusoidal time) reversed.

Design decisions (this is NOT a port):

1. **Fused per-chain direction.** The reference integrates every chain both
   forward *and* backward and masks one result away
   (``gauge_dynamics.py:195-259``) — 2x wasted FLOPs and 2x backprop.  Here
   the expensive work per sub-step (potential gradient + network call) is
   *direction-independent*: forward and backward sub-updates consume the same
   net outputs and differ only in cheap elementwise combines.  So a single
   integration computes both variants elementwise and `where`-selects by the
   per-chain direction — exact reference proposal distribution at half cost.
   ``both_directions=True`` in :class:`DynamicsConfig` restores the literal
   reference dataflow for differential testing.
2. **`lax.scan` hot loop** over leapfrog steps (vs ``tf.while_loop``),
   rematerialized with ``jax.checkpoint`` so training through K steps of
   second-order gradients stays memory-bounded.
3. **Explicit PRNG**: every transition consumes a key; momentum, direction,
   and accept randomness are independent splits.  Masks are drawn once at
   build time from a dedicated key (reference draws them with stateful numpy
   at graph-construction, ``gauge_dynamics.py:651-661``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Any
PotentialFn = Callable[[jax.Array], jax.Array]  # x (batch, d) -> (batch,)
NetApply = Callable[[Params, jax.Array, jax.Array, jax.Array],
                    Tuple[jax.Array, jax.Array, jax.Array]]


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Static configuration of the augmented leapfrog kernel."""

    x_dim: int
    num_steps: int = 5                # leapfrog steps per trajectory
    eps_trainable: bool = True
    hmc: bool = False                 # zero the nets -> plain HMC
    use_log_eps: bool = False         # eps = exp(alpha) (utils/dynamics.py:51-60)
    both_directions: bool = False     # literal reference dataflow (debug)
    remat: bool = True                # jax.checkpoint the step body
    # State-space group.  'r1': flat R^n (reference semantics — MoG/VAE, and
    # the gauge fork's literal behavior where angles are re-wrapped mod 2pi
    # OUTSIDE the kernel, gauge_model.py:1180).  'u1': compact U(1)^n torus —
    # networks see periodic (cos, sin) features and the position scaling is
    # the circle diffeomorphism x' = 2 atan(exp(s) tan(x/2)) with exact
    # log-Jacobian, so the kernel commutes with 2pi shifts and the folded
    # chain satisfies detailed balance EXACTLY.  The reference's flat kernel
    # + host-side wrap does NOT (non-periodic nets make folding
    # irreversible); we measured the resulting plaquette bias at ~0.027 on
    # 8x8 beta=4 (0.8365 vs exact 0.8633).
    group: str = "r1"
    # Upper bound on the trainable step size (0 = unbounded, reference
    # semantics).  The ESJD objective rewards larger eps right up to the
    # acceptance cliff; with Adam momentum the parameter can coast past it,
    # acceptance hits exactly 0, gradients vanish, and training dies (seen
    # reproducibly at 32x32).  A cap at the known-stable scale removes the
    # runaway without affecting eps decreases.
    eps_cap: float = 0.0
    # Merge the adjacent momentum half-steps of consecutive leapfrog steps
    # (the end-of-step-i and start-of-step-(i+1) V updates act on the same x
    # with the same cached gradient, differing only in the time encoding)
    # into ONE full-step update at the boundary time i+1/2: VNet calls drop
    # from 2K to K+1 per trajectory.  Still an exact invertible kernel with
    # exact log-Jacobian and MH accept; in HMC mode (zero nets) it is
    # *identical* to the unmerged integrator (two half-kicks with the same
    # gradient compose to one full kick).  As a learned kernel it is a
    # different — equally expressive — parametrization family, so it is
    # opt-in; default False keeps reference-kernel parity.
    merge_v_halves: bool = False


class DynamicsParams(NamedTuple):
    """Trainable + fixed state of the dynamics (a pytree)."""

    xnet: Params            # position-update network ("XNet")
    vnet: Params            # momentum-update network ("VNet")
    raw_eps: jax.Array      # eps, or alpha = log(eps) if use_log_eps
    masks: jax.Array        # (num_steps, x_dim) binary hold-masks


class Transition(NamedTuple):
    """Outputs of one MH transition (reference ``apply_transition`` returns
    ``(x_proposed, v_proposed, accept_prob, x_out)``)."""

    x_proposed: jax.Array
    v_proposed: jax.Array
    accept_prob: jax.Array
    x_out: jax.Array
    sumlogdet: jax.Array
    accept_mask: jax.Array
    forward_frac: jax.Array


def make_masks(key: jax.Array, num_steps: int, x_dim: int) -> jax.Array:
    """Per-step binary masks with exactly ``x_dim // 2`` ones.

    Reference: fresh random permutation per step
    (``gauge_dynamics.py:651-661``).
    """
    def one(k):
        perm = jax.random.permutation(k, x_dim)
        return (perm < (x_dim // 2)).astype(jnp.float32)

    return jax.vmap(one)(jax.random.split(key, num_steps))


def time_encoding(step_idx: jax.Array, num_steps: int) -> jax.Array:
    """Sinusoidal leapfrog-time encoding ``[cos(2 pi i/K), sin(2 pi i/K)]``.

    Reference ``gauge_dynamics.py:611-633``.  ``step_idx`` may be per-chain
    ``(batch,)`` (directions differ) -> returns ``(batch, 2)``.
    """
    ang = 2.0 * np.pi * step_idx.astype(jnp.float32) / num_steps
    return jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)


def init_dynamics_params(
    key: jax.Array,
    cfg: DynamicsConfig,
    xnet_init: Callable[[jax.Array], Params],
    vnet_init: Callable[[jax.Array], Params],
    eps_init: float = 0.25,
) -> DynamicsParams:
    kx, kv, km = jax.random.split(key, 3)
    raw = np.log(eps_init) if cfg.use_log_eps else eps_init
    return DynamicsParams(
        xnet=xnet_init(kx),
        vnet=vnet_init(kv),
        raw_eps=jnp.asarray(raw, jnp.float32),
        masks=make_masks(km, cfg.num_steps, cfg.x_dim),
    )


def get_eps(params: DynamicsParams, cfg: DynamicsConfig) -> jax.Array:
    eps = jnp.exp(params.raw_eps) if cfg.use_log_eps else params.raw_eps
    if cfg.eps_cap > 0:
        eps = jnp.minimum(eps, cfg.eps_cap)
    return eps


def make_dynamics(
    cfg: DynamicsConfig,
    potential_fn: PotentialFn,
    xnet_apply: NetApply,
    vnet_apply: NetApply,
):
    """Build the pure transition functions for a given target + networks.

    Returns a dict of pure functions:
      ``transition(params, x, beta, key) -> Transition``
      ``integrate(params, x, v, beta, direction) -> (x', v', sumlogdet)``
      ``hamiltonian(x, v, beta) -> (batch,)``
    ``beta`` doubles as inverse temperature: the MoG path's ``T`` scaling
    (``utils/dynamics.py:227-236``) is ``beta = 1/T``.
    """

    if cfg.hmc:
        def zero_net(params, v, x, t, aux=None):
            # output dim is always x_dim (inputs may be periodic features
            # of doubled width in the 'u1' group)
            z = jnp.zeros((v.shape[0], cfg.x_dim), v.dtype)
            return z, z, z
        xnet_apply_, vnet_apply_ = zero_net, zero_net
    else:
        xnet_apply_, vnet_apply_ = xnet_apply, vnet_apply

    def potential_energy(x, beta):
        return beta * potential_fn(x)

    def kinetic_energy(v):
        return 0.5 * jnp.sum(jnp.square(v), axis=-1)

    def hamiltonian(x, v, beta):
        return potential_energy(x, beta) + kinetic_energy(v)

    grad_potential = jax.grad(lambda x, beta: jnp.sum(potential_energy(x, beta)))

    periodic = cfg.group == "u1"

    def pos_features(x, mask=None):
        """Network view of the position: raw for 'r1', (cos, sin) for 'u1'
        (2pi-invariant, so the kernel commutes with wrapping)."""
        if not periodic:
            return x if mask is None else mask * x
        feats = jnp.concatenate([jnp.cos(x), jnp.sin(x)], axis=-1)
        if mask is not None:
            feats = jnp.concatenate([mask, mask], axis=-1) * feats
        return feats

    def update_v(params, x, v, g, beta, tau, d_col, d_row, eps, aux,
                 factor=0.5):
        """Direction-fused momentum kick (``factor`` x eps; 0.5 = half-step).

        ``d_col (batch,1)`` / ``d_row (batch,)`` in {+1,-1}.  Shares the
        gradient + VNet evaluation across directions; elementwise combines
        are where-selected.  ``g = grad_potential(x, beta)`` is passed in:
        the caller caches it across leapfrog steps (the last half-step of
        step i and the first of step i+1 evaluate it at the same x), which
        cuts potential-gradient evaluations from 2K+... to K+1 per
        trajectory.  ``factor=1.0`` is the merged full-step boundary kick
        (``merge_v_halves``); the ``exp(eps*q)`` gradient-scaling keeps the
        full eps in either case, as the reference's half-step does
        (``gauge_dynamics.py:497-508``).
        """
        s, t, q = vnet_apply_(params.vnet, pos_features(x), g, tau, aux)
        h_s = factor * eps * s
        a = factor * eps * (jnp.exp(eps * q) * g - t)
        # one signed exp instead of separate exp(+h)/exp(-h) branches:
        # fwd (d=+1): v*exp(h) - a;  bwd (d=-1): (v+a)*exp(-h)
        e = jnp.exp(d_col * h_s)
        v_new = jnp.where(d_col > 0, v * e - a, (v + a) * e)
        logdet = d_row * jnp.sum(h_s, axis=-1)
        return v_new, logdet

    def circle_scale(x, a):
        """Equivariant scaling on the circle: ``2 atan(exp(a) tan(x/2))``.

        A diffeomorphism of (-pi, pi] fixing {0, pi} with exact
        log-Jacobian ``a - log(cos^2(x/2) + exp(2a) sin^2(x/2))``; the
        torus-valid replacement for the flat ``x * exp(a)`` scaling.
        """
        s2, c2 = jnp.sin(0.5 * x), jnp.cos(0.5 * x)
        ea = jnp.exp(a)
        y = 2.0 * jnp.arctan2(ea * s2, c2)
        logdet = a - jnp.log(c2 * c2 + ea * ea * s2 * s2)
        return y, logdet

    def _wrap(x):
        return x - 2.0 * np.pi * jnp.floor((x + np.pi) / (2.0 * np.pi))

    def update_x(params, x, v, tau, hold_mask, d_col, d_row, eps, aux):
        """Direction-fused position step; ``hold_mask`` part stays fixed.

        'r1': reference update ``x*exp(eps*s) + eps*(exp(eps*q)*v + t)``
        (``gauge_dynamics.py:511-534``).  'u1': circle-scaling + translation
        with wrap, exactly invertible on the torus.
        """
        s, t, q = xnet_apply_(
            params.xnet, v, pos_features(x, hold_mask), tau, aux
        )
        es = eps * s
        b = eps * (jnp.exp(eps * q) * v + t)
        if not periodic:
            # one signed exp: fwd (d=+1) x*exp(es)+b; bwd (d=-1) (x-b)*exp(-es)
            e = jnp.exp(d_col * es)
            upd = jnp.where(d_col > 0, x * e + b, (x - b) * e)
            ld_elem = es
        else:
            # forward: x -> wrap(circle_scale(x, es) + b)
            # backward (inverse): x -> circle_scale(wrap(x - b), -es)
            # Select the *input* and run ONE signed circle_scale — halves the
            # sin/cos/exp/atan2/log work vs computing both branches.
            u = jnp.where(d_col > 0, x, _wrap(x - b))
            y, ld = circle_scale(u, d_col * es)
            upd = jnp.where(d_col > 0, _wrap(y + b), y)
            ld_elem = ld  # signed per-direction Jacobian by construction
        x_new = hold_mask * x + (1.0 - hold_mask) * upd
        if not periodic:
            logdet = d_row * jnp.sum((1.0 - hold_mask) * ld_elem, axis=-1)
        else:
            # ld_elem is already the signed per-direction Jacobian
            logdet = jnp.sum((1.0 - hold_mask) * ld_elem, axis=-1)
        return x_new, logdet

    def _step_context(params, step, d_row):
        """Per-step mask/time indexing shared by the split and merged
        integrators: each chain reads masks/time at ``i = step`` (forward)
        or ``i = K-1-step`` (backward) — reference
        ``gauge_dynamics.py:412-483``.  Returns
        ``(d_col, tau, hold1, hold2)`` where forward within-step X order is
        hold=m then hold=1-m and backward the reverse."""
        d_col = d_row[:, None]
        idx = jnp.where(d_row > 0, step, cfg.num_steps - 1 - step).astype(jnp.int32)
        tau = time_encoding(idx, cfg.num_steps)
        mask = params.masks[idx]            # (batch, x_dim) per-chain gather
        mask_inv = 1.0 - mask
        hold1 = jnp.where(d_col > 0, mask, mask_inv)
        hold2 = 1.0 - hold1
        return d_col, tau, hold1, hold2

    def leapfrog_step(params, x, v, g, beta, step, d_row, eps, aux):
        """One augmented leapfrog step with per-chain direction ``d_row``.

        ``g`` is the cached potential gradient at ``x``; the fresh
        gradient at the updated position is returned for the next step.
        """
        d_col, tau, hold1, hold2 = _step_context(params, step, d_row)

        sumlogdet = jnp.zeros(x.shape[0], x.dtype)
        v, ld = update_v(params, x, v, g, beta, tau, d_col, d_row, eps, aux)
        sumlogdet += ld
        x, ld = update_x(params, x, v, tau, hold1, d_col, d_row, eps, aux)
        sumlogdet += ld
        x, ld = update_x(params, x, v, tau, hold2, d_col, d_row, eps, aux)
        sumlogdet += ld
        g = grad_potential(x, beta)
        v, ld = update_v(params, x, v, g, beta, tau, d_col, d_row, eps, aux)
        sumlogdet += ld
        return x, v, g, sumlogdet

    step_fn = jax.checkpoint(leapfrog_step, static_argnums=()) if cfg.remat else leapfrog_step

    def _integrate_split(params, x, v, beta, direction, aux=None):
        """Run ``num_steps`` leapfrog steps; ``direction (batch,)`` in {+1,-1}."""
        eps = get_eps(params, cfg)

        def body(carry, step):
            x, v, g, logdet = carry
            x, v, g, ld = step_fn(params, x, v, g, beta, step, direction, eps, aux)
            return (x, v, g, logdet + ld), None

        init = (x, v, grad_potential(x, beta),
                jnp.zeros(x.shape[0], x.dtype))
        (x, v, _, sumlogdet), _ = jax.lax.scan(
            body, init, jnp.arange(cfg.num_steps)
        )
        return x, v, sumlogdet

    def leapfrog_step_merged(params, x, v, g, beta, step, d_row, eps, aux):
        """One ``merge_v_halves`` step: boundary V kick, then the two X
        sub-updates.

        Body ``step`` applies the momentum kick that precedes its X
        updates: a half-kick at trajectory time 0 (step 0) or a merged
        full kick at the boundary time ``step - 1/2`` otherwise.  The
        closing half-kick at time K-1 runs after the scan (the caller).
        Backward (d=-1) reads the reversed time sequence, so the map is
        the exact inverse of forward by construction.
        """
        K = cfg.num_steps
        d_col, tau_x, hold1, hold2 = _step_context(params, step, d_row)

        is_first = (step == 0)
        factor = jnp.where(is_first, 0.5, 1.0)
        t_fwd = jnp.where(is_first, 0.0, step - 0.5)
        t_bwd = jnp.where(is_first, K - 1.0, K - 0.5 - step)
        tau_v = time_encoding(jnp.where(d_row > 0, t_fwd, t_bwd), K)

        sumlogdet = jnp.zeros(x.shape[0], x.dtype)
        v, ld = update_v(params, x, v, g, beta, tau_v, d_col, d_row, eps,
                         aux, factor=factor)
        sumlogdet += ld
        x, ld = update_x(params, x, v, tau_x, hold1, d_col, d_row, eps, aux)
        sumlogdet += ld
        x, ld = update_x(params, x, v, tau_x, hold2, d_col, d_row, eps, aux)
        sumlogdet += ld
        g = grad_potential(x, beta)
        return x, v, g, sumlogdet

    merged_step_fn = (
        jax.checkpoint(leapfrog_step_merged) if cfg.remat else leapfrog_step_merged
    )

    def _integrate_merged(params, x, v, beta, direction, aux=None):
        """``merge_v_halves`` trajectory: K+1 VNet calls instead of 2K."""
        eps = get_eps(params, cfg)
        d_col = direction[:, None]

        def body(carry, step):
            x, v, g, logdet = carry
            x, v, g, ld = merged_step_fn(
                params, x, v, g, beta, step, direction, eps, aux)
            return (x, v, g, logdet + ld), None

        init = (x, v, grad_potential(x, beta),
                jnp.zeros(x.shape[0], x.dtype))
        (x, v, g, sumlogdet), _ = jax.lax.scan(
            body, init, jnp.arange(cfg.num_steps)
        )
        # closing half-kick: trajectory time K-1 forward, 0 backward
        idx_last = jnp.where(direction > 0, cfg.num_steps - 1.0, 0.0)
        tau_v = time_encoding(idx_last, cfg.num_steps)
        v, ld = update_v(params, x, v, g, beta, tau_v, d_col, direction, eps,
                         aux, factor=0.5)
        return x, v, sumlogdet + ld

    integrate = _integrate_merged if cfg.merge_v_halves else _integrate_split

    def accept_prob_fn(x0, v0, x1, v1, sumlogdet, beta):
        """``exp(min(H0 - H1 + logdet, 0))`` with NaN->0
        (``gauge_dynamics.py:592-609``)."""
        dh = hamiltonian(x0, v0, beta) - hamiltonian(x1, v1, beta) + sumlogdet
        prob = jnp.exp(jnp.minimum(dh, 0.0))
        return jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))

    def _sanitize(x, v, xp, vp):
        """Replace non-finite proposal entries with the initial state.

        The reference only zeroes NaN *accept probs*
        (``gauge_dynamics.py:609``) — a NaN proposal then still reaches the
        loss as ``metric(x, xp) * 0 = NaN`` and poisons the gradients.  Here
        an overflowed proposal is rejected outright and stays finite.
        """
        ok = jnp.all(jnp.isfinite(xp) & jnp.isfinite(vp), axis=-1, keepdims=True)
        return jnp.where(ok, xp, x), jnp.where(ok, vp, v)

    def _transition_fused(params, x, beta, key, aux=None):
        kv, kd, ka = jax.random.split(key, 3)
        v = jax.random.normal(kv, x.shape, x.dtype)
        direction = jnp.where(
            jax.random.uniform(kd, (x.shape[0],)) > 0.5, 1.0, -1.0
        ).astype(x.dtype)
        xp, vp, sumlogdet = integrate(params, x, v, beta, direction, aux)
        prob = accept_prob_fn(x, v, xp, vp, sumlogdet, beta)
        xp, vp = _sanitize(x, v, xp, vp)
        accept = (
            jax.random.uniform(ka, prob.shape) < prob
        ).astype(x.dtype)
        x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
        return Transition(
            x_proposed=xp, v_proposed=vp, accept_prob=prob, x_out=x_out,
            sumlogdet=sumlogdet, accept_mask=accept,
            forward_frac=jnp.mean((direction > 0).astype(jnp.float32)),
        )

    def _transition_both(params, x, beta, key, aux=None):
        """Literal reference dataflow: integrate forward AND backward with the
        same initial momentum, then mask (``gauge_dynamics.py:195-259``)."""
        kv, kd, ka = jax.random.split(key, 3)
        v = jax.random.normal(kv, x.shape, x.dtype)
        ones = jnp.ones(x.shape[0], x.dtype)
        xf, vf, ldf = integrate(params, x, v, beta, ones, aux)
        xb, vb, ldb = integrate(params, x, v, beta, -ones, aux)
        pf = accept_prob_fn(x, v, xf, vf, ldf, beta)
        pb = accept_prob_fn(x, v, xb, vb, ldb, beta)
        xf, vf = _sanitize(x, v, xf, vf)
        xb, vb = _sanitize(x, v, xb, vb)
        fwd = (jax.random.uniform(kd, (x.shape[0],)) > 0.5).astype(x.dtype)
        fwd_col = fwd[:, None]
        xp = fwd_col * xf + (1 - fwd_col) * xb
        vp = fwd_col * vf + (1 - fwd_col) * vb
        prob = fwd * pf + (1 - fwd) * pb
        sumlogdet = fwd * ldf + (1 - fwd) * ldb
        accept = (jax.random.uniform(ka, prob.shape) < prob).astype(x.dtype)
        x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
        return Transition(
            x_proposed=xp, v_proposed=vp, accept_prob=prob, x_out=x_out,
            sumlogdet=sumlogdet, accept_mask=accept,
            forward_frac=jnp.mean(fwd),
        )

    transition = _transition_both if cfg.both_directions else _transition_fused

    def chain_operator(params, x, beta, key, max_compositions: int, aux=None):
        """Compose a random number (1..max) of full leapfrog integrations
        before ONE MH accept — ``chain_operator`` parity
        (``utils/sampler.py:61-93``, used by the VAE's
        ``random_lf_composition``).

        Static shapes: always runs ``max_compositions`` integrations and
        freezes the state once the per-chain count is exhausted; the
        log-Jacobian accumulates only over active compositions.
        """
        kn, kv, kd, ka = jax.random.split(key, 4)
        n_comp = jax.random.randint(kn, (x.shape[0],), 1, max_compositions + 1)
        v = jax.random.normal(kv, x.shape, x.dtype)
        direction = jnp.where(
            jax.random.uniform(kd, (x.shape[0],)) > 0.5, 1.0, -1.0
        ).astype(x.dtype)

        def body(carry, i):
            xc, vc, ld = carry
            active = (i < n_comp)
            xn, vn, ldn = integrate(params, xc, vc, beta, direction, aux)
            xc = jnp.where(active[:, None], xn, xc)
            vc = jnp.where(active[:, None], vn, vc)
            ld = ld + jnp.where(active, ldn, 0.0)
            return (xc, vc, ld), None

        init = (x, v, jnp.zeros(x.shape[0], x.dtype))
        (xp, vp, sumlogdet), _ = jax.lax.scan(
            body, init, jnp.arange(max_compositions)
        )
        prob = accept_prob_fn(x, v, xp, vp, sumlogdet, beta)
        xp, vp = _sanitize(x, v, xp, vp)
        accept = (jax.random.uniform(ka, prob.shape) < prob).astype(x.dtype)
        x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
        return Transition(
            x_proposed=xp, v_proposed=vp, accept_prob=prob, x_out=x_out,
            sumlogdet=sumlogdet, accept_mask=accept,
            forward_frac=jnp.mean((direction > 0).astype(jnp.float32)),
        )

    return {
        "transition": transition,
        "integrate": integrate,
        "hamiltonian": hamiltonian,
        "potential_energy": potential_energy,
        "kinetic_energy": kinetic_energy,
        "accept_prob": accept_prob_fn,
        "chain_operator": chain_operator,
    }
