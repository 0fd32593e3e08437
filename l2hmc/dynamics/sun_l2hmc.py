"""Trainable L2HMC-style sampler on SU(N) lattice gauge groups.

Extends the framework beyond the reference (whose SU(N) support is dead
scaffolding — SURVEY §7.4, ``lattice/gauge_generators.py``) with a *learned*
kernel on the group manifold, keeping the MH step exact:

- **Momentum update is augmented** with the same (S, T, Q) structure as the
  flat L2HMC kernel (``dynamics/l2hmc.py``), acting on the su(N)-algebra
  momentum coefficients::

      p' = p * exp(eps/2 S) - eps/2 (exp(eps Q) F - T),   logdet += eps/2 sum(S)

  where ``F`` is the left-translation force.  Because the update is linear
  in ``p`` and (S, T, Q) depend only on the links, the log-Jacobian is
  exact — same bookkeeping that the flat kernel property-tests.
- **Position update stays the exponential map** ``U <- exp(i d eps p.T) U``:
  a left translation, Haar-measure preserving, so it contributes no
  Jacobian.  Learning lives entirely in the momentum channel — this
  sidesteps the open problem of volume-tracked learned diffeomorphisms on
  the group while remaining strictly more expressive than HMC (the flat
  kernel's position scaling has no canonical SU(N) analog).
- One shared momentum net is used for both half-steps (the reference also
  shares its VNet), which makes the backward kernel the exact inverse under
  time-index reversal; direction is drawn per chain and fused with
  where-selects like the flat kernel.

The net is a pointwise MLP over per-link features: the force components
(algebra channels), Re/Im traces of the two adjacent plaquettes, and the
sinusoidal leapfrog-time encoding.  The output layer is zero-initialized,
so at init the kernel *is* plain Lie-group HMC and training can only
improve it.  Loss is the reference's squared-jump form on the
gauge-invariant plaquette-trace distance.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from l2hmc.lattice.sun import generators, sun_action, sun_plaquette, random_sun
from l2hmc.dynamics.sun_hmc import _left_translate, _reunitarize


class SUNNetParams(NamedTuple):
    w1: jax.Array
    b1: jax.Array
    w_s: jax.Array
    w_t: jax.Array
    w_q: jax.Array


class SUNL2HMCParams(NamedTuple):
    raw_eps: jax.Array
    net: SUNNetParams


class SUNL2HMCConfig(NamedTuple):
    n: int = 2                 # SU(N)
    num_steps: int = 3         # leapfrog steps per transition
    eps_init: float = 0.1
    eps_cap: float = 0.5       # acceptance-cliff guard
    hidden: int = 32
    eps_trainable: bool = True
    # float32 (re, im) pair representation (ops/cmat.py), for runtimes
    # without complex dtypes; links are then (B, Lt, Lx, 2, 2, N, N) with
    # the pair axis after the direction axis.
    real_pairs: bool = False


def _n_feats(n: int) -> int:
    k = n * n - 1
    return k + 4 + 2  # force channels + 2 plaquette (re, im) pairs + time


def init_sun_l2hmc(key: jax.Array, cfg: SUNL2HMCConfig) -> SUNL2HMCParams:
    k = cfg.n * cfg.n - 1
    f = _n_feats(cfg.n)
    k1, _ = jax.random.split(key)
    scale = 1.0 / np.sqrt(f)
    net = SUNNetParams(
        w1=scale * jax.random.normal(k1, (f, cfg.hidden), jnp.float32),
        b1=jnp.zeros((cfg.hidden,), jnp.float32),
        # zero-init heads: the kernel starts exactly at plain HMC
        w_s=jnp.zeros((cfg.hidden, k), jnp.float32),
        w_t=jnp.zeros((cfg.hidden, k), jnp.float32),
        w_q=jnp.zeros((cfg.hidden, k), jnp.float32),
    )
    return SUNL2HMCParams(
        raw_eps=jnp.asarray(cfg.eps_init, jnp.float32), net=net
    )


def _plaq_feats_from_tr(tr_re: jax.Array, tr_im: jax.Array) -> jax.Array:
    """Per-link gauge-invariant features from plaquette traces/N:
    (Re, Im) of the two plaquettes each link borders.  ``(B, Lt, Lx, 2, 4)``.

    link (t,x,0) borders P(t,x) and P(t,x-1); link (t,x,1): P(t,x), P(t-1,x).
    """
    f0 = jnp.stack(
        [tr_re, tr_im,
         jnp.roll(tr_re, 1, axis=-1), jnp.roll(tr_im, 1, axis=-1)],
        axis=-1,
    )
    f1 = jnp.stack(
        [tr_re, tr_im,
         jnp.roll(tr_re, 1, axis=-2), jnp.roll(tr_im, 1, axis=-2)],
        axis=-1,
    )
    return jnp.stack([f0, f1], axis=-2)              # (B, Lt, Lx, 2, 4)


def _make_rep(cfg: SUNL2HMCConfig):
    """Representation bundle: complex dtype or float32 (re, im) pairs
    (ops/cmat.py)."""
    n = cfg.n
    if cfg.real_pairs:
        from l2hmc.lattice import sun_nd
        from l2hmc.ops import cmat

        gp = cmat.gens_pair(n)

        def plaq_tr(u):
            p = sun_nd.plaq_field_nd_pairs(u, 0, 1)
            re = jnp.trace(p[..., 0, :, :], axis1=-2, axis2=-1) / n
            im = jnp.trace(p[..., 1, :, :], axis1=-2, axis2=-1) / n
            return re, im

        return dict(
            mat_tail=3,  # trailing (2, N, N)
            action=lambda u, beta: sun_nd.wilson_action_nd_pairs(u, beta),
            plaq_tr=plaq_tr,
            left_translate=lambda u, th: sun_nd._left_translate_pairs(u, th, gp),
            reunit=cmat.polar_reunitarize,
        )

    gens = generators(n)

    def plaq_tr(u):
        tr = jnp.trace(sun_plaquette(u), axis1=-2, axis2=-1) / n
        return tr.real, tr.imag

    return dict(
        mat_tail=2,  # trailing (N, N)
        action=lambda u, beta: sun_action(u, beta),
        plaq_tr=plaq_tr,
        left_translate=lambda u, th: _left_translate(u, th, gens),
        reunit=_reunitarize,
    )


def make_sun_dynamics(cfg: SUNL2HMCConfig, beta):
    """Build the transition for SU(N) links ``(B, Lt, Lx, 2, N, N)``
    (complex) or ``(B, Lt, Lx, 2, 2, N, N)`` (``real_pairs=True``)."""
    n = cfg.n
    k = n * n - 1
    rep = _make_rep(cfg)
    mt = rep["mat_tail"]

    def get_eps(params):
        eps = params.raw_eps
        if cfg.eps_cap > 0:
            eps = jnp.minimum(eps, cfg.eps_cap)
        return eps

    def force(u):
        def s_of_theta(theta):
            return jnp.sum(rep["action"](rep["left_translate"](u, theta), beta))

        zero = jnp.zeros(u.shape[:-mt] + (k,), jnp.float32)
        return jax.grad(s_of_theta)(zero)

    def kinetic(p):
        return 0.5 * jnp.sum(p * p, axis=(-4, -3, -2, -1))

    def net_stq(net: SUNNetParams, u, f_force, tau):
        re, im = rep["plaq_tr"](u)
        feats = jnp.concatenate(
            [
                f_force,
                _plaq_feats_from_tr(re, im),
                jnp.broadcast_to(tau, u.shape[:-mt] + (2,)),
            ],
            axis=-1,
        )
        h = jax.nn.relu(feats @ net.w1 + net.b1)
        # tanh-bounded S and Q (the stable head form)
        return jnp.tanh(h @ net.w_s), h @ net.w_t, jnp.tanh(h @ net.w_q)

    def update_p(params, u, p, tau, d_col, d_row, eps):
        """Fused-direction augmented momentum half-step (exact logdet)."""
        f = force(u)
        s, t, q = net_stq(params.net, u, f, tau)
        half_s = 0.5 * eps * s
        a = 0.5 * eps * (jnp.exp(eps * q) * f - t)
        e = jnp.exp(d_col * half_s)
        p_new = jnp.where(d_col > 0, p * e - a, (p + a) * e)
        logdet = d_row * jnp.sum(half_s, axis=(-4, -3, -2, -1))
        return p_new, logdet

    def time_enc(i):
        ang = 2.0 * np.pi * i / max(cfg.num_steps, 1)
        return jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)

    def leapfrog(params, u, p, step, d_row, eps):
        d_col = d_row[:, None, None, None, None]
        idx = jnp.where(d_row > 0, step, cfg.num_steps - 1 - step)
        tau = time_enc(idx)[:, None, None, None, :]  # per-chain (B,1,1,1,2)
        sumlogdet = jnp.zeros(u.shape[0], jnp.float32)
        p, ld = update_p(params, u, p, tau, d_col, d_row, eps)
        sumlogdet += ld
        u = rep["reunit"](rep["left_translate"](u, (d_col * eps) * p))
        p, ld = update_p(params, u, p, tau, d_col, d_row, eps)
        sumlogdet += ld
        return u, p, sumlogdet

    def transition(params: SUNL2HMCParams, u, key):
        eps = get_eps(params)
        kv, kd, ka = jax.random.split(key, 3)
        p0 = jax.random.normal(kv, u.shape[:-mt] + (k,), jnp.float32)
        d_row = jnp.where(
            jax.random.bernoulli(kd, 0.5, (u.shape[0],)), 1.0, -1.0
        )

        def body(carry, step):
            uu, pp, ld = carry
            uu, pp, dl = leapfrog(params, uu, pp, step, d_row, eps)
            return (uu, pp, ld + dl), None

        (u1, p1, sumlogdet), _ = jax.lax.scan(
            body, (u, p0, jnp.zeros(u.shape[0], jnp.float32)),
            jnp.arange(cfg.num_steps),
        )
        h0 = rep["action"](u, beta) + kinetic(p0)
        h1 = rep["action"](u1, beta) + kinetic(p1)
        prob = jnp.exp(jnp.minimum(h0 - h1 + sumlogdet, 0.0))
        prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
        accept = jax.random.uniform(ka, prob.shape) < prob
        acc = accept.reshape(accept.shape + (1,) * (u.ndim - 1))
        out = jnp.where(acc, u1, u)
        return {
            "x_out": out, "x_proposed": u1, "accept_prob": prob,
            "accept_mask": accept, "sumlogdet": sumlogdet,
        }

    def integrate(params, u, p, direction):
        """Deterministic integration at fixed per-chain direction — the
        reversibility test surface."""
        eps = get_eps(params)

        def body(carry, step):
            uu, pp, ld = carry
            uu, pp, dl = leapfrog(params, uu, pp, step, direction, eps)
            return (uu, pp, ld + dl), None

        (u1, p1, ld), _ = jax.lax.scan(
            body, (u, p, jnp.zeros(u.shape[0], jnp.float32)),
            jnp.arange(cfg.num_steps),
        )
        return u1, p1, ld

    return {"transition": transition, "integrate": integrate,
            "force": force, "get_eps": get_eps}


def plaq_trace_distance(u_a: jax.Array, u_b: jax.Array) -> jax.Array:
    """Gauge-invariant squared jump ``mean_plaq |tr P_a - tr P_b|^2 / N^2``
    per sample — the metric for the ESJD loss on the group.

    Accepts complex links or float (re, im) pairs (detected by dtype)."""
    n = u_a.shape[-1]
    if jnp.iscomplexobj(u_a):
        ta = jnp.trace(sun_plaquette(u_a), axis1=-2, axis2=-1)
        tb = jnp.trace(sun_plaquette(u_b), axis1=-2, axis2=-1)
        d2 = jnp.abs(ta - tb) ** 2
    else:
        from l2hmc.lattice import sun_nd

        pa = sun_nd.plaq_field_nd_pairs(u_a, 0, 1)
        pb = sun_nd.plaq_field_nd_pairs(u_b, 0, 1)
        dre = jnp.trace(pa[..., 0, :, :] - pb[..., 0, :, :],
                        axis1=-2, axis2=-1)
        dim = jnp.trace(pa[..., 1, :, :] - pb[..., 1, :, :],
                        axis1=-2, axis2=-1)
        d2 = dre * dre + dim * dim
    return jnp.mean(d2, axis=(-2, -1)) / (n * n)


def make_sun_train_step(cfg: SUNL2HMCConfig, beta, optimizer, loss_scale=0.1):
    """ESJD training step (reference loss form ``ls/d - d/ls``,
    ``gauge_model.py:766-795``, on the plaquette-trace metric)."""
    dyn = make_sun_dynamics(cfg, beta)

    def loss_fn(params, u, key):
        out = dyn["transition"](params, u, key)
        d = plaq_trace_distance(u, out["x_proposed"]) * out["accept_prob"]
        d = d + 1e-4
        loss = jnp.mean(loss_scale / d - d / loss_scale)
        return loss, out

    def train_step(params, opt_state, u, key):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, u, key
        )
        grads = jax.tree.map(jnp.nan_to_num, grads)
        if not cfg.eps_trainable:
            grads = grads._replace(raw_eps=jnp.zeros_like(grads.raw_eps))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            "accept_prob": jnp.mean(out["accept_prob"]),
            "eps": dyn["get_eps"](params),
        }
        return params, opt_state, out["x_out"], metrics

    return train_step, dyn
