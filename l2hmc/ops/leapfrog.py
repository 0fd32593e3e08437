"""Whole-chain U(1) HMC: the shared flat math, its plain reference, and the
CUDA kernel that runs a whole chain in one launch.

The XLA form (``dynamics/hmc.py hmc_chain``) issues several fusions per
leapfrog step and round-trips the chain state through device memory on
every transition.  ``u1_chain.cu`` instead runs ``num_transitions``
complete HMC transitions per call -- K leapfrog steps of the analytic
Wilson-action force (the formulas of ``ops/wilson.py``), the mod-2pi wrap,
the Hamiltonian bookkeeping and the MH accept, optionally one exact
instanton hop -- with one thread block per chain and the chain's links in
shared memory throughout.  Device memory sees the initial state once, the
final state once, and one ``(num_transitions, chains)`` observable row per
transition.

Layout: links are flat ``(chains, Lt*Lx)`` per direction, row-major
``i = t * Lx + s``.  A time-roll is a global rotation by ``Lx``; a
space-roll is a rotation by 1 corrected at the ``s``-row boundary.

Randomness: the kernel draws momenta and accept uniforms from
Philox4x32-10 (:func:`philox4x32_10` is its numpy model) or takes them as
arrays (``rand_arrays``).  :func:`hmc_chain_reference` consumes the same
arrays, so kernel and reference agree to float32 rounding.

Reference semantics covered: plain-HMC transition = ``HMC/hmc.py:50-98``
(also the ``hmc=True`` degeneration of ``dynamics/gauge_dynamics.py``, whose
zero-net leapfrog reduces to exactly this integrator); Wilson action =
``lattice/lattice.py:300-313``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# Shared math on flat (batch, Lt*Lx) link arrays.
#
# Row-major flat index i = t * Lx + s.  ``roll`` is any function with
# jnp.roll(a, k, axis=1) semantics (the reference passes jnp.roll itself).
# ---------------------------------------------------------------------------


def _roll_t(a, k, lx, roll):
    """roll(links, k, axis=time): exact global rotation by k*Lx."""
    return roll(a, k * lx)


def _roll_s(a, k, lx, s_col, roll):
    """roll(links, k, axis=space) for k in {-1, +1}: rotation by k,
    corrected at the s-row boundary (the global wrap crosses into the
    neighboring t-row there)."""
    if k == -1:
        fix = roll(a, lx - 1)
        return jnp.where(s_col == lx - 1, fix, roll(a, -1))
    if k == 1:
        fix = roll(a, -(lx - 1))
        return jnp.where(s_col == 0, fix, roll(a, 1))
    raise ValueError(k)


def _plaq_flat(u0, u1, lx, s_col, roll):
    """P = u0 - u1 - roll(u0,-1,s) + roll(u1,-1,t)  (ops/wilson.py:37-38)."""
    return u0 - u1 - _roll_s(u0, -1, lx, s_col, roll) + _roll_t(u1, -1, lx, roll)


def _grad_flat(sinp, lx, s_col, roll):
    """dS/du0 = sinP - roll(sinP,+1,s); dS/du1 = -sinP + roll(sinP,+1,t)."""
    g0 = sinp - _roll_s(sinp, 1, lx, s_col, roll)
    g1 = -sinp + _roll_t(sinp, 1, lx, roll)
    return g0, g1


def _wrap(x):
    return x - _TWO_PI * jnp.floor((x + np.pi) / _TWO_PI)


def _potential_fields(y0, y1, lx, s_col, roll):
    """Plaquette-field stats in one pass: potential, sine AND cosine
    fields, and the (unrounded) topological charge ``Q = sum(wrap(P)) /
    2pi`` (``lattice/u1.py topological_charge``).  The cosine field is
    the hop-chain carry (see :func:`_hop_math`); plain chains drop it."""
    p = _plaq_flat(y0, y1, lx, s_col, roll)
    chg = jnp.sum(_wrap(p), axis=1) * (1.0 / _TWO_PI)
    cosp = jnp.cos(p)
    return jnp.sum(1.0 - cosp, axis=1), jnp.sin(p), cosp, chg


def _winding_flat(rows, d, lt, lx):
    """Flat winding-1 field halves ``(rows, d)`` (dynamics/topo.py
    winding_field, flat layout): ``w1 = delta * t``; ``w0`` nonzero only
    on the seam row ``t = lt-1`` where it is ``-delta * lt * s``.  Pure
    iota arithmetic, f32-exact (integer values < 2^24)."""
    delta0 = _TWO_PI / d
    i_f = jax.lax.broadcasted_iota(jnp.int32, (rows, d), 1).astype(jnp.float32)
    s_f = i_f - lx * jnp.floor(i_f * (1.0 / lx))
    t_f = (i_f - s_f) * (1.0 / lx)
    w1 = delta0 * t_f
    w0 = jnp.where(t_f == float(lt - 1), -delta0 * lt * s_f,
                   jnp.zeros_like(s_f))
    return w0, w1


def _hop_math(x0, x1, pot, sinp, cosp, chg, nu, u_h, beta, w0f, w1f):
    """One exact instanton hop on carried plaquette fields — NO plaquette
    pass (dynamics/topo.py semantics, fused form).

    Everything the Metropolis test needs is already in hand: with the
    uniform shift ``delta = 2 pi nu / d`` (mod 2 pi at the seam corner),
    ``dS = (1 - cos d0)(d - pot) + nu sin d0 sum(sinp)``.  On accept the
    links shift by ``nu w`` and the carried fields rotate in closed form:
    ``sin' = sin cos d + cos sin d``, ``cos' = cos cos d - sin sin d``,
    ``pot' = pot + dS``, and the charge updates by ``nu`` minus the exact
    count of plaquettes pushed across the +-pi branch cut
    (``cos P < -cos d0`` on the ``nu``-side half-plane).
    """
    d = x0.shape[1]
    cd = float(np.cos(_TWO_PI / d))
    sd = float(np.sin(_TWO_PI / d))
    ds = (1.0 - cd) * (d - pot) + nu * sd * jnp.sum(sinp, axis=1)
    prob = jnp.exp(jnp.minimum(-beta * ds, 0.0))
    prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
    acc = (u_h < prob).astype(x0.dtype)
    an = acc * nu                                # signed accepted winding
    an_col = an[:, None]
    x0 = _wrap(x0 + an_col * w0f)
    x1 = _wrap(x1 + an_col * w1f)
    cda = 1.0 + acc * (cd - 1.0)                 # cos(delta*|an|)
    sda = an * sd                                # sin(delta*an)
    sinp_new = sinp * cda[:, None] + cosp * sda[:, None]
    cosp_new = cosp * cda[:, None] - sinp * sda[:, None]
    pot_new = pot + acc * ds
    n_b = jnp.sum(
        ((cosp < -cd) & (nu[:, None] * sinp >= 0.0)).astype(x0.dtype),
        axis=1)
    chg_new = chg + an * (1.0 - n_b)
    return x0, x1, prob, pot_new, sinp_new, cosp_new, chg_new


def _transition_math(x0, x1, v0, v1, u, eps, beta, num_leapfrog, lx,
                     s_col, roll, pot0=None, sinp=None, chg0=None,
                     cosp=None):
    """One full HMC transition on flat link arrays; pure function of its
    inputs (``u1_chain.cu`` mirrors it operation for operation).

    ``pot0``/``sinp``/``chg0`` optionally inject the potential,
    plaquette-sine field, and charge of the INPUT state (all are in hand at
    the end of the previous transition's accept step — carrying them saves
    one of the K+1 plaquette+trig evaluations per transition; the carried
    values are bit-identical to recomputation, they were produced by the
    same ops at the same point).  ``cosp`` additionally carries the cosine
    field for hop chains (:func:`_hop_math`); when given the return tuple
    grows by ``cosp_out``.

    Returns ``(x0', x1', accept_prob, avg_plaq_of_output, pot_out,
    sinp_out, chg_out[, cosp_out])``.
    """
    n_plaq = x0.shape[1]
    track_cosp = cosp is not None

    if pot0 is None:
        pot0, sinp, cosp0, chg0 = _potential_fields(x0, x1, lx, s_col, roll)
        if track_cosp:
            cosp = cosp0
    ke0 = 0.5 * (jnp.sum(v0 * v0, axis=1) + jnp.sum(v1 * v1, axis=1))

    g0, g1 = _grad_flat(sinp, lx, s_col, roll)
    w0 = v0 - 0.5 * eps * beta * g0
    w1 = v1 - 0.5 * eps * beta * g1
    y0, y1 = x0, x1
    pot1, sinp1, cosp1, chg1 = pot0, sinp, cosp, chg0  # overwritten in loop
    for k in range(num_leapfrog):
        y0 = _wrap(y0 + eps * w0)
        y1 = _wrap(y1 + eps * w1)
        pot1, sinp1, cosp1, chg1 = _potential_fields(y0, y1, lx, s_col, roll)
        g0, g1 = _grad_flat(sinp1, lx, s_col, roll)
        c = eps if k < num_leapfrog - 1 else 0.5 * eps
        w0 = w0 - c * beta * g0
        w1 = w1 - c * beta * g1
    ke1 = 0.5 * (jnp.sum(w0 * w0, axis=1) + jnp.sum(w1 * w1, axis=1))

    dh = (beta * pot0 + ke0) - (beta * pot1 + ke1)
    prob = jnp.exp(jnp.minimum(dh, 0.0))
    prob = jnp.where(jnp.isfinite(prob), prob, jnp.zeros_like(prob))
    acc = (u < prob).astype(x0.dtype)
    acc_col = acc[:, None]
    x0 = acc_col * y0 + (1.0 - acc_col) * x0
    x1 = acc_col * y1 + (1.0 - acc_col) * x1
    # output state's potential / sine field / charge: all already in hand
    pot_out = acc * pot1 + (1.0 - acc) * pot0
    sinp_out = acc_col * sinp1 + (1.0 - acc_col) * sinp
    chg_out = acc * chg1 + (1.0 - acc) * chg0
    avg_plaq = 1.0 - pot_out / n_plaq
    if track_cosp:
        cosp_out = acc_col * cosp1 + (1.0 - acc_col) * cosp
        return x0, x1, prob, avg_plaq, pot_out, sinp_out, chg_out, cosp_out
    return x0, x1, prob, avg_plaq, pot_out, sinp_out, chg_out


# ---------------------------------------------------------------------------
# Plain reference: same math, explicit randomness.
# ---------------------------------------------------------------------------


def hmc_chain_reference(links, v0s, v1s, us, eps, beta, num_leapfrog,
                        hop_arrays=None):
    """Run ``N = v0s.shape[0]`` transitions with injected randomness.

    ``links (B, Lt, Lx, 2)``; ``v0s/v1s (N, B, Lt*Lx)``; ``us (N, B)``.
    ``hop_arrays=(nus, uhs)`` (each ``(N, B)``, nus in {+1,-1}) appends one
    exact instanton hop (:func:`_hop_math`) after every transition.
    Returns ``(links_out, plaq_trace (N, B), charge_trace (N, B),
    prob_trace (N, B))``; charges are rounded to integer sectors.
    """
    b, lt, lx, _ = links.shape
    d = lt * lx
    s_col = (jax.lax.broadcasted_iota(jnp.int32, (b, d), 1) % lx)
    roll = functools.partial(jnp.roll, axis=1)
    x0 = links[..., 0].reshape(b, d)
    x1 = links[..., 1].reshape(b, d)

    pot, sinp, cosp, chg = _potential_fields(x0, x1, lx, s_col, roll)

    if hop_arrays is None:
        def body(carry, rand):
            x0, x1, pot, sinp, chg = carry
            v0, v1, u = rand
            x0, x1, prob, plaq, pot, sinp, chg = _transition_math(
                x0, x1, v0, v1, u, eps, beta, num_leapfrog, lx, s_col, roll,
                pot0=pot, sinp=sinp, chg0=chg)
            return (x0, x1, pot, sinp, chg), (plaq, chg, prob)

        (x0, x1, _, _, _), (plaqs, chgs, probs) = jax.lax.scan(
            body, (x0, x1, pot, sinp, chg), (v0s, v1s, us))
    else:
        nus, uhs = hop_arrays
        w0f, w1f = _winding_flat(b, d, lt, lx)

        def body(carry, rand):
            x0, x1, pot, sinp, cosp, chg = carry
            v0, v1, u, nu, uh = rand
            x0, x1, prob, plaq, pot, sinp, chg, cosp = _transition_math(
                x0, x1, v0, v1, u, eps, beta, num_leapfrog, lx, s_col, roll,
                pot0=pot, sinp=sinp, chg0=chg, cosp=cosp)
            x0, x1, _, pot, sinp, cosp, chg = _hop_math(
                x0, x1, pot, sinp, cosp, chg, nu, uh, beta, w0f, w1f)
            plaq = 1.0 - pot / d
            return (x0, x1, pot, sinp, cosp, chg), (plaq, chg, prob)

        (x0, x1, _, _, _, _), (plaqs, chgs, probs) = jax.lax.scan(
            body, (x0, x1, pot, sinp, cosp, chg), (v0s, v1s, us, nus, uhs))
    out = jnp.stack([x0.reshape(b, lt, lx), x1.reshape(b, lt, lx)], axis=-1)
    return out, plaqs, jnp.round(chgs), probs




# ---------------------------------------------------------------------------
# Numpy model of the kernel's generator (Philox4x32-10, Box-Muller).
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def philox4x32_10(counter, key) -> np.ndarray:
    """Philox4x32-10 (Salmon et al., SC'11) on ``counter (..., 4)`` words
    with ``key (2,)`` words; returns ``(..., 4)`` uint32.  The kernel's
    ``philox4x32_10`` computes the same bits."""
    c = np.asarray(counter, np.uint64) & _MASK32
    c0, c1, c2, c3 = (c[..., n] for n in range(4))
    k0, k1 = (np.uint64(int(w) & _MASK32) for w in key)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
    mask, shift = np.uint64(_MASK32), np.uint64(32)
    for _ in range(10):
        p0 = m0 * c0
        p1 = m1 * c2
        c0, c1, c2, c3 = ((p1 >> shift) ^ c1 ^ k0, p1 & mask,
                          (p0 >> shift) ^ c3 ^ k1, p0 & mask)
        k0 = (k0 + w0) & mask
        k1 = (k1 + w1) & mask
    return np.stack([c0, c1, c2, c3], axis=-1).astype(np.uint32)


def uniform_open(bits) -> np.ndarray:
    """23 random bits -> float32 ``(2k + 1) / 2^24``: in (0, 1), exact."""
    k = (np.asarray(bits, np.uint32) >> np.uint32(9)).astype(np.float32)
    return k * np.float32(2.0 ** -23) + np.float32(2.0 ** -24)


def philox_draws(seed, num_transitions: int, num_chains: int, d: int):
    """Everything the kernel draws for one call, as arrays in the layout of
    ``rand_arrays``: ``(v0s, v1s (N, B, d), us, nus, uhs (N, B))``.

    Site ``i`` of chain ``c`` at transition ``t`` uses the counter
    ``(i, t, c, 0)``; its two uniforms become the site's two momenta by
    Box-Muller.  The chain's scalars use the counter ``(d, t, c, 0)``.
    The normals here are taken in float64, so they match the kernel's
    float32 ``logf``/``sincospif`` to rounding, not bit for bit.
    """
    t, c, i = np.meshgrid(np.arange(num_transitions), np.arange(num_chains),
                          np.arange(d + 1), indexing="ij")
    ctr = np.stack([i, t, c, np.zeros_like(i)], axis=-1)
    r = philox4x32_10(ctr, seed)
    u1 = uniform_open(r[..., :d, 0]).astype(np.float64)
    u2 = uniform_open(r[..., :d, 1]).astype(np.float64)
    rad = np.sqrt(-2.0 * np.log(u1))
    v0s = (rad * np.cos(_TWO_PI * u2)).astype(np.float32)
    v1s = (rad * np.sin(_TWO_PI * u2)).astype(np.float32)
    scalars = r[..., d, :]
    us = uniform_open(scalars[..., 0])
    nus = np.where(scalars[..., 1] & 1, 1.0, -1.0).astype(np.float32)
    uhs = uniform_open(scalars[..., 2])
    return v0s, v1s, us, nus, uhs


# ---------------------------------------------------------------------------
# The CUDA kernel (u1_chain.cu) through jax.ffi.
# ---------------------------------------------------------------------------

_SOURCE = Path(__file__).with_name("u1_chain.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_TARGET_PHILOX = "l2hmc_u1_chain_philox"
_TARGET_INJECTED = "l2hmc_u1_chain_injected"
_SMEM_LIMIT = 232448            # shared memory one Hopper block may use
_MAX_THREADS = 1024
_SITES_PER_THREAD = (1, 2, 4, 8, 16)   # the kernel's instantiations
_REDUCE_FLOATS = 4 * 32         # block_sum scratch: 4 values x 32 warps


def launch_config(lt: int, lx: int) -> Optional[Tuple[int, int, int]]:
    """``(threads, sites_per_thread, shared_bytes)`` of one chain's block,
    or None when the lattice does not fit one block.

    One thread per site up to 1024 threads (a whole number of warps), then
    several sites per thread; shared memory holds the two proposal link
    arrays, the plaquette sines and the reduction scratch.
    """
    d = lt * lx
    threads = min(-(-d // 32) * 32, _MAX_THREADS)
    spt = next((s for s in _SITES_PER_THREAD if threads * s >= d), None)
    smem = 4 * (3 * d + _REDUCE_FLOATS)
    if spt is None or smem > _SMEM_LIMIT:
        return None
    return threads, spt, smem


def kernel_fits(lt: int, lx: int) -> bool:
    return launch_config(lt, lx) is not None


def _library_path() -> Path:
    """Build ``u1_chain.cu`` for sm_90a into ``<repo>/build`` (once per
    source and JAX version; the name carries their hash)."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + jax.__version__.encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"u1_chain_{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    partial = lib.with_suffix(".so.partial")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(partial), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(partial, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _register_targets():
    lib = ctypes.cdll.LoadLibrary(str(_library_path()))
    for name, symbol in ((_TARGET_PHILOX, "L2hmcU1ChainPhilox"),
                         (_TARGET_INJECTED, "L2hmcU1ChainInjected")):
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    return lib


def _kernel_scalars(eps, beta, d: int, lt: int) -> jax.Array:
    """The kernel's ``scal`` row: the runtime scalars and the hop constants
    rounded to float32 exactly as :func:`_hop_math` and
    :func:`_winding_flat` round them."""
    cd = float(np.cos(_TWO_PI / d))
    sd = float(np.sin(_TWO_PI / d))
    delta0 = _TWO_PI / d
    consts = jnp.asarray([cd, sd, 1.0 - cd, delta0, -delta0 * lt],
                         jnp.float32)
    runtime = jnp.stack([jnp.asarray(eps, jnp.float32),
                         jnp.asarray(beta, jnp.float32)])
    return jnp.concatenate([runtime, consts])


def hmc_chain_cuda(
    links: jax.Array,
    key: jax.Array,
    eps,
    beta,
    num_leapfrog: int,
    num_transitions: int,
    rand_arrays=None,
    hop: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run ``num_transitions`` U(1) HMC transitions in one CUDA launch.

    ``links (B, Lt, Lx, 2)`` float32 angles.  Returns ``(links_out,
    plaq_trace (N, B), charge_trace (N, B), prob_trace (N, B))``, the
    traces being per-chain observables of each transition's OUTPUT state;
    charges are rounded to integer sectors.  ``hop=True`` appends one exact
    instanton hop (:func:`_hop_math`) after every transition.

    ``rand_arrays=(v0s, v1s, us[, nus, uhs])`` injects the randomness
    (``(N, B, Lt*Lx)`` momenta, ``(N, B)`` scalars), as
    :func:`hmc_chain_reference` takes it; by default the kernel draws it
    from Philox keyed by ``key``.  The call lowers only for CUDA; raises
    ValueError when the lattice does not fit one block's shared memory.
    """
    b, lt, lx, _ = links.shape
    d = lt * lx
    config = launch_config(lt, lx)
    if config is None:
        raise ValueError(
            f"a {lt}x{lx} lattice needs {4 * (3 * d + _REDUCE_FLOATS)} bytes "
            f"of shared memory per chain; one block has {_SMEM_LIMIT}")
    threads, spt, smem = config
    if any(dev.platform == "gpu" for dev in jax.devices()):
        _register_targets()
    f32 = jnp.float32
    x0 = links[..., 0].reshape(b, d).astype(f32)
    x1 = links[..., 1].reshape(b, d).astype(f32)
    scal = _kernel_scalars(eps, beta, d, lt)
    trace = jax.ShapeDtypeStruct((num_transitions, b), f32)
    state = jax.ShapeDtypeStruct((b, d), f32)
    out_types = (state, state, trace, trace, trace)
    attrs = dict(lt=lt, lx=lx, num_leapfrog=num_leapfrog, hop=int(hop),
                 threads=threads, spt=spt, smem=smem)
    if rand_arrays is None:
        seed = jax.random.bits(key, (2,), jnp.uint32)
        outs = jax.ffi.ffi_call(_TARGET_PHILOX, out_types)(
            x0, x1, scal, seed, **attrs)
    else:
        if hop and len(rand_arrays) != 5:
            raise ValueError("hop=True with injected randomness needs "
                             "(v0s, v1s, us, nus, uhs)")
        v0s, v1s, us = (jnp.asarray(a, f32) for a in rand_arrays[:3])
        if v0s.shape != (num_transitions, b, d) or us.shape != trace.shape:
            raise ValueError(f"rand_arrays must be (N, B, d) momenta and "
                             f"(N, B) scalars for N={num_transitions}, "
                             f"B={b}, d={d}")
        if hop:
            nus, uhs = (jnp.asarray(a, f32) for a in rand_arrays[3:])
        else:
            nus = uhs = jnp.zeros(trace.shape, f32)
        outs = jax.ffi.ffi_call(_TARGET_INJECTED, out_types)(
            x0, x1, scal, v0s, v1s, us, nus, uhs, **attrs)
    x0, x1, plaqs, chgs, probs = outs
    out = jnp.stack([x0.reshape(b, lt, lx), x1.reshape(b, lt, lx)], axis=-1)
    return out, plaqs, jnp.round(chgs), probs
