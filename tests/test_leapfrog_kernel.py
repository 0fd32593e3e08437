"""Whole-chain U(1) HMC (ops/leapfrog.py): the plain reference, the numpy
model of the kernel's generator, and everything around the CUDA call that
runs without a card -- launch geometry, shapes, argument checks, and the
dispatch of ``hmc_chain_u1_fused`` (CUDA lowering vs the XLA scan).

The kernel itself has no CPU mode; its comparison with the reference runs
on the card (tests/test_chip_kernel.py, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics.hmc import hmc_chain_u1_fused, hmc_chain_u1_xla
from l2hmc.lattice import u1
from l2hmc.ops import leapfrog
from l2hmc.ops.leapfrog import hmc_chain_cuda, hmc_chain_reference


def _rand_inputs(key, n, b, lt, lx):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    links = jax.random.uniform(k1, (b, lt, lx, 2), minval=-np.pi,
                               maxval=np.pi)
    v0s = jax.random.normal(k2, (n, b, lt * lx))
    v1s = jax.random.normal(k3, (n, b, lt * lx))
    us = jax.random.uniform(k4, (n, b))
    return links, v0s, v1s, us


def test_reference_twin_matches_independent_leapfrog(key):
    """The twin's flat-lane plaquette/gradient formulas against an
    independent leapfrog built on ``u1.wilson_action`` + autodiff."""
    n, b, lt, lx = 2, 4, 4, 6
    links, v0s, v1s, us = _rand_inputs(key, n, b, lt, lx)
    eps, beta, K = 0.08, 1.7, 4

    shape = u1.LatticeShape(lt, lx)
    pot = u1.make_potential_fn(shape)
    grad = jax.grad(lambda x: jnp.sum(beta * pot(x)))

    x = links.reshape(b, -1)

    def flat_v(v0, v1):
        return jnp.stack(
            [v0.reshape(b, lt, lx), v1.reshape(b, lt, lx)], axis=-1
        ).reshape(b, -1)

    plaqs_exp, probs_exp = [], []
    for i in range(n):
        v = flat_v(v0s[i], v1s[i])
        h0 = beta * pot(x) + 0.5 * jnp.sum(v * v, axis=1)
        y, w = x, v - 0.5 * eps * grad(x)
        for k in range(K):
            y = u1.wrap(y + eps * w)
            c = eps if k < K - 1 else 0.5 * eps
            w = w - c * grad(y)
        h1 = beta * pot(y) + 0.5 * jnp.sum(w * w, axis=1)
        prob = jnp.exp(jnp.minimum(h0 - h1, 0.0))
        acc = (us[i] < prob)[:, None]
        x = jnp.where(acc, y, x)
        probs_exp.append(prob)
        plaqs_exp.append(u1.avg_plaquette(x.reshape(b, lt, lx, 2)))

    out_r, plaq_r, chg_r, prob_r = hmc_chain_reference(
        links, v0s, v1s, us, eps=eps, beta=beta, num_leapfrog=K)
    np.testing.assert_allclose(out_r.reshape(b, -1), x, atol=1e-4)
    np.testing.assert_allclose(prob_r, jnp.stack(probs_exp), atol=1e-4)
    np.testing.assert_allclose(plaq_r, jnp.stack(plaqs_exp), atol=1e-4)




# ---------------------------------------------------------------------------
# Generator: Philox4x32-10 known answers (Random123's kat_vectors) and the
# moments of what the kernel draws.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, expected):
    out = leapfrog.philox4x32_10(np.array(counter, np.uint32), key)
    assert out.dtype == np.uint32
    assert tuple(int(x) for x in out) == expected


def test_uniform_open_is_exact_and_open():
    bits = np.array([0, 511, 512, 0xFFFFFFFF], np.uint32)
    u = leapfrog.uniform_open(bits)
    assert u.dtype == np.float32
    np.testing.assert_array_equal(
        u, np.array([1, 1, 3, 2 ** 24 - 1], np.float64) / 2 ** 24)
    assert np.all((u > 0) & (u < 1))


def test_philox_draws_moments():
    v0s, v1s, us, nus, uhs = leapfrog.philox_draws(
        (1234, 5678), num_transitions=8, num_chains=64, d=256)
    assert v0s.shape == v1s.shape == (8, 64, 256)
    assert us.shape == nus.shape == uhs.shape == (8, 64)
    v = np.concatenate([v0s.ravel(), v1s.ravel()]).astype(np.float64)
    n = v.size
    assert abs(v.mean()) < 5 / np.sqrt(n)
    assert abs(v.var() - 1.0) < 5 * np.sqrt(2.0 / n)
    assert abs(np.mean(v ** 4) - 3.0) < 0.1
    # the cos and sin halves of one Box-Muller pair are independent
    assert abs(np.mean(v0s * v1s)) < 5 / np.sqrt(v0s.size)
    for u in (us, uhs):
        assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)
    assert set(np.unique(nus)) == {-1.0, 1.0}
    assert abs(nus.mean()) < 5 / np.sqrt(nus.size)


def test_philox_draws_streams_are_distinct():
    """Counters differ by site, transition and chain; keys by seed."""
    a = leapfrog.philox_draws((1, 2), 2, 3, 16)[0]
    b = leapfrog.philox_draws((1, 3), 2, 3, 16)[0]
    assert not np.any(a == b)
    flat = a.reshape(-1)
    assert len(np.unique(flat)) == flat.size


# ---------------------------------------------------------------------------
# Launch geometry, shapes and argument checks of the CUDA call.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lt,lx,expected", [
    (16, 16, (256, 1, 4 * (3 * 256 + 128))),
    (64, 64, (1024, 4, 4 * (3 * 4096 + 128))),
    (6, 10, (64, 1, 4 * (3 * 60 + 128))),
    (32, 48, (1024, 2, 4 * (3 * 1536 + 128))),
    (128, 128, (1024, 16, 4 * (3 * 16384 + 128))),
])
def test_launch_config(lt, lx, expected):
    threads, spt, smem = leapfrog.launch_config(lt, lx)
    assert (threads, spt, smem) == expected
    assert threads % 32 == 0 and threads * spt >= lt * lx
    assert smem <= 232448


@pytest.mark.parametrize("lt,lx", [(256, 256), (160, 160)])
def test_oversized_lattice_is_refused(lt, lx, key):
    assert leapfrog.launch_config(lt, lx) is None
    assert not leapfrog.kernel_fits(lt, lx)
    with pytest.raises(ValueError, match="shared memory"):
        hmc_chain_cuda(jnp.zeros((2, lt, lx, 2)), key, 0.1, 4.0, 3, 2)


@pytest.mark.parametrize("b", [1, 33, 2048])
@pytest.mark.parametrize("hop", [False, True])
def test_cuda_call_shapes(b, hop, key):
    n = 7
    out = jax.eval_shape(
        lambda l, k: hmc_chain_cuda(l, k, 0.1, 4.0, 3, n, hop=hop),
        jax.ShapeDtypeStruct((b, 16, 16, 2), jnp.float32), key)
    assert out[0].shape == (b, 16, 16, 2)
    assert [o.shape for o in out[1:]] == [(n, b)] * 3
    assert all(o.dtype == jnp.float32 for o in out)


def test_injected_randomness_is_checked(key):
    n, b, lt, lx = 3, 4, 4, 4
    links, v0s, v1s, us = _rand_inputs(key, n, b, lt, lx)
    with pytest.raises(ValueError, match="hop=True"):
        hmc_chain_cuda(links, key, 0.1, 2.0, 3, n,
                       rand_arrays=(v0s, v1s, us), hop=True)
    with pytest.raises(ValueError, match="rand_arrays"):
        hmc_chain_cuda(links, key, 0.1, 2.0, 3, n + 1,
                       rand_arrays=(v0s, v1s, us))


def test_kernel_scalars_round_like_the_reference():
    """The hop constants the kernel receives are the float32 values that
    _hop_math and _winding_flat compute with."""
    lt, lx = 6, 10
    d = lt * lx
    scal = np.asarray(leapfrog._kernel_scalars(0.08, 4.0, d, lt))
    cd, sd = np.cos(2 * np.pi / d), np.sin(2 * np.pi / d)
    np.testing.assert_array_equal(scal[:2], np.float32([0.08, 4.0]))
    np.testing.assert_array_equal(
        scal[2:5], np.float32([cd, sd, 1.0 - cd]))
    w0f, w1f = leapfrog._winding_flat(1, d, lt, lx)
    t = np.arange(d) // lx
    s = np.arange(d) % lx
    np.testing.assert_array_equal(np.asarray(w1f)[0],
                                  np.float32(scal[5]) * t.astype(np.float32))
    seam = np.where(t == lt - 1, scal[6] * s.astype(np.float32), 0.0)
    np.testing.assert_array_equal(np.asarray(w0f)[0], seam.astype(np.float32))


# ---------------------------------------------------------------------------
# Dispatch of hmc_chain_u1_fused.
# ---------------------------------------------------------------------------


def _lowered(fn, args, platform=None):
    traced = jax.jit(fn).trace(*args)
    lowered = (traced.lower(lowering_platforms=(platform,)) if platform
               else traced.lower())
    return lowered.as_text()


@pytest.mark.parametrize("hop", [False, True])
def test_fused_chain_lowers_to_kernel_for_cuda_only(hop, key):
    fn = functools.partial(hmc_chain_u1_fused, eps=0.08, beta=4.0,
                           num_leapfrog=5, num_samples=10, hop=hop)
    args = (jnp.zeros((33, 16, 16, 2)), key)
    cuda = _lowered(fn, args, "cuda")
    assert "custom_call @l2hmc_u1_chain_philox" in cuda
    assert f"hop = {int(hop)} : i64" in cuda
    assert "threads = 256 : i64" in cuda
    assert "l2hmc_u1_chain" not in _lowered(fn, args)


def test_fused_chain_too_large_for_a_block_stays_on_xla(key):
    fn = functools.partial(hmc_chain_u1_fused, eps=0.08, beta=4.0,
                           num_leapfrog=2, num_samples=2)
    cuda = _lowered(fn, (jax.ShapeDtypeStruct((2, 256, 256, 2), jnp.float32),
                         key), "cuda")
    assert "l2hmc_u1_chain" not in cuda


@pytest.mark.parametrize("hop", [False, True])
def test_fused_chain_xla_path_samples_the_oracle(hop, key):
    """The CPU path of hmc_chain_u1_fused (the XLA scan) on the exact
    plaquette; with the hop, the charge moves every few transitions."""
    b, lt, lx, beta, n = 64, 8, 8, 2.0, 300
    out, plaqs, chgs, probs = jax.jit(
        lambda l, k: hmc_chain_u1_fused(l, k, 0.15, beta, 4, n, hop=hop))(
            jnp.zeros((b, lt, lx, 2)), key)
    assert out.shape == (b, lt, lx, 2)
    assert bool(jnp.all(jnp.abs(out) <= np.pi + 1e-5))
    per_chain = np.asarray(plaqs)[100:].mean(axis=0)
    err = per_chain.std(ddof=1) / np.sqrt(b)
    exact = float(u1.u1_plaq_exact(beta))
    assert abs(per_chain.mean() - exact) < 5 * err + 0.01, (per_chain.mean(), exact)
    assert float(np.mean(probs)) > 0.6
    np.testing.assert_array_equal(np.asarray(chgs), np.round(chgs))
    # the traces are those of the returned chain
    np.testing.assert_allclose(np.asarray(plaqs)[-1],
                               np.asarray(u1.avg_plaquette(out)), atol=1e-5)
    if hop:
        assert np.mean(np.diff(np.asarray(chgs), axis=0) != 0) > 0.05


def test_fused_chain_is_the_xla_scan_on_cpu(key):
    links = jax.random.uniform(key, (8, 6, 6, 2), minval=-np.pi, maxval=np.pi)
    a = hmc_chain_u1_fused(links, key, 0.1, 3.0, 3, 5)
    b = hmc_chain_u1_xla(links, key, 0.1, 3.0, 3, 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_hop_twin_carried_fields_match_recomputation(key):
    """The hop's closed-form field rotations (sin'/cos'/pot'/chg') must
    equal a fresh plaquette-field evaluation of the shifted state —
    otherwise subsequent transitions run on a corrupted carry."""
    from l2hmc.ops.leapfrog import (
        _hop_math, _potential_fields, _winding_flat,
    )

    b, lt, lx = 8, 4, 6
    d = lt * lx
    links = jax.random.uniform(key, (b, lt, lx, 2), minval=-np.pi,
                               maxval=np.pi)
    x0 = links[..., 0].reshape(b, d)
    x1 = links[..., 1].reshape(b, d)
    s_col = (jax.lax.broadcasted_iota(jnp.int32, (b, d), 1) % lx)
    roll = functools.partial(jnp.roll, axis=1)
    pot, sinp, cosp, chg = _potential_fields(x0, x1, lx, s_col, roll)
    nu = jnp.array([1.0, -1.0] * 4)
    uh = jnp.zeros((b,))            # force accept
    w0f, w1f = _winding_flat(b, d, lt, lx)
    x0n, x1n, prob, potn, sinpn, cospn, chgn = _hop_math(
        x0, x1, pot, sinp, cosp, chg, nu, uh, 0.0, w0f, w1f)
    pot2, sinp2, cosp2, chg2 = _potential_fields(x0n, x1n, lx, s_col, roll)
    np.testing.assert_allclose(potn, pot2, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sinpn, sinp2, atol=1e-5)
    np.testing.assert_allclose(cospn, cosp2, atol=1e-5)
    np.testing.assert_allclose(chgn, chg2, atol=1e-3)


def test_winding_flat_matches_topo_module():
    from l2hmc.dynamics import topo
    from l2hmc.ops.leapfrog import _winding_flat

    lt, lx = 6, 4
    shape = u1.LatticeShape(lt, lx)
    w = np.asarray(topo.winding_field(shape, 1)).reshape(lt, lx, 2)
    w0f, w1f = _winding_flat(1, lt * lx, lt, lx)
    np.testing.assert_allclose(np.asarray(w0f).reshape(lt, lx), w[..., 0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(w1f).reshape(lt, lx), w[..., 1],
                               atol=1e-6)
