"""Whole-chain CUDA kernel (ops/u1_chain.cu) against its plain reference.

These tests need a CUDA device: they are marked ``chip`` and skip
elsewhere.  ``python chip_smoke.py`` runs them on the card.

Tolerances.  The kernel does no matrix product, so it differs from
:func:`hmc_chain_reference` only in summation order and in the last bit of
sin, cos, exp and floor (both are compiled without fast math).  Hence:

- links, compared on the circle (``wrap(kernel - reference)``), to 1e-4:
  rounding differences of ~1e-7 grow through K leapfrog steps and N
  transitions, and an angle that lands within rounding of +-pi may wrap to
  the other side;
- plaquette traces to rtol 1e-5 (atol 1e-6): a sum of D terms of size <= 2
  in float32 carries ~D * 2^-24 of absolute error, i.e. ~1e-7 of the mean;
- acceptance probabilities to ``8 * 2^-24 * H``: ``exp(dH)`` inherits the
  rounding of the two Hamiltonians, each a float32 sum of magnitude
  ``H = beta * pot + ke`` (~8e3 at 64x64), so the error in ``dH`` scales
  with ``H``, not with ``dH``, and a fixed 1e-5 cannot hold at 64x64;
- accept decisions identical, except for chains where ``|u - p|`` is
  within that tolerance (or 1e-5) at some transition: there the two
  roundings may decide differently, and the chain is left out of the
  comparison from then on (at most 5% of the chains);
- charges (rounded to sectors) identical on the compared chains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.lattice import u1
from l2hmc.ops.leapfrog import (
    hmc_chain_cuda, hmc_chain_reference, philox_draws,
)

pytestmark = pytest.mark.chip

_U = 2.0 ** -24


@pytest.fixture
def cuda_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA device; run `python chip_smoke.py` on one")
    return dev


def _inputs(key, n, b, lt, lx, hop):
    k = jax.random.split(key, 6)
    # near equilibrium at beta=4 (plaquette ~0.86) so that accepts and
    # rejects both occur
    links = u1.wrap(0.35 * jax.random.normal(k[0], (b, lt, lx, 2)))
    v0s = jax.random.normal(k[1], (n, b, lt * lx))
    v1s = jax.random.normal(k[2], (n, b, lt * lx))
    us = jax.random.uniform(k[3], (n, b))
    rand = (v0s, v1s, us)
    if hop:
        rand += (jax.random.rademacher(k[4], (n, b)).astype(jnp.float32),
                 jax.random.uniform(k[5], (n, b)))
    return links, rand


def compare_with_reference(lt, lx, b, n=4, hop=False, eps=0.08, beta=4.0,
                           num_leapfrog=5, seed=0, generator=False):
    """Run kernel and reference on the same randomness; assert the
    tolerances above and return the largest deviations seen.

    The randomness is injected into both, or with ``generator=True``
    drawn by the kernel's Philox and given to the reference from the numpy
    model of it (``philox_draws``), which checks the generator's bits."""
    key = jax.random.PRNGKey(seed)
    links, rand = _inputs(key, n, b, lt, lx, hop)
    if generator:
        seed_words = np.asarray(jax.random.bits(key, (2,), jnp.uint32))
        draws = philox_draws(seed_words, n, b, lt * lx)
        rand = tuple(jnp.asarray(a) for a in (draws if hop else draws[:3]))
    kern = jax.jit(lambda l, r: hmc_chain_cuda(
        l, key, eps, beta, num_leapfrog, n,
        rand_arrays=None if generator else r, hop=hop))
    ref = jax.jit(lambda l, r: hmc_chain_reference(
        l, r[0], r[1], r[2], eps, beta, num_leapfrog,
        hop_arrays=r[3:] if hop else None))
    out_k, plaq_k, chg_k, prob_k = (np.asarray(a) for a in kern(links, rand))
    out_r, plaq_r, chg_r, prob_r = (np.asarray(a) for a in ref(links, rand))
    d = lt * lx
    v0s, v1s, us = (np.asarray(a, np.float64) for a in rand[:3])
    ke = 0.5 * (np.sum(v0s ** 2, axis=-1) + np.sum(v1s ** 2, axis=-1))
    h_scale = beta * d * (1.0 - plaq_r) + ke
    tol_p = 8 * _U * h_scale
    tie = np.abs(us - prob_r) < np.maximum(tol_p, 1e-5)
    # leave a chain out from its first near-tie on
    live = ~np.cumsum(tie, axis=0).astype(bool)
    ok_chain = live.all(axis=0)
    dp = np.abs(prob_k - prob_r)
    dlink = np.abs(np.asarray(u1.wrap(jnp.asarray(out_k - out_r))))[ok_chain]
    stats = {
        "shape": f"{lt}x{lx}", "chains": b, "transitions": n, "hop": hop,
        "accept_rate": float(np.mean(us < prob_r)),
        "chains_left_out": int((~ok_chain).sum()),
        "max_link_diff": float(dlink.max()),
        "max_plaq_rel_diff": float(np.max(
            np.abs(plaq_k - plaq_r)[live] / np.abs(plaq_r[live]))),
        "max_prob_diff_over_tol": float(np.max(dp[live] / tol_p[live])),
        "decisions_differ": int(np.sum(
            ((us < prob_k) != (us < prob_r))[live])),
    }
    print(stats)
    assert ok_chain.mean() >= 0.95, f"{(~ok_chain).sum()} chains near a tie"
    assert stats["decisions_differ"] == 0
    assert np.all(dp[live] <= tol_p[live]), stats
    np.testing.assert_allclose(plaq_k[live], plaq_r[live], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(chg_k[live], chg_r[live])
    assert dlink.max() <= 1e-4, stats
    return stats


@pytest.mark.parametrize("hop", [False, True], ids=["hmc", "hop"])
@pytest.mark.parametrize("lt,lx,b", [(16, 16, 2048), (64, 64, 512),
                                     (6, 10, 33)])
def test_kernel_matches_reference(cuda_device, lt, lx, b, hop):
    compare_with_reference(lt, lx, b, hop=hop)


@pytest.mark.parametrize("hop", [False, True], ids=["hmc", "hop"])
def test_generator_matches_numpy_model(cuda_device, hop):
    """The kernel's own Philox draws are the numpy model's: fed to the
    reference, they reproduce the kernel's chain."""
    compare_with_reference(16, 16, 64, n=3, hop=hop, generator=True)


def test_dispatch_lowers_to_the_kernel(cuda_device):
    """On the card ``hmc_chain_u1_fused`` compiles to the kernel's custom
    call, so no fallback to the XLA scan can hide."""
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused

    links = jnp.zeros((64, 16, 16, 2))
    for hop in (False, True):
        hlo = jax.jit(lambda l, k: hmc_chain_u1_fused(
            l, k, 0.08, 4.0, 5, 10, hop=hop)).lower(
                links, jax.random.PRNGKey(0)).compile().as_text()
        assert "l2hmc_u1_chain_philox" in hlo
