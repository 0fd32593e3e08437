"""Parallel-tempering tests: swap mechanics and per-rung exactness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.dynamics import tempering
from l2hmc.dynamics.hmc import hmc_chain
from l2hmc.lattice import u1

SHAPE = u1.LatticeShape(8, 8)
POT = u1.make_potential_fn(SHAPE)


def test_ptconfig_validation():
    with pytest.raises(ValueError):
        tempering.PTConfig(betas=(1.0, 2.0), eps=(0.1, 0.1))  # ascending
    with pytest.raises(ValueError):
        tempering.PTConfig(betas=(2.0, 1.0), eps=(0.1,))      # length


def test_swap_preserves_config_multiset(key):
    """Swapping only permutes configs between rungs — the union of states
    after the swap phase equals the union after the local phase applied
    alone (checked via sorted per-chain action values)."""
    cfg = tempering.PTConfig(betas=(2.0, 1.5, 1.0), eps=(0.1, 0.12, 0.15),
                             num_steps=3)
    x = u1.random_links(key, 3 * 8, SHAPE).reshape(3, 8, SHAPE.num_links)
    out = tempering.pt_transition(POT, x, cfg, key, parity=jnp.asarray(0))
    # rerun with a swap-suppressing ladder (identical betas -> d_beta = 0
    # -> log_alpha = 0 -> always accept; instead compare action multisets)
    u_after = np.sort(np.asarray(POT(out.x.reshape(-1, SHAPE.num_links))))
    # reconstruct the unswapped local output by inverting the swap
    x_unswapped = np.asarray(out.x).copy()
    sw = np.asarray(out.swap_mask)
    for i in range(2):
        m = sw[i].astype(bool)
        a, b = x_unswapped[i].copy(), x_unswapped[i + 1].copy()
        x_unswapped[i][m], x_unswapped[i + 1][m] = b[m], a[m]
    u_before = np.sort(np.asarray(POT(
        x_unswapped.reshape(-1, SHAPE.num_links))))
    np.testing.assert_allclose(u_after, u_before, rtol=1e-6)


def test_equal_betas_always_swap(key):
    cfg = tempering.PTConfig(betas=(2.0, 2.0), eps=(0.1, 0.1), num_steps=2)
    x = u1.random_links(key, 2 * 16, SHAPE).reshape(2, 16, SHAPE.num_links)
    out = tempering.pt_transition(POT, x, cfg, key, parity=jnp.asarray(0))
    assert float(out.swap_prob.min()) == 1.0          # d_beta = 0
    assert float(out.swap_mask.mean()) == 1.0


def test_off_parity_pairs_never_swap(key):
    cfg = tempering.PTConfig(betas=(2.0, 1.5, 1.0), eps=(0.1, 0.1, 0.1),
                             num_steps=2)
    x = u1.random_links(key, 3 * 8, SHAPE).reshape(3, 8, SHAPE.num_links)
    out = tempering.pt_transition(POT, x, cfg, key, parity=jnp.asarray(1))
    # parity 1 -> only pair (1,2) active; pair (0,1) must be frozen
    assert float(out.swap_prob[0].max()) == 0.0
    assert float(out.swap_mask[0].max()) == 0.0


def test_pt_rungs_stationary_on_oracles(key):
    """Every rung holds ITS OWN plaquette oracle under swaps, and the
    target rung reproduces the exact <Q^2> — replica exchange is exact,
    not just the local kernel."""
    betas = (2.0, 1.5, 1.0)
    cfg = tempering.PTConfig(betas=betas, eps=(0.15, 0.17, 0.2), num_steps=5)
    c = 64
    # equilibrate each rung independently first
    rungs = []
    for i, b in enumerate(betas):
        x0 = u1.random_links(jax.random.fold_in(key, i), c, SHAPE)
        xs, _ = hmc_chain(POT, x0, b, jax.random.fold_in(key, 10 + i),
                          cfg.eps[i], 5, 300, wrap_fn=u1.wrap)
        rungs.append(xs[-1])
    x = jnp.stack(rungs)

    def obs(x0):
        o = u1.observables(x0, SHAPE)
        return {"plaqs": o["plaqs"], "charges": o["charges"]}

    chunk = tempering.make_pt_chunk(POT, cfg, 400, wrap_fn=u1.wrap,
                                    observables_fn=obs)
    x, m = chunk(x, jax.random.fold_in(key, 99), jnp.asarray(0))
    # swaps actually happen
    assert float(np.asarray(m["swap_rate"]).mean()) > 0.05
    # measure per-rung plaquettes over a second chunk (first = extra therm)
    x, m = chunk(x, jax.random.fold_in(key, 100), jnp.asarray(0))
    plaq0 = float(np.asarray(m["plaqs"]).mean())
    assert abs(plaq0 - float(u1.u1_plaq_exact(betas[0]))) < 5e-3
    # final-state per-rung plaquette against each oracle
    for i, b in enumerate(betas):
        pi = float(u1.avg_plaquette(u1.to_links(x[i], SHAPE)).mean())
        assert abs(pi - float(u1.u1_plaq_exact(b))) < 2e-2, (i, b, pi)
    q = np.asarray(m["charges"])
    q2 = float((q ** 2).mean())
    q2_exact = u1.topological_susceptibility_exact(
        betas[0], SHAPE.num_plaquettes)
    assert abs(q2 - q2_exact) / q2_exact < 0.15
