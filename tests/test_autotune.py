"""Auto-tuner (train/autotune.py) — joint (K, eps) search tests.

Validation of the full-size search against the hand-swept champion needs
the device; these tests check the mechanism on
a small lattice: DA lands eps in a sane band, every (K, eps-grid) cell is
probed and scored, and the trained-kernel search anchors its eps grid at
lambda* = K*eps*.
"""

import dataclasses

import jax
import numpy as np
import pytest

from l2hmc.train.autotune import TuneResult, _lag1_ess, tune_hmc, tune_l2hmc
from l2hmc.train.gauge import GaugeConfig, init_train_state
from l2hmc.lattice import u1


@pytest.fixture(scope="module")
def base_cfg():
    return GaugeConfig(time_size=4, space_size=4, num_chains=32, num_steps=3,
                       network_arch="mlp", num_hidden=16, eps_init=0.2,
                       beta_init=2.0, beta_final=2.0, train_steps=300)


def test_lag1_ess_ranks_mixing():
    rng = np.random.default_rng(0)
    white = rng.normal(size=(400, 8))
    ar = np.zeros((400, 8))
    for t in range(1, 400):
        ar[t] = 0.9 * ar[t - 1] + rng.normal(size=8)
    assert _lag1_ess(white) > 5 * _lag1_ess(ar)
    assert 0.8 < _lag1_ess(white) <= 1.3


@pytest.mark.slow
def test_tune_hmc_small(base_cfg):
    key = jax.random.PRNGKey(0)
    x = u1.random_links(key, base_cfg.num_chains, base_cfg.shape)
    res = tune_hmc(base_cfg, x, beta=2.0, key=key, k_grid=(2, 4),
                   da_steps=80, probe_steps=200, target_accept=0.75,
                   eps_grid=(0.9, 1.1), estimator="lag1")
    assert isinstance(res, TuneResult)
    assert res.num_steps in (2, 4) and res.eps > 0
    assert len(res.cells) == 4          # 2 K x 2 eps multipliers
    # DA drives acceptance to a sane band; the eps grid brackets it
    for c in res.cells:
        assert 0.3 < c["accept"] <= 1.0, c
        assert np.isfinite(c["score"]) and c["score"] >= 0
    by_k = {}
    for c in res.cells:
        by_k.setdefault(c["K"], []).append(c["eps"])
    # within each K the two eps cells keep the grid ratio (cells round
    # eps to 5 decimals)
    for k, eps_list in by_k.items():
        lo, hi = sorted(eps_list)
        np.testing.assert_allclose(hi / lo, 1.1 / 0.9, rtol=1e-3)


@pytest.mark.slow
def test_tune_l2hmc_anchors_at_hmc_trajectory(base_cfg):
    key = jax.random.PRNGKey(1)
    hmc_opt = TuneResult(num_steps=4, eps=0.2, score=1.0, accept=0.8,
                         cells=())
    res = tune_l2hmc(base_cfg, key, hmc_opt, k_grid=(2, 4),
                     probe_train_steps=250, probe_steps=200,
                     eps_grid=(1.0, 1.2), estimator="lag1")
    assert res.num_steps in (2, 4)
    assert len(res.cells) == 4
    by_k = {}
    for c in res.cells:
        by_k.setdefault(c["K"], []).append(c["eps"])
    # eps grids anchored at lambda*/K = 0.8/K
    np.testing.assert_allclose(sorted(by_k[2]), [0.4, 0.48], rtol=1e-5)
    np.testing.assert_allclose(sorted(by_k[4]), [0.2, 0.24], rtol=1e-5)
    for c in res.cells:
        assert np.isfinite(c["score"]) and c["score"] >= 0
