"""Tests for the statistics module against analytic AR(1) autocorrelation."""

import numpy as np
import pytest

from l2hmc.analysis import stats


def ar1(n, rho, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(n)
    e = rng.normal(size=n) * np.sqrt(1 - rho**2)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    return x


def test_autocorr_ar1():
    rho = 0.8
    x = ar1(200_000, rho)
    acf = stats.autocorr_fft(x)
    np.testing.assert_allclose(acf[1], rho, atol=0.02)
    np.testing.assert_allclose(acf[3], rho**3, atol=0.03)


def test_ess_ar1():
    """ESS of AR(1): 1/(1 + 2 sum rho^k) = (1-rho)/(1+rho)."""
    rho = 0.6
    x = ar1(200_000, rho)
    ess = stats.calc_ess(x)
    expected = (1 - rho) / (1 + rho)
    np.testing.assert_allclose(ess, expected, rtol=0.15)


def test_ess_iid():
    x = np.random.default_rng(1).normal(size=50_000)
    assert stats.calc_ess(x) > 0.8


def test_batch_means_ess_ar1():
    """Batch-means ESS on AR(1) matches the analytic T*(1-rho)/(1+rho)."""
    rho = 0.9
    n = 400_000
    x = ar1(n, rho)
    ess = stats.batch_means_ess(x, num_batches=100)
    expected = n * (1 - rho) / (1 + rho)
    np.testing.assert_allclose(ess, expected, rtol=0.3)


def test_batch_means_ess_iid_and_edges():
    x = np.random.default_rng(4).normal(size=20_000)
    ess = stats.batch_means_ess(x, num_batches=50)
    assert ess > 0.5 * len(x)
    # degenerate inputs stay finite and bounded
    assert stats.batch_means_ess(np.ones(100)) == 100.0
    assert stats.batch_means_ess(np.arange(3.0)) == 3.0


def test_integrated_time_ar1():
    """tau_int of AR(1) = (1+rho)/(1-rho)."""
    rho = 0.7
    x = ar1(400_000, rho)
    tau, reliable = stats.integrated_time(x)
    assert reliable
    np.testing.assert_allclose(tau, (1 + rho) / (1 - rho), rtol=0.15)


def test_jackknife_mean_err():
    rng = np.random.default_rng(2)
    x = rng.normal(loc=3.0, scale=2.0, size=10_000)
    mean, err = stats.jackknife(x, num_blocks=20)
    np.testing.assert_allclose(mean, 3.0, atol=0.1)
    # error should approximate sigma/sqrt(n)
    np.testing.assert_allclose(err, 2.0 / np.sqrt(10_000), rtol=0.5)


def test_sem():
    x = np.random.default_rng(3).normal(size=40_000)
    np.testing.assert_allclose(stats.sem(x), 1.0 / np.sqrt(40_000), rtol=0.1)


def test_tunneling_rate():
    means = np.array([[-2.0, 0.0], [2.0, 0.0]])
    # trajectory hopping every step
    traj = np.array([[-2.0, 0], [2.0, 0], [-2.0, 0], [2.0, 0]])
    assert stats.tunneling_rate(traj, means) == 1.0
    # no hops
    traj2 = np.tile([[-2.0, 0.0]], (10, 1))
    assert stats.tunneling_rate(traj2, means) == 0.0


def test_charge_histogram_and_stats():
    charges = np.array([[0, 1, -1, 0], [0, 0, 1, 1]]).T
    h = stats.charge_histogram(charges)
    assert h[0] == 4 and h[1] == 3 and h[-1] == 1
    m = stats.observables_stats({"charges": charges.astype(float)}, therm_frac=0.0)
    np.testing.assert_allclose(m["charges"]["susceptibility"], np.mean(charges**2))


def test_therm_cut():
    x = np.arange(100)
    assert len(stats.therm_cut(x, 0.25)) == 75


def ar1_batch(t, c, rho, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((t, c))
    x[0] = rng.normal(size=c)
    e = rng.normal(size=(t, c)) * np.sqrt(1 - rho**2)
    for i in range(1, t):
        x[i] = rho * x[i - 1] + e[i]
    return x


def test_pooled_integrated_time_short_chains():
    """Pooled tau_int recovers the analytic AR(1) tau where a single
    short trace is unreliable (the 32x32 Q regime)."""
    rho = 0.9
    tau_exact = (1 + rho) / (1 - rho)          # 19.0
    x = ar1_batch(400, 512, rho, seed=1)
    tau, reliable = stats.pooled_integrated_time(x)
    assert reliable
    assert abs(tau - tau_exact) / tau_exact < 0.12
    # single 400-step trace at tau=19: tol*tau = 950 > 400 -> unreliable
    _, single_ok = stats.integrated_time(x[:, 0])
    assert not single_ok


def test_pooled_matches_single_chain_limit():
    rho = 0.6
    x = ar1(200_000, rho)
    tau_pooled, ok = stats.pooled_integrated_time(x)
    tau_single, _ = stats.integrated_time(x)
    assert ok
    assert abs(tau_pooled - tau_single) / tau_single < 0.05


def test_pooled_ess_iid():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 128))
    assert stats.pooled_ess(x) > 0.8          # iid -> tau ~ 1
    tau, ok = stats.pooled_integrated_time(x)
    assert ok and tau < 1.3
