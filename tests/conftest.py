"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip sharding paths are validated the way SURVEY §4/§7 directs —
``xla_force_host_platform_device_count`` CPU devices — so the suite runs
anywhere.  The platform is set in ``pytest_configure``, before any test
module touches a device.  A run that selects only the ``chip`` tests
(``-m chip``, as ``chip_smoke.py`` does inside its own JAX process) leaves
the platform alone, so those tests see the card.
"""

import os

import jax
import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "") == "chip":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # jax read JAX_PLATFORMS when it was imported; set the live config too
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def key():
    return jax.random.PRNGKey(42)


# ---------------------------------------------------------------------------
# Test tiers.  The full suite takes ~20 min (long-chain detailed-balance,
# training, and SU(N) trajectory tests dominate); the default tier keeps the
# edit-test loop under ~5 min.  Membership below is the measured >=8s set
# (pytest --durations); run EVERYTHING with `pytest -m ""`.
# ---------------------------------------------------------------------------

SLOW_TESTS = {
    "test_4d_su2_hmc_strong_coupling", "test_4d_su3_improved_hmc_runs",
    "test_checkpoint_roundtrip", "test_config5_script_end_to_end",
    "test_eps_dual_averaging_warmup", "test_eps_fixed_training_freezes_eps",
    "test_forward_kl_training_raises_likelihood",
    "test_full_transition_domain_sharded_matches_replicated",
    "test_gauge_improved_action_trains", "test_gauge_invariance_4d",
    "test_gauge_train_chunk_runs_and_improves", "test_gmm_arrangements",
    "test_hybrid_chain_stationary_on_oracle", "test_identity_at_init",
    "test_independence_mh_uniform_target_accepts_everything",
    "test_inverse_roundtrip_and_density",
    "test_logdet_matches_autodiff_jacobian_depth2",
    "test_logq_of_gradient_matches_finite_differences",
    "test_loss_z_term_parity_modes", "test_lrn_variant",
    "test_pair_group_ops_match_complex", "test_pair_hmc_shards_over_chain_axis",
    "test_pair_hmc_trajectory_matches_complex",
    "test_pair_representation_matches_complex", "test_pair_training_step_runs",
    "test_plaq_metric_loss", "test_posterior_sampler_conditions_on_data",
    "test_random_lf_composition_trains", "test_reverse_kl_training_improves_ess",
    "test_reversibility_and_logdet_antisymmetry",
    "test_reweighted_plaquette_on_oracle", "test_scg_trained_sampler_vs_hmc_ess",
    "test_scg_training_beats_initial_loss", "test_sharded_scan_chunk",
    "test_sharded_training_matches_single_device", "test_su3_energy_conservation",
    "test_su3_hmc_matches_exact_plaquette", "test_temperature_annealing_path",
    "test_topological_susceptibility_exact_oracle",
    "test_train_hops_moves_training_chain_sectors",
    "test_training_beats_hmc_mixing",
    "test_composite_chain_stationary_on_oracles",
    "test_pt_rungs_stationary_on_oracles", "test_local_net_trains_on_gauge",
    "test_hop_acceptance_rises_with_volume",
    "test_u1_kernel_detailed_balance_vs_metropolis",
    "test_u1_logdet_matches_autodiff", "test_vae_cli_smoke",
    "test_vae_training_improves_elbo",
}


def pytest_collection_modifyitems(config, items):
    matched = set()
    for item in items:
        base = item.name.split("[")[0]
        if base in SLOW_TESTS:
            matched.add(base)
            item.add_marker(pytest.mark.slow)
    # Guard: a renamed slow test would silently fall back into
    # the fast tier; fail collection loudly when the registry drifts.
    # Only enforced on full-directory collection — single-file/-k runs
    # legitimately see a subset.
    if len(items) > 150:
        stale = SLOW_TESTS - matched
        if stale:
            raise pytest.UsageError(
                f"tests/conftest.py SLOW_TESTS entries match no collected "
                f"test (renamed or removed?): {sorted(stale)}")
