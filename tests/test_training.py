"""End-to-end training tests: the SCGExperiment equivalent (BASELINE.json
config 1) and the U(1) gauge slice, kept small enough for CPU CI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.analysis import stats
from l2hmc.lattice import u1
from l2hmc.targets import scg_2d, gmm_axes
from l2hmc.train.gauge import (
    GaugeConfig,
    init_train_state,
    make_eval_chunk,
    make_train_chunk,
)
from l2hmc.train.sampler import (
    SamplerConfig,
    init_sampler_state,
    make_sample_chain,
    make_sampler_train_chunk,
)
from l2hmc.dynamics.hmc import hmc_chain


def test_scg_training_beats_initial_loss(key):
    """Train L2HMC on the 2-D strongly-correlated Gaussian: loss must drop
    and acceptance must stay healthy."""
    target = scg_2d()
    cfg = SamplerConfig(x_dim=2, num_chains=64, num_steps=5, eps_init=0.1,
                        num_hidden=16, train_steps=200)
    state = init_sampler_state(cfg, target.energy, key)
    chunk = make_sampler_train_chunk(cfg, target.energy, 50)

    first10 = None
    losses = []
    for i in range(4):
        key, sub = jax.random.split(key)
        state, m = chunk(state, sub)
        if first10 is None:
            first10 = float(m["loss"][:10].mean())
        losses.append(float(m["loss"].mean()))
    assert np.all(np.isfinite(losses)), f"loss went non-finite: {losses}"
    assert losses[-1] < first10, f"loss did not improve: {first10} -> {losses}"
    assert float(m["accept_prob"].mean()) > 0.2
    # NaN-guards: params and chain state stay finite for the whole run
    assert all(
        bool(jnp.all(jnp.isfinite(l)))
        for l in jax.tree_util.tree_leaves((state.params, state.x))
    )


def test_scg_trained_sampler_vs_hmc_ess(key):
    """The trained sampler should traverse the ill-conditioned Gaussian
    faster than step-size-limited HMC (the paper's headline result).
    We compare ESS along the stiff-to-slow principal axis."""
    target = scg_2d()
    cfg = SamplerConfig(x_dim=2, num_chains=32, num_steps=10, eps_init=0.1,
                        num_hidden=32, train_steps=600, lr_init=3e-3)
    state = init_sampler_state(cfg, target.energy, key)
    chunk = make_sampler_train_chunk(cfg, target.energy, 100)
    for i in range(6):
        key, sub = jax.random.split(key)
        state, m = chunk(state, sub)

    # sample both
    n = 400
    x0 = jnp.zeros((32, 2))
    sample = make_sample_chain(cfg, target.energy)
    xs, probs = sample(state.params, x0, jax.random.fold_in(key, 1), n)
    # HMC with small eps (stability-limited by the stiff direction:
    # sqrt(lambda_min)=0.1 => eps ~ 0.1)
    xs_hmc, probs_hmc = hmc_chain(
        target.energy, x0, 1.0, jax.random.fold_in(key, 2), 0.1, 10, n
    )

    # project on the slow principal axis (variance 100 direction)
    evals, evecs = np.linalg.eigh(np.asarray(target.sigma))
    slow = evecs[:, -1]
    proj = np.asarray(xs) @ slow        # (T, chains)
    proj_hmc = np.asarray(xs_hmc) @ slow

    ess = np.mean([stats.calc_ess(proj[:, c]) for c in range(8)])
    ess_hmc = np.mean([stats.calc_ess(proj_hmc[:, c]) for c in range(8)])
    assert ess > ess_hmc, f"L2HMC ESS {ess:.4f} <= HMC ESS {ess_hmc:.4f}"


def test_temperature_annealing_path(key):
    """MoG training with annealing: temperature decays toward 1."""
    target = gmm_axes(dim=2, sep=2.0, var=0.1)
    cfg = SamplerConfig(x_dim=2, num_chains=32, num_steps=5, num_hidden=16,
                        use_annealing=True, temp_init=5.0,
                        annealing_steps=10, annealing_factor=0.9)
    state = init_sampler_state(cfg, target.energy, key)
    chunk = make_sampler_train_chunk(cfg, target.energy, 100)
    state, m = chunk(state, key)
    t_end = float(state.temp.temperature)
    assert t_end < 5.0
    assert t_end >= 1.0


def test_gauge_train_chunk_runs_and_improves(key):
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=32, num_steps=2,
                      network_arch="mlp", num_hidden=32, train_steps=150,
                      beta_init=2.0, beta_final=2.0)
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 75)
    state, m1 = chunk(state, jax.random.fold_in(key, 1))
    state, m2 = chunk(state, jax.random.fold_in(key, 2))
    assert float(m2["loss"].mean()) < float(m1["loss"].mean())
    assert np.all(np.isfinite(np.asarray(m2["loss"])))
    # chain state stays wrapped
    assert float(jnp.max(jnp.abs(state.x))) <= np.pi + 1e-5


def test_train_hops_moves_training_chain_sectors(key):
    """train_hops=True interleaves the exact instanton hop into the
    training chain: the chain must visit multiple Q sectors where the
    plain L2HMC training chain at the same (tiny) depth barely tunnels,
    and the hop must keep states wrapped/finite (the beta>=5
    frozen-training-distribution fix)."""
    base = GaugeConfig(time_size=4, space_size=4, num_chains=32, num_steps=2,
                       network_arch="mlp", num_hidden=16, train_steps=60,
                       beta_init=2.0, beta_final=2.0)
    charges = {}
    for hops in (False, True):
        cfg = dataclasses.replace(base, train_hops=hops)
        state = init_train_state(cfg, key)
        chunk = make_train_chunk(cfg, 30)
        kk = key
        qs = []
        for i in range(2):
            kk, sub = jax.random.split(kk)
            state, m = chunk(state, sub)
            qs.append(np.asarray(m["charges2"]))
        assert np.all(np.isfinite(np.concatenate(qs)))
        assert float(jnp.max(jnp.abs(state.x))) <= np.pi + 1e-5
        charges[hops] = float(np.concatenate(qs).mean())
    # the hop-augmented chain occupies nonzero sectors (mean Q^2 > 0.05);
    # at 4x4 beta=2 the hop accepts ~50%+ so sector spread is immediate
    assert charges[True] > 0.05


def test_grad_summaries_in_metrics(key):
    """grad_summaries=True surfaces per-variable param/grad stats in the
    train-step metrics (reference gauge_model.py:853-886 parity)."""
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=8, num_steps=2,
                      network_arch="mlp", num_hidden=16, train_steps=10,
                      beta_init=2.0, beta_final=2.0, grad_summaries=True)
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 2)
    _, m = chunk(state, jax.random.fold_in(key, 1))
    grad_keys = [k for k in m if k.startswith("grads/")]
    param_keys = [k for k in m if k.startswith("params/")]
    assert "grads/global_norm" in m
    # every xnet/vnet leaf gets all five stats
    assert any("xnet" in k and k.endswith("/l2") for k in grad_keys)
    assert any("vnet" in k and k.endswith("/stddev") for k in param_keys)
    for k in ("grads/global_norm",) + tuple(grad_keys[:3]):
        assert np.all(np.isfinite(np.asarray(m[k]))), k
    # masks grads are nulled, so their summary must be exactly zero
    mask_l2 = [k for k in grad_keys if "masks" in k and k.endswith("/l2")]
    assert mask_l2 and float(np.asarray(m[mask_l2[0]]).max()) == 0.0


def test_gauge_eval_plaquette_near_oracle(key):
    """HMC-mode eval on 4x4 at beta=2 must land near I1/I0(2)=0.6978."""
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=64, num_steps=4,
                      eps_init=0.2, network_arch="zero", hmc=True,
                      eps_trainable=False)
    state = init_train_state(cfg, key)
    ev = make_eval_chunk(cfg, 500)
    x = u1.random_links(key, 64, cfg.shape)
    x, met = ev(state.params, x, 2.0, jax.random.fold_in(key, 3))
    plaq = float(np.asarray(met["plaqs"])[250:].mean())
    exact = float(u1.u1_plaq_exact(2.0))
    assert abs(plaq - exact) < 0.03, f"plaq {plaq} vs exact {exact}"
    acc = float(np.asarray(met["accept_prob"]).mean())
    assert acc > 0.5


def test_eps_dual_averaging_warmup(key):
    """Dual-averaging eps warmup recovers from a hopeless eps_init.

    Start at eps=1.2 (acceptance ~0 at 8x8 beta=2: the dead-gradient trap
    that killed hand-tuned large-volume runs): the warmup must pull eps
    down to a value with acceptance near the target, then gradient
    training continues without dying.
    """
    cfg = GaugeConfig(time_size=8, space_size=8, num_chains=32, num_steps=3,
                      network_arch="mlp", num_hidden=32, train_steps=400,
                      beta_init=2.0, beta_final=2.0, eps_init=1.2,
                      eps_warmup_steps=200, eps_target_accept=0.7)
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 100)
    accs, epss = [], []
    for i in range(4):
        state, m = chunk(state, jax.random.fold_in(key, i))
        accs.append(float(np.asarray(m["accept_prob"])[-20:].mean()))
        epss.append(float(np.asarray(m["eps"])[-1]))
    assert epss[0] < 1.2, f"warmup did not move eps: {epss}"
    assert epss[-1] < 0.5, f"eps did not reach a stable scale: {epss}"
    # end-of-warmup acceptance near the target; post-warmup stays alive
    assert 0.4 < accs[1] < 0.95, f"acceptance off target after warmup: {accs}"
    assert accs[-1] > 0.3, f"post-warmup training died: {accs}"
    assert np.isfinite(np.asarray(m["loss"])).all()

    # eps_warmup_steps=0 keeps the old semantics exactly: da untouched
    cfg0 = dataclasses.replace(cfg, eps_warmup_steps=0, eps_init=0.25)
    s0 = init_train_state(cfg0, key)
    s1, _ = make_train_chunk(cfg0, 10)(s0, key)
    np.testing.assert_allclose(np.asarray(s1.da.t), 0.0)


def test_loss_z_term_parity_modes(key):
    """Differential test of the loss dataflow flags.

    The reference computes the z std/charge terms against the X-chain
    proposal (gauge_model.py:776,788).  Verify both modes against a manual
    reconstruction from the same transitions, and that charge_reward flips
    exactly the charge term's sign.
    """
    from l2hmc.train import losses
    from l2hmc.train.gauge import build_dynamics, make_loss_fn

    base = GaugeConfig(time_size=4, space_size=4, num_chains=16, num_steps=2,
                       network_arch="mlp", num_hidden=16)
    state = init_train_state(base, key)
    x = state.x
    beta, lkey = 2.0, jax.random.fold_in(key, 7)

    def manual_loss(cfg):
        """Reconstruct loss_fn's value with the same key splits."""
        _, dyn, _ = build_dynamics(cfg)
        kx, kz, kzi = jax.random.split(lkey, 3)
        out_x = dyn["transition"](state.params, x, beta, kx)
        z = jax.random.normal(kzi, x.shape, x.dtype)
        out_z = dyn["transition"](state.params, z, beta, kz)
        z_prop = out_x.x_proposed if cfg.ref_z_term else out_z.x_proposed
        metric = losses.get_metric_fn(cfg.metric)
        l = losses.esjd_loss(
            x, out_x.x_proposed, out_x.accept_prob,
            z, z_prop, out_z.accept_prob,
            metric_fn=metric, loss_scale=cfg.loss_scale,
            aux_weight=cfg.aux_weight, std_weight=cfg.std_weight)
        dq_x = u1.charge_diff_approx(x, out_x.x_proposed, cfg.shape)
        dq_z = u1.charge_diff_approx(z, z_prop, cfg.shape)
        charge = losses.charge_loss(
            dq_x, out_x.accept_prob, dq_z, out_z.accept_prob,
            charge_weight=cfg.charge_weight, aux_weight=cfg.aux_weight,
            reward=cfg.charge_reward)
        return float(l + charge), float(charge)

    for flags in [dict(), dict(ref_z_term=True), dict(charge_reward=True)]:
        cfg = dataclasses.replace(base, **flags)
        got, _ = jax.jit(
            lambda p, x, k: make_loss_fn(cfg, build_dynamics(cfg)[1])(
                p, x, beta, k))(state.params, x, lkey)
        want, _ = manual_loss(cfg)
        np.testing.assert_allclose(float(got), want, rtol=1e-5), flags

    l_default, _ = manual_loss(base)
    l_ref, _ = manual_loss(dataclasses.replace(base, ref_z_term=True))
    assert l_default != l_ref, "ref_z_term mode must change the loss"

    # reward mode flips exactly the charge term
    l_parity, c_parity = manual_loss(base)
    l_reward, c_reward = manual_loss(
        dataclasses.replace(base, charge_reward=True))
    np.testing.assert_allclose(c_reward, -c_parity, rtol=1e-6)
    np.testing.assert_allclose(l_parity - l_reward, 2 * c_parity, rtol=1e-4)


def test_beta_annealing_schedule():
    from l2hmc.train.schedules import beta_schedule

    b0 = float(beta_schedule(0, 100, 2.0, 4.0))
    bT = float(beta_schedule(100, 100, 2.0, 4.0))
    bmid = float(beta_schedule(50, 100, 2.0, 4.0))
    assert b0 == pytest.approx(2.0)
    assert bT == pytest.approx(4.0)
    # linear in 1/beta: midpoint of 1/2 and 1/4 is 3/8 -> beta=8/3
    assert bmid == pytest.approx(8.0 / 3.0, rel=1e-5)


def test_gauge_improved_action_trains(key):
    """The rectangle-improved action wires through the full L2HMC training
    path (loss, second-order grads through the leapfrog, Adam)."""
    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=32, num_steps=2,
                      network_arch="mlp", num_hidden=32, train_steps=100,
                      beta_init=1.0, beta_final=1.0, action="improved")
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 50)
    state, m = chunk(state, jax.random.fold_in(key, 1))
    assert np.all(np.isfinite(np.asarray(m["loss"])))
    assert float(np.asarray(m["accept_prob"])[-10:].mean()) > 0.1


def test_plaq_metric_loss(key):
    """The observable-space ESJD metric (metric='plaq_cos'): loss matches a
    manual plaquette-field reconstruction and trains without NaNs."""
    from l2hmc.train import losses
    from l2hmc.train.gauge import build_dynamics, make_loss_fn

    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=16, num_steps=2,
                      network_arch="mlp", num_hidden=16, metric="plaq_cos",
                      charge_weight=0.0)
    state = init_train_state(cfg, key)
    x, beta = state.x, 2.0
    lkey = jax.random.fold_in(key, 3)

    got, _ = jax.jit(
        lambda p, x, k: make_loss_fn(cfg, build_dynamics(cfg)[1])(
            p, x, beta, k))(state.params, x, lkey)
    got = float(got)

    # manual reconstruction with the same key splits
    _, dyn, _ = build_dynamics(cfg)
    kx, kz, kzi = jax.random.split(lkey, 3)
    out_x = dyn["transition"](state.params, x, beta, kx)
    z = jax.random.normal(kzi, x.shape, x.dtype)
    out_z = dyn["transition"](state.params, z, beta, kz)

    def plaq_metric(x1, x2):
        p1 = u1.plaq_sums(u1.to_links(x1, cfg.shape))
        p2 = u1.plaq_sums(u1.to_links(x2, cfg.shape))
        d = jnp.abs(jnp.cos(p1) - jnp.cos(p2))
        return d.reshape(*d.shape[:-2], -1)

    want = float(losses.esjd_loss(
        x, out_x.x_proposed, out_x.accept_prob,
        z, out_z.x_proposed, out_z.accept_prob,
        metric_fn=plaq_metric, loss_scale=cfg.loss_scale,
        aux_weight=cfg.aux_weight, std_weight=cfg.std_weight))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    # and the full training chunk runs on it
    cfg2 = dataclasses.replace(cfg, train_steps=60)
    st = init_train_state(cfg2, key)
    st, m = make_train_chunk(cfg2, 30)(st, jax.random.fold_in(key, 9))
    assert np.all(np.isfinite(np.asarray(m["loss"])))


def test_eps_fixed_training_freezes_eps(key):
    """--eps_fixed path (the round-2 champion recipe): raw_eps must stay
    bit-identical through training while the conditioners move."""
    from l2hmc.dynamics.l2hmc import get_eps
    from l2hmc.train.gauge import build_dynamics

    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=16, num_steps=2,
                      network_arch="mlp", num_hidden=16, train_steps=60,
                      eps_init=0.1, eps_trainable=False)
    state = init_train_state(cfg, key)
    dyn_cfg, _, _ = build_dynamics(cfg)
    eps0 = float(get_eps(state.params, dyn_cfg))
    assert eps0 == pytest.approx(0.1, rel=1e-6)

    x0 = np.asarray(jax.tree_util.tree_leaves(state.params.xnet)[0])
    state, m = make_train_chunk(cfg, 30)(state, jax.random.fold_in(key, 1))
    state, m = make_train_chunk(cfg, 30)(state, jax.random.fold_in(key, 2))

    assert float(get_eps(state.params, dyn_cfg)) == eps0, "eps moved"
    x1 = np.asarray(jax.tree_util.tree_leaves(state.params.xnet)[0])
    assert not np.allclose(x0, x1), "conditioners did not train"
    assert np.all(np.isfinite(np.asarray(m["loss"])))


def test_train_to_convergence_retrains_on_low_acceptance(key):
    """Detect-and-retrain: an unreachable acceptance
    threshold forces every retry; threshold off -> exactly one attempt."""
    from l2hmc.train.gauge import GaugeConfig, train_to_convergence

    cfg = GaugeConfig(time_size=4, space_size=4, num_chains=8, num_steps=2,
                      network_arch="mlp", num_hidden=8, train_steps=4,
                      merge_v_halves=True)
    state, m, attempts = train_to_convergence(
        cfg, key, chunk_size=2, retrain_acc=0.0)
    assert len(attempts) == 1
    assert 0.0 <= attempts[0]["end_accept"] <= 1.0

    state, m, attempts = train_to_convergence(
        cfg, key, chunk_size=2, retrain_acc=2.0, max_retrains=2)
    assert len(attempts) == 3          # initial + 2 retrains, all "failed"
    assert all(a["end_accept"] < 2.0 for a in attempts)
    assert m["accept_prob"].shape == (2,)
