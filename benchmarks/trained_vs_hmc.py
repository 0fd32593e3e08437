#!/usr/bin/env python
"""Trained L2HMC vs tuned HMC, cost-normalized, on U(1) 16x16 at beta=4.

A trained kernel can win per step and still lose per wall-second, because
the S/T/Q conditioner networks cost transition time.  This benchmark is
the head-to-head harness for that trade: it trains an L2HMC kernel at an arbitrary conditioner size /
integrator config, then measures BOTH samplers' effective samples per
second on the SAME eval harness (``make_eval_chunk`` XLA scan) from the
same thermalized state:

  - plaquette ESS/s (the generic-observable metric), and
  - topological-charge ESS/s + tunneling rate (the fork's headline claim,
    reference ``gauge_model.py:766-795`` charge loss / ``charge_diff_op``
    ``:849-851``).

HMC runs at (K=5, eps=0.08) unless overridden; re-tune it for the device
with ``benchmarks/hmc_ess_sweep.py`` so the comparison credits HMC its
cheaper transition and its best settings.

Usage:
  python benchmarks/trained_vs_hmc.py --arch mlp --num_hidden 64 \
      --merge_v --num_steps 5 --train_steps 3000
  python benchmarks/trained_vs_hmc.py --params_from runs/h2h/xyz.npz  # re-eval
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import numpy as np


def _trace(msg):
    print(f"[h2h {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def run_eval(cfg, params, x, beta, key, num_steps, chunk_size=1000):
    """Timed eval on the shared harness: returns traces + wall seconds."""
    from l2hmc.train.gauge import make_eval_chunk

    base_chunk = make_eval_chunk(cfg, chunk_size)

    # Slice the observable traces on-device to the chains the estimators
    # use (trace_stats reads 64) BEFORE the host transfer: the device-to-
    # host transfer of full-batch traces is harness overhead, not sampling
    # cost, and it is stripped identically for both samplers.  Total-wall
    # timing over all chunks (NOT best-chunk: async dispatch overlaps
    # device work with host transfers, so per-chunk minima systematically
    # undercount steady-state cost — and more so for the cheaper sampler).
    @jax.jit
    def chunk(params, x, beta, key):
        x, m = base_chunk(params, x, beta, key)
        return x, {k: v[:, :64] for k, v in m.items()}

    # compile + warm outside the timed region
    x, m = chunk(params, x, beta, key)
    float(np.asarray(m["charges"]).sum())
    plaqs, charges, accepts = [], [], []
    t0 = time.perf_counter()
    done = 0
    while done < num_steps:
        key, sub = jax.random.split(key)
        x, m = chunk(params, x, beta, sub)
        done += chunk_size
        plaqs.append(np.asarray(m["plaqs"]))
        charges.append(np.asarray(m["charges"]))
        accepts.append(np.asarray(m["accept_prob"]))
    # drain: the appends above already pulled device->host
    wall = time.perf_counter() - t0
    return (np.concatenate(plaqs), np.concatenate(charges),
            float(np.concatenate(accepts).mean()), wall, x)


def trace_stats(arr, wall, max_chains=64, total_chains=None):
    """ESS ratio / tau_int / eff-samples-per-second for a (T, chains) trace.

    ``total_chains``: chains the timed run actually advanced (the trace may
    be an on-device slice of the batch); eff samples/s scales with it.
    """
    from l2hmc.analysis import stats

    total = total_chains or arr.shape[1]
    cols = range(min(max_chains, arr.shape[1]))
    ess = float(np.mean([stats.calc_ess(arr[:, c]) for c in cols]))
    taus = [stats.integrated_time(arr[:, c]) for c in cols]
    return {
        "ess_ratio": round(ess, 5),
        "tau_int": round(float(np.mean([t for t, _ in taus])), 2),
        "tau_reliable_frac": round(float(np.mean([ok for _, ok in taus])), 2),
        "eff_samples_per_s": round(ess * arr.shape[0] * total / wall, 1),
        "steps_per_s": round(arr.shape[0] / wall, 1),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    # trained-kernel config
    p.add_argument("--arch", default="conv",
                   choices=["conv", "mlp", "local"])
    p.add_argument("--num_filters", type=int, default=8)
    p.add_argument("--local_kernel", type=int, default=3)
    p.add_argument("--local_layers", type=int, default=2)
    p.add_argument("--num_hidden", type=int, default=0, help="0 -> 2*x_dim")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps K")
    p.add_argument("--merge_v", action="store_true")
    p.add_argument("--use_bf16", action="store_true",
                   help="bfloat16 matmuls (f32 accumulation) in the S/T/Q "
                        "nets; MH accept stays f32-exact")
    p.add_argument("--charge_reward", action="store_true")
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--eps_init", type=float, default=0.35)
    p.add_argument("--eps_cap", type=float, default=0.0)
    p.add_argument("--eps_fixed", action="store_true",
                   help="freeze eps at --eps_init: train only the S/T/Q "
                        "conditioners around a fixed integrator step (with "
                        "zero-init heads + --eps_init at HMC's optimum the "
                        "kernel STARTS exactly at tuned HMC)")
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--lr_init", type=float, default=1e-3,
                   help="large volumes need a smaller lr: the per-step "
                        "S/T/Q output jump enters the Hamiltonian summed "
                        "over x_dim links")
    p.add_argument("--metric", default="cos_diff",
                   help="ESJD metric (see train_gauge --metric); plaq_cos "
                        "trains jump distance in the observable space the "
                        "eval ESS is scored in")
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--eval_chains", type=int, default=0,
                   help="chains for the timed eval (0 = same as training)")
    p.add_argument("--eval_init", default="train",
                   choices=["train", "metropolis"],
                   help="eval start: annealed training chains, or exact "
                        "checkerboard-Metropolis thermalization (use when "
                        "the anneal leaves chains sub-equilibrated — at "
                        ">=32x32 with slow-mixing kernels the timed eval "
                        "otherwise measures the transient)")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    # HMC baseline at its own optimum (round-1 joint sweep)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--hmc_num_steps", type=int, default=5)
    # protocol
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_params", default="",
                   help="checkpoint dir to save the full train state")
    p.add_argument("--save_npz", default="",
                   help="flat-leaf npz of the trained params + config "
                        "(bench.py champion format: arr_i = tree_flatten "
                        "leaves in order, config = json string)")
    p.add_argument("--params_from", default="",
                   help="skip training; load params from a --save_params npz")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from l2hmc.lattice import u1
    from l2hmc.train import checkpoint as ckpt
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_train_chunk,
    )

    cfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, num_steps=args.num_steps,
        network_arch=args.arch, num_filters=args.num_filters,
        local_kernel=args.local_kernel, local_layers=args.local_layers,
        num_hidden=args.num_hidden, train_steps=args.train_steps,
        charge_weight=args.charge_weight, charge_reward=args.charge_reward,
        merge_v_halves=args.merge_v, eps_init=args.eps_init,
        eps_cap=args.eps_cap, eps_trainable=not args.eps_fixed,
        metric=args.metric, use_bf16=args.use_bf16, lr_init=args.lr_init,
    )
    key = jax.random.PRNGKey(args.seed)
    _trace(f"devices: {jax.devices()}")

    state = init_train_state(cfg, key)
    if args.params_from and args.params_from.endswith(".npz"):
        # flat-leaf npz from --save_npz: params only, so thermalize the
        # eval start with exact checkerboard Metropolis sweeps instead of
        # the (absent) annealed chain state
        z = np.load(args.params_from, allow_pickle=False)
        flat, treedef = jax.tree_util.tree_flatten(state.params)
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[f"arr_{i}"]) for i in range(len(flat))])
        from l2hmc.lattice.metropolis import thermalize
        key, tk = jax.random.split(key)
        x_th = jax.jit(lambda x, k: thermalize(
            k, x, cfg.shape, cfg.beta_final, 500))(state.x, tk)
        state = state._replace(params=params, x=x_th)
        _trace(f"restored params npz {args.params_from}; "
               f"500-sweep Metropolis thermalization done")
        train_wall = 0.0
    elif args.params_from:
        state = ckpt.restore_checkpoint(args.params_from, state)
        _trace(f"restored params from {args.params_from} "
               f"(step {int(state.step)})")
        train_wall = 0.0
    else:
        chunk = make_train_chunk(cfg, 250)
        _trace(f"training {cfg.train_steps} steps "
               f"(arch={args.arch} filters={args.num_filters} "
               f"hidden={cfg.hidden} K={args.num_steps} "
               f"merge_v={args.merge_v} charge_reward={args.charge_reward})...")
        t0 = time.perf_counter()
        for c in range(cfg.train_steps // 250):
            key, sub = jax.random.split(key)
            state, m = chunk(state, sub)
            if c % 4 == 3:
                _trace(f"  step {int(state.step)}: "
                       f"acc={float(np.asarray(m['accept_prob'])[-1]):.3f} "
                       f"plaq={float(np.asarray(m['plaqs'])[-1]):.5f} "
                       f"eps={float(np.asarray(m['eps'])[-1]):.4f}")
        train_wall = time.perf_counter() - t0
        _trace(f"trained in {train_wall:.1f}s wall")
        if args.save_params:
            ckpt.save_checkpoint(args.save_params, state, int(state.step), cfg)
            _trace(f"saved params to {args.save_params}")
        if args.save_npz:
            flat, _ = jax.tree_util.tree_flatten(state.params)
            np.savez(
                args.save_npz, *[np.asarray(a) for a in flat],
                config=json.dumps(dataclasses.asdict(cfg)))
            _trace(f"saved flat params npz to {args.save_npz}")

    beta = cfg.beta_final
    eval_chains = args.eval_chains or cfg.num_chains
    x0 = state.x
    if eval_chains != cfg.num_chains:
        # tile/trim the annealed chains to the eval batch
        reps = int(np.ceil(eval_chains / cfg.num_chains))
        x0 = jnp.tile(state.x, (reps, 1))[:eval_chains]
        cfg = dataclasses.replace(cfg, num_chains=eval_chains)
    if args.eval_init == "metropolis":
        from l2hmc.lattice.metropolis import thermalize

        key, tk = jax.random.split(key)
        x0 = jax.jit(lambda x, k: thermalize(
            k, x, cfg.shape, beta, args.therm_sweeps))(x0, tk)
        _trace(f"eval chains thermalized ({args.therm_sweeps} exact "
               f"Metropolis sweeps)")

    # --- trained kernel, timed on the shared harness ---
    key, k1 = jax.random.split(key)
    plaq_l2, q_l2, acc_l2, wall_l2, x_end = run_eval(
        cfg, state.params, x0, beta, k1, args.eval_steps)
    res_l2 = {
        "sampler": "l2hmc_trained",
        "accept_prob": round(acc_l2, 4),
        "plaq": trace_stats(plaq_l2, wall_l2, total_chains=eval_chains),
        "charge": trace_stats(q_l2, wall_l2, total_chains=eval_chains),
        "tunneling_rate_per_step": round(
            float(np.abs(np.diff(q_l2, axis=0)).mean()), 5),
        "plaq_mean": round(float(plaq_l2[args.eval_steps // 4:].mean()), 6),
        "q2": round(float((q_l2 ** 2).mean()), 3),
        "wall_s": round(wall_l2, 2),
    }
    _trace(json.dumps(res_l2))

    # --- HMC at its own optimum, same thermalized state, same harness ---
    hmc_cfg = dataclasses.replace(
        cfg, hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False, num_steps=args.hmc_num_steps,
        merge_v_halves=False)
    hmc_state = init_train_state(hmc_cfg, key)
    key, k2 = jax.random.split(key)
    plaq_h, q_h, acc_h, wall_h, _ = run_eval(
        hmc_cfg, hmc_state.params, x_end, beta, k2, args.eval_steps)
    res_hmc = {
        "sampler": f"hmc_K{args.hmc_num_steps}_eps{args.hmc_eps}",
        "accept_prob": round(acc_h, 4),
        "plaq": trace_stats(plaq_h, wall_h, total_chains=eval_chains),
        "charge": trace_stats(q_h, wall_h, total_chains=eval_chains),
        "tunneling_rate_per_step": round(
            float(np.abs(np.diff(q_h, axis=0)).mean()), 5),
        "plaq_mean": round(float(plaq_h[args.eval_steps // 4:].mean()), 6),
        "q2": round(float((q_h ** 2).mean()), 3),
        "wall_s": round(wall_h, 2),
    }
    _trace(json.dumps(res_hmc))

    shape = cfg.shape
    result = {
        "benchmark": "trained_vs_hmc",
        "label": args.label,
        "config": {
            "size": args.size, "beta": beta, "eval_chains": eval_chains,
            "eval_steps": args.eval_steps, "arch": args.arch,
            "num_filters": args.num_filters, "num_hidden": cfg.hidden,
            "K": args.num_steps, "merge_v": args.merge_v,
            "charge_reward": args.charge_reward,
            "charge_weight": args.charge_weight,
            "train_steps": args.train_steps,
            "eps_init": args.eps_init, "eps_fixed": args.eps_fixed,
            "metric": args.metric,
            "hmc_K": args.hmc_num_steps, "hmc_eps": args.hmc_eps,
        },
        "plaq_exact": round(float(u1.u1_plaq_exact(beta)), 6),
        "q2_exact": round(float(
            u1.topological_susceptibility_exact(beta, shape.num_plaquettes)), 3),
        "l2hmc": res_l2,
        "hmc": res_hmc,
        "plaq_ess_per_s_ratio": round(
            res_l2["plaq"]["eff_samples_per_s"]
            / max(res_hmc["plaq"]["eff_samples_per_s"], 1e-9), 3),
        "plaq_ess_per_step_ratio": round(
            res_l2["plaq"]["ess_ratio"]
            / max(res_hmc["plaq"]["ess_ratio"], 1e-9), 3),
        "q_ess_per_s_ratio": round(
            res_l2["charge"]["eff_samples_per_s"]
            / max(res_hmc["charge"]["eff_samples_per_s"], 1e-9), 3),
        "tunneling_per_s_ratio": round(
            (res_l2["tunneling_rate_per_step"] * res_l2["plaq"]["steps_per_s"])
            / max(res_hmc["tunneling_rate_per_step"]
                  * res_hmc["plaq"]["steps_per_s"], 1e-9), 3),
        "train_wall_s": round(train_wall, 1),
    }

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
