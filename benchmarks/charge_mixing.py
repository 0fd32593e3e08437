#!/usr/bin/env python
"""Topological charge mixing: trained L2HMC vs tuned HMC on U(1) 16x16.

The fork's raison d'etre (README.md:14-27 of the reference) is faster
topological-charge tunneling: plain HMC gets stuck in a charge sector as
beta grows, and the learned kernel is trained (charge loss,
``gauge_model.py:766-795``) to hop sectors.  The reference reports the
per-step charge movement as ``charge_diff_op`` (``gauge_model.py:849-851``)
but publishes no numbers.  This benchmark measures the claim end-to-end:

  1. train the L2HMC sampler at the canonical 16x16 config (beta 2 -> 4),
  2. sample with the trained kernel at beta=4,
  3. sample with HMC at a given step size (default eps=0.10) and at the
     same trajectory length,
  4. report per-step tunneling rate  <|Q_{t+1} - Q_t|>,  the integrated
     autocorrelation time of Q, Q-ESS per wall-second, and <Q^2> against
     the exact finite-volume susceptibility.

Wall-clock is measured per sampler, so the comparison is cost-normalized:
HMC's cheaper transition is credited to it.

Usage:  python benchmarks/charge_mixing.py [--train_steps N] [--eval_steps N]
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
    print(f"[charge_mixing {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def run_eval(cfg, params, x, beta, key, num_steps, chunk_size=500):
    """Timed eval: returns (Q trace (steps, chains), accept, wall_s, x)."""
    from l2hmc.train.gauge import make_eval_chunk

    chunk = make_eval_chunk(cfg, chunk_size)
    # compile + thermalize one chunk outside the timed region
    x, m = chunk(params, x, beta, key)
    float(np.asarray(m["charges"]).sum())
    charges, accepts = [], []
    t0 = time.perf_counter()
    done = 0
    while done < num_steps:
        key, sub = jax.random.split(key)
        x, m = chunk(params, x, beta, sub)
        charges.append(np.asarray(m["charges"]))
        accepts.append(np.asarray(m["accept_prob"]))
        done += chunk_size
    wall = time.perf_counter() - t0
    return np.concatenate(charges), float(np.concatenate(accepts).mean()), wall, x


def charge_stats(q, wall, label):
    """Tunneling rate, tau_int, ESS/s for a (steps, chains) charge trace."""
    from l2hmc.analysis import stats

    dq = np.abs(np.diff(q, axis=0))
    rate = float(dq.mean())
    taus, reliable = [], []
    ess = []
    for c in range(q.shape[1]):
        tau, ok = stats.integrated_time(q[:, c])
        taus.append(tau)
        reliable.append(ok)
        ess.append(stats.calc_ess(q[:, c]))
    ess_ratio = float(np.mean(ess))
    out = {
        "sampler": label,
        "tunneling_rate_per_step": round(rate, 5),
        "tau_int_Q": round(float(np.mean(taus)), 2),
        "tau_int_reliable_frac": round(float(np.mean(reliable)), 2),
        "Q_ess_ratio": round(ess_ratio, 5),
        "Q_ess_per_s": round(ess_ratio * q.shape[0] * q.shape[1] / wall, 1),
        "steps_per_s": round(q.shape[0] / wall, 1),
        "susceptibility": round(float((q ** 2).mean()), 3),
    }
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--eval_steps", type=int, default=4000)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--hmc_eps", type=float, default=0.10,
                   help="HMC step size (re-tune per device: "
                        "benchmarks/hmc_ess_sweep.py)")
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from l2hmc.lattice import u1
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_train_chunk,
    )

    cfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains, num_steps=args.num_steps,
        network_arch="conv", train_steps=args.train_steps,
        charge_weight=args.charge_weight,
    )
    key = jax.random.PRNGKey(args.seed)
    _trace(f"devices: {jax.devices()}")

    # --- train ---
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 250)
    _trace(f"training {cfg.train_steps} steps (compile on first chunk)...")
    t0 = time.perf_counter()
    for c in range(cfg.train_steps // 250):
        key, sub = jax.random.split(key)
        state, m = chunk(state, sub)
        if c % 4 == 3:
            _trace(f"  step {int(state.step)}: acc="
                   f"{float(np.asarray(m['accept_prob'])[-1]):.3f} "
                   f"plaq={float(np.asarray(m['plaqs'])[-1]):.5f}")
    _trace(f"trained in {time.perf_counter()-t0:.1f}s wall")

    beta = cfg.beta_final
    # --- trained kernel eval (annealed chains; reference protocol) ---
    key, k1 = jax.random.split(key)
    q_l2, acc_l2, wall_l2, x_end = run_eval(
        cfg, state.params, state.x, beta, k1, args.eval_steps)
    res_l2 = charge_stats(q_l2, wall_l2, "l2hmc_trained")
    res_l2["accept_prob"] = round(acc_l2, 4)
    _trace(json.dumps(res_l2))

    # --- HMC at its ESS-optimal eps, started from equilibrated state ---
    hmc_cfg = dataclasses.replace(
        cfg, hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False)
    hmc_state = init_train_state(hmc_cfg, key)
    key, k2 = jax.random.split(key)
    q_hmc, acc_hmc, wall_hmc, _ = run_eval(
        hmc_cfg, hmc_state.params, x_end, beta, k2, args.eval_steps)
    res_hmc = charge_stats(q_hmc, wall_hmc, f"hmc_eps{args.hmc_eps}")
    res_hmc["accept_prob"] = round(acc_hmc, 4)
    _trace(json.dumps(res_hmc))

    shape = cfg.shape
    result = {
        "benchmark": "topological_charge_mixing",
        "config": f"U(1) {args.size}x{args.size}, {args.num_chains} chains, "
                  f"{args.num_steps} leapfrog steps, beta={beta}",
        "q2_exact": round(float(
            u1.topological_susceptibility_exact(beta, shape.num_plaquettes)), 3),
        "l2hmc": res_l2,
        "hmc": res_hmc,
        "tunneling_speedup_per_step": round(
            res_l2["tunneling_rate_per_step"]
            / max(res_hmc["tunneling_rate_per_step"], 1e-12), 2),
        "Q_ess_per_s_speedup": round(
            res_l2["Q_ess_per_s"] / max(res_hmc["Q_ess_per_s"], 1e-12), 2),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
