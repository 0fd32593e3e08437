#!/usr/bin/env python
"""Beta-robustness campaign: autotune-driven head-to-heads off beta=4.

An error-barred claim at one coupling (beta=4) says little about the
method.  This script makes the claim a property of the METHOD, not the
point: for each requested (size, beta) it

1. cold-starts the joint (K, eps) search for BOTH samplers
   (``train/autotune.py`` via ``autotune_gauge``-equivalent calls, 2
   probe seeds, refine pass — zero hand-picked integrator settings
   anywhere),
2. runs the ``h2h_seeds`` interleaved multi-seed protocol at the tuned
   cells (independent trainings, >=12k-step evals, jackknife errors).

Output: one JSON line per (size, beta) with the tuned cells and the
ratio table, written to --out_dir.

Usage:
  python benchmarks/beta_campaign.py --size 16 --beta 3.0 --seeds 3
  python benchmarks/beta_campaign.py --size 8 --beta 3.0 --seeds 3 \
      --eval_steps 12000
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
    print(f"[beta {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=3.0)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed0", type=int, default=3000)
    p.add_argument("--train_steps", type=int, default=12000)
    p.add_argument("--eval_steps", type=int, default=16000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--num_hidden", type=int, default=64)
    p.add_argument("--arch", default="mlp", choices=["mlp", "conv", "local"],
                   help="conditioner family for the trained cell (local = "
                        "the weight-shared per-link conv family, r4)")
    p.add_argument("--num_filters", type=int, default=8)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--train_hops", action="store_true",
                   help="interleave exact instanton hops into the training "
                        "chains (probes AND campaign trainings) — the beta>=5 "
                        "frozen-training-distribution fix")
    p.add_argument("--retrain_acc", type=float, default=0.0,
                   help="forwarded to h2h_seeds: detect-and-retrain "
                        "threshold on end-of-training acceptance (0=off); "
                        "0.7 at beta>=5 makes the campaign mean "
                        "unconditional")
    p.add_argument("--max_retrains", type=int, default=3)
    p.add_argument("--hmc_k", type=int, default=0,
                   help="reuse a previously auto-tuned HMC optimum "
                        "(skip tune_hmc); 0 = tune cold")
    p.add_argument("--hmc_eps", type=float, default=0.0)
    p.add_argument("--probe_train_steps", type=int, default=8000)
    p.add_argument("--probe_seeds", type=int, default=2)
    p.add_argument("--probe_chains", type=int, default=1024)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--hmc_k_grid", default="3,4,5,6,8")
    p.add_argument("--l2hmc_k_grid", default="2,3,4,5")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if args.hmc_k > 0 and args.hmc_eps <= 0:
        # a cached optimum needs BOTH values; eps=0 would build a
        # degenerate never-moving HMC baseline and inflate every ratio
        p.error("--hmc_k requires --hmc_eps > 0 (the cached optimum's "
                "step size)")

    from benchmarks import h2h_seeds
    from l2hmc.lattice import u1
    from l2hmc.lattice.metropolis import thermalize
    from l2hmc.train.autotune import TuneResult, tune_hmc, tune_l2hmc
    from l2hmc.train.gauge import GaugeConfig

    _trace(f"devices: {jax.devices()}; size {args.size} beta {args.beta}")
    base = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.num_chains,
        network_arch=args.arch, num_hidden=args.num_hidden,
        num_filters=args.num_filters, lr_init=args.lr_init,
        train_hops=args.train_hops, merge_v_halves=True,
        eps_init=0.35 * (64.0 / (args.size * args.size)) ** 0.25,
        beta_init=2.0, beta_final=args.beta,
        charge_reward=True, charge_weight=1.0,
    )
    key = jax.random.PRNGKey(97 + int(10 * args.beta) + args.size)

    x0 = u1.random_links(key, base.num_chains, base.shape)
    x0 = jax.jit(lambda x, k: thermalize(
        k, x, base.shape, args.beta, 1500))(x0, jax.random.fold_in(key, 7))
    _trace("thermalized")

    t0 = time.perf_counter()
    if args.hmc_k > 0:
        # reuse a previously auto-tuned optimum (from a prior campaign
        # JSON) — still tuner-produced, just cached
        hmc_opt = TuneResult(num_steps=args.hmc_k, eps=args.hmc_eps,
                             score=0.0, accept=0.0, cells=())
        _trace(f"HMC optimum (cached): K={hmc_opt.num_steps} "
               f"eps={hmc_opt.eps}")
    else:
        hmc_opt = tune_hmc(
            base, x0, args.beta, jax.random.fold_in(key, 1),
            k_grid=tuple(int(k) for k in args.hmc_k_grid.split(",")),
            probe_chains=args.probe_chains)
        _trace(f"HMC optimum: K={hmc_opt.num_steps} eps={hmc_opt.eps} "
               f"acc={hmc_opt.accept:.3f} ({time.perf_counter()-t0:.0f}s)")

    t0 = time.perf_counter()
    l2_opt = tune_l2hmc(
        base, jax.random.fold_in(key, 2), hmc_opt,
        k_grid=tuple(int(k) for k in args.l2hmc_k_grid.split(",")),
        probe_train_steps=args.probe_train_steps,
        probe_chains=args.probe_chains,
        probe_seeds=args.probe_seeds)
    _trace(f"trained cell: K={l2_opt.num_steps} eps={l2_opt.eps} "
           f"({time.perf_counter()-t0:.0f}s)")
    # refine: +-10% eps at the winning K
    anchor = TuneResult(num_steps=l2_opt.num_steps, eps=l2_opt.eps,
                        score=0.0, accept=0.0, cells=())
    ref = tune_l2hmc(
        base, jax.random.fold_in(key, 3), anchor,
        k_grid=(l2_opt.num_steps,), eps_grid=(0.9, 1.1),
        probe_train_steps=args.probe_train_steps,
        probe_chains=args.probe_chains,
        probe_seeds=args.probe_seeds)
    merged = sorted(l2_opt.cells + ref.cells, key=lambda c: -c["score"])
    k_t, eps_t = merged[0]["K"], merged[0]["eps"]
    _trace(f"refined trained cell: K={k_t} eps={eps_t}")

    # h2h campaign at the tuned cells
    out_path = args.out or f"runs/beta_{args.size}_{args.beta}.json"
    h2h_argv = [
        "--size", str(args.size), "--beta", str(args.beta),
        "--seeds", str(args.seeds), "--seed0", str(args.seed0),
        "--train_steps", str(args.train_steps),
        "--eval_steps", str(args.eval_steps),
        "--eval_chains", str(args.eval_chains),
        "--num_chains", str(args.num_chains),
        "--num_hidden", str(args.num_hidden),
        "--arch", args.arch, "--num_filters", str(args.num_filters),
        "--lr_init", str(args.lr_init),
        "--therm_sweeps", str(args.therm_sweeps),
        "--num_steps", str(k_t), "--eps", str(eps_t),
        "--hmc_num_steps", str(hmc_opt.num_steps),
        "--hmc_eps", str(hmc_opt.eps),
        "--charge_reward", "--eval_init", "metropolis",
        "--out", out_path + ".h2h",
    ]
    if args.train_hops:
        h2h_argv.append("--train_hops")
    if args.retrain_acc > 0:
        h2h_argv += ["--retrain_acc", str(args.retrain_acc),
                     "--max_retrains", str(args.max_retrains)]
    _trace(f"h2h: {' '.join(h2h_argv)}")
    h2h_seeds.main(h2h_argv)

    h2h_res = json.loads(Path(out_path + ".h2h").read_text())
    result = {
        "benchmark": "beta_campaign",
        "size": args.size, "beta": args.beta,
        "arch": args.arch, "train_hops": args.train_hops,
        "retrain_acc": args.retrain_acc,
        "lr_init": args.lr_init,
        "hmc_opt": {"K": hmc_opt.num_steps, "eps": hmc_opt.eps,
                    "accept": hmc_opt.accept},
        "trained_cell": {"K": k_t, "eps": eps_t,
                         "cells": merged[:4]},
        "h2h_summary": h2h_res["summary"],
        "h2h_per_seed": h2h_res["per_seed"],
        "plaq_exact": h2h_res["plaq_exact"],
    }
    out_s = json.dumps(result)
    print(out_s)
    Path(out_path).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
