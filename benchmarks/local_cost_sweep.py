#!/usr/bin/env python
"""Sampling-cost sweep of the local-conditioner family at large volume.

The local (c8, k3, L2) conditioner at 64x64 buys per-step quality over
tuned HMC at a transition cost well above HMC's: its volume decay is a
COST problem (C=8 convs are narrow), not physics.  Sampling throughput is
weight-independent, so the cost frontier of the family can be mapped in
seconds per variant without training: this sweep times
``make_eval_chunk`` for local variants (channels x layers x kernel),
the MLP h64 reference, and the HMC baseline at the campaign batch.

Usage: python benchmarks/local_cost_sweep.py --size 64 --chains 1024
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
import jax.numpy as jnp
import numpy as np


def _trace(msg):
    print(f"[lcs {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--hmc_num_steps", type=int, default=8)
    p.add_argument("--hmc_eps", type=float, default=0.04552)
    p.add_argument("--eps", type=float, default=0.10014)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from l2hmc.lattice import u1
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_eval_chunk,
    )

    _trace(f"devices: {jax.devices()}")
    base = GaugeConfig(
        time_size=args.size, space_size=args.size, num_chains=args.chains,
        num_steps=args.num_steps, eps_init=args.eps, eps_trainable=False,
        merge_v_halves=True, beta_final=args.beta)
    key = jax.random.PRNGKey(3)
    x0 = u1.random_links(key, args.chains, base.shape)

    variants = [
        ("hmc_K8", dataclasses.replace(
            base, hmc=True, network_arch="zero",
            num_steps=args.hmc_num_steps, eps_init=args.hmc_eps)),
        ("mlp_h64", dataclasses.replace(
            base, network_arch="mlp", num_hidden=64)),
        ("local_c8_L2_k3", dataclasses.replace(
            base, network_arch="local", num_filters=8, local_layers=2,
            local_kernel=3)),
        ("local_c8_L1_k3", dataclasses.replace(
            base, network_arch="local", num_filters=8, local_layers=1,
            local_kernel=3)),
        ("local_c4_L1_k3", dataclasses.replace(
            base, network_arch="local", num_filters=4, local_layers=1,
            local_kernel=3)),
        ("local_c8_L1_k5", dataclasses.replace(
            base, network_arch="local", num_filters=8, local_layers=1,
            local_kernel=5)),
        ("local_c16_L1_k3", dataclasses.replace(
            base, network_arch="local", num_filters=16, local_layers=1,
            local_kernel=3)),
        ("localflat_c8_L2", dataclasses.replace(
            base, network_arch="local_flat", num_filters=8,
            local_layers=2)),
        ("localflat_c8_L1", dataclasses.replace(
            base, network_arch="local_flat", num_filters=8,
            local_layers=1)),
    ]
    res = {}
    for tag, cfg in variants:
        state = init_train_state(cfg, key)
        chunk = make_eval_chunk(cfg, args.steps)

        @jax.jit
        def run(params, x, k):
            x, m = chunk(params, x, args.beta, k)
            return x, jnp.sum(m["plaqs"][:, :8])

        x, s = run(state.params, x0, jax.random.fold_in(key, 1))
        float(s)                              # compile + warm
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            x, s = run(state.params, x, jax.random.fold_in(key, 2 + i))
            float(s)
            best = min(best, time.perf_counter() - t0)
        res[tag] = {
            "steps_per_s": round(args.steps / best, 2),
            "us_per_transition": round(best / args.steps * 1e6, 1),
        }
        _trace(f"{tag}: {res[tag]}")

    hmc_thr = res["hmc_K8"]["steps_per_s"]
    for tag in res:
        res[tag]["thr_vs_hmc"] = round(res[tag]["steps_per_s"] / hmc_thr, 4)
    result = {
        "benchmark": "local_cost_sweep",
        "config": {"size": args.size, "chains": args.chains,
                   "K_trained": args.num_steps,
                   "K_hmc": args.hmc_num_steps, "steps": args.steps},
        "variants": res,
        "note": ("ratio_needed_for_win = 1/per_step_quality; r4 measured "
                 "per-step 1.597 for local c8L2 at 64x64 -> any variant "
                 "with thr_vs_hmc > 0.63 that keeps that quality wins"),
    }
    out_s = json.dumps(result)
    print(out_s)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
