#!/usr/bin/env python
"""Joint (num_leapfrog, eps) sweep for plaquette-ESS/s on the whole-chain HMC.

bench.py's ESS/s figure runs plain HMC on ``hmc_chain_u1_fused`` (the
whole-chain CUDA kernel on a GPU).  The cost-normalized optimum is a JOINT
property of (K, eps): transitions/s falls ~1/K while the per-transition
ESS ratio rises with trajectory length eps*K.  This sweep measures
effective plaquette samples/s across the grid on the device and prints one JSON line per point plus a "best" line the headline config
can adopt.

Usage: python benchmarks/hmc_ess_sweep.py [--size 16] [--chains 2048]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--therm", type=int, default=500)
    p.add_argument("--record", type=int, default=1000)
    p.add_argument("--trace_chains", type=int, default=16,
                   help="chains read back for the ESS estimate")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused

    # Grid: for each K, eps values bracketing the acceptance sweet spot.
    # The leapfrog energy error per trajectory grows with both K and eps,
    # so the usable eps band shrinks slowly with K.
    grid = {
        1: (0.10, 0.15, 0.20, 0.25),
        2: (0.10, 0.125, 0.15, 0.20),
        3: (0.08, 0.10, 0.125, 0.15),
        5: (0.08, 0.10, 0.125),
        8: (0.06, 0.08, 0.10),
        12: (0.05, 0.0667, 0.08),
    }

    key = jax.random.PRNGKey(7)
    best = None
    for num_lf, eps_list in grid.items():
        # one compile per K: eps rides the kernel's runtime scalar input
        @jax.jit
        def record(links, k, eps, num_lf=num_lf):
            links, pl_tr, _, pr_tr = hmc_chain_u1_fused(
                links, k, eps, args.beta, num_lf, args.record)
            return (links, pl_tr[:, :args.trace_chains],
                    jnp.mean(pr_tr), jnp.sum(pl_tr))

        for eps in eps_list:
            links = jnp.zeros((args.chains, args.size, args.size, 2))
            kt, k1, k2, key = jax.random.split(key, 4)

            # thermalize from cold: at least --therm transitions (the first
            # call also compiles); record-length calls keep one program
            for i in range(max(1, -(-args.therm // args.record))):
                kt, sub = jax.random.split(kt)
                links, _, _, d = record(links, sub, eps)
            float(d)
            t0 = time.perf_counter()
            links, pl16, acc, d = record(links, k1, eps)
            float(d)
            wall = time.perf_counter() - t0
            pl = np.asarray(pl16)
            ess_ratio = float(np.mean(
                [stats.calc_ess(pl[:, c]) for c in range(pl.shape[1])]))
            ess_per_s = ess_ratio * args.record * args.chains / wall
            frozen = float(acc) < 0.2
            row = {
                "num_leapfrog": num_lf, "eps": eps,
                "accept": round(float(acc), 3),
                "ess_ratio": round(ess_ratio, 4),
                "transitions_per_s": round(args.record / wall, 1),
                "ess_per_s": round(ess_per_s, 1),
            }
            if frozen:
                # a (nearly) frozen chain has a constant trace, for which
                # the ESS estimator returns ~1 — meaningless, exclude
                row["frozen"] = True
            print(json.dumps(row), flush=True)
            if not frozen and (best is None or ess_per_s > best["ess_per_s"]):
                best = row
    print(json.dumps({"best": best}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
