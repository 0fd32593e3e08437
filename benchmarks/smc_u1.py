#!/usr/bin/env python
"""SMC over the beta ladder on U(1) lattice gauge theory (BASELINE config 5).

Anneals a particle ensemble of lattice configurations from beta_init to
beta_final with importance reweighting + systematic resampling + HMC move
kernels, producing (a) equilibrated configurations at beta_final, (b) an
estimate of log Z(beta_final)/Z(beta_init), and (c) the average plaquette
checked against the analytic oracle.

In 2-D U(1) the partition function factorizes over plaquettes (up to the
global charge constraint), so log Z(b1)/Z(b0) per plaquette is analytically
``log[ I0(b1) e^{-b1} / (I0(b0) e^{-b0}) ]`` — an exact anchor for the SMC
normalizer on top of the plaquette check.

Usage:
    python benchmarks/smc_u1.py --size 16 --particles 256 --betas 31
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
    p.add_argument("--particles", type=int, default=256)
    p.add_argument("--beta_init", type=float, default=1.0)
    p.add_argument("--beta_final", type=float, default=4.0)
    p.add_argument("--betas", type=int, default=31, help="ladder rungs")
    p.add_argument("--moves_per_rung", type=int, default=5)
    p.add_argument("--leapfrog", type=int, default=5)
    p.add_argument("--thermalize", type=int, default=500,
                   help="HMC steps to equilibrate at beta_init first")
    p.add_argument("--move", default="hmc", choices=["hmc", "fused"],
                   help="move kernel: XLA-scan HMC (default) or the "
                        "whole-chain path (dynamics/hmc.py "
                        "hmc_chain_u1_fused: one CUDA kernel launch per "
                        "rung on a GPU, the XLA scan elsewhere)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.dynamics.hmc import hmc_chain
    from l2hmc.dynamics.smc import smc_beta_ladder
    from l2hmc.lattice import u1

    shape = u1.LatticeShape(args.size, args.size)
    pot = u1.make_potential_fn(shape)
    key = jax.random.PRNGKey(0)

    # equilibrate the ensemble at beta_init
    k0, k1, key = jax.random.split(key, 3)
    x0 = u1.random_links(k0, args.particles, shape)
    eps0 = (64.0 / shape.num_plaquettes) ** 0.25 * 0.4 / np.sqrt(args.beta_init)
    xs, probs = jax.jit(
        lambda x, k: hmc_chain(pot, x, args.beta_init, k, eps0, args.leapfrog,
                               args.thermalize, wrap_fn=u1.wrap)
    )(x0, k1)
    x0 = xs[-1]

    from l2hmc.dynamics.smc import (
        make_u1_fused_move, make_u1_hmc_move, u1_log_z_exact_factorized,
        weighted_mean,
    )

    use_fused = args.move == "fused"
    if use_fused:
        move = make_u1_fused_move(shape, args.leapfrog, args.moves_per_rung)
    else:
        move = make_u1_hmc_move(pot, u1.wrap, shape.num_plaquettes,
                                args.leapfrog, args.moves_per_rung)

    betas = jnp.linspace(args.beta_init, args.beta_final, args.betas)
    t0 = time.perf_counter()
    final, ess_trace = jax.jit(
        lambda k, x: smc_beta_ladder(k, x, pot, betas, move)
    )(key, x0)
    log_z = float(final.log_z)
    wall = time.perf_counter() - t0

    obs = u1.observables(final.x, shape)
    # importance-weighted mean: the final population carries residual
    # log-weights under adaptive resampling
    plaq = float(weighted_mean(final.log_w, obs["plaqs"]))
    exact = float(u1.u1_plaq_exact(args.beta_final))

    log_z_exact = u1_log_z_exact_factorized(
        shape.num_plaquettes, args.beta_init, args.beta_final)

    result = {
        "lattice": f"{args.size}x{args.size}",
        "particles": args.particles,
        "beta": [args.beta_init, args.beta_final],
        "plaq": round(plaq, 5),
        "plaq_exact": round(exact, 5),
        "log_z": round(log_z, 2),
        "log_z_exact_factorized": round(log_z_exact, 2),
        "min_ess_frac": round(float(np.asarray(ess_trace).min()) / args.particles, 3),
        "wall_s": round(wall, 2),
        "move": "fused" if use_fused else "hmc",
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
