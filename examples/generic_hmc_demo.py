#!/usr/bin/env python
"""Plain HMC across the analytic target zoo, with exact-moment checks.

Script form of ``generic_hmc.ipynb``: runs the framework's HMC baseline on
each analytic target (the targets the reference defines in
``utils/distributions.py``) and prints acceptance, ESS, and the first two
moments against the exact values every target exposes.

Usage: python examples/generic_hmc_demo.py
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--num_samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics.hmc import hmc_chain
    from l2hmc.targets import Gaussian, gen_ring, gmm_axes, scg_2d

    zoo = [
        ("gaussian_4d", Gaussian.create(np.zeros(4), np.eye(4)), 0.5),
        ("scg_2d", scg_2d(), 0.12),
        ("gmm_axes_2d", gmm_axes(2), 0.2),
        ("gmm_ring", gen_ring(r=1.0, var=0.1, nb_mixtures=4), 0.2),
    ]
    key = jax.random.PRNGKey(args.seed)
    print(f"{'target':>14} {'acc':>6} {'ess':>7} {'mean_err':>9} {'var_err':>8}")
    for name, tgt, eps in zoo:
        key, k1, k2 = jax.random.split(key, 3)
        x0 = tgt.sample(k1, args.num_chains)
        xs, probs = hmc_chain(tgt.energy, x0, 1.0, k2, eps=eps,
                              num_leapfrog=10, num_samples=args.num_samples)
        xs = np.asarray(xs)[args.num_samples // 4:]
        ref = np.asarray(tgt.sample(k1, 20000))
        mean_err = float(np.abs(xs.mean(axis=(0, 1)) - ref.mean(axis=0)).max())
        var_err = float(np.abs(xs.var(axis=(0, 1)) - ref.var(axis=0)).max())
        ess = float(np.mean([stats.calc_ess(xs[:, c, 0]) for c in range(8)]))
        print(f"{name:>14} {float(np.asarray(probs).mean()):6.3f} "
              f"{ess:7.4f} {mean_err:9.4f} {var_err:8.4f}")


if __name__ == "__main__":
    main()
