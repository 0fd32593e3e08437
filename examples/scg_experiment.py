#!/usr/bin/env python
"""SCG experiment: trained L2HMC vs HMC on the strongly-correlated Gaussian.

Script form of the reference's ``SCGExperiment.ipynb`` (the L2HMC paper's
headline demo, SURVEY §4): a 2-D Gaussian with condition number 1e4 —
plain HMC mixes slowly along the stiff direction; the learned kernel
rescales it away.  Prints per-coordinate ESS for both samplers.

Usage: python examples/scg_experiment.py [--train_steps 3000]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_steps", type=int, default=3000)
    p.add_argument("--num_chains", type=int, default=200)
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics.hmc import hmc_chain
    from l2hmc.targets import scg_2d
    from l2hmc.train.sampler import (
        SamplerConfig, init_sampler_state, make_sample_chain,
        make_sampler_train_chunk,
    )

    target = scg_2d()
    key = jax.random.PRNGKey(args.seed)
    cfg = SamplerConfig(x_dim=2, num_chains=args.num_chains, num_steps=10,
                        eps_init=0.1, num_hidden=10,
                        train_steps=args.train_steps)

    state = init_sampler_state(cfg, target.energy, key)
    chunk = make_sampler_train_chunk(cfg, target.energy, 500)
    t0 = time.perf_counter()
    done = 0
    while done < cfg.train_steps:
        key, sub = jax.random.split(key)
        state, m = chunk(state, sub)
        done += 500
        print(f"step {done:5d}  loss {float(np.asarray(m['loss'])[-1]):10.3f}  "
              f"acc {float(np.asarray(m['accept_prob'])[-1]):.3f}  "
              f"eps {float(np.asarray(m['eps'])[-1]):.4f}")
    print(f"trained in {time.perf_counter() - t0:.1f}s")

    sample = make_sample_chain(cfg, target.energy)
    key, k1, k2 = jax.random.split(key, 3)
    x0 = target.sample(k1, args.num_chains)
    xs, probs = sample(state.params, x0, k2, args.eval_steps)
    xs = np.asarray(xs)

    # HMC baseline at a tuned step size
    xs_h, probs_h = hmc_chain(target.energy, x0, 1.0, k2, eps=0.15,
                              num_leapfrog=10, num_samples=args.eval_steps)
    xs_h = np.asarray(xs_h)

    def ess(arr):
        return float(np.mean([stats.calc_ess(arr[:, c, d])
                              for c in range(8) for d in range(2)]))

    e_l, e_h = ess(xs), ess(xs_h)
    print(f"\nL2HMC: acc {float(np.mean(np.asarray(probs))):.3f}  "
          f"ESS/sample {e_l:.4f}")
    print(f"HMC:   acc {float(np.mean(np.asarray(probs_h))):.3f}  "
          f"ESS/sample {e_h:.4f}")
    print(f"ESS gain: {e_l / max(e_h, 1e-9):.1f}x")
    assert e_l > e_h, "trained sampler should beat HMC on the SCG target"


if __name__ == "__main__":
    main()
