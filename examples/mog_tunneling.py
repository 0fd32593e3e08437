#!/usr/bin/env python
"""MoG experiment: mode tunneling, trained L2HMC (annealed) vs HMC.

Script form of ``MOGExperiment.ipynb``: a 2-D mixture of Gaussians with
well-separated modes.  HMC gets trapped in one mode (tunneling rate ~0);
the temperature-annealed learned kernel hops between them far more
often (hops per step, a per-step statistic).

Thin wrapper over the canonical CLI recipe (`cli/train_sampler.py
--target gmm_axes --annealing`) — training with tunneling-rate-driven
schedule adaptation, then an eval comparing both samplers from the same
start.

Usage: python examples/mog_tunneling.py [--train_steps 4000]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_steps", type=int, default=4000)
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--log_dir", default="runs/examples/mog")
    args = p.parse_args(argv)

    from cli.train_sampler import main as sampler_main
    from l2hmc.utils.io import latest_run_dir

    sampler_main([
        "--target", "gmm_axes", "--annealing",
        "--train_steps", str(args.train_steps),
        "--eval_steps", str(args.eval_steps),
        "--log_dir", args.log_dir,
    ])
    run_dir = latest_run_dir(args.log_dir)
    summary = json.loads((Path(run_dir) / "summary.json").read_text())
    r_l = summary["l2hmc"]["tunneling_rate"]
    r_h = summary["hmc"]["tunneling_rate"]
    print(f"\ntunneling rate  L2HMC: {r_l:.4f}   HMC: {r_h:.4f}  "
          f"({r_l / max(r_h, 1e-4):.0f}x)")
    assert r_l > 5 * max(r_h, 1e-3), "learned kernel should tunnel far more"


if __name__ == "__main__":
    main()
