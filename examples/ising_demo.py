#!/usr/bin/env python
"""2-D Ising sweep across the critical temperature.

Script form of ``ising_lattice_dynamics.ipynb``: checkerboard Metropolis
chains at a ladder of temperatures; |magnetization| is ~1 deep in the
ordered phase, ~0 in the disordered phase, crossing near the exact
Onsager critical temperature ``T_c = 2 / ln(1 + sqrt 2) = 2.269``.

Usage: python examples/ising_demo.py [--l 16]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--l", type=int, default=16)
    p.add_argument("--num_sweeps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.lattice.ising import ising_chain

    t_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
    key = jax.random.PRNGKey(args.seed)
    print(f"L={args.l}, exact T_c = {t_c:.4f}")
    print(f"{'T':>6} {'|m|':>7} {'E/site':>8}")
    ms = {}
    for t in (1.5, 2.0, 2.27, 2.6, 3.5):
        key, sub = jax.random.split(key)
        e, m = ising_chain(sub, args.l, 1.0 / t, args.num_sweeps,
                           batch=args.batch)
        cut = args.num_sweeps // 3
        mm = float(np.asarray(m)[cut:].mean())
        ee = float(np.asarray(e)[cut:].mean()) / (args.l * args.l)
        ms[t] = mm
        print(f"{t:6.2f} {mm:7.4f} {ee:8.4f}")
    assert ms[1.5] > 0.9, "ordered phase should be ~fully magnetized"
    assert ms[3.5] < 0.3, "disordered phase should be ~unmagnetized"


if __name__ == "__main__":
    main()
