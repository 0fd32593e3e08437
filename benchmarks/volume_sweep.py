#!/usr/bin/env python
"""Transition time vs lattice volume: the ``training_times.ipynb`` parity.

The reference notebook fits time-per-step against target dimensionality as
a power law ``a * x^b`` from local logs it doesn't ship (SURVEY §6).  This
measures it on real hardware: jitted sampling transitions at fixed chain
count across L in {8, 16, 32, 64}, then the least-squares power-law fit.

Usage: python benchmarks/volume_sweep.py [--num_chains 128]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_chains", type=int, default=128)
    p.add_argument("--sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--arch", default="conv")
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--hidden_cap", type=int, default=4096,
                   help="cap on the dense-trunk width (128x128 needs "
                        "<=1024: the 4096-wide heads plus Adam state "
                        "exceed HBM)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.lattice import u1
    from l2hmc.train import gauge as G

    rows = []
    key = jax.random.PRNGKey(0)
    for l in args.sizes:
        cfg = G.GaugeConfig(
            time_size=l, space_size=l, num_chains=args.num_chains,
            num_steps=3, network_arch=args.arch, eps_init=0.32 / l * 2.5,
            # default hidden = 2*x_dim blows HBM at L=64 (16k hidden ->
            # multi-GB dense weights); cap like the 32x32 training runs
            num_hidden=min(2 * 2 * l * l, args.hidden_cap),
        )
        state = G.init_train_state(cfg, key)
        _, dyn, _ = G.build_dynamics(cfg)

        @jax.jit
        def chunk(params, x, k):
            def body(x, kk):
                out = dyn["transition"](params, x, 4.0, kk)
                return u1.wrap(out.x_out), out.accept_prob
            keys = jax.random.split(k, args.chunk)
            x, probs = jax.lax.scan(body, x, keys)
            return x, jnp.mean(probs), jnp.sum(x)

        x = u1.random_links(key, cfg.num_chains, cfg.shape)
        x, acc, dig = chunk(state.params, x, key)
        float(dig)
        best = 1e9
        for _ in range(3):
            key, sub = jax.random.split(key)
            t0 = time.perf_counter()
            x, acc, dig = chunk(state.params, x, sub)
            float(dig)
            best = min(best, time.perf_counter() - t0)
        ms = best / args.chunk * 1e3
        rows.append({"l": l, "x_dim": 2 * l * l, "ms_per_transition": round(ms, 4),
                     "accept": round(float(acc), 3)})
        print(json.dumps(rows[-1]), file=sys.stderr)

    dims = np.array([r["x_dim"] for r in rows], float)
    ts = np.array([r["ms_per_transition"] for r in rows], float)
    b, log_a = np.polyfit(np.log(dims), np.log(ts), 1)
    print(json.dumps({
        "metric": "transition_ms_vs_dim_power_law",
        "exponent_b": round(float(b), 3),
        "coeff_a_ms": round(float(np.exp(log_a)), 6),
        "rows": rows,
        "platform": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
