"""4-D SU(N) Lie-group HMC throughput + physics check on one chip.

Runs the d-dimensional path (`lattice/sun_nd.py`) at a 4-D SU(3) config,
reports link-updates/s and the measured plaquette against the
strong-coupling anchor at small beta.

Usage:  python benchmarks/sun_nd_bench.py [--n 3] [--l 8] [--beta 1.0]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--l", type=int, default=8, help="lattice extent (L^4)")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eps", type=float, default=0.0,
                   help="0 -> volume-scaled 0.32/L (leapfrog error ~ V eps^4)")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--rect_c1", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.eps == 0.0:
        args.eps = 0.32 / args.l

    # real-pair representation (ops/cmat.py); trajectory-identical to the
    # complex form (tested)
    from l2hmc.lattice.sun_nd import (
        avg_plaq_nd_pairs, improved_action_nd_pairs, random_links_nd_pairs,
        sun_nd_hmc_transition_pairs, sun_plaq_strong_coupling,
        wilson_action_nd_pairs,
    )

    dims = (args.l,) * 4
    if args.rect_c1 != 0.0:
        action = lambda u: improved_action_nd_pairs(u, args.beta, args.rect_c1)
    else:
        action = lambda u: wilson_action_nd_pairs(u, args.beta)

    key = jax.random.PRNGKey(0)
    links = random_links_nd_pairs(key, args.n, args.batch, dims, scale=0.5)

    @jax.jit
    def chunk(u, k):
        def body(u, kk):
            out = sun_nd_hmc_transition_pairs(
                u, kk, args.eps, args.num_steps, action)
            return out.links, (avg_plaq_nd_pairs(out.links), out.accept_prob)

        keys = jax.random.split(k, args.chunk)
        u, (plaqs, probs) = jax.lax.scan(body, u, keys)
        return u, plaqs, probs, jnp.sum(jnp.abs(u))

    t0 = time.perf_counter()
    links, plaqs, probs, digest = chunk(links, key)
    float(digest)
    compile_s = time.perf_counter() - t0

    best = float("inf")
    all_plaqs = []
    for i in range(args.chunks):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        links, plaqs, probs, digest = chunk(links, sub)
        float(digest)
        best = min(best, time.perf_counter() - t0)
        all_plaqs.append(np.asarray(plaqs))

    num_links = args.batch * int(np.prod(dims)) * 4
    link_updates_per_s = num_links * args.num_steps * args.chunk / best
    meas = float(np.concatenate(all_plaqs[1:]).mean()) if args.chunks > 1 \
        else float(all_plaqs[0][args.chunk // 2:].mean())
    print(json.dumps({
        "metric": "sun4d_link_updates_per_s",
        "value": round(link_updates_per_s, 1),
        "config": f"SU({args.n}) {args.l}^4 beta={args.beta} "
                  f"batch={args.batch} {args.num_steps} lf-steps c1={args.rect_c1}",
        "plaq": round(meas, 5),
        "plaq_strong_coupling_lo": sun_plaq_strong_coupling(args.n, args.beta),
        "accept_prob": round(float(np.asarray(probs).mean()), 4),
        "ms_per_transition": round(best * 1e3 / args.chunk, 3),
        "compile_s": round(compile_s, 1),
        "platform": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
