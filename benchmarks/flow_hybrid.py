#!/usr/bin/env python
"""Flow+HMC hybrid chain vs pure HMC on topological mixing.

The trained L2HMC kernel moves the charge by local, diffusive steps.  The
flow gives a qualitatively different lever: independence proposals draw a
FRESH topological sector, so even a modest flow acceptance rate can beat
local kernels on tau_int(Q) — whose cost for local kernels grows steeply
with beta (topological freezing).  Measured cost-normalized:

  hybrid:  M HMC transitions + 1 flow independence proposal per round
           (exact p-stationarity; the flow accept evaluates q at the
           HMC-evolved state via the numerical inverse)
  control: the same round structure without the flow move

Both run as jitted chunks of rounds (one compile, several dispatches);
per-round topological charge is the only readback.

Usage:
    python benchmarks/flow_hybrid.py --checkpoint runs/flow16/run_1 \
        --beta 4.0 --rounds 400 --hmc_per_round 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def log(msg):
    print(f"[flow_hybrid {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="run dir of cli/train_flow.py (reads checkpoints/)")
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--chains", type=int, default=128)
    p.add_argument("--rounds", type=int, default=400)
    p.add_argument("--chunk_rounds", type=int, default=50)
    p.add_argument("--hmc_per_round", type=int, default=10)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--hmc_leapfrog", type=int, default=5)
    p.add_argument("--therm", type=int, default=500, help="HMC thermalization")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics import flow as F
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused, hmc_transition
    from l2hmc.lattice import u1
    from l2hmc.train import checkpoint as ckpt

    run_dir = Path(args.checkpoint)
    cfg_dict = ckpt.load_config_dict(run_dir / "checkpoints")
    if cfg_dict is None:
        raise FileNotFoundError(
            f"no config.json under {run_dir}/checkpoints — is this a "
            "train_flow run dir?")
    cfg = F.FlowConfig(**cfg_dict)
    key = jax.random.PRNGKey(3)
    params = ckpt.restore_checkpoint(
        run_dir / "checkpoints", F.init_flow(key, cfg))
    lt, lx = cfg.time_size, cfg.space_size
    b = args.chains
    pot = u1.make_potential_fn(u1.LatticeShape(lt, lx))
    log(f"{lt}x{lx} beta={args.beta} layers={cfg.num_layers} chains={b}")

    k0, k1, k2, key = jax.random.split(key, 4)
    links = jnp.zeros((b, lt, lx, 2))
    links, _, _, _ = jax.jit(lambda l, k: hmc_chain_u1_fused(
        l, k, args.hmc_eps, args.beta, args.hmc_leapfrog, args.therm))(
            links, k0)
    jax.block_until_ready(links)
    log("thermalized")

    hybrid_chunk = jax.jit(lambda l, k: F.flow_hmc_hybrid_chain(
        params, k, l, args.beta, args.chunk_rounds, args.hmc_per_round,
        args.hmc_eps, args.hmc_leapfrog, cfg))

    def control_rounds(links, k):
        def one_round(x, kk):
            def hmc_body(x, kkk):
                out = hmc_transition(pot, x, args.beta, kkk, args.hmc_eps,
                                     args.hmc_leapfrog)
                return u1.wrap(out.x_out), out.accept_prob

            x, probs = jax.lax.scan(
                hmc_body, x, jax.random.split(kk, args.hmc_per_round))
            q = u1.topological_charge(x.reshape(b, lt, lx, 2))
            return x, (q, jnp.mean(probs))

        x, (qs, accs) = jax.lax.scan(one_round, links.reshape(b, -1),
                                     jax.random.split(k, args.chunk_rounds))
        return x.reshape(b, lt, lx, 2), qs, accs

    control_chunk = jax.jit(control_rounds)

    n_chunks = max(1, args.rounds // args.chunk_rounds)
    n_rounds = n_chunks * args.chunk_rounds      # rounds that actually run

    def run_chain(chunk_fn, links, key, unpack):
        qs_all, acc_all, plaq_all = [], [], []
        # compile
        out = chunk_fn(links, key)
        jax.block_until_ready(out)
        log("chunk compiled")
        t0 = time.perf_counter()
        for i in range(n_chunks):
            key, sub = jax.random.split(key)
            links, q, acc, plaq = unpack(chunk_fn(links, sub))
            qs_all.append(q)
            acc_all.append(acc)
            if plaq is not None:
                plaq_all.append(plaq)
        float(jnp.sum(qs_all[-1]))               # drain before stopping clock
        wall = time.perf_counter() - t0
        # trace readback stays OUTSIDE the timed region (not sampling cost)
        qs = np.concatenate([np.asarray(q) for q in qs_all])
        acc = float(np.mean([np.asarray(a).mean() for a in acc_all]))
        plaq = (float(np.mean([np.asarray(x).mean() for x in plaq_all]))
                if plaq_all else None)
        return qs, acc, plaq, wall

    qs_h, facc, plaq_h, wall_h = run_chain(
        hybrid_chunk, links, k1,
        lambda o: (o[0], o[1], o[3], o[2]))
    log(f"hybrid done: {wall_h:.1f}s flow_acc={facc:.4f}")
    qs_c, hacc, _, wall_c = run_chain(
        control_chunk, links, k2,
        lambda o: (o[0], o[1], o[2], None))
    log(f"control done: {wall_c:.1f}s hmc_acc={hacc:.4f}")

    def q_stats(q):
        dq = np.abs(np.diff(q, axis=0)).mean()
        taus = [stats.integrated_time(q[:, c])[0]
                for c in range(min(32, q.shape[1]))]
        return float(dq), float(np.mean(taus)), float((q ** 2).mean())

    dq_h, tau_h, chi_h = q_stats(qs_h)
    dq_c, tau_c, chi_c = q_stats(qs_c)
    chi_exact = float(u1.topological_susceptibility_exact(args.beta, lt * lx))

    result = {
        "lattice": f"{lt}x{lx}", "beta": args.beta, "chains": b,
        "rounds": n_rounds, "hmc_per_round": args.hmc_per_round,
        "flow_accept": round(facc, 4),
        "hmc_accept": round(hacc, 4),
        "plaq_hybrid": round(plaq_h, 5),
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 5),
        "chi_q": {"hybrid": round(chi_h, 3), "hmc": round(chi_c, 3),
                  "exact": round(chi_exact, 3)},
        "dq_per_round": {"hybrid": round(dq_h, 4), "hmc": round(dq_c, 4)},
        "tau_int_q_rounds": {"hybrid": round(tau_h, 2),
                             "hmc": round(tau_c, 2)},
        "wall_s": {"hybrid": round(wall_h, 2), "hmc": round(wall_c, 2)},
        "dq_per_s": {
            "hybrid": round(dq_h * n_rounds / wall_h, 2),
            "hmc": round(dq_c * n_rounds / wall_c, 2)},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
