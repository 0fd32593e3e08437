#!/usr/bin/env python
"""Matched-physical-volume freezing line: the hop's advantage along beta ∝ V.

The claim "at matched physical volume the hop's beta*dS stays constant
while HMC's tunneling dies exponentially" needs the line itself, not one
point plus an argument.  At FIXED beta the tunneling ratio shrinks with
volume, so the physically-relevant direction — fixed lattice
spacing, beta ∝ V, the continuum limit at constant physical volume — is
the load-bearing axis.  This driver measures it.

Physics of the line: in 2-D U(1) the continuum coupling sets the spacing
via beta ~ 1/(g^2 a^2); holding the physical volume L_phys = a*L fixed
while refining a means beta ∝ L^2 = V.  Along that line:

- the hop's Metropolis exponent beta*dS stays O(1): dS concentrates at
  ~ (2 pi^2 / V)(<cos P> V)/V * ... -> beta*dS ~ beta/V = const, so hop
  acceptance approaches a CONSTANT (measured column `hop_accept`),
- HMC's diffusive tunneling rate dies exponentially in beta (instanton
  suppression e^{-beta * S_inst}), which is the textbook freezing problem.

Protocol per point = the topo_ensemble campaign standard (interleaved
timed chunks, all hop cost counted, pooled multi-chain tau_int(Q),
jackknife over reps), with the HMC baseline at its OWN auto-tuned joint
(K, eps) optimum at that (size, beta) — zero hand-picked integrator
settings (train/autotune.py tune_hmc).

Usage:
  python benchmarks/freeze_line.py --points 8:2.5,16:5.0,32:10.0 \
      --reps 3 --eval_steps 8000
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax


def _trace(msg):
    print(f"[freeze {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--points", default="8:2.5,16:5.0,32:10.0",
                   help="comma list of size:beta along the beta ∝ V line")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=8000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--trace_chains", type=int, default=256)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--probe_chains", type=int, default=1024)
    p.add_argument("--hmc_cache", default="",
                   help="optional cached optima 'size:K:eps;...' to skip "
                        "tune_hmc at points already tuned (tuner-produced "
                        "values only — e.g. from a prior campaign JSON)")
    p.add_argument("--out_dir", default="runs")
    args = p.parse_args(argv)

    from benchmarks import topo_ensemble
    from l2hmc.lattice import u1
    from l2hmc.lattice.metropolis import thermalize
    from l2hmc.train.autotune import tune_hmc
    from l2hmc.train.gauge import GaugeConfig

    cache = {}
    for item in args.hmc_cache.split(";"):
        if item:
            s, k, e = item.split(":")
            cache[int(s)] = (int(k), float(e))

    points = []
    for item in args.points.split(","):
        s, b = item.split(":")
        points.append((int(s), float(b)))
    _trace(f"devices: {jax.devices()}; line: {points}")

    rows = []
    for size, beta in points:
        cfg = GaugeConfig(time_size=size, space_size=size,
                          num_chains=args.probe_chains, beta_final=beta)
        if size in cache:
            k_h, eps_h = cache[size]
            _trace(f"{size}x{size} beta={beta}: cached HMC K={k_h} "
                   f"eps={eps_h}")
        else:
            key = jax.random.PRNGKey(31 + size)
            x0 = u1.random_links(key, args.probe_chains, cfg.shape)
            x0 = jax.jit(lambda x, k: thermalize(
                k, x, cfg.shape, beta, args.therm_sweeps))(
                    x0, jax.random.fold_in(key, 7))
            t0 = time.perf_counter()
            opt = tune_hmc(cfg, x0, beta, jax.random.fold_in(key, 1),
                           probe_chains=args.probe_chains)
            k_h, eps_h = opt.num_steps, opt.eps
            _trace(f"{size}x{size} beta={beta}: tuned HMC K={k_h} "
                   f"eps={eps_h} acc={opt.accept:.3f} "
                   f"({time.perf_counter()-t0:.0f}s)")

        out_path = f"{args.out_dir}/freeze_{size}_{beta:g}.json"
        topo_ensemble.main([
            "--size", str(size), "--beta", str(beta),
            "--reps", str(args.reps),
            "--eval_steps", str(args.eval_steps),
            "--eval_chains", str(args.eval_chains),
            "--trace_chains", str(args.trace_chains),
            "--therm_sweeps", str(args.therm_sweeps),
            "--hmc_num_steps", str(k_h), "--hmc_eps", str(eps_h),
            "--no_champion", "--out", out_path,
        ])
        res = json.loads(Path(out_path).read_text())
        s = res["summary"]["hmc+hop"]
        h = res["summary"]["hmc"]
        row = {
            "size": size, "beta": beta,
            "hmc": f"K={k_h} eps={eps_h}",
            "hop_accept": res["per_rep"][0]["hmc+hop"].get("hop_accept"),
            "ratio_tunneling_per_s": s["ratio_tunneling_per_s"],
            "ratio_q_ess_per_s_pooled": s["ratio_q_ess_per_s_pooled"],
            "ratio_plaq_ess_per_s": s["ratio_plaq_ess_per_s"],
            "hmc_tunneling_per_step": res["per_rep"][0]["hmc"][
                "tunneling_per_step"],
            "hop_tunneling_per_step": res["per_rep"][0]["hmc+hop"][
                "tunneling_per_step"],
            "q2_hop": s["q2_mean"], "q2_hmc": h["q2_mean"],
            "q2_exact": res["q2_exact"],
            "detail": out_path,
        }
        rows.append(row)
        _trace(f"row: {json.dumps(row)}")

    result = {"benchmark": "freeze_line",
              "protocol": (f"topo_ensemble reps={args.reps} "
                           f"eval_steps={args.eval_steps} "
                           f"chains={args.eval_chains}, HMC auto-tuned "
                           "per point, all hop cost counted"),
              "rows": rows}
    out_s = json.dumps(result)
    print(out_s)
    Path(f"{args.out_dir}/freeze_line.json").write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
