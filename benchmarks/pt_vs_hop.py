#!/usr/bin/env python
"""Parallel tempering vs the instanton hop at the freezing point.

``dynamics/tempering.py`` is exact and tested, but the case against it
("O(R^2) ladder round trips for ~R-x cost") is an argument until it is
measured — and PT is the only shipped topological mechanism that
generalizes beyond 2-D U(1) (the hop's closed form does not).  This
harness settles it with the topo_ensemble protocol at 16x16 beta=5 (the
freezing regime):

- samplers: tuned HMC, HMC+hop, and a PT ladder (R rungs beta 5 -> 2,
  all rungs' wall-clock counted — they run as ONE flat (R*C, d) kernel);
- every sampler's usable output is its target-beta chains; ESS/s
  normalizes by usable chains over TOTAL wall, so the R-x ensemble cost
  is priced in;
- interleaved timed chunks, pooled multi-chain tau_int(Q), jackknife
  over reps.

Usage:
  python benchmarks/pt_vs_hop.py --beta 5.0 --rungs 5 --reps 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def _trace(msg):
    print(f"[pt {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def jackknife_mean_err(vals):
    vals = np.asarray(vals, dtype=np.float64)
    n = len(vals)
    if n < 2:
        return float(vals.mean()), float("nan")
    loo = np.array([np.delete(vals, i).mean() for i in range(n)])
    err = np.sqrt((n - 1) / n * ((loo - loo.mean()) ** 2).sum())
    return float(vals.mean()), float(err)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=5.0)
    p.add_argument("--beta_min", type=float, default=2.0)
    p.add_argument("--rungs", type=int, default=5)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--chunk_size", type=int, default=500)
    p.add_argument("--chains", type=int, default=2048,
                   help="HMC / HMC+hop batch")
    p.add_argument("--pt_chains", type=int, default=512,
                   help="chains PER RUNG (usable output = this)")
    p.add_argument("--hmc_num_steps", type=int, default=4)
    p.add_argument("--hmc_eps", type=float, default=0.079,
                   help="auto-tuned 16x16 beta=5 optimum (freeze_line)")
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--trace_chains", type=int, default=256)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from benchmarks.trained_vs_hmc import trace_stats
    from l2hmc.analysis import stats as _st
    from l2hmc.dynamics import topo
    from l2hmc.dynamics.tempering import PTConfig, make_pt_chunk
    from l2hmc.lattice import u1
    from l2hmc.lattice.metropolis import thermalize
    from l2hmc.ops.wilson import make_potential_fn
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_eval_chunk,
    )

    _trace(f"devices: {jax.devices()}")
    shape = u1.LatticeShape(args.size, args.size)
    n_tr = args.trace_chains

    # ladder: linear in beta, target first; per-rung eps from the tuned
    # target-eps by the leapfrog-error scaling eps ~ beta^(-1/2) (error
    # per step ~ beta * eps^2 at fixed K)
    betas = tuple(float(b) for b in np.linspace(
        args.beta, args.beta_min, args.rungs))
    eps = tuple(round(args.hmc_eps * float(np.sqrt(args.beta / b)), 5)
                for b in betas)
    pt_cfg = PTConfig(betas=betas, eps=eps, num_steps=args.hmc_num_steps)
    _trace(f"ladder: betas={betas} eps={eps}")

    hcfg = GaugeConfig(
        time_size=args.size, space_size=args.size, num_chains=args.chains,
        num_steps=args.hmc_num_steps, hmc=True, network_arch="zero",
        eps_init=args.hmc_eps, eps_trainable=False, beta_final=args.beta)
    hparams = init_train_state(hcfg, jax.random.PRNGKey(1)).params

    def slice_tr(base):
        @jax.jit
        def chunk(params, x, beta, key):
            x, m = base(params, x, beta, key)
            return x, {k: v[:, :n_tr] for k, v in m.items()}
        return chunk

    ch_h = slice_tr(make_eval_chunk(hcfg, args.chunk_size))
    ch_hop = slice_tr(topo.make_hop_eval_chunk(hcfg, args.chunk_size))

    potential = make_potential_fn(shape)

    def obs_fn(x0):
        o = u1.observables(x0, shape)
        return {"plaqs": o["plaqs"][:n_tr], "charges": o["charges"][:n_tr]}

    pt_chunk = make_pt_chunk(potential, pt_cfg, args.chunk_size,
                             wrap_fn=u1.wrap, observables_fn=obs_fn)

    key = jax.random.PRNGKey(77)
    _trace(f"thermalizing HMC batch + {args.rungs} PT rungs...")
    x0 = u1.random_links(key, args.chains, shape)
    x0 = jax.jit(lambda x, k: thermalize(
        k, x, shape, args.beta, args.therm_sweeps))(
            x0, jax.random.fold_in(key, 9))
    float(jnp.sum(x0))
    rungs = []
    for i, b in enumerate(betas):
        xr = u1.random_links(jax.random.fold_in(key, 20 + i),
                             args.pt_chains, shape)
        xr = jax.jit(lambda x, k, b=b: thermalize(
            k, x, shape, b, args.therm_sweeps))(
                xr, jax.random.fold_in(key, 40 + i))
        rungs.append(xr)
    x_pt = jnp.stack(rungs)
    float(jnp.sum(x_pt))

    per_rep = []
    for rep in range(args.reps):
        rkey = jax.random.fold_in(key, 100 + rep)
        states = {"hmc": x0, "hmc+hop": x0, "pt": x_pt}
        acc = {t: {"plaqs": [], "charges": [], "wall": 0.0, "extra": {}}
               for t in states}
        rnd = jnp.asarray(0, jnp.int32)

        # warm + compile (untimed)
        states["hmc"], m = ch_h(hparams, states["hmc"], args.beta,
                                jax.random.fold_in(rkey, 999901))
        float(np.asarray(m["charges"]).sum())
        states["hmc+hop"], m = ch_hop(hparams, states["hmc+hop"], args.beta,
                                      jax.random.fold_in(rkey, 999902))
        float(np.asarray(m["charges"]).sum())
        states["pt"], m = pt_chunk(states["pt"],
                                   jax.random.fold_in(rkey, 999903), rnd)
        rnd = rnd + args.chunk_size
        float(np.asarray(m["charges"]).sum())

        n_chunks = args.eval_steps // args.chunk_size
        for i in range(n_chunks):
            for tag in ("hmc", "hmc+hop", "pt"):
                rkey, sub = jax.random.split(rkey)
                a = acc[tag]
                t0 = time.perf_counter()
                if tag == "pt":
                    states[tag], m = pt_chunk(states[tag], sub, rnd)
                    rnd = rnd + args.chunk_size
                else:
                    prm = hparams
                    ch = ch_h if tag == "hmc" else ch_hop
                    states[tag], m = ch(prm, states[tag], args.beta, sub)
                pl = np.asarray(m["plaqs"])         # drains the chunk
                a["wall"] += time.perf_counter() - t0
                a["plaqs"].append(pl)
                a["charges"].append(np.asarray(m["charges"]))
                if tag == "pt":
                    a["extra"].setdefault("swap_rate", []).append(
                        np.asarray(m["swap_rate"]))
                if "hop_accept" in m:
                    a["extra"].setdefault("hop_accept", []).append(
                        np.asarray(m["hop_accept"]))

        rec = {}
        for tag in states:
            a = acc[tag]
            pl = np.concatenate(a["plaqs"])
            q = np.concatenate(a["charges"])
            usable = args.pt_chains if tag == "pt" else args.chains
            st = trace_stats(pl, a["wall"], max_chains=n_tr,
                             total_chains=usable)
            tau_q, tau_ok = _st.pooled_integrated_time(q)
            tun = (float(np.abs(np.diff(q, axis=0)).mean())
                   * st["steps_per_s"])
            rec[tag] = {
                "plaq": st, "plaq_mean": round(float(pl.mean()), 6),
                "q2_mean": round(float((q ** 2).mean()), 4),
                "q_tau_pooled": round(tau_q, 2),
                "q_tau_pooled_reliable": bool(tau_ok),
                "q_ess_per_s_pooled": round(
                    (1.0 / max(tau_q, 1.0)) * q.shape[0] * usable
                    / a["wall"], 1),
                "tunneling_per_s_per_chain": round(tun, 4),
                "tunneling_per_step": round(
                    float(np.abs(np.diff(q, axis=0)).mean()), 4),
                "usable_chains": usable,
            }
            if "swap_rate" in a["extra"]:
                sw = np.concatenate(a["extra"]["swap_rate"])
                rec[tag]["swap_rate_per_pair"] = [
                    round(float(s), 3) for s in sw.mean(axis=0)]
            if "hop_accept" in a["extra"]:
                rec[tag]["hop_accept"] = round(float(np.concatenate(
                    a["extra"]["hop_accept"]).mean()), 4)
        base = rec["hmc"]
        for tag in rec:
            r = rec[tag]
            r["ratio_q_ess_per_s_pooled"] = round(
                r["q_ess_per_s_pooled"]
                / max(base["q_ess_per_s_pooled"], 1e-9), 4)
            r["ratio_plaq_ess_per_s"] = round(
                r["plaq"]["eff_samples_per_s"]
                / base["plaq"]["eff_samples_per_s"], 4)
        per_rep.append(rec)
        for tag in rec:
            r = rec[tag]
            _trace(f"rep {rep} {tag}: Q-ESS/s(pooled) "
                   f"x{r['ratio_q_ess_per_s_pooled']} "
                   f"tau_Q {r['q_tau_pooled']} "
                   f"tun/step {r['tunneling_per_step']} "
                   f"q2 {r['q2_mean']}"
                   + (f" swaps {r['swap_rate_per_pair']}"
                      if 'swap_rate_per_pair' in r else ""))

    summary = {}
    for tag in per_rep[0]:
        s = {}
        for k in ("ratio_q_ess_per_s_pooled", "ratio_plaq_ess_per_s"):
            mean, err = jackknife_mean_err([r[tag][k] for r in per_rep])
            s[k] = {"mean": round(mean, 4), "err_jk": round(err, 4)}
        s["q_tau_pooled"] = round(float(np.mean(
            [r[tag]["q_tau_pooled"] for r in per_rep])), 2)
        s["q2_mean"] = round(float(np.mean(
            [r[tag]["q2_mean"] for r in per_rep])), 4)
        summary[tag] = s

    result = {
        "benchmark": "pt_vs_hop",
        "config": {
            "size": args.size, "beta": args.beta, "reps": args.reps,
            "ladder": {"betas": betas, "eps": eps,
                       "K": args.hmc_num_steps,
                       "chains_per_rung": args.pt_chains},
            "hmc": f"K={args.hmc_num_steps} eps={args.hmc_eps} "
                   f"@{args.chains}",
            "eval_steps": args.eval_steps,
        },
        "plaq_exact": round(float(u1.u1_plaq_exact(args.beta)), 6),
        "q2_exact": round(u1.topological_susceptibility_exact(
            args.beta, shape.num_plaquettes), 4),
        "per_rep": per_rep,
        "summary": summary,
    }
    out_s = json.dumps(result)
    print(out_s)
    if args.out:
        Path(args.out).write_text(out_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
