#!/usr/bin/env python
"""Topological-channel head-to-head: instanton hops vs tuned HMC (r3 item 1).

Round 3 closed with the topological channel LOST at 16x16 beta=4
(tunneling/s 0.914 +- 0.003, Q-ESS/s 0.928 +- 0.013 vs HMC at its joint
(K, eps) optimum) and the negative result scoped to the single-kernel
L2HMC family.  This harness measures the ensemble move that escapes the
family: the exact winding (instanton-hop) proposal of
``dynamics/topo.py`` interleaved with the local kernel.

Protocol = the h2h_seeds campaign standard:
- every sampler advances its own 2048-chain batch from the same
  Metropolis-thermalized state;
- timed chunks are INTERLEAVED round-robin (a/b/c/a/b/c...) so clock
  drift hits all samplers equally;
- the hop cost is INSIDE the timed chunk (all ensemble cost counted);
- n_reps independent repetitions, jackknife error bars on every ratio.

Samplers:
  hmc        K/eps at the measured joint optimum (the r2/r3 baseline)
  hmc+hop    same local kernel + n_hops winding proposals per step
  champ+hop  the shipped trained champion + winding proposals
             (only when benchmarks/champion_16x16.npz matches --size)

Usage:
  python benchmarks/topo_ensemble.py --size 16 --beta 4.0 --reps 3
  python benchmarks/topo_ensemble.py --size 32 --beta 4.0 \
      --hmc_num_steps 6 --hmc_eps 0.063 --eval_steps 4000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def _trace(msg):
    print(f"[topo {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def jackknife_mean_err(vals):
    vals = np.asarray(vals, dtype=np.float64)
    n = len(vals)
    if n < 2:
        return float(vals.mean()), float("nan")
    loo = np.array([np.delete(vals, i).mean() for i in range(n)])
    err = np.sqrt((n - 1) / n * ((loo - loo.mean()) ** 2).sum())
    return float(vals.mean()), float(err)


def load_champion(size):
    """(cfg, params) from the shipped npz, or None if absent/mismatched."""
    import json as _json

    from l2hmc.train.gauge import GaugeConfig, init_train_state

    path = Path(__file__).parent / "champion_16x16.npz"
    if not path.exists():
        return None
    z = np.load(path, allow_pickle=False)
    cfg_d = _json.loads(str(z["config"]))
    if int(cfg_d.get("time_size", 0)) != size:
        return None
    known = {f.name for f in dataclasses.fields(GaugeConfig)}
    cfg = GaugeConfig(**{k: v for k, v in cfg_d.items() if k in known})
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten(state.params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(z[f"arr_{i}"]) for i in range(len(flat))])
    return cfg, params


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eval_steps", type=int, default=6000)
    p.add_argument("--eval_chains", type=int, default=2048)
    p.add_argument("--chunk_size", type=int, default=1000)
    p.add_argument("--hmc_num_steps", type=int, default=5)
    p.add_argument("--hmc_eps", type=float, default=0.08)
    p.add_argument("--n_hops", type=int, default=1)
    p.add_argument("--nu_max", type=int, default=1)
    p.add_argument("--therm_sweeps", type=int, default=1500)
    p.add_argument("--trace_chains", type=int, default=64,
                   help="on-device trace slice width; raise at large volume "
                        "so the POOLED tau_int(Q) window stays reliable "
                        "(pooling cuts rho-noise by sqrt(chains))")
    p.add_argument("--no_champion", action="store_true")
    p.add_argument("--train_champion", action="store_true",
                   help="when no shipped npz matches this size, train the "
                        "r3-recipe trained cell inline (e.g. the 32x32 "
                        "auto-tuned K=4 eps=0.095 cell) so the champ+hop "
                        "row exists at volume")
    p.add_argument("--champ_k", type=int, default=4)
    p.add_argument("--champ_eps", type=float, default=0.095)
    p.add_argument("--champ_train_steps", type=int, default=12000)
    p.add_argument("--champ_hidden", type=int, default=64)
    p.add_argument("--champ_train_hops", action="store_true",
                   help="train the inline champion with instanton hops in "
                        "the training chain (required at beta>=5: frozen "
                        "training distribution)")
    p.add_argument("--champ_seed", type=int, default=11,
                   help="inline-training seed (retrain-on-detect: pick "
                        "another if end acc lands in the beta=5 "
                        "half-acceptance basin)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from benchmarks.trained_vs_hmc import trace_stats
    from l2hmc.dynamics import topo
    from l2hmc.lattice import u1
    from l2hmc.lattice.metropolis import thermalize
    from l2hmc.train.gauge import (
        GaugeConfig, init_train_state, make_eval_chunk,
    )

    _trace(f"devices: {jax.devices()}")
    shape = u1.LatticeShape(args.size, args.size)

    hcfg = GaugeConfig(
        time_size=args.size, space_size=args.size,
        num_chains=args.eval_chains, num_steps=args.hmc_num_steps,
        hmc=True, network_arch="zero", eps_init=args.hmc_eps,
        eps_trainable=False, beta_final=args.beta)
    hparams = init_train_state(hcfg, jax.random.PRNGKey(1)).params

    n_tr = args.trace_chains

    def slice64(base):
        @jax.jit
        def chunk(params, x, beta, key):
            x, m = base(params, x, beta, key)
            return x, {k: v[:, :n_tr] for k, v in m.items()}
        return chunk

    samplers = [
        ("hmc", slice64(make_eval_chunk(hcfg, args.chunk_size)), hparams),
        ("hmc+hop", slice64(topo.make_hop_eval_chunk(
            hcfg, args.chunk_size, n_hops=args.n_hops, nu_max=args.nu_max)),
         hparams),
    ]
    champ = None if args.no_champion else load_champion(args.size)
    if champ is None and args.train_champion and not args.no_champion:
        from l2hmc.train.gauge import make_train_chunk

        tcfg = GaugeConfig(
            time_size=args.size, space_size=args.size, num_chains=128,
            num_steps=args.champ_k, network_arch="mlp",
            num_hidden=args.champ_hidden, merge_v_halves=True,
            eps_init=args.champ_eps, eps_trainable=False,
            train_steps=args.champ_train_steps, beta_final=args.beta,
            charge_reward=True, train_hops=args.champ_train_hops)
        tkey = jax.random.PRNGKey(args.champ_seed)
        tstate = init_train_state(tcfg, tkey)
        tchunk = make_train_chunk(tcfg, 250)
        kk = tkey
        t0 = time.time()
        for _ in range(max(args.champ_train_steps // 250, 1)):
            kk, sub = jax.random.split(kk)
            tstate, tm = tchunk(tstate, sub)
        _trace(f"inline champion trained ({time.time()-t0:.0f}s): end acc "
               f"{float(np.asarray(tm['accept_prob'])[-1]):.3f}")
        champ = (tcfg, tstate.params)
    if champ is not None:
        ccfg, cparams = champ
        ccfg = dataclasses.replace(ccfg, num_chains=args.eval_chains)
        samplers.append(
            ("champ+hop", slice64(topo.make_hop_eval_chunk(
                ccfg, args.chunk_size, n_hops=args.n_hops,
                nu_max=args.nu_max)), cparams))
        _trace(f"champion loaded: K={ccfg.num_steps} h{ccfg.num_hidden}")

    key = jax.random.PRNGKey(7)
    _trace(f"Metropolis thermalization ({args.therm_sweeps} sweeps)...")
    x0 = u1.random_links(key, args.eval_chains, shape)
    x0 = jax.jit(lambda x, k: thermalize(
        k, x, shape, args.beta, args.therm_sweeps))(
            x0, jax.random.fold_in(key, 9))
    float(jnp.sum(x0))

    per_rep = []
    for rep in range(args.reps):
        rkey = jax.random.fold_in(key, 100 + rep)
        xs = {tag: x0 for tag, _, _ in samplers}
        acc = {tag: {"plaqs": [], "charges": [], "wall": 0.0,
                     "accept": [], "hop_accept": []}
               for tag, _, _ in samplers}
        # compile + warm (untimed, folded keys)
        for i, (tag, ch, prm) in enumerate(samplers):
            xs[tag], m = ch(prm, xs[tag], args.beta,
                            jax.random.fold_in(rkey, 999900 + i))
            float(np.asarray(m["charges"]).sum())
        n_chunks = args.eval_steps // args.chunk_size
        for i in range(n_chunks):
            for tag, ch, prm in samplers:
                rkey, sub = jax.random.split(rkey)
                a = acc[tag]
                t0 = time.perf_counter()
                xs[tag], m = ch(prm, xs[tag], args.beta, sub)
                pl = np.asarray(m["plaqs"])          # drains the chunk
                a["wall"] += time.perf_counter() - t0
                a["plaqs"].append(pl)
                a["charges"].append(np.asarray(m["charges"]))
                a["accept"].append(np.asarray(m["accept_prob"]))
                if "hop_accept" in m:
                    a["hop_accept"].append(np.asarray(m["hop_accept"]))

        rec = {}
        for tag, _, _ in samplers:
            a = acc[tag]
            pl = np.concatenate(a["plaqs"])
            q = np.concatenate(a["charges"])
            st = trace_stats(pl, a["wall"], total_chains=args.eval_chains)
            qt = trace_stats(q, a["wall"], total_chains=args.eval_chains)
            # pooled multi-chain tau_int(Q) (analysis/stats.py, r3 item 6):
            # at large tau the per-chain Sokal window is noise; pooling the
            # 64 estimator chains extends the reliable range ~64x
            from l2hmc.analysis import stats as _st

            tau_q, tau_ok = _st.pooled_integrated_time(q)
            qt["tau_pooled"] = round(tau_q, 2)
            qt["tau_pooled_reliable"] = bool(tau_ok)
            qt["eff_samples_per_s_pooled"] = round(
                (1.0 / max(tau_q, 1.0)) * q.shape[0] * args.eval_chains
                / a["wall"], 1)
            tun = float(np.abs(np.diff(q, axis=0)).mean()) * st["steps_per_s"]
            rec[tag] = {
                "plaq": st, "charge": qt,
                "steps_per_s": st["steps_per_s"],
                "tunneling_per_s": round(tun, 2),
                "tunneling_per_step": round(
                    float(np.abs(np.diff(q, axis=0)).mean()), 4),
                "accept": round(float(np.concatenate(a["accept"]).mean()), 4),
                "plaq_mean": round(float(pl.mean()), 6),
                "q2_mean": round(float((q ** 2).mean()), 4),
            }
            if a["hop_accept"]:
                rec[tag]["hop_accept"] = round(
                    float(np.concatenate(a["hop_accept"]).mean()), 4)
        base = rec["hmc"]
        for tag in rec:
            r = rec[tag]
            r["ratio_plaq_ess_per_s"] = round(
                r["plaq"]["eff_samples_per_s"]
                / base["plaq"]["eff_samples_per_s"], 4)
            r["ratio_q_ess_per_s"] = round(
                r["charge"]["eff_samples_per_s"]
                / max(base["charge"]["eff_samples_per_s"], 1e-9), 4)
            r["ratio_q_ess_per_s_pooled"] = round(
                r["charge"]["eff_samples_per_s_pooled"]
                / max(base["charge"]["eff_samples_per_s_pooled"], 1e-9), 4)
            r["ratio_tunneling_per_s"] = round(
                r["tunneling_per_s"] / max(base["tunneling_per_s"], 1e-9), 4)
        per_rep.append(rec)
        for tag in rec:
            r = rec[tag]
            _trace(f"rep {rep} {tag}: plaq-ESS/s x{r['ratio_plaq_ess_per_s']}"
                   f" Q-ESS/s x{r['ratio_q_ess_per_s']}"
                   f" tun/s x{r['ratio_tunneling_per_s']}"
                   f" (tun/step {r['tunneling_per_step']},"
                   f" acc {r['accept']}"
                   + (f", hop_acc {r['hop_accept']}" if 'hop_accept' in r
                      else "") + f", q2 {r['q2_mean']})")

    summary = {}
    for tag, _, _ in samplers:
        s = {}
        for k in ("ratio_plaq_ess_per_s", "ratio_q_ess_per_s",
                  "ratio_q_ess_per_s_pooled", "ratio_tunneling_per_s"):
            mean, err = jackknife_mean_err([r[tag][k] for r in per_rep])
            s[k] = {"mean": round(mean, 4), "err_jk": round(err, 4)}
        s["q2_mean"], s["q2_err"] = (round(v, 4) for v in jackknife_mean_err(
            [r[tag]["q2_mean"] for r in per_rep]))
        s["plaq_mean"] = round(float(np.mean(
            [r[tag]["plaq_mean"] for r in per_rep])), 6)
        summary[tag] = s

    from l2hmc.lattice.u1 import (
        topological_susceptibility_exact, u1_plaq_exact,
    )

    result = {
        "benchmark": "topo_ensemble",
        "config": {
            "size": args.size, "beta": args.beta, "reps": args.reps,
            "eval_steps": args.eval_steps, "eval_chains": args.eval_chains,
            "hmc": f"K={args.hmc_num_steps} eps={args.hmc_eps}",
            "n_hops": args.n_hops, "nu_max": args.nu_max,
        },
        "plaq_exact": round(float(u1_plaq_exact(args.beta)), 6),
        "q2_exact": round(topological_susceptibility_exact(
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
