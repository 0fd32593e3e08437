"""Benchmark: L2HMC sampling throughput on U(1) 16x16 on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": R,
   "platform": "gpu", "device_kind": ..., "device_count": 1, ...}

- ``lf_steps_per_s_merged_kernel``: (transitions * leapfrog steps *
  chains) / wall for the fused-direction transition with merged momentum
  half-kicks (periodic CNN networks, sampling path) at 2048 chains;
  ``vs_baseline_dataflow`` is its speedup over the *reference dataflow* on
  the same card — the compute-both-directions-and-mask transition the TF
  implementation uses (reference ``dynamics/gauge_dynamics.py:195-259``).
  The reference publishes no numbers of its own (BASELINE.md), so the
  baseline is its algorithmic dataflow here.
- ``plaq_ess_per_s``: effective plaquette samples per second of plain HMC
  (K=5, eps=0.08, 2048 chains) on ``hmc_chain_u1_fused`` — one launch of
  the whole-chain CUDA kernel per 1500 transitions.
- ``trained_*``: the committed champion (benchmarks/champion_16x16.npz)
  against HMC at (K=5, eps=0.08), with and without an instanton hop, on
  the same XLA eval harness, chunks interleaved; the headline then is the
  champion's effective plaquette samples per second.

Every timed call ends in ``block_until_ready``; compilation happens in a
warm-up call outside the timing.  A platform other than the GPU is an
error.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import numpy as np


def _trace(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


CHUNK = 100  # transitions per device program

def bench_transition(cfg, both_directions: bool, repeats: int, key,
                     merge_v_halves: bool = False):
    from l2hmc.train import gauge as G
    from l2hmc.lattice import u1
    import dataclasses

    cfg = dataclasses.replace(cfg, both_directions=both_directions,
                              merge_v_halves=merge_v_halves)
    _trace(f"init state (both={both_directions})...")
    state = G.init_train_state(cfg, key)
    _, dyn, _ = G.build_dynamics(cfg)

    def sample_chunk(params, x, key):
        def body(x, k):
            out = dyn["transition"](params, x, 4.0, k)
            return u1.wrap(out.x_out), out.accept_prob
        keys = jax.random.split(key, CHUNK)
        x, probs = jax.lax.scan(body, x, keys)
        return x, jnp.mean(probs)

    x = u1.random_links(key, cfg.num_chains, cfg.shape)
    _trace("compiling + warmup...")
    compiled = jax.jit(sample_chunk).lower(state.params, x, key).compile()
    x, acc = jax.block_until_ready(compiled(state.params, x, key))
    _trace("warm; timing...")

    best = float("inf")
    for i in range(repeats):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        x, acc = jax.block_until_ready(compiled(state.params, x, sub))
        dt = time.perf_counter() - t0
        best = min(best, dt)
    lf_steps = CHUNK * cfg.num_steps * cfg.num_chains
    return lf_steps / best, float(acc), best


def main():
    from l2hmc.train.gauge import GaugeConfig

    cfg = GaugeConfig(
        time_size=16, space_size=16, num_chains=128, num_steps=3,
        network_arch="conv", num_filters=8, eps_init=0.1,
    )
    key = jax.random.PRNGKey(42)

    import dataclasses as _dc0

    # canonical batch (reference config: 128 chains) — latency-floor regime
    fused128, acc, dt = bench_transition(cfg, False, repeats=5, key=key,
                                         merge_v_halves=True)
    _trace(f"merged@128: {fused128:,.0f} lf-steps/s ({dt*1e3/CHUNK:.3f} ms/transition)")
    # chains are embarrassingly parallel: the headline is measured at a
    # batch that fills the card
    big = _dc0.replace(cfg, num_chains=2048)
    # headline kernel: fused direction + merged momentum half-kicks (K+1
    # VNet calls instead of 2K; exact MH kernel, physics-validated — the
    # 8x8 merged training run hits the plaquette oracle to 1.5e-4)
    fused_rate, _, dt_big = bench_transition(
        big, False, repeats=4, key=key, merge_v_halves=True)
    _trace(f"merged@2048: {fused_rate:,.0f} lf-steps/s")
    # reference-parity kernel (same learned family as the reference)
    parity_rate, _, dt_parity = bench_transition(big, False, repeats=3, key=key)
    _trace(f"parity-fused@2048: {parity_rate:,.0f} lf-steps/s")
    ref_rate, _, dt_ref = bench_transition(big, True, repeats=2, key=key)
    _trace(f"reference-dataflow@2048: {ref_rate:,.0f} lf-steps/s")

    # ESS/s of the average plaquette: plain HMC (well-defined without a
    # trained checkpoint) on hmc_chain_u1_fused, 1500 transitions per call,
    # thermalized chains, 3000 recorded transitions at 2048 chains
    from l2hmc.analysis import stats as _stats
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused

    ess_chains = 2048
    ess_leapfrog, ess_eps = 5, 0.08
    links = jnp.zeros((ess_chains, cfg.time_size, cfg.space_size, 2))

    @jax.jit
    def record(links, key):
        links, pl_tr, _, _ = hmc_chain_u1_fused(
            links, key, ess_eps, 4.0, ess_leapfrog, 1500)
        # 16-chain trace slice for the ESS estimate
        return links, pl_tr[:, :16]

    keys = jax.random.split(key, 3)
    links, _ = jax.block_until_ready(record(links, keys[0]))  # therm+compile
    t0 = time.perf_counter()
    handles = []
    for i in range(2):
        links, pl16 = jax.block_until_ready(record(links, keys[i + 1]))
        handles.append(pl16)
    wall = time.perf_counter() - t0
    pl = np.concatenate([np.asarray(h) for h in handles])  # (3000, 16)
    ess_ratio = float(np.mean([
        _stats.calc_ess(pl[:, c]) for c in range(pl.shape[1])
    ]))
    ess_per_s = ess_ratio * pl.shape[0] * ess_chains / wall
    _trace(f"ESS ratio {ess_ratio:.4f} -> {ess_per_s:,.0f} eff samples/s "
           f"(HMC chain @{ess_chains})")

    # --- learned-sampler headline ---
    # ESS/s of the TRAINED champion kernel vs HMC at (K=5, eps=0.08), both
    # timed on the same XLA eval harness from the same Metropolis-
    # thermalized state, chunks interleaved (trained / hmc / trained+hop)
    # so that drift of the card's clocks hits all three alike.
    from l2hmc.dynamics import topo as _topo
    from l2hmc.lattice import u1 as _u1c
    from l2hmc.lattice.metropolis import thermalize as _therm
    from l2hmc.train import gauge as _Gc

    champ_path = Path(__file__).parent / "benchmarks" / "champion_16x16.npz"
    z = np.load(champ_path, allow_pickle=False)
    cfg_d = json.loads(str(z["config"]))
    known = {f.name for f in _dc0.fields(GaugeConfig)}
    ccfg = GaugeConfig(**{k: v for k, v in cfg_d.items() if k in known})
    ccfg = _dc0.replace(ccfg, num_chains=1024)
    cstate = _Gc.init_train_state(ccfg, key)
    flat, treedef = jax.tree_util.tree_flatten(cstate.params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(z[f"arr_{i}"]) for i in range(len(flat))])

    # the shipped champion is 16x16 beta=4; a champion npz at another
    # volume/beta ships its own HMC baseline in the config dict
    beta_c = float(cfg_d.get("beta_final", 4.0))
    hcfg = _dc0.replace(
        ccfg, hmc=True, network_arch="zero",
        eps_init=float(cfg_d.get("hmc_opt_eps", 0.08)),
        eps_trainable=False,
        num_steps=int(cfg_d.get("hmc_opt_num_steps", 5)),
        merge_v_halves=False)
    hstate = _Gc.init_train_state(hcfg, key)

    _trace("champion eval: Metropolis thermalization...")
    x0 = _u1c.random_links(key, ccfg.num_chains, ccfg.shape)
    x0 = jax.jit(lambda x, k: _therm(k, x, ccfg.shape, beta_c, 1000))(
        x0, jax.random.fold_in(key, 11))

    def sliced(base_e):
        @jax.jit
        def chunk_e(params, x, beta, k):
            x, m = base_e(params, x, beta, k)
            return x, {n: v[:, :64] for n, v in m.items()}

        return chunk_e

    chs = {"t": sliced(_Gc.make_eval_chunk(ccfg, 1000)),
           "h": sliced(_Gc.make_eval_chunk(hcfg, 1000)),
           "th": sliced(_topo.make_hop_eval_chunk(ccfg, 1000))}
    xs = {"t": x0, "h": x0, "th": x0}
    prm = {"t": params, "h": hstate.params, "th": params}
    for tag in chs:   # compile + warm
        xs[tag], _ = jax.block_until_ready(
            chs[tag](prm[tag], xs[tag], beta_c, key))
    accum = {tag: ([], [], 0.0) for tag in chs}
    kk = jax.random.fold_in(key, 13)
    for i in range(4):
        for tag in chs:
            kk, sub = jax.random.split(kk)
            pls, qs, wall_e = accum[tag]
            t0 = time.perf_counter()
            xs[tag], m = jax.block_until_ready(
                chs[tag](prm[tag], xs[tag], beta_c, sub))
            wall_e += time.perf_counter() - t0
            pls.append(np.asarray(m["plaqs"]))
            qs.append(np.asarray(m["charges"]))
            accum[tag] = (pls, qs, wall_e)

    def finish(tag, cfg_e, label):
        pls, qs, wall_e = accum[tag]
        pl_e = np.concatenate(pls)
        q_e = np.concatenate(qs)
        ess_e = float(np.mean(
            [_stats.calc_ess(pl_e[:, c]) for c in range(64)]))
        eff = ess_e * pl_e.shape[0] * cfg_e.num_chains / wall_e
        tun = float(np.abs(np.diff(q_e, axis=0)).mean()) \
            * pl_e.shape[0] / wall_e
        _trace(f"{label}: ESS {ess_e:.4f}, {eff:,.0f} eff samples/s, "
               f"tunneling {tun:.2f}/s/chain-row")
        return eff, ess_e, tun, float(pl_e.mean())

    eff_t, ess_t, tun_t, plaq_t = finish("t", ccfg, "trained")
    eff_h, ess_h, tun_h, plaq_h = finish("h", hcfg, "hmc")
    eff_th, ess_th, tun_th, plaq_th = finish("th", ccfg, "trained+hop")
    tau_h, _ = _stats.pooled_integrated_time(np.concatenate(accum["h"][1]))
    tau_th, _ = _stats.pooled_integrated_time(np.concatenate(accum["th"][1]))

    dev = jax.devices()[0]
    result = {
        "metric": "trained_plaq_ess_per_s_per_chip",
        "value": round(eff_t, 1),
        "unit": "effective plaquette samples/s",
        "vs_baseline": round(eff_t / eff_h, 3),
        "baseline_def": "HMC at (K=5, eps=0.08), same harness, interleaved",
        "config": (
            f"champion {cfg_d.get('network_arch')} h{cfg_d.get('num_hidden')} "
            f"K={cfg_d.get('num_steps')} eps_fixed "
            f"merge_v={cfg_d.get('merge_v_halves')} @1024 chains"),
        "trained_vs_hmc_ess_per_step": round(ess_t / ess_h, 3),
        "trained_vs_hmc_tunneling_per_s": round(tun_t / tun_h, 3),
        "trained_hop_plaq_ess_per_s": round(eff_th, 1),
        "trained_hop_vs_hmc_ess_per_s": round(eff_th / eff_h, 3),
        "trained_hop_tunneling_vs_hmc": round(tun_th / tun_h, 3),
        "trained_hop_q_tau_pooled": round(tau_th, 2),
        "hmc_q_tau_pooled": round(tau_h, 2),
        "trained_plaq_mean": round(plaq_t, 6),
        "trained_hop_plaq_mean": round(plaq_th, 6),
        "hmc_plaq_mean": round(plaq_h, 6),
        "lf_steps_per_s_merged_kernel": round(fused_rate, 1),
        "vs_baseline_dataflow": round(fused_rate / ref_rate, 3),
        "transition_config": (
            "U(1) 16x16, 2048 chains, 3 leapfrog steps, periodic CNN, "
            "beta=4, fused-direction + merged-V kernel"),
        "ms_per_transition_2048": round(dt_big * 1e3 / CHUNK, 4),
        "lf_steps_per_s_parity_kernel": round(parity_rate, 1),
        "vs_baseline_parity_kernel": round(parity_rate / ref_rate, 3),
        "lf_steps_per_s_128chains": round(fused128, 1),
        "ms_per_transition_128": round(dt * 1e3 / CHUNK, 4),
        "accept_prob_untrained": round(acc, 4),
        "plaq_ess_per_s": round(ess_per_s, 1),
        "plaq_ess_ratio_hmc": round(ess_ratio, 5),
        "plaq_ess_kernel": (f"hmc_chain_u1_fused@{ess_chains} "
                            f"K={ess_leapfrog} eps={ess_eps}"),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        # the card's name and power limit: a card below 700 W runs slower
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{jax.devices()[0].platform}")
    main()
