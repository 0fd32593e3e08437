"""Joint (K, eps) auto-tuning for HMC and the trained L2HMC kernel.

The reference's only integrator adaptation is the trainable step size
(``/root/reference/l2hmc/dynamics/gauge_dynamics.py:89-96``); trajectory
length K is always hand-picked, and round-2's champion settings (K=3,
eps=0.125 at 16x16) came out of a manual grid.  This module replaces the
hand sweep with a probe-based search so champion configs reproduce from a
cold start and transfer across volumes:

HMC (:func:`tune_hmc`):
  for each K in the grid, dual-averaging drives eps to a target acceptance
  (``dynamics/nuts.py dual_averaging_update`` — the NUTS-style controller),
  then a short timed probe chain scores **cost-normalized decorrelation**:
  a lag-1 ESS proxy of the average-plaquette trace times measured steps/s.
  The argmax over K stands in for the full grid sweep
  (``benchmarks/hmc_ess_sweep.py``) at a fraction of its cost.  The score
  includes wall-clock time, so an optimum is specific to the device it was
  tuned on.

Trained kernel (:func:`tune_l2hmc`):
  the trained maps' demonstrated skill is holding acceptance at COARSER
  steps than HMC can afford, so the
  search is anchored at HMC's optimal trajectory length lambda* = K*eps*:
  for each candidate K (descending from HMC's K*), eps_K = lambda*/K is
  frozen (``eps_fixed`` — the acceptance-greedy ESJD objective otherwise
  retreats to short trajectories), a short probe training runs, and the
  same timed lag-1 score picks K.  Smaller K wins only if the conditioners
  actually rescue the coarse-step acceptance — exactly the trade the
  champion config embodies.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _trace(msg):
    """Per-cell progress to stderr: probe phases run for many minutes at
    large volume with no output otherwise, and silence is indistinguishable
    from a hung process."""
    print(f"[tune {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    num_steps: int                # chosen K
    eps: float                    # chosen step size
    score: float                  # lag-1 eff-samples/s proxy at the chosen cell
    accept: float                 # measured acceptance at the chosen cell
    cells: Tuple[Dict, ...]       # every probed cell, for the record


def _lag1_ess(trace: np.ndarray) -> float:
    """Lag-1 autocorrelation ESS proxy, averaged over chains.

    For the near-AR(1) plaquette trace, ESS_ratio ~ (1-rho1)/(1+rho1); a
    few hundred steps give a low-variance estimate where the Sokal-window
    estimator would still be noise.  Used for RANKING (K, eps) cells, not
    for reporting absolute ESS.
    """
    x = trace - trace.mean(axis=0, keepdims=True)
    num = (x[1:] * x[:-1]).sum(axis=0)
    den = (x * x).sum(axis=0) + 1e-30
    rho1 = np.clip(num / den, -0.999, 0.999)
    return float(np.mean((1.0 - rho1) / (1.0 + rho1)))


def _hmc_cfg(base, k: int, eps: float):
    return dataclasses.replace(
        base, hmc=True, network_arch="zero", num_steps=k, eps_init=eps,
        eps_trainable=False, merge_v_halves=False)


def _make_probe_chunk(cfg, chunk: int = 200):
    """Compile one probe chunk for a (K, arch) family.

    eps lives in ``params`` (``init_train_state`` bakes ``eps_init`` into
    the dynamics pytree), so every eps cell of the same K reuses this one
    compiled function — only K changes the scan body and forces a retrace.
    """
    from l2hmc.train.gauge import make_eval_chunk

    base = make_eval_chunk(cfg, chunk)

    @jax.jit
    def run(params, x, beta, k):
        x, m = base(params, x, beta, k)
        return x, m["plaqs"][:, :64], jnp.mean(m["accept_prob"])

    return run


def _timed_probe(cfg, params, x, beta, key, steps: int, chunk: int = 200,
                 run=None):
    """Run ``steps`` eval transitions; return (plaq trace, accept, wall).

    Pass ``run`` (from :func:`_make_probe_chunk`) to reuse a compiled probe
    across eps cells; without it each call compiles its own.
    """
    if run is None:
        run = _make_probe_chunk(cfg, chunk)

    # warm stream is folded off the timed stream (no key reuse between the
    # untimed warm chunk and the first timed chunk)
    x, pl, acc = run(params, x, beta, jax.random.fold_in(key, 999901))
    float(acc)
    traces, accs = [], []
    t0 = time.perf_counter()
    for i in range(max(steps // chunk, 1)):
        key, sub = jax.random.split(key)
        x, pl, acc = run(params, x, beta, sub)
        traces.append(np.asarray(pl))
        accs.append(float(acc))
    wall = time.perf_counter() - t0
    return np.concatenate(traces), float(np.mean(accs)), wall, x


def _da_tune_eps(cfg, x, beta, key, da_steps: int, target: float) -> float:
    """Dual-averaging eps search at fixed K (one jitted scan)."""
    from l2hmc.dynamics.nuts import (
        dual_averaging_init, dual_averaging_update,
    )
    from l2hmc.lattice import u1
    from l2hmc.train.gauge import build_dynamics, init_train_state

    state = init_train_state(cfg, key)
    _, dyn, _ = build_dynamics(cfg)

    @jax.jit
    def run(params, x, key):
        def body(carry, k):
            x, da = carry
            p = params._replace(raw_eps=jnp.exp(da.log_eps))
            out = dyn["transition"](p, x, beta, k)
            da = dual_averaging_update(
                da, jnp.mean(out.accept_prob), target=target)
            return (u1.wrap(out.x_out), da), None

        (x, da), _ = jax.lax.scan(
            body, (x, dual_averaging_init(float(cfg.eps_init))),
            jax.random.split(key, da_steps))
        return jnp.exp(da.log_eps_avg)

    return float(run(state.params, x, key))


def _probe_score(trace: np.ndarray, wall: float, chains: int,
                 estimator: str) -> float:
    """eff-samples/s of a probe trace.

    ``estimator='sokal'`` uses the production FFT/Sokal ESS
    (``analysis/stats.calc_ess``) — the SAME estimator the final
    head-to-head is scored with, so the tuner optimizes the reported
    metric (the round-3 lag-1 prototype systematically over-ranked
    fine-step kernels relative to the Sokal ranking).  ``'lag1'`` keeps
    the cheap proxy for tiny CPU tests.
    """
    if estimator == "lag1":
        ess = _lag1_ess(trace)
    else:
        from l2hmc.analysis import stats

        ess = float(np.mean([stats.calc_ess(trace[:, c])
                             for c in range(trace.shape[1])]))
    return ess * trace.shape[0] * chains / wall


def _tile_chains(x, n: int):
    """Tile a (chains, x_dim) state up to n chains (production-batch
    probes: at small batches the transition is latency-bound, which
    compresses the steps/s advantage of cheap/coarse kernels and
    over-ranks fine-step cells)."""
    if n <= x.shape[0]:
        return x[:n]
    reps = -(-n // x.shape[0])
    return jnp.tile(x, (reps, 1))[:n]


def tune_hmc(
    base_cfg,
    x,
    beta: float,
    key: jax.Array,
    k_grid: Sequence[int] = (3, 4, 5, 6, 8),
    da_steps: int = 300,
    probe_steps: int = 1000,
    target_accept: float = 0.8,
    eps_grid: Sequence[float] = (0.85, 1.0, 1.15),
    estimator: str = "sokal",
    probe_chains: int = 0,
) -> TuneResult:
    """Joint (K, eps) search for plain HMC.

    ``base_cfg``: a ``GaugeConfig`` fixing lattice/chains; ``x``: a
    thermalized chain state ``(chains, x_dim)`` (tune AT the target
    distribution — a cold start would tune the transient).

    Per K: DA finds the eps of the target acceptance, then a small
    multiplicative ``eps_grid`` around it is probe-scored — the DA point
    is an acceptance statement, not an ESS/s optimum, and the grid
    recovers the optimum without assuming the target-acceptance folklore.
    All eps cells per K reuse one compiled probe (eps is a runtime
    parameter of the transition).
    """
    from l2hmc.train.gauge import init_train_state

    n_probe = probe_chains or base_cfg.num_chains
    x_probe = _tile_chains(x, n_probe)
    probe_cfg_chains = dataclasses.replace(base_cfg, num_chains=n_probe)

    cells = []
    best = None
    for k in k_grid:
        kk = jax.random.fold_in(key, k)
        cfg_k = _hmc_cfg(base_cfg, k, base_cfg.eps_init)
        eps_da = _da_tune_eps(cfg_k, x, beta, kk, da_steps, target_accept)
        probe_run = _make_probe_chunk(_hmc_cfg(probe_cfg_chains, k, eps_da))
        for mult in eps_grid:
            eps_k = eps_da * mult
            cfg_k = _hmc_cfg(probe_cfg_chains, k, eps_k)
            params = init_train_state(cfg_k, kk).params
            trace, acc, wall, x_probe = _timed_probe(
                cfg_k, params, x_probe, beta,
                jax.random.fold_in(kk, int(100 * mult)), probe_steps,
                run=probe_run)
            score = _probe_score(trace, wall, n_probe, estimator)
            cell = {"K": k, "eps": round(eps_k, 5), "accept": round(acc, 4),
                    "score": round(score, 1)}
            cells.append(cell)
            if best is None or score > best[0]:
                best = (score, k, eps_k, acc)
    return TuneResult(num_steps=best[1], eps=round(best[2], 5),
                      score=best[0], accept=best[3], cells=tuple(cells))


def tune_l2hmc(
    base_cfg,
    key: jax.Array,
    hmc_opt: TuneResult,
    k_grid: Sequence[int] = (2, 3, 4, 5),
    probe_train_steps: int = 2000,
    probe_steps: int = 1000,
    eps_grid: Sequence[float] = (0.8, 1.0, 1.2),
    estimator: str = "sokal",
    probe_chains: int = 0,
    probe_seeds: int = 1,
) -> TuneResult:
    """Choose the trained kernel's (K, eps) around HMC's optimal
    trajectory length ``lambda* = K* x eps*``.

    Per K the probe trains ``probe_train_steps`` at each frozen
    ``eps = mult x lambda*/K`` of the multiplicative ``eps_grid`` (short
    beta anneal of the base config), then runs the timed probe with the
    production ESS estimator.  The grid matters: the anchor is a
    heuristic, and the coarse-K cells this search exists to rank can
    sit at eps values the exact anchor misses.  Returns the winning
    cell; callers train the full-length kernel at that setting.

    Probe depth matters too: coarse-K cells need O(10k) training steps
    before the conditioners' acceptance rescue matures, so short probes
    systematically under-rank exactly the cells this search exists to
    find — pass ``probe_train_steps`` equal to the production training
    length when the hardware affords it.
    """
    from l2hmc.train.gauge import init_train_state, make_train_chunk

    lam = hmc_opt.num_steps * hmc_opt.eps
    n_probe = probe_chains or base_cfg.num_chains
    cells = []
    best = None
    for k in k_grid:
        cfg_k0 = dataclasses.replace(
            base_cfg, num_steps=k, eps_init=lam / k, eps_trainable=False,
            train_steps=probe_train_steps)
        chunk = make_train_chunk(cfg_k0, 250)   # compiled once per K
        probe_run = _make_probe_chunk(
            dataclasses.replace(cfg_k0, num_chains=n_probe))
        for mult in eps_grid:
            eps_k = mult * lam / k
            cfg_k = dataclasses.replace(cfg_k0, eps_init=eps_k)
            probe_cfg = dataclasses.replace(cfg_k, num_chains=n_probe)
            seed_scores, seed_accs, seed_taccs = [], [], []
            # probe_seeds > 1 averages out training-seed variance, which
            # is substantial near the coarse-step frontier (measured:
            # identical cells landing at acc 0.46 vs 0.75 across seeds)
            for s in range(probe_seeds):
                kk = jax.random.fold_in(
                    key, 100 + 10 * k + int(100 * mult) + 1000 * s)
                state = init_train_state(cfg_k, kk)
                for _ in range(max(probe_train_steps // 250, 1)):
                    kk, sub = jax.random.split(kk)
                    state, m = chunk(state, sub)
                seed_taccs.append(float(np.asarray(m["accept_prob"])[-1]))
                trace, acc, wall, _ = _timed_probe(
                    probe_cfg, state.params, _tile_chains(state.x, n_probe),
                    base_cfg.beta_final, jax.random.fold_in(kk, 1),
                    probe_steps, run=probe_run)
                seed_scores.append(
                    _probe_score(trace, wall, n_probe, estimator))
                seed_accs.append(acc)
            score = float(np.mean(seed_scores))
            acc = float(np.mean(seed_accs))
            cell = {"K": k, "eps": round(eps_k, 5), "accept": round(acc, 4),
                    "accept_train_end": round(float(np.mean(seed_taccs)), 4),
                    "score": round(score, 1),
                    "seed_scores": [round(s, 1) for s in seed_scores]}
            cells.append(cell)
            _trace(f"l2hmc cell K={k} eps={eps_k:.4f}: score {score:.0f} "
                   f"acc {acc:.3f} (train-end {cell['accept_train_end']})")
            if best is None or score > best[0]:
                best = (score, k, eps_k, acc)
    return TuneResult(num_steps=best[1], eps=round(best[2], 5),
                      score=best[0], accept=best[3], cells=tuple(cells))
