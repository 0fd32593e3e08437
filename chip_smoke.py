#!/usr/bin/env python
"""Smoke test of the U(1) gauge system on an NVIDIA GPU.

    python chip_smoke.py             # one card: device, train, HMC, kernel
    python chip_smoke.py --four      # four cards: the sharded paths only
    python chip_smoke.py --rehearse  # every phase but the kernel, on the
                                     # CPU at a tiny size (4x4, 8 chains)

One card runs the flagship model through its entry point
(``cli/train_gauge.py``: the 16x16 lattice, periodic CNN, K=3, 2048
chains), checkpoints and resumes it, evaluates it on the exact plaquette
oracle, runs plain HMC through the same CLI and through
``hmc_chain_u1_fused``, checks the whole-chain CUDA kernel against its
plain reference (the ``chip`` tests, in this process) and times it against
the XLA scan.  ``--four`` runs the data-parallel train chunk, the
domain-sharded transition and the ppermute action on four cards, each
against its single-device run.

Everything runs in one JAX process, and no phase's failure is caught: any
failure exits non-zero.  Without ``--rehearse`` a platform other than the
GPU is refused.  The last line of stdout is one JSON object naming the
device; records too long for the console go to ``chiprun_out/chip_smoke``,
the CLI run directories to ``build/chip_smoke``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from l2hmc.utils.compile_cache import setup_compile_cache  # noqa: E402

OUT_DIR = REPO / "chiprun_out" / "chip_smoke"   # small records
RUN_DIR = REPO / "build" / "chip_smoke"          # run dirs, eval traces


@dataclasses.dataclass(frozen=True)
class Sizes:
    size: int               # lattice side
    chains: int
    beta_final: float
    train_steps: int
    chunk: int              # logging chunk of the train loop
    run_steps: int          # eval steps per beta
    therm_sweeps: int       # Metropolis sweeps of --eval_init metropolis
    fused_steps: int        # transitions of the hmc_chain_u1_fused check
    fused_skip: int         # of which thermalization


FULL = Sizes(size=16, chains=2048, beta_final=4.0, train_steps=200,
             chunk=50, run_steps=1000, therm_sweeps=2000, fused_steps=2000,
             fused_skip=500)
TINY = Sizes(size=4, chains=8, beta_final=2.0, train_steps=20, chunk=10,
             run_steps=200, therm_sweeps=100, fused_steps=400, fused_skip=100)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(msg)


def phase(name: str):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            log(f"== {name}")
            out = fn(*args, **kwargs)
            log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


def jackknife_over_chains(per_chain: "np.ndarray", blocks: int = 32):
    """Mean and jackknife error of independent chains' time averages."""
    import numpy as np

    from l2hmc.analysis import stats

    return stats.jackknife(np.asarray(per_chain, np.float64),
                           num_blocks=min(blocks, len(per_chain)))


def check_oracle(name, traces, exact, skip):
    """Assert the per-chain mean of ``traces (T, B)`` past ``skip`` is
    within 5 jackknife errors of ``exact``."""
    import numpy as np

    per_chain = np.asarray(traces)[skip:].mean(axis=0)
    mean, err = jackknife_over_chains(per_chain)
    dev = (mean - exact) / err
    log(f"  {name}: {mean:.6f} +- {err:.6f} (exact {exact:.6f}, "
        f"{dev:+.2f} sigma)")
    require(abs(dev) < 5.0, f"{name} off the oracle by {dev:.1f} sigma")
    return mean, err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


@phase("device")
def device_phase(rehearse: bool):
    import jax

    devices = jax.devices()
    dev = devices[0]
    log(f"  platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
        log(f"  nvidia-smi: {smi.stdout.strip()}")
    log(f"  jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}")
    log(f"  jax {jax.__version__}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")


def _eval_checks(run_dir: Path, betas, min_accept: float):
    import numpy as np

    from l2hmc.lattice import u1

    for beta in betas:
        tr = np.load(run_dir / f"eval_beta{beta:g}.npz")
        skip = len(tr["plaqs"]) // 4
        check_oracle(f"plaquette beta={beta:g}", tr["plaqs"],
                     float(u1.u1_plaq_exact(beta)), skip)
        acc = float(np.asarray(tr["accept_prob"])[skip:].mean())
        log(f"  accept beta={beta:g}: {acc:.4f}")
        require(acc > min_accept, f"eval acceptance {acc} at beta={beta}")


def _first_logged_step(run_dir: Path) -> int:
    with open(run_dir / "metrics.jsonl") as f:
        return int(json.loads(f.readline())["step"])


@phase("train")
def train_phase(sz: Sizes):
    import jax

    from cli import train_gauge
    from l2hmc.train import checkpoint as ckpt
    from l2hmc.train.gauge import init_train_state, make_train_chunk

    log_dir = RUN_DIR / "train"
    shutil.rmtree(log_dir, ignore_errors=True)
    half = sz.train_steps // 2
    # lr 1e-4, not the default 1e-3: at 1024 chains and more the default
    # schedule walks the 16x16 CNN into the zero-acceptance trap by step
    # 170, on the GPU and the CPU alike (PERF.md), and this phase checks
    # the path, not the recipe
    common = [
        "--time_size", str(sz.size), "--space_size", str(sz.size),
        "--network_arch", "conv", "--num_steps", "3", "--eps", "0.1",
        "--lr_init", "1e-4",
        "--num_samples", str(sz.chains), "--beta_init", "2.0",
        "--beta_final", str(sz.beta_final), "--logging_steps", str(sz.chunk),
        "--save_steps", str(half), "--log_dir", str(log_dir), "--seed", "7",
    ]
    train_gauge.main(common + ["--train_steps", str(half), "--run_steps", "0"])
    first = log_dir / "run_1"
    saved = ckpt.latest_step(first / "checkpoints")
    require(saved == half, f"checkpoint at step {saved}, expected {half}")
    train_gauge.main(common + [
        "--restore", "--train_steps", str(sz.train_steps),
        "--run_steps", str(sz.run_steps), "--eval_init", "metropolis",
        "--eval_therm_sweeps", str(sz.therm_sweeps)])
    second = log_dir / "run_2"
    resumed = _first_logged_step(second) - sz.chunk
    require(resumed == half, f"resumed from step {resumed}, expected {half}")
    last = ckpt.latest_step(second / "checkpoints")
    require(last == sz.train_steps, f"last checkpoint at step {last}")
    log(f"  resumed from step {resumed}; trained to {sz.train_steps}")
    _eval_checks(second, (sz.beta_final, sz.beta_final - 1.0), 0.2)

    cfg = train_gauge.flags_to_config(train_gauge.build_parser().parse_args(
        common + ["--train_steps", str(sz.train_steps)]))
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    compiled = make_train_chunk(cfg, sz.chunk).lower(
        state, jax.random.PRNGKey(1)).compile()
    log(f"  train chunk memory_analysis: {compiled.memory_analysis()}")


@phase("hmc")
def hmc_phase(sz: Sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cli import train_gauge
    from l2hmc.analysis import stats
    from l2hmc.dynamics.hmc import hmc_chain_u1_fused
    from l2hmc.lattice import u1

    log_dir = RUN_DIR / "hmc"
    shutil.rmtree(log_dir, ignore_errors=True)
    beta = sz.beta_final
    train_gauge.main([
        "--hmc", "--time_size", str(sz.size), "--space_size", str(sz.size),
        "--num_steps", "5", "--eps", "0.08", "--num_samples", str(sz.chains),
        "--beta_init", str(beta), "--beta_final", str(beta),
        "--train_steps", "0", "--run_steps", str(sz.run_steps),
        "--eval_init", "metropolis", "--eval_therm_sweeps",
        str(sz.therm_sweeps), "--log_dir", str(log_dir)])
    _eval_checks(log_dir / "run_1", (beta, beta - 1.0), 0.2)

    shape = u1.LatticeShape(sz.size, sz.size)
    q2_exact = float(u1.topological_susceptibility_exact(
        beta, shape.num_plaquettes))
    links = jnp.zeros((sz.chains, sz.size, sz.size, 2), jnp.float32)
    for hop in (False, True):
        run = jax.jit(lambda l, k, hop=hop: hmc_chain_u1_fused(
            l, k, 0.08, beta, 5, sz.fused_steps, hop=hop))
        out, plaqs, charges, probs = run(links, jax.random.PRNGKey(11 + hop))
        plaqs, charges = np.asarray(plaqs), np.asarray(charges)
        require(np.isfinite(np.asarray(out)).all(), "non-finite links")
        tag = "hmc+hop" if hop else "hmc"
        check_oracle(f"{tag} plaquette", plaqs, float(u1.u1_plaq_exact(beta)),
                     sz.fused_skip)
        tau, _ = stats.pooled_integrated_time(charges[sz.fused_skip:])
        log(f"  {tag} accept {float(np.asarray(probs).mean()):.4f}, "
            f"pooled tau_int(Q) {float(tau):.1f}")
        check_oracle(f"{tag} <Q^2>", charges ** 2, q2_exact, sz.fused_skip)


def _time_calls(fns, links, n_rounds):
    """Median seconds per call of each fn, calls interleaved a, b, b, a."""
    import jax
    import numpy as np

    times = {name: [] for name in fns}
    order = list(fns) + list(reversed(list(fns)))
    key = jax.random.PRNGKey(5)
    for name, fn in fns.items():            # compile and warm up
        jax.block_until_ready(fn(links, key))
        jax.block_until_ready(fn(links, jax.random.fold_in(key, 1)))
    for r in range(n_rounds):
        for i, name in enumerate(order):
            k = jax.random.fold_in(key, 100 + 10 * r + i)
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name](links, k))
            times[name].append(time.perf_counter() - t0)
    return {name: float(np.median(t)) for name, t in times.items()}, times


def time_kernel_vs_xla(size, chains, transitions=1500, num_leapfrog=5,
                       eps=0.08, beta=4.0, n_rounds=3):
    """Whole-chain kernel against the XLA scan that ``hmc_chain_u1_fused``
    runs without it; median microseconds per transition."""
    import jax

    from l2hmc.dynamics.hmc import hmc_chain_u1_xla
    from l2hmc.ops.leapfrog import hmc_chain_cuda

    links = u1_warm_links(size, chains, beta)
    fns = {
        "xla": jax.jit(lambda l, k: hmc_chain_u1_xla(
            l, k, eps, beta, num_leapfrog, transitions)),
        "kernel": jax.jit(lambda l, k: hmc_chain_cuda(
            l, k, eps, beta, num_leapfrog, transitions)),
    }
    med, raw = _time_calls(fns, links, n_rounds)
    us = {name: 1e6 * t / transitions for name, t in med.items()}
    return {
        "shape": f"{size}x{size}", "chains": chains, "K": num_leapfrog,
        "eps": eps, "transitions_per_call": transitions,
        "xla_us_per_transition": us["xla"],
        "kernel_us_per_transition": us["kernel"],
        "speedup": us["xla"] / us["kernel"],
        "raw_seconds": raw,
    }


def u1_warm_links(size, chains, beta):
    """Links near equilibrium at ``beta``: a short kernel-free XLA run."""
    import jax
    import jax.numpy as jnp

    from l2hmc.dynamics.hmc import hmc_chain_u1_xla

    links = jnp.zeros((chains, size, size, 2), jnp.float32)
    links, _, _, _ = jax.jit(lambda l, k: hmc_chain_u1_xla(
        l, k, 0.08, beta, 5, 50))(links, jax.random.PRNGKey(3))
    return links


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)


@phase("chip tests")
def chip_tests_phase():
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-s", "-m", "chip", "-p", "no:cacheprovider",
                      str(REPO / "tests")], plugins=[outcomes])
    log(f"  chip tests: {len(outcomes.passed)} passed, "
        f"{len(outcomes.failed)} failed, {len(outcomes.skipped)} skipped")
    require(rc == 0 and outcomes.passed and not outcomes.skipped, (
        rc, outcomes.failed, outcomes.skipped))


@phase("kernel timing")
def kernel_timing_phase():
    recs = [time_kernel_vs_xla(16, 2048), time_kernel_vs_xla(64, 512)]
    for r in recs:
        log(f"  {r['shape']} chains={r['chains']} K={r['K']} "
            f"N={r['transitions_per_call']}: xla "
            f"{r['xla_us_per_transition']:.2f} us/transition, kernel "
            f"{r['kernel_us_per_transition']:.2f} us/transition, "
            f"speedup {r['speedup']:.2f}x")
    (OUT_DIR / "kernel_timing.json").write_text(json.dumps(recs, indent=1))


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


@phase("four: data-parallel train chunk")
def four_train_phase(sz: Sizes):
    import jax
    import numpy as np

    from l2hmc.parallel.mesh import get_mesh, shard_train_state
    from l2hmc.train.gauge import GaugeConfig, init_train_state, make_train_chunk

    cfg = GaugeConfig(time_size=sz.size, space_size=sz.size,
                      num_chains=sz.chains, num_steps=3, eps_init=0.1,
                      network_arch="conv", beta_init=2.0,
                      beta_final=sz.beta_final, train_steps=sz.train_steps)
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    chunk = make_train_chunk(cfg, 10)
    results = {}
    for name, devices in (("1 card", jax.devices()[:1]),
                          ("4 cards", jax.devices()[:4])):
        mesh = get_mesh(devices=devices)
        with jax.default_matmul_precision("highest"):
            _, m = chunk(shard_train_state(state, mesh), key)
        results[name] = {k: np.asarray(m[k]) for k in ("loss", "accept_prob")}
        log(f"  {name}: loss {results[name]['loss']}")
    one, four = results["1 card"], results["4 cards"]
    dloss = np.max(np.abs(four["loss"] - one["loss"]) / np.abs(one["loss"]))
    dacc = np.max(np.abs(four["accept_prob"] - one["accept_prob"]))
    log(f"  max rel loss diff {dloss:.3e}, max accept diff {dacc:.3e}")
    # at "highest" precision the chain all-reduce's summation order is the
    # only difference: float32 rounding, grown over 10 optimizer steps
    require(dloss < 1e-4 and dacc < 1e-4, (dloss, dacc))


@phase("four: domain-sharded transition")
def four_domain_phase(sz: Sizes):
    import jax
    import numpy as np

    from l2hmc.parallel.mesh import get_mesh, lattice_sharding, replicated
    from l2hmc.train.gauge import GaugeConfig, build_dynamics, init_train_state

    mesh = get_mesh(num_data=2, num_space=2, devices=jax.devices()[:4])
    cfg = GaugeConfig(time_size=sz.size, space_size=sz.size,
                      num_chains=sz.chains, num_steps=3, eps_init=0.1,
                      network_arch="conv")
    key = jax.random.PRNGKey(2)
    state = init_train_state(cfg, key)
    _, dyn, _ = build_dynamics(cfg)
    rep, xsh = replicated(mesh), lattice_sharding(mesh)
    f = jax.jit(lambda p, x, k: dyn["transition"](p, x, 3.0, k),
                in_shardings=(rep, xsh, rep))
    dev0 = jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        out = f(jax.device_put(state.params, rep),
                jax.device_put(state.x, xsh), key)
        ref = jax.jit(lambda p, x, k: dyn["transition"](p, x, 3.0, k))(
            jax.device_put(state.params, dev0),
            jax.device_put(state.x, dev0), key)
    dx = float(np.max(np.abs(np.asarray(out.x_out) - np.asarray(ref.x_out))))
    dp = float(np.max(np.abs(np.asarray(out.accept_prob)
                             - np.asarray(ref.accept_prob))))
    log(f"  sharded vs one card: max |dx| {dx:.3e}, max |dp| {dp:.3e}")
    # halo exchanges and per-chain psums reorder float32 sums only.  The
    # accept probability is exp(dH), dH a difference of two float32 sums
    # of magnitude ~1e3 (beta * action + kinetic over 512 links), so a
    # few ulps of 1e3 (6e-5 each) move it by ~1e-4
    require(dx < 1e-4 and dp < 1e-3, (dx, dp))


@phase("four: ppermute action")
def four_ppermute_phase(sz: Sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from l2hmc.lattice import u1
    from l2hmc.parallel.domain import make_domain_action
    from l2hmc.parallel.mesh import get_mesh

    mesh = get_mesh(num_data=1, num_space=4, devices=jax.devices()[:4])
    shape = u1.LatticeShape(sz.size, sz.size)
    dom = make_domain_action(mesh, shape)
    links = jax.random.uniform(jax.random.PRNGKey(4),
                               (sz.chains, sz.size, sz.size, 2),
                               minval=-np.pi, maxval=np.pi)
    sharded = jax.device_put(links, NamedSharding(mesh, P(None, "space")))
    a = jax.jit(dom["action"])(sharded)
    g = jax.jit(jax.grad(lambda l: jnp.sum(dom["action"](l))))(sharded)
    a_ref = jax.jit(u1.wilson_action)(links)
    g_ref = jax.jit(jax.grad(lambda l: jnp.sum(u1.wilson_action(l))))(links)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)
    log(f"  action max |da| "
        f"{float(np.max(np.abs(np.asarray(a) - np.asarray(a_ref)))):.3e}, "
        f"grad max |dg| "
        f"{float(np.max(np.abs(np.asarray(g) - np.asarray(g_ref)))):.3e}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded phases")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on the CPU; every phase but the kernel")
    args = p.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            flags = os.environ.get("XLA_FLAGS", "")
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    setup_compile_cache()
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if not args.rehearse and dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {dev.platform}); "
                         "--rehearse runs on the CPU")
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        raise SystemExit(f"chip_smoke: needs {need} devices, JAX found "
                         f"{len(jax.devices())}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sz = TINY if args.rehearse else FULL

    device_phase(args.rehearse)
    if args.four:
        four_train_phase(sz)
        four_domain_phase(sz)
        four_ppermute_phase(sz)
        count = 4
    else:
        train_phase(sz)
        hmc_phase(sz)
        if not args.rehearse:
            kernel_timing_phase()
            chip_tests_phase()
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
