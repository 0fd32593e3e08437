#!/usr/bin/env python
"""Analytic-target L2HMC sampler training CLI.

Rebuild of ``mog_model.py`` main (``:1025-1286``) + the SCGExperiment
notebook: pick a target (GMM arrangements / ring / strongly-correlated
Gaussian / rough well / funnel), train the sampler with the squared-jump
loss, optionally anneal temperature with the *dynamic* schedule adaptation
driven by measured tunneling rates (``mog_model.py:489-663``), and report
tunneling/acceptance/ESS diagnostics with jackknife errors plus an HMC
comparison.

Usage:
    python cli/train_sampler.py --target scg --train_steps 2000
    python cli/train_sampler.py --target gmm_axes --dim 2 --annealing
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from l2hmc.utils.flags import ArgfileParser  # noqa: E402


def build_parser():
    p = ArgfileParser(description=__doc__)
    p.add_argument("--target", default="scg",
                   choices=["scg", "tilted", "gmm_axes", "gmm_single_axis",
                            "gmm_one_per_axis", "gmm_diagonal", "gmm_ring",
                            "rough_well", "funnel"],
                   help="gmm_axes == reference 'single_axis' (pair at +-sep "
                        "on axis 0); gmm_one_per_axis == reference 'axes' "
                        "(one mode per coordinate axis); gmm_diagonal == "
                        "reference 'diagonal' (pair at +-sep*ones) — "
                        "mog_model.py:1040-1112")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--sep", type=float, default=2.0, help="GMM mode separation")
    p.add_argument("--var", type=float, default=0.1, help="GMM component variance")
    p.add_argument("--nb_mixtures", type=int, default=4, help="ring modes")
    # sampler / training (mog_model defaults)
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--num_steps", type=int, default=10)
    p.add_argument("--eps", type=float, default=0.1)
    p.add_argument("--num_hidden", type=int, default=10)
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--hmc", action="store_true")
    # annealing (mog_model.py:940-952)
    p.add_argument("--annealing", action="store_true")
    p.add_argument("--temp_init", type=float, default=10.0)
    p.add_argument("--annealing_steps", type=int, default=100)
    p.add_argument("--annealing_factor", type=float, default=0.98)
    p.add_argument("--tunneling_rate_steps", type=int, default=500,
                   help="diagnostics + schedule adaptation interval")
    # eval
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--log_dir", default="runs/sampler")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    return p


def make_target(args):
    import numpy as np

    from l2hmc import targets as T

    if args.target == "scg":
        return T.scg_2d(), None
    if args.target == "tilted":
        return T.random_tilted_gaussian(args.seed, args.dim), None
    if args.target in ("gmm_axes", "gmm_single_axis"):
        t = T.gmm_single_axis(args.dim, sep=args.sep, var=args.var)
        return t, np.asarray(t.mus)
    if args.target == "gmm_one_per_axis":
        t = T.gmm_one_per_axis(args.dim, sep=args.sep, var=args.var)
        return t, np.asarray(t.mus)
    if args.target == "gmm_diagonal":
        t = T.gmm_diagonal(args.dim, sep=args.sep, var=args.var)
        return t, np.asarray(t.mus)
    if args.target == "gmm_ring":
        t = T.gen_ring(r=args.sep, var=args.var, nb_mixtures=args.nb_mixtures)
        return t, np.asarray(t.mus)
    if args.target == "rough_well":
        return T.RoughWell(dim=args.dim, eps=0.1), None
    if args.target == "funnel":
        return T.GaussianFunnel(dim=args.dim), None
    raise ValueError(args.target)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.dynamics.hmc import hmc_chain
    from l2hmc.train import schedules
    from l2hmc.train.sampler import (
        SamplerConfig, init_sampler_state, make_sample_chain,
        make_sampler_train_chunk,
    )
    from l2hmc.train import checkpoint as ckpt
    from l2hmc.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    install_sigterm_handler()
    target, modes = make_target(args)
    dim = (
        2 if args.target in ("scg", "gmm_ring") else args.dim
    )
    cfg = SamplerConfig(
        x_dim=dim, num_chains=args.num_samples, num_steps=args.num_steps,
        eps_init=args.eps, num_hidden=args.num_hidden, hmc=args.hmc,
        loss_scale=args.loss_scale, lr_init=args.lr_init,
        train_steps=args.train_steps, use_annealing=args.annealing,
        temp_init=args.temp_init, annealing_steps=args.annealing_steps,
        annealing_factor=args.annealing_factor,
    )
    key = jax.random.PRNGKey(args.seed)
    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}; target={args.target} dim={dim}")

    state = init_sampler_state(cfg, target.energy, key)
    chunk = make_sampler_train_chunk(cfg, target.energy, args.logging_steps)
    sample = make_sample_chain(cfg, target.energy)

    logger = MetricsLogger(run_dir)
    logger.COLUMNS = [
        ("step", "{:>7d}"), ("dt", "{:>8.3f}"), ("loss", "{:>12.4g}"),
        ("accept_prob", "{:>7.4f}"), ("eps", "{:>7.4f}"),
        ("temperature", "{:>6.2f}"), ("tunneling_rate", "{:>7.4f}"),
    ]

    t_prev = time.perf_counter()
    steps_done = 0
    try:
        while steps_done < cfg.train_steps:
            key, sub = jax.random.split(key)
            state, m = chunk(state, sub)
            steps_done += args.logging_steps
            t_now = time.perf_counter()
            rec = {k: float(np.asarray(v)[-1]) for k, v in m.items()}
            rec.update(step=steps_done, dt=(t_now - t_prev) / args.logging_steps)
            t_prev = t_now

            # periodic tunneling diagnostics + dynamic schedule adaptation
            # (mog_model.py:971-1010)
            if modes is not None and steps_done % args.tunneling_rate_steps < args.logging_steps:
                key, sub = jax.random.split(key)
                xs, probs = sample(state.params, state.x, sub, 200)
                rates = [
                    stats.tunneling_rate(np.asarray(xs)[:, c], modes)
                    for c in range(min(16, xs.shape[1]))
                ]
                jk_mean, jk_err = stats.jackknife(np.asarray(rates), num_blocks=4)
                rec["tunneling_rate"] = jk_mean
                if args.annealing:
                    state = state._replace(
                        temp=schedules.adapt_temperature_schedule(
                            state.temp, jnp.asarray(jk_mean)
                        )
                    )
                log(f"  tunneling rate: {jk_mean:.4f} +- {jk_err:.4f}")
            logger.write(rec)
    except (KeyboardInterrupt, SystemExit):
        # save-and-exit on interrupt/SIGTERM (mog_model.py:1015-1022)
        log(f"interrupted at step {steps_done}; checkpointing...")
        ckpt.save_checkpoint(run_dir / "checkpoints", state, steps_done)
        logger.close()
        raise

    # final eval: ESS + moments (+ HMC comparison)
    key, k1, k2 = jax.random.split(key, 3)
    x0 = jnp.zeros((cfg.num_chains, dim))
    xs, probs = sample(state.params, x0, k1, args.eval_steps)
    xs_hmc, probs_hmc = hmc_chain(
        target.energy, x0, 1.0, k2, float(np.asarray(m["eps"])[-1]),
        cfg.num_steps, args.eval_steps,
    )

    def ess_of(arr):
        arr = np.asarray(arr)
        return float(np.mean([
            stats.calc_ess(arr[:, c, 0]) for c in range(min(16, arr.shape[1]))
        ]))

    summary = {
        "l2hmc": {
            "ess_per_step": ess_of(xs),
            "accept": float(np.asarray(probs).mean()),
            "mean": np.asarray(xs)[args.eval_steps // 4:].mean(axis=(0, 1)).tolist(),
            "std": np.asarray(xs)[args.eval_steps // 4:].std(axis=(0, 1)).tolist(),
        },
        "hmc": {
            "ess_per_step": ess_of(xs_hmc),
            "accept": float(np.asarray(probs_hmc).mean()),
        },
    }
    if modes is not None:
        summary["l2hmc"]["tunneling_rate"] = float(np.mean([
            stats.tunneling_rate(np.asarray(xs)[:, c], modes)
            for c in range(min(16, xs.shape[1]))
        ]))
        summary["hmc"]["tunneling_rate"] = float(np.mean([
            stats.tunneling_rate(np.asarray(xs_hmc)[:, c], modes)
            for c in range(min(16, xs_hmc.shape[1]))
        ]))
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary, indent=2))
    logger.close()
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
