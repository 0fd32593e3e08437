#!/usr/bin/env python
"""U(1) gauge L2HMC training CLI.

Rebuild of the reference entry point (``gauge_model.py:2167-2436`` main +
argparse with ``@argfile`` support): train the learned sampler, run periodic
in-training evaluations, checkpoint, and finish with the long eval protocol
(20k/50k steps at beta_final and beta_final-1, ``gauge_model.py:2142-2148``
— here configurable via --run_steps).

Usage:
    python cli/train_gauge.py @configs/l8_train.txt
    python cli/train_gauge.py --space_size 8 --train_steps 5000 --hmc
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from l2hmc.utils.flags import ArgfileParser  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = ArgfileParser(description=__doc__)
    # lattice / dynamics (names follow the reference flags)
    p.add_argument("--time_size", type=int, default=8)
    p.add_argument("--space_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=128, help="number of chains")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--eps", default="0.35",
                   help="initial step size, or 'auto' for the volume-scaled "
                        "rule 0.35*(64/V)^(1/4) (leapfrog error grows ~V*eps^4; "
                        "a constant eps at large V starts in the zero-acceptance "
                        "dead-gradient trap)")
    p.add_argument("--eps_fixed", action="store_true", help="freeze step size")
    p.add_argument("--eps_cap", type=float, default=0.0,
                   help="upper bound on trainable eps (0 = unbounded)")
    p.add_argument("--eps_warmup_steps", type=int, default=0,
                   help="dual-averaging warmup: adapt eps to the target "
                        "acceptance for the first N steps, then hand off to "
                        "gradient training (replaces hand-tuned eps at "
                        "large volume; don't combine with --eps_cap)")
    p.add_argument("--eps_target_accept", type=float, default=0.7,
                   help="acceptance target for --eps_warmup_steps")
    p.add_argument("--autotune", action="store_true",
                   help="cold-start joint (K, eps) search before training "
                        "(train/autotune.py): tunes HMC's optimum at this "
                        "volume/beta, then probe-trains coarse-K trained "
                        "cells around its trajectory length and overrides "
                        "--num_steps/--eps with the winner; implies "
                        "--eps_fixed.  Measured at 16x16: lands within 5% "
                        "of the hand-swept champion")
    p.add_argument("--autotune_probe_steps", type=int, default=8000,
                   help="probe-training depth per autotune cell (coarse-K "
                        "acceptance rescue needs ~10k steps to mature)")
    p.add_argument("--hmc", action="store_true", help="plain-HMC mode (zero nets)")
    p.add_argument("--network_arch", default="conv",
                   choices=["conv", "mlp", "local", "local_flat", "zero"])
    p.add_argument("--num_hidden", type=int, default=0, help="0 -> 2*x_dim")
    p.add_argument("--num_filters", type=int, default=8,
                   help="conv stack width; channel count for --network_arch local")
    p.add_argument("--local_kernel", type=int, default=3,
                   help="conv kernel size for the weight-shared local conditioner")
    p.add_argument("--local_layers", type=int, default=2,
                   help="conv depth for the local conditioner")
    p.add_argument("--bf16", action="store_true", help="bfloat16 network matmuls")
    p.add_argument("--group", default="u1", choices=["u1", "r1"],
                   help="kernel state space: exact torus (u1) or flat+wrap (r1)")
    p.add_argument("--train_hops", action="store_true",
                   help="interleave exact instanton hops (dynamics/topo.py) "
                        "into the training chain: keeps the training-state "
                        "distribution Q-sector-complete where annealed "
                        "chains freeze (beta >= 5)")
    p.add_argument("--eval_hops", type=int, default=0,
                   help="interleave N exact instanton hops (dynamics/topo.py)"
                        " per step into EVERY eval chain — the topological-"
                        "channel winner (16x16 beta=5: tunneling/s ~165x "
                        "tuned HMC, all hop cost counted).  Surfaces "
                        "hop_accept/hop_dq in the eval summary")
    p.add_argument("--nu_max", type=int, default=1,
                   help="max |winding| per hop proposal (--eval_hops)")
    p.add_argument("--retrain_acc", type=float, default=0.0,
                   help="detect-and-retrain threshold on end-of-training "
                        "acceptance (0 = off).  beta >= 5 trainings land in "
                        "two separable basins (end acc ~0.55 failed vs "
                        "~0.87 converged); 0.7 auto-reseeds "
                        "the failures so the shipped recipe is "
                        "unconditional.  Attempts are recorded in "
                        "params.json")
    p.add_argument("--max_retrains", type=int, default=3,
                   help="extra training attempts for --retrain_acc")
    p.add_argument("--merge_v_halves", action="store_true",
                   help="merge adjacent momentum half-steps across leapfrog "
                        "steps (K+1 VNet calls instead of 2K; exact kernel, "
                        "different learned family)")
    # loss
    p.add_argument("--action", default="wilson", choices=["wilson", "improved"],
                   help="gauge action: Wilson or tree-level Symanzik-improved")
    p.add_argument("--rect_c1", type=float, default=-1.0 / 12.0,
                   help="rectangle coefficient for --action improved")
    p.add_argument("--metric", default="cos_diff",
                   help="ESJD metric: l1|l2|cos|cos2|cos_diff (link space, "
                        "reference zoo) or plaq_cos|plaq_cos2 (observable "
                        "space: jump in the plaquette field cos P)")
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--std_weight", type=float, default=1.0)
    p.add_argument("--aux_weight", type=float, default=1.0)
    p.add_argument("--charge_weight", type=float, default=1.0)
    p.add_argument("--charge_reward", action="store_true",
                   help="flip the charge term to REWARD accepted charge "
                        "movement (loss -= w*px*dq); default keeps the "
                        "reference's literal penalizing sign "
                        "(gauge_model.py:783-795)")
    p.add_argument("--ref_z_term", action="store_true",
                   help="literal reference z-term dataflow: z std/charge "
                        "terms computed against the X-chain proposal "
                        "(gauge_model.py:776,788); default uses the z "
                        "proposal")
    # optimization / annealing
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--lr_decay_steps", type=int, default=1000)
    p.add_argument("--lr_decay_rate", type=float, default=0.96)
    p.add_argument("--clip_value", type=float, default=1.0)
    p.add_argument("--train_steps", type=int, default=5000)
    p.add_argument("--beta_init", type=float, default=2.0)
    p.add_argument("--beta_final", type=float, default=4.0)
    # run management
    p.add_argument("--log_dir", default="runs/gauge")
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=0,
                   help="in-training eval every N steps (0=off)")
    p.add_argument("--run_steps", type=int, default=2000,
                   help="post-training eval steps per beta")
    p.add_argument("--eval_init", default="train",
                   choices=["train", "random", "metropolis"],
                   help="eval chain start: annealed training chains (default; "
                        "fresh random chains can freeze in metastable defects "
                        "at large beta), reference-parity random, or the "
                        "annealed chains equilibrated by exact checkerboard "
                        "Metropolis sweeps at the eval beta (the standard "
                        "lattice warm start; required at 64x64 where a fast "
                        "anneal leaves chains in a >10k-step metastable "
                        "plateau)")
    p.add_argument("--eval_therm_sweeps", type=int, default=2000,
                   help="Metropolis sweeps for --eval_init metropolis")
    p.add_argument("--restore", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensorboard", action="store_true", help="write TB scalar summaries")
    p.add_argument("--summary_steps", type=int, default=0,
                   help="per-variable param summaries every N steps (0=off; "
                        "reference variable_summaries, utils/tf_logging.py:74-86)")
    p.add_argument("--grad_summaries", action="store_true",
                   help="per-variable parameter AND gradient "
                        "mean/std/min/max/l2 stats computed on-device each "
                        "step, written into every metrics.jsonl record "
                        "(reference _create_summaries, gauge_model.py:853-886)")
    p.add_argument("--profile", action="store_true",
                   help="jax.profiler trace of steps 10-20")
    p.add_argument("--profile_every", type=int, default=0,
                   help="with --profile: re-trace one chunk every N "
                        "logging chunks into timeline_<step>/ dirs — the "
                        "reference's per-logging-step Chrome-trace "
                        "timelines (gauge_model.py:1250-1265)")
    return p


def resolve_eps(a) -> float:
    if str(a.eps) != "auto":
        return float(a.eps)
    vol = a.time_size * a.space_size
    return 0.35 * (64.0 / vol) ** 0.25


def flags_to_config(a):
    from l2hmc.train.gauge import GaugeConfig

    return GaugeConfig(
        time_size=a.time_size, space_size=a.space_size,
        num_chains=a.num_samples, num_steps=a.num_steps,
        eps_init=resolve_eps(a),
        eps_cap=a.eps_cap, eps_trainable=not a.eps_fixed, hmc=a.hmc,
        network_arch="zero" if a.hmc else a.network_arch,
        num_hidden=a.num_hidden, num_filters=a.num_filters, use_bf16=a.bf16,
        local_kernel=a.local_kernel, local_layers=a.local_layers,
        metric=a.metric, loss_scale=a.loss_scale, std_weight=a.std_weight,
        aux_weight=a.aux_weight, charge_weight=a.charge_weight,
        charge_reward=a.charge_reward, ref_z_term=a.ref_z_term,
        lr_init=a.lr_init, lr_decay_steps=a.lr_decay_steps,
        lr_decay_rate=a.lr_decay_rate, clip_value=a.clip_value,
        train_steps=a.train_steps, beta_init=a.beta_init,
        beta_final=a.beta_final, group=a.group,
        action=a.action, rect_c1=a.rect_c1,
        merge_v_halves=a.merge_v_halves, train_hops=a.train_hops,
        eps_warmup_steps=a.eps_warmup_steps,
        eps_target_accept=a.eps_target_accept,
        grad_summaries=a.grad_summaries,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.analysis import stats
    from l2hmc.lattice import u1
    from l2hmc.parallel.mesh import (
        get_mesh, initialize_distributed, shard_train_state,
    )
    from l2hmc.train import checkpoint as ckpt
    from l2hmc.train.gauge import (
        init_train_state, make_eval_chunk, make_train_chunk,
    )
    from l2hmc.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    install_sigterm_handler()
    initialize_distributed()
    cfg = flags_to_config(args)
    key = jax.random.PRNGKey(args.seed)

    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}")
    log(f"devices: {jax.devices()}")
    # volume advisory (128x128 study): per-step S/T/Q output
    # jumps enter the Hamiltonian summed over x_dim links, and the eps
    # acceptance cliff tightens with volume — default settings that train
    # fine at L<=64 freeze the chain at larger L
    x_dim = 2 * cfg.time_size * cfg.space_size
    if (not cfg.hmc and x_dim > 16384 and cfg.eps_warmup_steps == 0
            and (cfg.lr_init > 5e-5 or cfg.eps_trainable)):
        log(f"WARNING: x_dim={x_dim} with lr_init={cfg.lr_init} and "
            f"eps_trainable={cfg.eps_trainable} — at this volume the "
            "dead-gradient trap closes easily; use --eps_warmup_steps "
            "(dual-averaging warmup finds the stable eps automatically) "
            "and a small lr (e.g. --lr_init 2e-5)")

    # --autotune composes badly with --restore: the search could change
    # num_steps (masks shape (K, d)) after a checkpoint already fixed it,
    # and re-running the probe sweep on every resume wastes minutes.  When
    # a checkpoint exists, the tuned (K, eps) are already baked into the
    # restored cfg/params — skip the search.
    _has_ckpt = args.restore and any(
        Path(args.log_dir).glob("run_*/checkpoints"))
    if args.autotune and _has_ckpt:
        log("autotune: skipped — restoring from an existing checkpoint "
            "(its (K, eps) are fixed by the saved state)")
    if args.autotune and not cfg.hmc and not _has_ckpt:
        # cold-start joint (K, eps) search (train/autotune.py): tune HMC's
        # optimum at the target distribution, then the trained kernel's
        # coarse-K cells around its trajectory length
        from l2hmc.lattice.metropolis import thermalize
        from l2hmc.train.autotune import tune_hmc, tune_l2hmc

        key, k1, k2, k3 = jax.random.split(key, 4)
        x0_t = u1.random_links(k1, cfg.num_chains, cfg.shape)
        x_th = jax.jit(lambda x, k: thermalize(
            k, x, cfg.shape, cfg.beta_final, 1000))(x0_t, k1)
        hmc_opt = tune_hmc(cfg, x_th, cfg.beta_final, k2,
                           probe_chains=max(cfg.num_chains, 512))
        log(f"autotune: HMC optimum K={hmc_opt.num_steps} eps={hmc_opt.eps} "
            f"acc={hmc_opt.accept:.3f}")
        l2_opt = tune_l2hmc(
            cfg, k3, hmc_opt,
            probe_train_steps=args.autotune_probe_steps,
            probe_chains=max(cfg.num_chains, 512))
        log(f"autotune: trained cell K={l2_opt.num_steps} eps={l2_opt.eps} "
            f"(probe acc {l2_opt.accept:.3f})")
        cfg = dataclasses.replace(
            cfg, num_steps=l2_opt.num_steps, eps_init=l2_opt.eps,
            eps_trainable=False)

    state = init_train_state(cfg, key)
    start_step = 0
    ckpt_dir = run_dir / "checkpoints"
    if args.restore:
        # restore from the latest run that has checkpoints
        prev = sorted(Path(args.log_dir).glob("run_*/checkpoints"))
        if prev:
            ckpt_src = prev[-1]
            step = ckpt.latest_step(ckpt_src)
            if step is not None:
                state = ckpt.restore_checkpoint(ckpt_src, state)
                start_step = int(state.step)
                log(f"restored step {start_step} from {ckpt_src}")

    if jax.device_count() > 1:
        mesh = get_mesh()
        state = shard_train_state(state, mesh)
        log(f"mesh: {mesh}")

    chunk_size = args.logging_steps
    train_chunk = make_train_chunk(cfg, chunk_size)
    eval_chunk = make_eval_chunk(cfg, 500) if args.eval_steps else None

    logger = MetricsLogger(run_dir, print_every=1, tensorboard=args.tensorboard)
    t_prev = time.perf_counter()
    # detect-and-retrain outer loop (train.gauge.train_to_convergence
    # semantics with the full CLI loop body): at beta >= 5 a training can
    # land in the half-acceptance basin; --retrain_acc re-seeds it
    max_attempts = 1 + (args.max_retrains if args.retrain_acc > 0 else 0)
    attempts = []
    try:
        for attempt in range(max_attempts):
            if attempt > 0:
                key = jax.random.fold_in(jax.random.PRNGKey(args.seed),
                                         7700 + attempt)
                state = init_train_state(cfg, key)
                start_step = 0
            n_chunks = max((cfg.train_steps - start_step) // chunk_size, 0)
            end_acc = float("nan")
            for c in range(n_chunks):
                key, sub = jax.random.split(key)
                trace_now = args.profile and (
                    c == 0 or (args.profile_every > 0
                               and c % args.profile_every == 0))
                if trace_now:
                    # recurring timelines land in their own per-step dirs
                    # (reference timeline_<step>.json,
                    # gauge_model.py:1250-1265)
                    tdir = run_dir / ("profile" if c == 0
                                      else f"timeline_{int(state.step)}")
                    with jax.profiler.trace(str(tdir)):
                        state, metrics = train_chunk(state, sub)
                        jax.block_until_ready(state.x)
                    # reference parity: dump the op-view digest right after
                    # the traced window (gauge_model.py:1048-1071)
                    from l2hmc.analysis.profile_digest import write_digest

                    digest = write_digest(
                        tdir, run_dir if c == 0 else tdir)
                    if digest is not None:
                        log(f"profile digest: {digest}")
                else:
                    state, metrics = train_chunk(state, sub)
                step = int(state.step)
                t_now = time.perf_counter()
                acc_arr = np.asarray(metrics["accept_prob"])
                end_acc = float(acc_arr[-min(50, chunk_size):].mean())
                rec = {k: float(np.asarray(v)[-1]) for k, v in metrics.items()}
                rec.update(
                    step=step,
                    dt=(t_now - t_prev) / chunk_size,
                    plaq_exact=float(u1.u1_plaq_exact(rec["beta"])),
                )
                t_prev = t_now
                logger.write(rec)

                if args.summary_steps and step % args.summary_steps < chunk_size:
                    logger.write_summaries(step, state.params)
                if args.save_steps and step % args.save_steps < chunk_size:
                    ckpt.save_checkpoint(ckpt_dir, state, step, cfg)
                if eval_chunk is not None and step % args.eval_steps < chunk_size:
                    key, sub = jax.random.split(key)
                    x_eval = u1.random_links(sub, cfg.num_chains, cfg.shape)
                    _, em = eval_chunk(state.params, x_eval, rec["beta"], sub)
                    log(
                        f"  eval@{step}: acc={float(np.asarray(em['accept_prob']).mean()):.4f} "
                        f"plaq={float(np.asarray(em['plaqs'])[250:].mean()):.5f}"
                    )
            attempts.append({"attempt": attempt,
                             "end_accept": round(end_acc, 4)})
            if (args.retrain_acc <= 0 or n_chunks == 0
                    or end_acc >= args.retrain_acc):
                break
            log(f"training attempt {attempt}: end acc {end_acc:.3f} < "
                f"{args.retrain_acc} (half-acceptance basin) — retraining "
                f"with a fresh seed")
    except (KeyboardInterrupt, SystemExit):
        # save-and-exit on interrupt (reference gauge_model.py:1295-1301)
        log(f"interrupted at step {int(state.step)}; checkpointing...")
        ckpt.save_checkpoint(ckpt_dir, state, int(state.step), cfg)
        logger.close()
        raise

    if attempts:
        # provenance: how many trainings the shipped params took
        save_params_json(run_dir, dict(vars(args),
                                       train_attempts=attempts))
    ckpt.save_checkpoint(ckpt_dir, state, int(state.step), cfg)

    # post-training eval protocol (gauge_model.py:2142-2148); --eval_hops
    # swaps in the composite kernel+hop chain (dynamics/topo.py) — the
    # framework's topological-channel winner, from the product surface
    if args.run_steps:
        if args.eval_hops > 0:
            from l2hmc.dynamics import topo

            eval_chunk = topo.make_hop_eval_chunk(
                cfg, min(args.run_steps, 1000), n_hops=args.eval_hops,
                nu_max=args.nu_max)
        else:
            eval_chunk = make_eval_chunk(cfg, min(args.run_steps, 1000))
        for beta in (cfg.beta_final, cfg.beta_final - 1.0):
            key, k0, k1 = jax.random.split(key, 3)
            if args.eval_init == "train":
                x = state.x
            elif args.eval_init == "metropolis":
                from l2hmc.lattice.metropolis import thermalize

                x = jax.jit(
                    lambda x, k: thermalize(
                        k, x, cfg.shape, beta, args.eval_therm_sweeps)
                )(state.x, k0)
                log(f"  eval init: {args.eval_therm_sweeps} Metropolis "
                    f"sweeps at beta={beta:g}")
            else:
                x = u1.random_links(k0, cfg.num_chains, cfg.shape)
            all_metrics = {}
            done = 0
            while done < args.run_steps:
                key, sub = jax.random.split(key)
                x, em = eval_chunk(state.params, x, beta, sub)
                for k, v in em.items():
                    all_metrics.setdefault(k, []).append(np.asarray(v))
                done += min(args.run_steps, 1000)
            merged = {k: np.concatenate(v) for k, v in all_metrics.items()}
            summary = stats.observables_stats(
                {k: v.mean(axis=-1) for k, v in merged.items()}
            )
            # <Q^2> must square PER-CHAIN charges; squaring the chain
            # average (what observables_stats sees above) biases it low
            # by ~1/num_chains.
            q_full = stats.therm_cut(merged["charges"])
            summary["charges"]["susceptibility"] = float((q_full ** 2).mean())
            summary["charges"]["histogram"] = stats.charge_histogram(q_full)
            # pooled multi-chain tau_int(Q) next to the single-trace Sokal
            # number: at large volume/beta the per-chain window is noise
            # exactly where tau is interesting (analysis/stats.py)
            tau_q, tau_ok = stats.pooled_integrated_time(q_full)
            summary["charges"]["tau_int_pooled"] = round(float(tau_q), 2)
            summary["charges"]["tau_int_pooled_reliable"] = bool(tau_ok)
            tau_q1, _ = stats.integrated_time(q_full.mean(axis=-1))
            summary["charges"]["tau_int_sokal_single"] = round(
                float(tau_q1), 2)
            summary["plaq_exact"] = float(u1.u1_plaq_exact(beta))
            summary["wloop22_exact"] = float(u1.wilson_loop_exact(beta, 4))
            if args.action == "wilson":
                summary["q2_exact"] = float(
                    u1.topological_susceptibility_exact(
                        beta, cfg.shape.num_plaquettes)
                )
            out_file = run_dir / f"eval_beta{beta:g}.json"
            if jax.process_index() == 0:
                out_file.write_text(json.dumps(summary, indent=2, default=str))
                # full traces for offline re-analysis (cli/analyze_run.py)
                np.savez_compressed(
                    run_dir / f"eval_beta{beta:g}.npz", **merged
                )
            q2_note = (f" <Q^2>={summary['charges']['susceptibility']:.4f}"
                       f" (exact {summary['q2_exact']:.4f})"
                       if "q2_exact" in summary else "")
            hop_note = ""
            if "hop_accept" in summary:
                hop_note = (
                    f" hop_acc={summary['hop_accept']['mean']:.4f}"
                    f" hop_dq={summary['hop_dq']['mean']:.4f}")
            tau_note = (
                f" tau_Q(pooled)={summary['charges']['tau_int_pooled']:g}"
                + ("" if summary["charges"]["tau_int_pooled_reliable"]
                   else "(unreliable)"))
            log(f"eval beta={beta:g}: plaq={summary['plaqs']['mean']:.5f} "
                f"(exact {summary['plaq_exact']:.5f}) "
                f"acc={summary['accept_prob']['mean']:.4f}{q2_note}"
                f"{hop_note}{tau_note}"
                f" -> {out_file}")

    logger.close()
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
