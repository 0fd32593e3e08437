#!/usr/bin/env python
"""Gauge-equivariant normalizing-flow training CLI for U(1) lattice gauge
theory (``dynamics/flow.py`` — the MLMC/Kanwar line, beyond the reference).

Trains the plaquette-coupling flow by reverse KL against the Wilson action,
then evaluates three ways:
  1. importance-reweighted observables (plaquette vs the exact oracle,
     topological susceptibility) with the weight-ESS,
  2. a flow-proposal independence-Metropolis chain (acceptance, plaquette),
  3. optional beta annealing: train at increasing beta reusing parameters.

Usage:
    python cli/train_flow.py --size 8 --beta 2 --train_steps 2000
    python cli/train_flow.py @configs/flow_8x8.txt
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from l2hmc.utils.flags import ArgfileParser  # noqa: E402


def build_parser():
    p = ArgfileParser(description=__doc__)
    p.add_argument("--size", type=int, default=8)
    p.add_argument("--time_size", type=int, default=0,
                   help="defaults to --size")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--beta_init", type=float, default=0.0,
                   help="anneal training from here to --beta (0 = off)")
    p.add_argument("--num_layers", type=int, default=16)
    p.add_argument("--n_mix", type=int, default=6)
    p.add_argument("--hidden_channels", type=int, default=32)
    p.add_argument("--conditioner_depth", type=int, default=1,
                   help="hidden conv layers per conditioner")
    p.add_argument("--kernel_size", type=int, default=3,
                   help="conditioner conv kernel (Kanwar et al. use large "
                        "kernels for long-range context at high beta)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--train_steps", type=int, default=3000)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--lr_decay_steps", type=int, default=1000)
    p.add_argument("--lr_decay_rate", type=float, default=0.7)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--clip_grad", type=float, default=10.0)
    # forward-KL (max-likelihood) fine-tuning phase on exact HMC samples:
    # targets KL(p||q), which governs hybrid-chain acceptance
    p.add_argument("--fkl_steps", type=int, default=0,
                   help="fine-tune steps with loss = reverse_kl + "
                        "fkl_weight * forward_kl(HMC samples)")
    p.add_argument("--fkl_weight", type=float, default=1.0)
    p.add_argument("--fkl_lr", type=float, default=2e-4,
                   help="the fine-tune phase uses its own fresh Adam "
                        "(the restored optimizer carries the main phase's "
                        "decayed schedule count)")
    p.add_argument("--fkl_batch", type=int, default=256)
    p.add_argument("--fkl_buffer", type=int, default=4096,
                   help="HMC-generated target-sample buffer size")
    p.add_argument("--fkl_hmc_eps", type=float, default=0.08)
    p.add_argument("--eval_batch", type=int, default=4096)
    p.add_argument("--mh_steps", type=int, default=1000,
                   help="0 skips the independence-MH eval")
    p.add_argument("--resume", default="",
                   help="run dir of a previous train_flow run: restore "
                        "params + optimizer state and train --train_steps "
                        "MORE steps into the same dir (config comes from "
                        "the checkpoint; size/layer flags are ignored)")
    p.add_argument("--log_dir", default="runs/flow")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--ckpt_steps", type=int, default=0,
                   help="checkpoint every N steps during training "
                        "(0 = only at the end)")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from l2hmc.dynamics import flow as F
    from l2hmc.lattice import u1
    from l2hmc.train import checkpoint as ckpt
    from l2hmc.utils.io import (MetricsLogger, log, make_run_dir,
                                    save_params_json)

    if args.resume:
        run_dir = Path(args.resume)
        cfg_dict = ckpt.load_config_dict(run_dir / "checkpoints")
        if cfg_dict is None:
            raise FileNotFoundError(
                f"no config.json under {run_dir}/checkpoints — is this a "
                "train_flow run dir?")
        cfg = F.FlowConfig(**cfg_dict)
        lt = cfg.time_size
    else:
        lt = args.time_size or args.size
        cfg = F.FlowConfig(time_size=lt, space_size=args.size,
                           num_layers=args.num_layers, n_mix=args.n_mix,
                           hidden_channels=args.hidden_channels,
                           kernel_size=args.kernel_size,
                           conditioner_depth=args.conditioner_depth)
        run_dir = make_run_dir(args.log_dir)
        save_params_json(run_dir, vars(args))
    key = jax.random.PRNGKey(args.seed)
    log(f"run dir: {run_dir}; {lt}x{cfg.space_size} beta={args.beta} "
        f"layers={cfg.num_layers} mix={cfg.n_mix} ch={cfg.hidden_channels}"
        + (" (resumed)" if args.resume else ""))

    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, args.lr_init, args.warmup_steps),
         optax.exponential_decay(args.lr_init, args.lr_decay_steps,
                                 args.lr_decay_rate)],
        [args.warmup_steps])
    opt = optax.chain(optax.clip_by_global_norm(args.clip_grad),
                      optax.adam(sched))

    key, k0 = jax.random.split(key)
    params = F.init_flow(k0, cfg)
    opt_state = opt.init(params)
    start_step = 0
    if args.resume:
        params = ckpt.restore_checkpoint(run_dir / "checkpoints", params)
        start_step = ckpt.latest_step(run_dir / "checkpoints") or 0
        try:
            opt_state = ckpt.restore_checkpoint(run_dir / "opt_state",
                                                opt_state)
        except FileNotFoundError:
            log("no optimizer state in checkpoint; Adam restarts fresh")
        # resumed training continues at the requested beta (no re-anneal)
        args.beta_init = 0.0

    # beta schedule during training (flows train best annealed at high beta)
    def beta_at(step):
        if args.beta_init <= 0.0:
            return args.beta
        frac = min(1.0, step / max(1, args.train_steps // 2))
        return args.beta_init + (args.beta - args.beta_init) * frac

    def make_chunk(n_steps):
        @jax.jit
        def chunk(params, opt_state, beta, key):
            def body(carry, k):
                params, opt_state = carry
                (_, aux), grads = jax.value_and_grad(
                    lambda p: F.reverse_kl_loss(p, k, args.batch, beta, cfg),
                    has_aux=True)(params)
                updates, opt_state = opt.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), aux

            keys = jax.random.split(key, n_steps)
            (params, opt_state), aux = jax.lax.scan(
                body, (params, opt_state), keys)
            return params, opt_state, aux

        return chunk

    chunk = make_chunk(args.logging_steps)
    logger = MetricsLogger(run_dir)
    logger.COLUMNS = [
        ("step", "{:>7d}"), ("dt", "{:>8.4f}"), ("beta", "{:>5.2f}"),
        ("loss", "{:>12.4f}"), ("ess_frac", "{:>8.4f}"),
        ("plaq", "{:>8.5f}"),
    ]

    # graceful shutdown: SIGTERM (e.g. `timeout`-killed runs) falls through
    # to the checkpoint save instead of losing the tail
    from l2hmc.utils.io import install_sigterm_handler

    install_sigterm_handler()

    t_prev = time.perf_counter()
    steps_done = 0
    interrupted = False
    try:
        while steps_done < args.train_steps:
            key, sub = jax.random.split(key)
            beta = beta_at(steps_done)
            params, opt_state, aux = chunk(params, opt_state, beta, sub)
            steps_done += args.logging_steps
            t_now = time.perf_counter()
            rec = {k: float(np.asarray(v)[-1]) for k, v in aux.items()}
            rec.update(step=start_step + steps_done, beta=beta,
                       dt=(t_now - t_prev) / args.logging_steps)
            t_prev = t_now
            logger.write(rec)
            if (args.ckpt_steps
                    and steps_done % args.ckpt_steps < args.logging_steps):
                ckpt.save_checkpoint(run_dir / "checkpoints", params,
                                     start_step + steps_done, cfg)
                ckpt.save_checkpoint(run_dir / "opt_state", opt_state,
                                     start_step + steps_done)

        # ---- phase 2 (optional): forward-KL fine-tune on exact HMC samples
        if args.fkl_steps > 0:
            from l2hmc.dynamics.hmc import hmc_chain_u1_fused

            key, kb = jax.random.split(key)
            n_chains = args.fkl_buffer // 2
            links = jnp.zeros((n_chains, cfg.time_size, cfg.space_size, 2))
            links, _, _, _ = jax.jit(lambda l, k: hmc_chain_u1_fused(
                l, k, args.fkl_hmc_eps, args.beta, 5, 600))(links, kb)
            kb, _ = jax.random.split(kb)
            links2, _, _, _ = jax.jit(lambda l, k: hmc_chain_u1_fused(
                l, k, args.fkl_hmc_eps, args.beta, 5, 100))(links, kb)
            buffer = jnp.concatenate([links, links2])   # (fkl_buffer, ...)
            log(f"fkl buffer: {buffer.shape[0]} HMC-equilibrated configs")

            opt_f = optax.chain(optax.clip_by_global_norm(args.clip_grad),
                                optax.adam(args.fkl_lr))
            opt_state_f = opt_f.init(params)

            @jax.jit
            def fkl_chunk(params, opt_state, key):
                def body(carry, k):
                    params, opt_state = carry
                    kr, kf = jax.random.split(k)
                    idx = jax.random.randint(kf, (args.fkl_batch,), 0,
                                             buffer.shape[0])

                    def loss_fn(p):
                        rkl, aux = F.reverse_kl_loss(p, kr, args.batch,
                                                     args.beta, cfg)
                        fkl = F.forward_kl_loss(p, buffer[idx], cfg)
                        return rkl + args.fkl_weight * fkl, (aux, fkl)

                    (_, (aux, fkl)), grads = jax.value_and_grad(
                        loss_fn, has_aux=True)(params)
                    updates, opt_state = opt_f.update(grads, opt_state)
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), {**aux, "fkl": fkl}

                keys = jax.random.split(key, args.logging_steps)
                (params, opt_state), aux = jax.lax.scan(
                    body, (params, opt_state), keys)
                return params, opt_state, aux

            done = 0
            while done < args.fkl_steps:
                key, sub = jax.random.split(key)
                params, opt_state_f, aux = fkl_chunk(params, opt_state_f, sub)
                done += args.logging_steps
                rec = {k: float(np.asarray(v)[-1]) for k, v in aux.items()}
                rec.update(step=start_step + steps_done + done,
                           beta=args.beta, dt=0.0)
                logger.write(rec)
                log(f"  fkl step {done}: -E_p[logq] {rec['fkl']:.2f} "
                    f"rkl-ess {rec['ess_frac']:.4f}")
                steps_done += args.logging_steps
    except (KeyboardInterrupt, SystemExit):
        # SIGTERM (e.g. `timeout`) and Ctrl-C land here: save, skip evals
        interrupted = True
        log(f"interrupted at step {start_step + steps_done} — saving")

    ckpt.save_checkpoint(run_dir / "checkpoints", params,
                         start_step + steps_done, cfg)
    ckpt.save_checkpoint(run_dir / "opt_state", opt_state,
                         start_step + steps_done)
    if interrupted:
        logger.close()
        return 1

    # ---- eval 1: importance-reweighted observables + weight ESS
    key, k1, k2, k3 = jax.random.split(key, 4)
    x, log_w, log_z = jax.jit(
        lambda k: F.importance_weights(params, k, args.eval_batch,
                                       args.beta, cfg))(k1)
    w = jnp.exp(log_w)
    plaq_rw = float(jnp.sum(w * u1.avg_plaquette(x)))
    q = u1.topological_charge(x)
    chi_rw = float(jnp.sum(w * q * q))
    ess_frac = float(1.0 / jnp.sum(w * w) / args.eval_batch)
    exact = float(u1.u1_plaq_exact(args.beta))

    # ---- eval 2: flow-proposal independence MH (skipped if --mh_steps 0)
    if args.mh_steps > 0:
        x0, logq0 = jax.jit(
            lambda k: F.sample_and_logq(params, k, args.eval_batch // 4,
                                        cfg))(k2)
        _, plaqs, accs = jax.jit(
            lambda k, x0, lq: F.independence_mh_chain(
                params, k, x0, lq, args.beta, args.mh_steps, cfg))(
                    k3, x0, logq0)
        therm = args.mh_steps // 4
        mh_accept = round(float(jnp.mean(accs)), 4)
        mh_plaq = round(float(jnp.mean(plaqs[therm:])), 5)
    else:
        mh_accept = mh_plaq = None
    summary = {
        "lattice": f"{cfg.time_size}x{cfg.space_size}",
        "beta": args.beta,
        "weight_ess_frac": round(ess_frac, 4),
        "plaq_reweighted": round(plaq_rw, 5),
        "plaq_exact": round(exact, 5),
        "chi_q_reweighted": round(chi_rw, 4),
        "chi_q_exact": round(float(u1.topological_susceptibility_exact(
            args.beta, cfg.shape.num_plaquettes)), 4),
        "mh_accept": mh_accept,
        "mh_plaq": mh_plaq,
        # direct log Z from the flow weights vs the factorized analytic
        # value (exact up to the global-charge constraint)
        "log_z_flow": round(float(log_z), 2),
        "log_z_exact_factorized": round(
            u1.log_z_exact_factorized(cfg.shape, args.beta), 2),
    }
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary))
    logger.close()
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
