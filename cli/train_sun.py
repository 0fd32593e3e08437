#!/usr/bin/env python
"""SU(N) lattice gauge sampling / training CLI.

Beyond-reference capability (the reference's SU(N) code is dead
scaffolding, SURVEY §7.4): sample 2-D SU(2)/SU(3) lattice gauge theory
with Lie-group HMC, or train the augmented (L2HMC-style) momentum kernel
and compare mixing against HMC.  Every run reports the measured average
plaquette next to the exact Weyl-measure single-plaquette value — the
SU(N) analog of the U(1) ``I1/I0`` oracle column.

Usage:
    python cli/train_sun.py --n 3 --beta 4.0 --hmc --run_steps 2000
    python cli/train_sun.py --n 2 --beta 2.0 --train_steps 1000
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
    p.add_argument("--n", type=int, default=2, choices=[2, 3], help="SU(N)")
    p.add_argument("--time_size", type=int, default=8)
    p.add_argument("--space_size", type=int, default=8)
    p.add_argument("--dims", type=int, nargs="+", default=None,
                   help="d-dimensional lattice extents (e.g. --dims 4 4 4 4 "
                        "for 4-D); HMC-only path via lattice.sun_nd")
    p.add_argument("--rect_c1", type=float, default=0.0,
                   help="rectangle-improved action coefficient "
                        "(with --dims; 0 = Wilson, -1/12 = tree Symanzik)")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=32, help="chains")
    p.add_argument("--num_steps", type=int, default=3, help="leapfrog steps")
    p.add_argument("--eps", type=float, default=0.15)
    p.add_argument("--hmc", action="store_true", help="plain HMC, no training")
    p.add_argument("--learn_position", action="store_true",
                   help="learned masked position translation (exactly "
                        "Haar-measure-preserving) on top of the augmented "
                        "momentum kernel")
    p.add_argument("--num_hidden", type=int, default=32)
    p.add_argument("--train_steps", type=int, default=1000)
    p.add_argument("--lr_init", type=float, default=1e-3)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--loss_scale", type=float, default=0.1)
    p.add_argument("--run_steps", type=int, default=1000, help="eval transitions")
    p.add_argument("--therm_frac", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_dir", default="runs/sun")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from l2hmc.dynamics.sun_hmc import (
        sun_hmc_transition, sun_plaq_exact,
    )
    from l2hmc.dynamics.sun_l2hmc import (
        SUNL2HMCConfig, init_sun_l2hmc, make_sun_train_step,
        plaq_trace_distance,
    )
    from l2hmc.lattice.sun import random_sun, sun_plaquette
    from l2hmc.utils.io import (
        MetricsLogger, install_sigterm_handler, make_run_dir, log,
    )

    install_sigterm_handler()
    run_dir = make_run_dir(args.log_dir)
    (run_dir / "params.json").write_text(json.dumps(vars(args), indent=2))
    logger = MetricsLogger(run_dir)
    key = jax.random.PRNGKey(args.seed)

    if args.dims is not None:
        # d-dimensional path (4-D SU(3) etc.): HMC sampling via sun_nd.
        from l2hmc.lattice.sun_nd import (
            sun_nd_hmc_chain, sun_plaq_strong_coupling,
        )

        if not args.hmc:
            log("--dims implies --hmc (the learned kernel is 2-D); "
                "sampling with plain Lie-group HMC")
        key, sub = jax.random.split(key)
        plaqs, probs = jax.jit(
            lambda k: sun_nd_hmc_chain(
                k, n=args.n, dims=tuple(args.dims), beta=args.beta,
                num_samples=args.run_steps, batch=args.num_samples,
                eps=args.eps, num_steps=args.num_steps, c1=args.rect_c1,
            )
        )(sub)
        cut = int(args.therm_frac * args.run_steps)
        meas = float(np.asarray(plaqs)[cut:].mean())
        summary = {
            "n": args.n, "beta": args.beta, "dims": list(args.dims),
            "rect_c1": args.rect_c1, "plaq": meas,
            "plaq_strong_coupling_lo": sun_plaq_strong_coupling(args.n, args.beta),
            "accept_prob": float(np.asarray(probs).mean()),
            "mode": "hmc_nd",
        }
        (run_dir / "eval.json").write_text(json.dumps(summary, indent=2))
        log(f"SU({args.n}) {'x'.join(map(str, args.dims))} beta={args.beta:g}"
            f" c1={args.rect_c1:g}: plaq={meas:.5f} "
            f"(strong-coupling LO {summary['plaq_strong_coupling_lo']:.5f}) "
            f"acc={summary['accept_prob']:.3f} -> {run_dir}")
        logger.close()
        return 0
    n, beta = args.n, args.beta
    exact = sun_plaq_exact(n, beta)
    key, k0 = jax.random.split(key)
    u = random_sun(
        k0, n, (args.num_samples, args.time_size, args.space_size, 2),
        scale=0.5)

    def avg_plaq(links):
        tr = jnp.trace(sun_plaquette(links), axis1=-2, axis2=-1).real / n
        return jnp.mean(tr, axis=(-2, -1))

    cfg = SUNL2HMCConfig(n=n, num_steps=args.num_steps, eps_init=args.eps,
                         hidden=args.num_hidden, eps_trainable=not args.hmc,
                         learn_position=args.learn_position and not args.hmc)
    opt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(optax.warmup_exponential_decay_schedule(
            0.0, args.lr_init, args.warmup_steps, 1000, 0.96)),
    )
    train_step, dyn = make_sun_train_step(cfg, beta, opt,
                                          loss_scale=args.loss_scale)
    params = init_sun_l2hmc(key, cfg)

    if not args.hmc and args.train_steps:
        opt_state = opt.init(params)
        chunk_len = min(args.train_steps, 100)

        @jax.jit
        def train_chunk(params, opt_state, u, k):
            def body(c, kk):
                params, opt_state, u = c
                params, opt_state, u, m = train_step(params, opt_state, u, kk)
                return (params, opt_state, u), m

            keys = jax.random.split(k, chunk_len)
            (params, opt_state, u), ms = jax.lax.scan(
                body, (params, opt_state, u), keys)
            return params, opt_state, u, {k_: v[-1] for k_, v in ms.items()}

        t0 = time.time()
        done = 0
        try:
            while done < args.train_steps:
                key, sub = jax.random.split(key)
                params, opt_state, u, m = train_chunk(params, opt_state, u, sub)
                done += chunk_len
                rec = {k_: float(v) for k_, v in m.items()}
                rec.update(step=done, wall_s=round(time.time() - t0, 2))
                logger.write(rec)
                log(f"step {done}: loss={rec['loss']:.3f} "
                    f"acc={rec['accept_prob']:.3f} eps={rec['eps']:.4f}")
        except (KeyboardInterrupt, SystemExit):
            # save-and-exit on interrupt/SIGTERM (gauge_model.py:1295-1301)
            from l2hmc.train import checkpoint as ckpt

            log(f"interrupted at step {done}; checkpointing...")
            ckpt.save_checkpoint(run_dir / "checkpoints",
                                 {"params": params, "links": u}, done)
            logger.close()
            raise

    # evaluation (trained kernel, or plain HMC with --hmc)
    @jax.jit
    def eval_chunk(params, u, k):
        def body(u, kk):
            if args.hmc:
                out = sun_hmc_transition(u, beta, kk, args.eps,
                                         args.num_steps, n)
                links, prob = out.links, out.accept_prob
                dist = plaq_trace_distance(u, links)
            else:
                o = dyn["transition"](params, u, kk)
                links, prob = o["x_out"], o["accept_prob"]
                dist = plaq_trace_distance(u, links)
            return links, (avg_plaq(links), prob, dist)

        keys = jax.random.split(k, args.run_steps)
        return jax.lax.scan(body, u, keys)

    key, sub = jax.random.split(key)
    u, (plaqs, probs, dists) = eval_chunk(params, u, sub)
    cut = int(args.therm_frac * args.run_steps)
    meas = float(np.asarray(plaqs)[cut:].mean())
    summary = {
        "n": n, "beta": beta,
        "plaq": meas, "plaq_exact": float(exact),
        "plaq_err": abs(meas - float(exact)),
        "accept_prob": float(np.asarray(probs).mean()),
        "esjd_plaq_trace": float(np.asarray(dists)[cut:].mean()),
        "mode": "hmc" if args.hmc else (
            "l2hmc+xnet" if args.learn_position else "l2hmc"),
    }
    (run_dir / "eval.json").write_text(json.dumps(summary, indent=2))
    log(f"SU({n}) beta={beta:g}: plaq={meas:.5f} (exact {float(exact):.5f}) "
        f"acc={summary['accept_prob']:.3f} ESJD={summary['esjd_plaq_trace']:.5f}"
        f" -> {run_dir}")
    logger.close()
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
