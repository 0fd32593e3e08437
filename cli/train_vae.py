#!/usr/bin/env python
"""VAE-with-L2HMC-posterior-sampler training CLI.

Rebuild of the reference's third runnable workload, ``vae/mnist_vae.py``
(Python-2 era): train a VAE whose posterior over latents is refined by an
L2HMC sampler conditioned on the data batch, then run the two evaluations
the reference spawns via ``os.system`` after training
(``vae/mnist_vae.py:338-347``):

  1. AIS log-likelihood estimate (``vae/eval_vae.py`` + ``utils/ais.py``),
  2. autocovariance / ESS / acceptance of the trained posterior sampler
     (``vae/eval_sampler.py``).

Flag names mirror the reference's HParams (``vae/mnist_vae.py:41-55``):
``--epoch --leapfrogs --MH --batch_size --latent_dim --eps
--learning_rate``.  Dataset: the environment bundles no MNIST files, so the
default dataset is sklearn's 8x8 digits binarized the way the reference
binarizes MNIST (``utils/func_utils.py:98-109``); ``--data path.npy``
accepts any (N, D) binary array.

Usage:
    python cli/train_vae.py --epoch 20 --latent_dim 8
    python cli/train_vae.py @configs/vae_digits.txt
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
    # reference HParams (vae/mnist_vae.py:41-55)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--epoch", type=int, default=20)
    p.add_argument("--leapfrogs", type=int, default=5)
    p.add_argument("--MH", type=int, default=2,
                   help="sequential L2HMC transitions per step")
    p.add_argument("--random_lf_composition", type=int, default=0,
                   help="each MH step composes a random 1..N full leapfrog "
                        "integrations before one accept (reference "
                        "utils/sampler.py:61-93 chain_operator; 0=off)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--latent_dim", type=int, default=8)
    p.add_argument("--eps", type=float, default=0.1)
    # architecture
    p.add_argument("--enc_hidden", type=int, default=256)
    p.add_argument("--dec_hidden", type=int, default=256)
    p.add_argument("--sampler_hidden", type=int, default=64)
    # data / eval
    p.add_argument("--data", default="",
                   help="optional .npy of binary pixels; default bundled digits")
    p.add_argument("--ais_betas", type=int, default=100,
                   help="AIS annealing rungs for the log-lik eval")
    p.add_argument("--ais_samples", type=int, default=256,
                   help="held-out data points for the AIS eval")
    p.add_argument("--eval_transitions", type=int, default=200,
                   help="chain length for the sampler autocovariance eval")
    p.add_argument("--log_dir", default="runs/vae")
    p.add_argument("--logging_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import numpy as np

    from l2hmc.train.vae import (
        VAEConfig, ais_log_likelihood, load_digits_binarized,
        make_vae_train_step, posterior_sampler_autocovariance,
    )
    from l2hmc.utils.io import (
        MetricsLogger, install_sigterm_handler, log, make_run_dir,
        save_params_json,
    )

    install_sigterm_handler()
    if args.data:
        data = np.load(args.data).astype(np.float32)
    else:
        data = load_digits_binarized()
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(data))
    n_test = min(args.ais_samples, len(data) // 5)
    test, train = data[perm[:n_test]], data[perm[n_test:]]

    cfg = VAEConfig(
        data_dim=data.shape[1], latent_dim=args.latent_dim,
        enc_hidden=args.enc_hidden, dec_hidden=args.dec_hidden,
        num_steps=args.leapfrogs, mh_steps=args.MH, eps_init=args.eps,
        sampler_hidden=args.sampler_hidden,
        random_lf_composition=args.random_lf_composition,
        lr_elbo=args.learning_rate, lr_sampler=args.learning_rate,
        lr_decoder=args.learning_rate,
    )
    key = jax.random.PRNGKey(args.seed)
    run_dir = make_run_dir(args.log_dir)
    save_params_json(run_dir, vars(args))
    log(f"run dir: {run_dir}; data {train.shape} train / {test.shape} test")

    init_state, train_step, fns = make_vae_train_step(cfg)
    key, sub = jax.random.split(key)
    state = init_state(sub)

    logger = MetricsLogger(run_dir)
    logger.COLUMNS = [
        ("step", "{:>7d}"), ("epoch", "{:>5d}"), ("dt", "{:>8.4f}"),
        ("elbo", "{:>12.4f}"), ("sampler_loss", "{:>12.4g}"),
        ("decoder_nll", "{:>12.4f}"), ("accept_prob", "{:>7.4f}"),
    ]

    steps_per_epoch = max(1, len(train) // args.batch_size)
    step = 0
    t_prev = time.perf_counter()
    try:
        for epoch in range(args.epoch):
            order = rng.permutation(len(train))
            for i in range(steps_per_epoch):
                batch = train[order[i * args.batch_size:(i + 1) * args.batch_size]]
                if len(batch) < args.batch_size:  # static shapes under jit
                    batch = np.concatenate(
                        [batch, train[: args.batch_size - len(batch)]])
                key, sub = jax.random.split(key)
                state, aux = train_step(state, batch, sub)
                step += 1
                if step % args.logging_steps == 0:
                    t_now = time.perf_counter()
                    rec = {k: float(np.asarray(v)) for k, v in aux.items()}
                    rec.update(step=step, epoch=epoch,
                               dt=(t_now - t_prev) / args.logging_steps)
                    t_prev = t_now
                    logger.write(rec)
    except (KeyboardInterrupt, SystemExit):
        # save-and-exit on interrupt/SIGTERM (gauge_model.py:1295-1301)
        from l2hmc.train import checkpoint as ckpt

        log(f"interrupted at step {step}; checkpointing...")
        ckpt.save_checkpoint(run_dir / "checkpoints", state, step)
        logger.close()
        raise

    # post-training evals (mnist_vae.py:338-347 spawns these as scripts)
    key, k1, k2 = jax.random.split(key, 3)
    log("AIS log-likelihood eval...")
    logw = np.asarray(ais_log_likelihood(
        cfg, fns, state.params, test, k1, num_betas=args.ais_betas,
        eps=args.eps))
    log("sampler autocovariance eval...")
    mix = posterior_sampler_autocovariance(
        cfg, fns, state.params, test[: args.batch_size], k2,
        num_transitions=args.eval_transitions)

    summary = {
        "ais_log_likelihood_mean": float(logw.mean()),
        "ais_log_likelihood_sem": float(logw.std() / np.sqrt(len(logw))),
        "sampler_ess_per_step": mix["ess_per_step"],
        "sampler_accept_prob": mix["accept_prob"],
        "final_elbo": float(np.asarray(aux["elbo"])),
    }
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    log(json.dumps(summary, indent=2))
    logger.close()
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
