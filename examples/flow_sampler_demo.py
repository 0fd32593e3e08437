#!/usr/bin/env python
"""Gauge-equivariant normalizing flow on U(1), end to end in minutes on CPU.

No reference-notebook counterpart (the reference has no flow models) —
this demonstrates the framework's third sampler family (`dynamics/flow.py`,
the MLMC/Kanwar line): train a plaquette-coupling flow by reverse KL,
then check all three exactness anchors:

  1. importance-reweighted plaquette vs the exact ``I1(beta)/I0(beta)``,
  2. direct log Z from the weights vs the factorized analytic value,
  3. a flow-proposal independence-Metropolis chain on the same oracle.

Usage: python examples/flow_sampler_demo.py [--size 8 --beta 1.5]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=8,
                   help="lattice side (must be divisible by 4: the mod-4 "
                        "coupling stripes require it)")
    p.add_argument("--beta", type=float, default=1.5)
    p.add_argument("--train_steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import optax

    from l2hmc.dynamics import flow as F
    from l2hmc.lattice import u1

    cfg = F.FlowConfig(time_size=args.size, space_size=args.size,
                       num_layers=12, n_mix=4, hidden_channels=16)
    key = jax.random.PRNGKey(args.seed)
    params = F.init_flow(key, cfg)
    opt = optax.adam(2e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, k):
        (_, aux), grads = jax.value_and_grad(
            lambda p: F.reverse_kl_loss(p, k, args.batch, args.beta, cfg),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, aux

    print(f"{args.size}x{args.size} beta={args.beta}: training "
          f"{args.train_steps} steps...")
    for i in range(args.train_steps):
        key, sub = jax.random.split(key)
        params, opt_state, aux = step(params, opt_state, sub)
        if (i + 1) % 100 == 0:
            print(f"  step {i+1:4d}  KL-loss {float(aux['loss']):9.2f}  "
                  f"weight-ESS {float(aux['ess_frac']):.3f}")

    key, k1, k2, k3 = jax.random.split(key, 4)
    x, log_w, log_z = F.importance_weights(params, k1, 4096, args.beta, cfg)
    plaq = float(jnp.sum(jnp.exp(log_w) * u1.avg_plaquette(x)))
    exact = float(u1.u1_plaq_exact(args.beta))
    log_z_exact = u1.log_z_exact_factorized(cfg.shape, args.beta)

    x0, logq0 = F.sample_and_logq(params, k2, 256, cfg)
    _, plaqs, accs = jax.jit(lambda k, x0, lq: F.independence_mh_chain(
        params, k, x0, lq, args.beta, 300, cfg))(k3, x0, logq0)
    mh_plaq = float(jnp.mean(plaqs[75:]))

    print(f"reweighted plaquette {plaq:.5f}   exact {exact:.5f}")
    print(f"direct log Z {float(log_z):9.2f}   factorized exact "
          f"{log_z_exact:9.2f}")
    print(f"independence-MH plaquette {mh_plaq:.5f}  accept "
          f"{float(jnp.mean(accs)):.3f}")
    ok = (abs(plaq - exact) < 0.02 and abs(float(log_z) - log_z_exact) < 1.0
          and abs(mh_plaq - exact) < 0.02)
    print("OK: all three anchors hit" if ok else "MISMATCH — investigate")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
