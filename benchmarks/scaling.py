#!/usr/bin/env python
"""Samples/s scaling-efficiency harness (BASELINE.json north star:
>= 80% efficiency 1 host -> 2+ hosts).

Measures sampling throughput with the chain batch sharded over 1, 2, ..., N
mesh devices, holding per-device chain count fixed (weak scaling — the
regime that matters for ensemble MCMC).  On real hardware the mesh spans
the cards of a host (and hosts); without several, run on virtual CPU
devices to
validate the mechanism end-to-end:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --chains_per_device 64

Multi-host launch recipe (run the SAME command on every host; one
invocation per host, mechanism identical to the reference's
``mpirun ... python gauge_model.py --horovod`` but through
``jax.distributed``, SURVEY §5.8):

    # host 0 (also the coordinator):
    python benchmarks/scaling.py --coordinator 10.0.0.1:8476 \
        --num_processes 2 --process_id 0 --chains_per_device 256
    # host 1:
    python benchmarks/scaling.py --coordinator 10.0.0.1:8476 \
        --num_processes 2 --process_id 1 --chains_per_device 256

    # then compute the 1->2 host efficiency against a single-host run:
    python benchmarks/scaling.py --chains_per_device 256   # prints rate R1
    ... --num_processes 2 ... --baseline_rate R1           # prints efficiency

In multi-process mode every process must participate in every collective,
so the harness runs ONLY the full global mesh (no per-device-count loop)
and process 0 prints the result.  Before timing, the psum topology is
assertion-checked: a device-index reduction and a mean-gradient-style
reduction over the global mesh must be exact.

Prints one JSON line per device count plus a summary efficiency line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def verify_psum_topology(mesh):
    """Assert the 'data'-axis reduction is wired across every device.

    1. device-index sum: shard ``arange(n)`` over 'data'; the jitted global
       sum must be exactly n(n-1)/2 (each device contributes its own index,
       so a mis-wired or dropped participant changes the value).
    2. gradient-style mean: the mean of a sharded per-chain vector must
       match the host-side mean bit-for-bit in f64-accumulated f32.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from l2hmc.parallel.mesh import chain_sharding

    n = int(np.prod(mesh.devices.shape))
    idx = jax.device_put(
        jnp.arange(n, dtype=jnp.float32)[:, None], chain_sharding(mesh))
    total = float(jax.jit(jnp.sum)(idx))
    expect = n * (n - 1) / 2.0
    assert total == expect, f"psum topology broken: {total} != {expect}"

    rng = np.random.default_rng(0)
    v = rng.normal(size=(8 * n, 4)).astype(np.float32)
    vs = jax.device_put(jnp.asarray(v), chain_sharding(mesh))
    got = float(jax.jit(jnp.mean)(vs))
    want = float(np.mean(v, dtype=np.float64))
    assert abs(got - want) < 1e-6, f"mean reduction off: {got} vs {want}"
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chains_per_device", type=int, default=64)
    p.add_argument("--time_size", type=int, default=16)
    p.add_argument("--space_size", type=int, default=16)
    p.add_argument("--num_steps", type=int, default=3)
    p.add_argument("--network_arch", default="conv")
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--mode", default="sample", choices=["sample", "train"])
    # multi-host (jax.distributed) launch
    p.add_argument("--coordinator", default="",
                   help="coordinator address host:port; enables "
                        "jax.distributed multi-process mode")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--baseline_rate", type=float, default=0.0,
                   help="single-host transitions/s to compute cross-host "
                        "weak-scaling efficiency against")
    args = p.parse_args(argv)

    import jax

    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import jax.numpy as jnp
    import numpy as np

    from l2hmc.lattice import u1
    from l2hmc.parallel.mesh import (
        chain_sharding, get_mesh, is_primary, shard_train_state,
        train_state_shardings,
    )
    from l2hmc.train.gauge import (
        GaugeConfig, build_dynamics, init_train_state, make_train_step,
    )

    n_dev = jax.device_count()
    multiproc = jax.process_count() > 1
    if multiproc:
        # all processes participate in every collective: one global mesh
        counts = [n_dev]
    else:
        counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    results = []
    for nd in counts:
        cfg = GaugeConfig(
            time_size=args.time_size, space_size=args.space_size,
            num_chains=args.chains_per_device * nd, num_steps=args.num_steps,
            network_arch=args.network_arch, eps_init=0.1,
        )
        mesh = get_mesh(num_data=nd, devices=jax.devices()[:nd])
        n_checked = verify_psum_topology(mesh)
        if is_primary():
            print(json.dumps({"psum_topology_ok": True,
                              "devices_checked": n_checked,
                              "processes": jax.process_count()}), flush=True)
        key = jax.random.PRNGKey(0)
        state = shard_train_state(init_train_state(cfg, key), mesh)

        if args.mode == "train":
            step_fn = make_train_step(cfg)
            shardings = train_state_shardings(state, mesh)

            @jax.jit
            def chunk_fn(state, key):
                def body(s, k):
                    s, m = step_fn(s, k)
                    return s, m["loss"]
                keys = jax.random.split(key, args.chunk)
                state, losses = jax.lax.scan(body, state, keys)
                return state, jnp.sum(losses)

            def run(key):
                s, digest = chunk_fn(state, key)
                float(digest)
                return s
        else:
            _, dyn, _ = build_dynamics(cfg)

            @jax.jit
            def chunk_fn(params, x, key):
                def body(x, k):
                    out = dyn["transition"](params, x, 4.0, k)
                    return u1.wrap(out.x_out), out.accept_prob
                keys = jax.random.split(key, args.chunk)
                x, probs = jax.lax.scan(body, x, keys)
                return x, jnp.sum(probs)

            x0 = jax.device_put(
                u1.random_links(key, cfg.num_chains, cfg.shape),
                chain_sharding(mesh),
            )

            def run(key):
                x, digest = chunk_fn(state.params, x0, key)
                float(digest)
                return x

        run(jax.random.PRNGKey(1))  # compile + warmup
        best = float("inf")
        for i in range(args.repeats):
            t0 = time.perf_counter()
            run(jax.random.PRNGKey(2 + i))
            best = min(best, time.perf_counter() - t0)
        rate = args.chunk * cfg.num_chains / best  # chain-transitions/s
        results.append({"devices": nd, "chains": cfg.num_chains,
                        "processes": jax.process_count(),
                        "transitions_per_s": round(rate, 1)})
        if is_primary():
            print(json.dumps(results[-1]), flush=True)

    if is_primary():
        if len(results) > 1:
            base = results[0]["transitions_per_s"]
            eff = {
                r["devices"]: round(
                    r["transitions_per_s"] / (base * r["devices"]), 3
                )
                for r in results[1:]
            }
            print(json.dumps({"weak_scaling_efficiency_vs_1dev": eff}))
        if args.baseline_rate > 0:
            r = results[-1]
            print(json.dumps({
                "weak_scaling_efficiency_vs_baseline": round(
                    r["transitions_per_s"]
                    / (args.baseline_rate * jax.process_count()), 3),
                "baseline_rate": args.baseline_rate,
                "processes": jax.process_count(),
            }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
