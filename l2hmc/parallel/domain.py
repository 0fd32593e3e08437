"""Lattice-domain decomposition: shard the time axis over the mesh.

The reference never shards the lattice — its only large-L accommodation is
disabling a TF graph rewrite (``gauge_model.py:915-919``, SURVEY §2.6).
For lattices too large for one card (or to trade cards for latency), the
move is domain decomposition (SURVEY §5.7): shard ``(Lt)`` over the mesh
'space' axis; the Wilson action's nearest-neighbor ``roll`` in time becomes
a one-row halo exchange between devices (``jax.lax.ppermute``) — the
structural cousin of ring attention's neighbor passing.

Implementation: ``shard_map`` over the mesh; inside each shard

    plaq rows [0..n-2] are local; the last row needs u1's first row from the
    *next* shard (roll(u1, -1, t) wraps across the boundary)

so the forward pass sends one ``(B, Lx)`` row per step around the ring, and
the analytic backward (``ops/wilson.py`` math) sends one ``sin P`` row the
other way.  Compute/communication overlap is XLA's job; the halo is O(Lx)
vs O(Lt Lx / n) local work.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from l2hmc.lattice import u1 as u1mod


def _neighbor_row_next(x_row: jax.Array, axis_name: str) -> jax.Array:
    """Fetch ``x_row`` from the next shard (wraps around the ring)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i - 1) % n) for i in range(n)]  # receive from right neighbor
    return jax.lax.ppermute(x_row, axis_name, perm)


def _neighbor_row_prev(x_row: jax.Array, axis_name: str) -> jax.Array:
    """Fetch ``x_row`` from the previous shard."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.lax.ppermute(x_row, axis_name, perm)


def _local_plaq_sums(links_blk: jax.Array, axis_name: str) -> jax.Array:
    """Plaquette sums for a time-shard ``(B, lt_blk, Lx, 2)``.

    P = u0 - u1 - roll(u0,-1,x) + u1(t+1,.) ; the t+1 of the last local row
    lives on the next shard.
    """
    u0 = links_blk[..., 0]
    u1_ = links_blk[..., 1]
    # local part of the t+1 shift: rows 1..n-1, then the halo row
    halo = _neighbor_row_next(u1_[:, :1], axis_name)  # first row of next shard
    u1_tp = jnp.concatenate([u1_[:, 1:], halo], axis=1)
    return u0 - u1_ - jnp.roll(u0, -1, axis=-1) + u1_tp


def make_domain_action(mesh: Mesh, shape: u1mod.LatticeShape, axis_name: str = "space"):
    """Build sharded action/observable functions over ``mesh``.

    Returns dict with ``action(links)``, ``observables(links)`` where
    ``links (B, Lt, Lx, 2)`` is sharded ``P(None, axis_name)`` on Lt.
    Both are custom-VJP'd with the analytic gradient (one reverse halo).
    """
    n_shards = mesh.shape[axis_name]
    assert shape.time_size % n_shards == 0, (
        f"Lt={shape.time_size} not divisible by mesh axis {axis_name}={n_shards}"
    )

    spec_links = P(None, axis_name, None, None)
    spec_batch = P(None)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec_links,), out_specs=spec_batch
    )
    def _action_fwd_shard(links_blk):
        p = _local_plaq_sums(links_blk, axis_name)
        local = jnp.sum(1.0 - jnp.cos(p), axis=(-2, -1))
        return jax.lax.psum(local, axis_name)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec_links,),
        out_specs=(spec_batch, spec_links),
    )
    def _action_res_shard(links_blk):
        p = _local_plaq_sums(links_blk, axis_name)
        local = jnp.sum(1.0 - jnp.cos(p), axis=(-2, -1))
        # keep sin P as the residual, stored in the links layout's first
        # direction slot shape (B, lt_blk, Lx) -> stack to match out spec
        sinp = jnp.sin(p)
        res = jnp.stack([sinp, jnp.zeros_like(sinp)], axis=-1)
        return jax.lax.psum(local, axis_name), res

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec_links, spec_batch),
        out_specs=spec_links,
    )
    def _action_bwd_shard(res_blk, g):
        sinp = res_blk[..., 0]
        # dS/du0(t,x) = sinP(t,x) - sinP(t,x-1)   (x local)
        g0 = sinp - jnp.roll(sinp, 1, axis=-1)
        # dS/du1(t,x) = -sinP(t,x) + sinP(t-1,x)  (t-1 crosses shards)
        halo = _neighbor_row_prev(sinp[:, -1:], axis_name)  # last row of prev
        sinp_tm = jnp.concatenate([halo, sinp[:, :-1]], axis=1)
        g1 = -sinp + sinp_tm
        return g[:, None, None, None] * jnp.stack([g0, g1], axis=-1)

    @jax.custom_vjp
    def action(links):
        return _action_fwd_shard(links)

    def fwd(links):
        a, res = _action_res_shard(links)
        return a, res

    def bwd(res, g):
        return (_action_bwd_shard(res, g),)

    action.defvjp(fwd, bwd)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec_links,),
        out_specs=(spec_batch, spec_batch, spec_batch),
    )
    def _observables_shard(links_blk):
        p = _local_plaq_sums(links_blk, axis_name)
        cosp = jnp.cos(p)
        actions = jax.lax.psum(jnp.sum(1.0 - cosp, axis=(-2, -1)), axis_name)
        plaqs = jax.lax.psum(jnp.sum(cosp, axis=(-2, -1)), axis_name) / (
            shape.num_plaquettes
        )
        q = jax.lax.psum(
            jnp.sum(u1mod.project_angle(p), axis=(-2, -1)), axis_name
        ) / (2 * jnp.pi)
        return actions, plaqs, q

    def observables(links):
        a, pl, q = _observables_shard(links)
        return {"actions": a, "plaqs": pl, "charges": jnp.round(q)}

    def sharding(batch: int) -> NamedSharding:
        return NamedSharding(mesh, spec_links)

    return {"action": action, "observables": observables,
            "links_spec": spec_links, "sharding": sharding}
