"""Device mesh + sharding utilities.

The reference's entire distributed backend is Horovod ring-allreduce data
parallelism (SURVEY §2.6/§5.8: ``hvd.DistributedOptimizer``,
``BroadcastGlobalVariablesHook``, rank-0 IO).  The replacement here is
declarative: one global jitted program over a ``jax.sharding.Mesh`` whose
'data' axis shards the *chain batch*; XLA inserts the gradient all-reduce
(NCCL on GPUs) from the sharding annotations.  No optimizer wrapper, no explicit
broadcast — replicated params are a sharding, not a protocol.

Axes:
- ``data``  : independent Markov chains (embarrassingly parallel sampling;
              gradients mean-reduced across it during training).
- ``space`` : optional lattice-domain decomposition for large lattices
              (``l2hmc.parallel.domain``) — the SP analog (SURVEY §5.7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def get_mesh(
    num_data: Optional[int] = None,
    num_space: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, space)`` mesh over the available devices.

    Defaults to all devices on the data axis, in the order of
    ``jax.devices()``: the cards of one host are joined all to all, so no
    device ordering is needed, and on multi-host that order keeps each
    host's devices contiguous.
    """
    devices = list(devices if devices is not None else jax.devices())
    if num_data is None:
        num_data = len(devices) // num_space
    arr = np.asarray(devices[: num_data * num_space]).reshape(num_data, num_space)
    return Mesh(arr, axis_names=("data", "space"))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Chains sharded over 'data'; feature axis unsharded: ``(batch, d)``."""
    return NamedSharding(mesh, P("data", None))


def chain_time_sharding(mesh: Mesh) -> NamedSharding:
    """Stacked eval metrics ``(T, batch, ...)``: batch axis sharded."""
    return NamedSharding(mesh, P(None, "data"))


def lattice_sharding(mesh: Mesh) -> NamedSharding:
    """Chains over 'data' AND the flat lattice axis over 'space':
    ``(batch, x_dim)`` fully domain-decomposed.

    The FULL transition (periodic CNN, Wilson-action rolls, per-chain
    H/logdet reductions) runs under this sharding via GSPMD alone — XLA
    inserts the halo exchanges for the convs/rolls and psums for the
    per-chain reductions; validated exact vs replicated in
    ``tests/test_domain.py`` and executed by ``dryrun_multichip``.  This
    subsumes the action-only manual-halo path (``parallel/domain.py``,
    kept as the explicit-ppermute reference) and is the large-L recipe:
    lattices whose trunk/activations exceed one chip's HBM shard over
    'space' with no kernel changes (SURVEY §5.7).
    """
    return NamedSharding(mesh, P("data", "space"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_train_state(state, mesh: Mesh):
    """Place a :class:`~l2hmc.train.gauge.TrainState`: params/opt_state
    replicated, chain state sharded over 'data'."""
    rep = replicated(mesh)
    chains = chain_sharding(mesh)
    # NOTE: no outer device_put — re-placing an already-globally-sharded
    # pytree without a sharding is an error under multi-process jax
    # (non-addressable arrays).
    return state._replace(
        params=jax.device_put(state.params, rep),
        opt_state=jax.device_put(state.opt_state, rep),
        x=jax.device_put(state.x, chains),
        step=jax.device_put(state.step, rep),
        da=jax.device_put(state.da, rep),
    )


def train_state_shardings(state, mesh: Mesh):
    """Matching pytree of shardings for jit in_shardings/out_shardings."""
    rep = replicated(mesh)
    chains = chain_sharding(mesh)
    return state._replace(
        params=jax.tree.map(lambda _: rep, state.params),
        opt_state=jax.tree.map(lambda _: rep, state.opt_state),
        x=chains,
        step=rep,
        da=jax.tree.map(lambda _: rep, state.da),
    )


def initialize_distributed():
    """Multi-host bring-up: ``jax.distributed.initialize()`` per host
    (reference analog: ``hvd.init()``, ``gauge_model.py:2039-2041``).

    No-op when not running under a multi-process launcher.
    """
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    ):
        jax.distributed.initialize()


def is_primary() -> bool:
    """Host-0 gate for IO (reference rank-0 convention,
    ``utils/file_io.py:27-46``)."""
    return jax.process_index() == 0
