"""Device mesh construction and multi-host initialization.

The reference's only parallelism is PyMC's chains-as-OS-processes with a
Manager-list for cross-process tree shipping (reference bart.py:130-132;
SURVEY 2.4).  The equivalents here:

* chains  — a vmapped leading axis sharded over the ``"chains"`` mesh
  axis (embarrassingly parallel; no collectives on the hot path).
* data    — optional sharding of the n-row axis for very large n; leaf
  sufficient statistics then reduce with ``psum`` over the mesh.
* hosts   — ``jax.distributed.initialize`` + a global mesh; chain draws
  gather to their owning host only at trace end (no pickling of trees).

TP/PP/SP/EP are N/A for BART by construction (no weight matrices, no
sequence axis; SURVEY 2.4, 5.7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op for a single process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_chain_shards: Optional[int] = None, n_data_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over (chains, data) axes.

    Defaults to all visible devices on the chains axis.  With
    ``n_data_shards > 1`` the device grid is (chains, data) and row-space
    reductions ride collectives within a data group: pass
    ``pgbart_step(..., data_axis="data")`` inside a shard_map whose row
    arrays (X, targets, tree_pred, sum_trees, Welford stats) carry
    PartitionSpec("data") — child sufficient statistics, likelihood
    sums and the split-value winner then psum/pmax over the axis (see
    tests/test_data_sharding.py for both the exactness proof and the
    end-to-end pattern).
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if n_chain_shards is None:
        n_chain_shards = devices.size // n_data_shards
    grid = devices[: n_chain_shards * n_data_shards].reshape(
        n_chain_shards, n_data_shards
    )
    return Mesh(grid, axis_names=("chains", "data"))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that lays a leading chain axis over the chains mesh axis."""
    return NamedSharding(mesh, PartitionSpec("chains"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
