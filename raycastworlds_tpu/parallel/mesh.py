"""Device-mesh and sharding helpers.

The reference has no parallelism of any kind (single mutable struct stepped in
place; see SURVEY.md section 2 "Parallelism & distributed communication").
This module is the greenfield parallel layer: a named mesh over
(data, model) axes, envs sharded along ``dp``, learner tensors optionally
sharded along ``mp``; XLA inserts the collectives (psum for gradient
reduction, all-gathers at the tensor-parallel boundaries) from the sharding
annotations — the standard scaling-book recipe, no hand-written comms.

Multi-host: call :func:`initialize_distributed` first on each host, then
``make_mesh`` builds the mesh over the global device set, and the same jitted
program runs SPMD across hosts.  Every device of one host reaches every
other at the same rate (NVLink, all to all), so the mesh is a plain
(dp, mp) grid shaped by the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "dp"
MODEL_AXIS = "mp"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up (no-op single-host).  Thin wrapper over
    ``jax.distributed.initialize`` so drivers need no conditional imports."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    dp: Optional[int] = None,
    mp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh of shape (dp, mp).  ``dp=None`` uses all remaining devices."""
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if dp is None:
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp={dp*mp} != #devices={n}")
    arr = np.asarray(devs).reshape(dp, mp)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for env-state / obs / action leaves: batch axis over dp,
    everything else replicated."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_state(state, mesh: Mesh):
    """Place every leaf of a batched EnvState with its batch axis over dp."""
    s = env_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), state)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    dp = mesh.shape[DATA_AXIS]
    if global_batch % dp:
        raise ValueError(f"batch {global_batch} not divisible by dp={dp}")
    return global_batch // dp
