"""Multi-host (multi-process) execution entry points.

SURVEY.md section 2.4 plans splats sharded over HOSTS and image tiles over
devices, which presupposes a multi-process setup. This module provides the
process-level plumbing the single-process mesh layer (parallel/mesh.py)
does not:

  * initialize(): `jax.distributed.initialize` wrapper (the reference has
    no distributed runtime at all; JAX's coordination service sets up the
    processes and XLA's collectives — NCCL on GPUs — move the data).
  * host_mesh(): a ("data", "tile") mesh whose "data" axis spans PROCESSES
    (each host's local devices fill the "tile" axis), so splat shards live
    host-local and the all_to_all pair exchange rides NVLink within a host
    and the network across hosts.
  * shard_host_data(): build a global jax.Array from per-process local
    splat shards without ever materializing the global array on one host.

Launch recipe (N processes, e.g. one per GPU host — same binary everywhere):

    JAX_COORDINATOR=host0:8476 JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i \
        python train.py ...
    # in code:
    from fourdgs.parallel import multihost
    multihost.initialize()                  # reads the env, no-op if unset
    mesh = multihost.host_mesh()
    step = multihost.make_train_step(...)   # same step as single-process

The 2-process x 4-device CPU test (tests/test_multihost.py) runs exactly
this path with JAX_PLATFORMS=cpu and asserts the distributed loss equals
the single-process value.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fourdgs.parallel.mesh import DATA_AXIS, TILE_AXIS


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize the JAX distributed runtime from args or environment
    (JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns True if
    initialization happened, False when running single-process (env unset).

    Nothing detects a GPU cluster: pass the coordinator address
    (host:port), the process count and this process's id, or set the env
    variables, on every process."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if coordinator is None:
        return False
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def host_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """("data", "tile") mesh with the "data" axis spanning processes.

    Devices are ordered so each mesh row holds exactly one process's local
    devices: splat shards ("data") are host-resident, tile parallelism
    ("tile") stays within a host's chips. Single-process: (1, n_local)."""
    devices = list(devices if devices is not None else jax.devices())
    n_proc = jax.process_count()
    n = len(devices)
    assert n % n_proc == 0, (n, n_proc)
    per = n // n_proc
    rows = [[] for _ in range(n_proc)]
    for d in devices:
        rows[d.process_index].append(d)
    assert all(len(r) == per for r in rows), [len(r) for r in rows]
    return Mesh(np.array(rows), (DATA_AXIS, TILE_AXIS))


def shard_host_data(local: np.ndarray, mesh: Mesh) -> jax.Array:
    """Assemble a global splat array from this process's LOCAL shard
    (sharded along axis 0 over the flattened mesh, the all_to_all layout).
    local must be this host's slice, length = global_n / process_count."""
    sharding = NamedSharding(mesh, P((DATA_AXIS, TILE_AXIS)))
    return jax.make_array_from_process_local_data(sharding, local)


def process_local_slice(global_n: int) -> slice:
    """Axis-0 slice of the global splat array owned by this process."""
    per = global_n // jax.process_count()
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
