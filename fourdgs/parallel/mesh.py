"""Device mesh construction for multi-chip rendering/training.

The reference is single-process/single-GPU (SURVEY.md section 2.4); this
module is the new first-class parallelism layer. Axes:

  * "data" — splats are sharded along this axis (the SSBO analog, split)
  * "tile" — image tiles are partitioned across this axis

For rendering, tiles are actually partitioned across the *flattened* mesh
(every device owns a disjoint slice of tiles) while projection is
data-parallel over splat shards; the projected compact records are
all-gathered over "data" (interconnect-friendly: records are ~44 bytes/splat vs the
full 4D parameter's ~100). Gradients flow back through the gather as a
reduce-scatter inserted by AD — no hand-written collectives needed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TILE_AXIS = "tile"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              data_parallel: Optional[int] = None) -> Mesh:
    """Build a ("data", "tile") mesh over `devices` (default: all).

    data_parallel picks the "data" axis length (must divide the device
    count); default: the largest power-of-two <= sqrt(n) for a balanced mesh,
    so 8 devices -> (2, 4), 4 -> (2, 2), 1 -> (1, 1).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data_parallel is None:
        data_parallel = 1
        while (data_parallel * 2) ** 2 <= n and n % (data_parallel * 2) == 0:
            data_parallel *= 2
        if n % data_parallel != 0:
            data_parallel = 1
    assert n % data_parallel == 0, (n, data_parallel)
    arr = np.array(devices).reshape(data_parallel, n // data_parallel)
    return Mesh(arr, (DATA_AXIS, TILE_AXIS))


def splat_sharding(mesh: Mesh) -> NamedSharding:
    """Splats sharded along axis 0 over "data", replicated over "tile"."""
    return NamedSharding(mesh, P(DATA_AXIS))


def splat_sharding_flat(mesh: Mesh) -> NamedSharding:
    """Splats sharded along axis 0 over the FLATTENED mesh (every device a
    distinct shard) — the layout of the all_to_all exchange path."""
    return NamedSharding(mesh, P((DATA_AXIS, TILE_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad axis 0 so it divides evenly across shards (splat counts are
    arbitrary; shard sizes must be equal)."""
    import jax.numpy as jnp
    n = x.shape[axis]
    pad = -n % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)
