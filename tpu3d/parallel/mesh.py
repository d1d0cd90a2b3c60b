"""Device-mesh helpers for multi-chip sharding.

The reference is single-process/single-GPU (SURVEY.md §2.x: no NCCL/MPI);
scaling here is a ``jax.sharding.Mesh`` over the devices, with XLA
collectives (NCCL on GPUs) inserted by ``shard_map``/``jit``. The mesh
follows the algorithm: the cards of one host are joined all to all. These helpers centralize mesh
construction so tests can fake an 8-device topology with
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_names: Sequence[str] = ("shard",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Build a mesh over the given (default: all) devices.

    With one axis, all devices go to it. With two (e.g. ('inst', 'shard')),
    ``shape`` picks the split; default puts everything on the last axis.
    """
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "shard") -> NamedSharding:
    """Shard the leading (row) dimension of an array across ``axis``."""
    return NamedSharding(mesh, P(axis))
