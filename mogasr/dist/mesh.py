"""Device mesh construction for data-parallel utterance sharding.

SURVEY.md §2 "Parallelism strategies": the one first-class strategy is DP over
a 1-D ``('data',)`` mesh with metrics/stats allreduced across devices
(BASELINE.json north_star: "data-parallel utterance sharding allreduced over
ICI"). The JAX-native equivalent of the reference's (nonexistent) comm
backend is XLA collectives: jit over NamedSharding inputs inserts the
all-reduces; no NCCL/MPI analogue is needed.

Multi-host extension: call ``jax.distributed.initialize()`` before
``make_mesh()`` and the same code runs over DCN.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mogasr.config import MeshConfig


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    cfg = cfg or MeshConfig()
    devs = list(devices) if devices is not None else jax.devices()
    if cfg.num_devices > 0:
        devs = devs[: cfg.num_devices]
    return Mesh(np.array(devs), (cfg.data_axis,))


def data_sharding(mesh: Mesh, axis: Optional[str] = None) -> NamedSharding:
    """Shard the leading (batch/frame) dimension across the data axis."""
    axis = axis or mesh.axis_names[0]
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Device-put a pytree of arrays with the leading dim sharded over data."""
    sh = data_sharding(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def replicate(tree, mesh: Mesh):
    sh = replicated(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0):
    """Pad leading dim to a multiple (shardability); returns (padded, orig_n)."""
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]), n
