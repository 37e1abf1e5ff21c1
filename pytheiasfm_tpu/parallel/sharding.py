"""Device-mesh sharding for the SfM kernels.

The reference's only parallelism is a thread pool (`util/threadpool.h:85`,
SURVEY.md §2.16); the scaling axes are:

  - the OBSERVATION axis for bundle adjustment (residual/JTJ accumulation is
    a segment-sum: shard observations, `psum` the per-view/per-track blocks
    — the distributed Schur reduction of SURVEY.md §7 step 9);
  - the PAIR axis for two-view verification (embarrassingly parallel);
  - the TRACK axis for triangulation.

Everything rides `jax.sharding.NamedSharding` over a 1-D "data" mesh
(multi-host meshes extend the same axis over DCN). XLA inserts the
collectives; kernels stay unchanged.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "shard_observations",
    "replicated",
    "pad_to_multiple",
]


def make_mesh(num_devices: int | None = None, axis_name: str = "data") -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_observations(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0):
    """Pad an axis so it divides evenly across the mesh."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(np.asarray(arr), pad_width, constant_values=fill), n
