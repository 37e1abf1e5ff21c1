"""Multi-host (multi-controller) initialization and global meshes.

SURVEY §7.9 / §5: the scale-out story is a mesh over (hosts x chips) with
collectives riding ICI within a slice and DCN across hosts. JAX's
multi-controller runtime gives every host process the SAME program over
the GLOBAL device set; this module wraps the initialization handshake and
global-mesh construction the pipelines use.

Typical launch (one process per host):

    from pytheiasfm_tpu.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476",
                         num_processes=4, process_id=HOST_ID)
    mesh = multihost.global_mesh()          # all devices, all hosts
    # shard observation/pair/track axes over mesh as usual; XLA routes
    # intra-slice collectives over ICI and cross-host ones over DCN.

The 2-process CPU test (`tests/test_multihost.py`) exercises exactly this
path with `xla_force_host_platform_device_count` per process — the
documented simulation of a multi-host mesh without a multi-host cluster.
"""

from __future__ import annotations

import numpy as np

__all__ = ["initialize", "global_mesh", "process_info", "is_initialized"]

_initialized = False


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_ids=None,
) -> None:
    """`jax.distributed.initialize` with the arguments every host must
    agree on. Must run before the first jax device query in the process."""
    global _initialized
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def process_info():
    """(process_index, process_count, local_device_count, global_device_count)."""
    import jax

    return (
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(axis_name: str = "data"):
    """1-D mesh over the GLOBAL device set (all hosts). Device order is
    jax.devices() order, which groups by process — contiguous shards land
    on one host, so the data axis crosses DCN only at host boundaries."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


def global_mesh_2d(axis_names=("host", "chip")):
    """2-D (hosts x chips-per-host) mesh over the global device set: the
    `host` axis crosses DCN, the `chip` axis stays on ICI. Shard
    bandwidth-hungry axes over `chip` and latency-tolerant ones over
    `host` (the scaling-book recipe: collectives ride ICI, not DCN).
    Requires every process to contribute the same local device count."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    nproc = jax.process_count()
    per_host = len(devs) // nproc
    if per_host * nproc != len(devs):
        raise ValueError(
            f"uneven device distribution: {len(devs)} devices over "
            f"{nproc} processes"
        )
    grid = np.asarray(devs).reshape(nproc, per_host)
    return Mesh(grid, tuple(axis_names))
