"""Explicit shard_map collectives for the distributed Schur reduction.

The BA kernel (`ba/lm.py`) is written in global terms; under a sharded-
observation layout GSPMD already lowers its segment-sums to per-device
partials + `psum`. This module is the same reduction written EXPLICITLY with
`shard_map` (SURVEY.md §7.9) — the building block for multi-host layouts
where the collective placement must be pinned rather than inferred, and the
in-suite proof that the sharded reduction matches the single-device math.

The reference has no distributed backend at all (SURVEY.md §2.16: thread
pool only); this layer is device-mesh scale-out over the interconnect.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

__all__ = [
    "sharded_segment_sum",
    "distributed_normal_equation_blocks",
]


def sharded_segment_sum(values, segment_ids, num_segments: int, mesh: Mesh,
                        axis_name: str = "data"):
    """segment_sum with the data axis sharded across the mesh: each device
    reduces its local shard into the full [num_segments, ...] accumulator,
    then one `psum` over ICI combines them. Equivalent to
    `jax.ops.segment_sum` on the gathered data."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(),
    )
    def f(v, ids):
        local = jax.ops.segment_sum(v, ids, num_segments=num_segments)
        return jax.lax.psum(local, axis_name)

    return f(values, segment_ids)


def distributed_normal_equation_blocks(
    Jc,  # [O, 2, 6] camera Jacobian blocks
    Jp,  # [O, 2, K] point Jacobian blocks
    r,  # [O, 2] residuals
    obs_view,  # [O]
    obs_track,  # [O]
    num_views: int,
    num_tracks: int,
    mesh: Mesh,
    axis_name: str = "data",
):
    """The Gauss-Newton block assembly of the Schur system, observation-
    sharded with explicit collectives:

      U   [V,6,6] = psum over devices of local sum_o Jc^T Jc
      Vt  [T,K,K] = psum of local sum_o Jp^T Jp
      bc  [V,6]   = -psum of local sum_o Jc^T r
      bp  [T,K]   = -psum of local sum_o Jp^T r

    One shard_map, one fused set of psums — the distributed form of the
    reduction `ba/lm.py` expresses globally.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P(), P()),
    )
    def f(jc, jp, res, ov, ot):
        U = jax.ops.segment_sum(
            jnp.einsum("ori,orj->oij", jc, jc), ov, num_segments=num_views
        )
        Vt = jax.ops.segment_sum(
            jnp.einsum("ori,orj->oij", jp, jp), ot, num_segments=num_tracks
        )
        bc = -jax.ops.segment_sum(
            jnp.einsum("ori,or->oi", jc, res), ov, num_segments=num_views
        )
        bp = -jax.ops.segment_sum(
            jnp.einsum("ori,or->oi", jp, res), ot, num_segments=num_tracks
        )
        out = (U, Vt, bc, bp)
        return tuple(jax.lax.psum(x, axis_name) for x in out)

    return f(Jc, Jp, r, obs_view, obs_track)
