"""Triplet baseline ratios from triangulated feature depths.

Batched re-design of `src/theia/sfm/global_pose_estimation/
compute_triplet_baseline_ratios.{h,cc}` (decl `:48`): each relative pose in a
view triplet (1-2, 1-3, 2-3) has unit-norm baseline; triangulating features
common to all three views recovers consistent relative scales as depth
ratios, with the median over features as the robust estimate. Used for
relative-scale recovery in hybrid/triplet position paths.

The reference loops features and `continue`s on degenerate ones; here all
features are processed as one masked batch and the median is a masked
median — one device program per triplet, vmappable across triplets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import rotation as rotops

__all__ = ["compute_triplet_baseline_ratios"]

_MIN_TRIANGULATION_ANGLE_DEG = 2.0  # kMinTriangulationAngle (.cc:61)


def _pair_depths(aa2, pos2, f1, f2):
    """Midpoint-triangulate one feature pair under a unit-baseline relative
    pose; return (depth1, depth2, valid). Mirrors GetTriangulatedPointDepths
    (.cc:55-87): origins {0, position_2}, directions {f1, R2^T f2},
    sufficient-angle gate, midpoint triangulation, depths to both origins."""
    d1 = f1 / jnp.linalg.norm(f1)
    d2 = rotops.angle_axis_rotate_point(-aa2, f2 / jnp.linalg.norm(f2))

    # Sufficient triangulation angle between the two rays.
    cos_ang = jnp.clip(jnp.dot(d1, d2), -1.0, 1.0)
    min_cos = jnp.cos(jnp.deg2rad(_MIN_TRIANGULATION_ANGLE_DEG))
    ok = cos_ang < min_cos

    # Midpoint of the closest points on the two rays:
    #   argmin_{t1,t2} |t1 d1 - (p2 + t2 d2)|^2.
    b = pos2
    d1d2 = jnp.dot(d1, d2)
    denom = 1.0 - d1d2 * d1d2
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t1 = (jnp.dot(b, d1) - jnp.dot(b, d2) * d1d2) / denom
    t2 = (jnp.dot(b, d1) * d1d2 - jnp.dot(b, d2)) / denom
    point = 0.5 * (t1 * d1 + (b + t2 * d2))

    depth1 = jnp.linalg.norm(point)
    depth2 = jnp.linalg.norm(point - pos2)
    # INTENTIONAL DEVIATION from GetTriangulatedPointDepths
    # (compute_triplet_baseline_ratios.cc): the reference accepts midpoint
    # solutions behind either camera (depths are norms regardless of sign);
    # the cheirality gate (t1 > 0, t2 > 0) drops those, which on noisy
    # borderline geometry keeps nonsense depths out of the baseline-ratio
    # medians. Feature counts can differ from the reference on such edges.
    ok = ok & (t1 > 0) & (t2 > 0) & jnp.isfinite(depth1) & jnp.isfinite(depth2)
    return depth1, depth2, ok


def _masked_median(values, mask):
    big = jnp.where(mask, values, jnp.inf)
    order = jnp.sort(big)
    n = jnp.sum(mask)
    mid = jnp.clip(n // 2, 0, values.shape[0] - 1)
    return order[mid]


@partial(jax.jit, static_argnames=())
def compute_triplet_baseline_ratios(
    aa12, pos12,  # relative pose 1->2 (angle-axis, unit-ish position)
    aa13, pos13,  # relative pose 1->3
    aa23, pos23,  # relative pose 2->3
    f1, f2, f3,   # [N, 2] NORMALIZED feature coordinates per view
    mask,         # [N] valid correspondences
):
    """Returns (baseline [3] = (1, b12_13, b12_23), num_valid).

    Parity: `theia::ComputeTripletBaselineRatios` (.cc:91-160) — ratios are
    medians of depth1_12/depth1_13 and depth2_12/depth2_23 over features
    that triangulate in all three pairs; num_valid==0 means failure (the
    reference returns false)."""
    h1 = jnp.concatenate([f1, jnp.ones((f1.shape[0], 1), f1.dtype)], axis=1)
    h2 = jnp.concatenate([f2, jnp.ones((f2.shape[0], 1), f2.dtype)], axis=1)
    h3 = jnp.concatenate([f3, jnp.ones((f3.shape[0], 1), f3.dtype)], axis=1)

    d1_12, d2_12, ok12 = jax.vmap(lambda a, b: _pair_depths(aa12, pos12, a, b))(
        h1, h2
    )
    d1_13, _d3_13, ok13 = jax.vmap(lambda a, b: _pair_depths(aa13, pos13, a, b))(
        h1, h3
    )
    d2_23, _d3_23, ok23 = jax.vmap(lambda a, b: _pair_depths(aa23, pos23, a, b))(
        h2, h3
    )
    valid = mask & ok12 & ok13 & ok23
    ratio2 = d1_12 / jnp.where(d1_13 == 0, 1e-12, d1_13)
    ratio3 = d2_12 / jnp.where(d2_23 == 0, 1e-12, d2_23)
    b2 = _masked_median(ratio2, valid)
    b3 = _masked_median(ratio3, valid)
    n = jnp.sum(valid)
    one = jnp.ones((), f1.dtype)
    baseline = jnp.stack([one, jnp.where(n > 0, b2, 0.0), jnp.where(n > 0, b3, 0.0)])
    return baseline, n
