"""Two-view geometric verification — the matching hot path.

Re-design of `/root/reference/src/theia/sfm/estimate_twoview_info.{h,cc}`
(`estimate_twoview_info.cc:259`, call stack SURVEY.md §3.1). The reference
verifies one pair at a time inside a thread pool; here verification runs as a
batched program over a whole block of view pairs at once (`vmap` over pairs x
RANSAC hypotheses) — the premier accelerator target identified in the survey.

Paths (estimate_twoview_info.h:84-96):
  1) both views calibrated -> essential matrix (5-pt RANSAC) -> decompose;
  2) otherwise -> fundamental matrix (8-pt) + focal recovery.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ransac import engine, estimators
from .reconstruction import CameraIntrinsicsPrior
from .view_graph import TwoViewInfo
from .visibility_pyramid import visibility_score
from ..ops import rotation as rotops

__all__ = [
    "EstimateTwoViewInfoOptions",
    "estimate_two_view_info",
    "estimate_two_view_info_batch",
    "normalize_features_by_priors",
    "compute_resolution_scaled_threshold",
]


@dataclasses.dataclass(frozen=True)
class EstimateTwoViewInfoOptions:
    """Parity: `theia::EstimateTwoViewInfoOptions`
    (`estimate_twoview_info.h:51-81`)."""

    ransac_type: str = engine.RansacType.RANSAC
    max_sampson_error_pixels: float = 6.0
    expected_ransac_confidence: float = 0.9999
    min_ransac_iterations: int = 10
    max_ransac_iterations: int = 1000
    use_mle: bool = True
    use_lo: bool = False
    lo_start_iterations: int = 10
    min_focal_length: float = 1.0
    max_focal_length: float = 1e12


def compute_resolution_scaled_threshold(threshold, width, height):
    """Parity: `theia::ComputeResolutionScaledThreshold` (util): thresholds
    are specified w.r.t. a 1024px-wide image and scaled to the actual
    resolution."""
    max_dim = max(width, height)
    if max_dim <= 0:
        return threshold
    return threshold * max_dim / 1024.0


def normalize_features_by_priors(
    prior1: CameraIntrinsicsPrior, prior2: CameraIntrinsicsPrior, points1, points2
):
    """Parity: `NormalizeFeatures` (`estimate_twoview_info.cc:66-101`):
    remove principal point and divide by the prior focal length (focal 1.0
    when either prior lacks a focal length)."""
    both_calibrated = (
        prior1.focal_length is not None and prior2.focal_length is not None
    )
    f1 = prior1.focal_length if both_calibrated else 1.0
    f2 = prior2.focal_length if both_calibrated else 1.0
    pp1 = prior1.principal_point or (
        prior1.image_width / 2.0,
        prior1.image_height / 2.0,
    )
    pp2 = prior2.principal_point or (
        prior2.image_width / 2.0,
        prior2.image_height / 2.0,
    )
    n1 = (np.asarray(points1) - np.asarray(pp1)) / f1
    n2 = (np.asarray(points2) - np.asarray(pp2)) / f2
    return n1, n2, both_calibrated


def _calibrated_kernel(key, n1, n2, mask, thresh, params, quality):
    """Jittable core of the calibrated path: 5-pt RANSAC relative pose."""
    model, summary = estimators.estimate_relative_pose(
        key, n1, n2, params, mask=mask, quality=quality, error_thresh=thresh
    )
    aa = rotops.rotation_matrix_to_angle_axis(model.rotation)
    return aa, model.position, summary.inliers, summary.num_inliers


def estimate_two_view_info(
    key,
    options: EstimateTwoViewInfoOptions,
    prior1: CameraIntrinsicsPrior,
    prior2: CameraIntrinsicsPrior,
    points1,
    points2,
    min_num_inlier_matches: int = 5,
):
    """Single-pair host API. Parity: `theia::EstimateTwoViewInfo`
    (`estimate_twoview_info.cc:259`): returns (TwoViewInfo | None,
    inlier_indices)."""
    n1, n2, calibrated = normalize_features_by_priors(
        prior1, prior2, points1, points2
    )
    params = engine.RansacParameters(
        failure_probability=1.0 - options.expected_ransac_confidence,
        min_iterations=options.min_ransac_iterations,
        max_iterations=options.max_ransac_iterations,
        use_lo=options.use_lo,
        sampler=(
            "prosac" if options.ransac_type == engine.RansacType.PROSAC else "random"
        ),
    )
    quality = "mle" if options.use_mle else "inlier"

    err1 = compute_resolution_scaled_threshold(
        options.max_sampson_error_pixels, prior1.image_width, prior1.image_height
    )
    err2 = compute_resolution_scaled_threshold(
        options.max_sampson_error_pixels, prior2.image_width, prior2.image_height
    )

    if calibrated:
        thresh = err1 * err2 / (prior1.focal_length * prior2.focal_length)
        aa, position, inliers, num_inliers = _calibrated_kernel(
            key,
            jnp.asarray(n1),
            jnp.asarray(n2),
            None,
            jnp.asarray(thresh),
            params,
            quality,
        )
        if int(num_inliers) < min_num_inlier_matches:
            return None, np.zeros((0,), np.int64)
        info = TwoViewInfo(
            focal_length_1=float(prior1.focal_length),
            focal_length_2=float(prior2.focal_length),
            rotation_2=np.asarray(aa, np.float64),
            position_2=np.asarray(position, np.float64),
            num_verified_matches=int(num_inliers),
        )
    else:
        thresh = err1 * err2
        model, summary = estimators.estimate_uncalibrated_relative_pose(
            key,
            jnp.asarray(n1),
            jnp.asarray(n2),
            params,
            quality=quality,
            error_thresh=jnp.asarray(thresh),
        )
        if int(summary.num_inliers) < min_num_inlier_matches:
            return None, np.zeros((0,), np.int64)
        f1 = float(np.clip(model.focal_length1[0], options.min_focal_length,
                           options.max_focal_length))
        f2 = float(np.clip(model.focal_length2[0], options.min_focal_length,
                           options.max_focal_length))
        aa = rotops.rotation_matrix_to_angle_axis(jnp.asarray(model.rotation[0]))
        info = TwoViewInfo(
            focal_length_1=f1,
            focal_length_2=f2,
            rotation_2=np.asarray(aa, np.float64),
            position_2=np.asarray(model.position[0], np.float64),
            num_verified_matches=int(summary.num_inliers),
        )
        inliers = summary.inliers

    inlier_idx = np.flatnonzero(np.asarray(inliers))
    # Visibility score over inlier pixel locations (estimate_twoview_info.cc
    # ComputeVisibilityScoreOfInliers, 12 levels total across both images).
    info.visibility_score = visibility_score(
        np.asarray(points1)[inlier_idx], prior1.image_width or 1024,
        prior1.image_height or 1024,
    ) + visibility_score(
        np.asarray(points2)[inlier_idx], prior2.image_width or 1024,
        prior2.image_height or 1024,
    )
    return info, inlier_idx


@partial(jax.jit, static_argnames=("params", "quality"))
def _batched_verifier_run(keys, points1, points2, mask, thresh, params, quality):
    def one(key, p1, p2, m, th):
        return _calibrated_kernel(key, p1, p2, m, th, params, quality)

    return jax.vmap(one)(keys, points1, points2, mask, thresh)


def make_batched_verifier(params: engine.RansacParameters, quality: str = "mle"):
    """Build a batched verifier over P pairs.

    Inputs (padded): points1/points2 [P, N, 2] normalized coords,
    mask [P, N], thresh [P]. Returns per-pair (rotation angle-axis [P, 3],
    position [P, 3], inliers [P, N], num_inliers [P]).

    This is the sharding-friendly entry: shard the P axis across devices and
    every pair's full RANSAC runs on-chip. The underlying jit is a
    module-level function with (params, quality) static, so every caller at
    the same shapes shares ONE compilation — a fresh closure per call would
    recompile each time (the round-2 fountain run lost ~100 s/run to this).
    """

    def run(keys, points1, points2, mask, thresh):
        return _batched_verifier_run(
            keys, points1, points2, mask, thresh, params, quality
        )

    return run


def estimate_two_view_info_batch(
    key,
    options: EstimateTwoViewInfoOptions,
    priors1,
    priors2,
    points1,
    points2,
    masks,
    min_num_inlier_matches: int = 5,
):
    """Verify a block of calibrated pairs in one device program.

    priors1/priors2: lists of CameraIntrinsicsPrior (len P).
    points1/points2 [P, N, 2] PIXEL coordinates (padded), masks [P, N].
    Returns a list of (TwoViewInfo | None, inlier_indices) per pair.
    """
    P = len(priors1)
    n1 = np.zeros_like(np.asarray(points1, np.float64))
    n2 = np.zeros_like(np.asarray(points2, np.float64))
    thresh = np.zeros((P,), np.float64)
    for i in range(P):
        a, b, calibrated = normalize_features_by_priors(
            priors1[i], priors2[i], points1[i], points2[i]
        )
        if not calibrated:
            raise ValueError(
                "estimate_two_view_info_batch handles calibrated pairs; "
                "route uncalibrated pairs through estimate_two_view_info"
            )
        n1[i], n2[i] = a, b
        e1 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels,
            priors1[i].image_width,
            priors1[i].image_height,
        )
        e2 = compute_resolution_scaled_threshold(
            options.max_sampson_error_pixels,
            priors2[i].image_width,
            priors2[i].image_height,
        )
        thresh[i] = e1 * e2 / (priors1[i].focal_length * priors2[i].focal_length)

    params = engine.RansacParameters(
        failure_probability=1.0 - options.expected_ransac_confidence,
        min_iterations=options.min_ransac_iterations,
        max_iterations=options.max_ransac_iterations,
        use_lo=options.use_lo,
    )
    quality = "mle" if options.use_mle else "inlier"
    verifier = make_batched_verifier(params, quality)
    keys = jax.random.split(key, P)
    dtype = jnp.float32
    aa, position, inliers, num_inliers = verifier(
        keys,
        jnp.asarray(n1, dtype),
        jnp.asarray(n2, dtype),
        jnp.asarray(masks),
        jnp.asarray(thresh, dtype),
    )
    # One batched pull for all four outputs (utils/fetch.py): four
    # sequential np.asarray calls each pay a full device->host round
    # trip, which dominates at fountain-size problems.
    from ..utils.fetch import fetch

    aa, position, inliers, num_inliers = fetch(
        (aa, position, inliers, num_inliers)
    )
    aa = np.asarray(aa, np.float64)
    position = np.asarray(position, np.float64)

    results = []
    for i in range(P):
        if num_inliers[i] < min_num_inlier_matches:
            results.append((None, np.zeros((0,), np.int64)))
            continue
        idx = np.flatnonzero(inliers[i])
        info = TwoViewInfo(
            focal_length_1=float(priors1[i].focal_length),
            focal_length_2=float(priors2[i].focal_length),
            rotation_2=aa[i],
            position_2=position[i],
            num_verified_matches=int(num_inliers[i]),
            visibility_score=visibility_score(
                np.asarray(points1[i])[idx],
                priors1[i].image_width or 1024,
                priors1[i].image_height or 1024,
            )
            + visibility_score(
                np.asarray(points2[i])[idx],
                priors2[i].image_width or 1024,
                priors2[i].image_height or 1024,
            ),
        )
        results.append((info, idx))
    return results
