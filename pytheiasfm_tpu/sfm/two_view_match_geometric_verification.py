"""Full two-view match geometric verification: RANSAC geometry -> guided
epipolar rematch -> triangulation gating -> two-view bundle adjustment.

Re-design of
`/root/reference/src/theia/sfm/two_view_match_geometric_verification.{h,cc}`
(options `two_view_match_geometric_verification.h:55-93`, flow
`VerifyMatches` at `two_view_match_geometric_verification.cc:114-183`):

  1. homography inlier count (plane fit diagnostic, `.cc:330`),
  2. RANSAC essential/fundamental estimation (`estimate_twoview_info`),
  3. optional guided matching along epipolar lines (`.cc:157-168`),
  4. triangulate matches, gate on reprojection error + triangulation angle,
  5. two-view bundle adjustment + final reprojection gate (`.cc:173-180`),
  6. refreshed `TwoViewInfo` from the optimized cameras.

Design: the reference verifies one pair per thread; every stage here is a
fixed-shape jittable kernel with leading batch axes so a whole block of pairs
runs as one device program (the matcher drives the batched path; the
`TwoViewMatchGeometricVerification` class is the single-pair parity API).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ba.two_view import bundle_adjust_two_views
from ..ops import triangulation as tri
from ..ops.rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
)
from ..ransac import engine, estimators
from .reconstruction import CameraIntrinsicsPrior
from .two_view import (
    EstimateTwoViewInfoOptions,
    compute_resolution_scaled_threshold,
    estimate_two_view_info,
)
from .view_graph import TwoViewInfo

__all__ = [
    "TwoViewMatchGeometricVerificationOptions",
    "TwoViewMatchGeometricVerification",
    "fundamental_from_two_view_info",
    "triangulation_gate",
    "refine_relative_pose_batch",
]


@dataclasses.dataclass
class TwoViewMatchGeometricVerificationOptions:
    """Parity: `TwoViewMatchGeometricVerification::Options`
    (`two_view_match_geometric_verification.h:55-93`)."""

    estimate_twoview_info_options: EstimateTwoViewInfoOptions = dataclasses.field(
        default_factory=EstimateTwoViewInfoOptions
    )
    min_num_inlier_matches: int = 30
    guided_matching: bool = False
    guided_matching_max_distance_pixels: float = 2.0
    guided_matching_lowes_ratio: float = 0.8
    bundle_adjustment: bool = True
    triangulation_max_reprojection_error: float = 15.0
    min_triangulation_angle_degrees: float = 4.0
    final_max_reprojection_error: float = 5.0


def _prior_K(prior: CameraIntrinsicsPrior) -> np.ndarray:
    f = prior.focal_length or 1.0
    pp = prior.principal_point or (
        prior.image_width / 2.0,
        prior.image_height / 2.0,
    )
    return np.array(
        [[f, 0.0, pp[0]], [0.0, f, pp[1]], [0.0, 0.0, 1.0]], np.float64
    )


def fundamental_from_two_view_info(
    rotation_aa, position, K1, K2
):
    """F mapping image-1 pixels to epipolar lines in image 2.

    With camera 1 = [I|0] and camera 2 = (R, c) (c = camera-2 position in the
    camera-1 frame), the essential matrix is E = R [c]_x (coplanarity of x1,
    c, R^T x2), and F = K2^{-T} E K1^{-1}. Parity with the reference's
    `FundamentalMatrixFromProjectionMatrices` usage in
    `guided_epipolar_matcher.cc`.
    """
    R = angle_axis_to_rotation_matrix(rotation_aa)
    c = position
    cx = jnp.zeros(R.shape[:-2] + (3, 3), R.dtype)
    cx = cx.at[..., 0, 1].set(-c[..., 2]).at[..., 0, 2].set(c[..., 1])
    cx = cx.at[..., 1, 0].set(c[..., 2]).at[..., 1, 2].set(-c[..., 0])
    cx = cx.at[..., 2, 0].set(-c[..., 1]).at[..., 2, 1].set(c[..., 0])
    E = R @ cx
    K1i = jnp.linalg.inv(K1)
    K2i = jnp.linalg.inv(K2)
    return jnp.swapaxes(K2i, -1, -2) @ E @ K1i


def triangulation_gate(
    rotation_aa,
    position,
    n1,
    n2,
    mask,
    max_reproj_norm,
    min_angle_degrees,
):
    """Triangulate normalized correspondences under ([I|0], (R, c)) and gate
    on reprojection error and triangulation angle.

    Parity: `TwoViewMatchGeometricVerification::TriangulatePoints`
    (`two_view_match_geometric_verification.cc:186-236`): points whose DLT
    triangulation reprojects worse than `triangulation_max_reprojection_error`
    or subtends less than `min_triangulation_angle_degrees` are dropped.

    All args support leading batch axes. n1/n2 [.., N, 2] normalized coords;
    max_reproj_norm is the pixel threshold already divided by focal length.
    Returns (points3d [.., N, 3], keep_mask [.., N]).
    """
    dtype = n1.dtype
    R = angle_axis_to_rotation_matrix(rotation_aa)
    t2 = -jnp.einsum("...ij,...j->...i", R, position)
    pose1 = (
        jnp.zeros(position.shape[:-1] + (3, 4), dtype)
        .at[..., :3, :3]
        .set(jnp.eye(3, dtype=dtype))
    )
    pose2 = jnp.concatenate([R, t2[..., None]], axis=-1)
    p1b = jnp.broadcast_to(pose1[..., None, :, :], n1.shape[:-1] + (3, 4))
    p2b = jnp.broadcast_to(pose2[..., None, :, :], n1.shape[:-1] + (3, 4))
    X4 = tri.triangulate(p1b, p2b, n1, n2)
    w = jnp.where(jnp.abs(X4[..., 3:4]) < 1e-12, 1e-12, X4[..., 3:4])
    X = X4[..., :3] / w

    # Reprojection in both views (normalized coordinates).
    z1 = X[..., 2]
    ok_depth1 = z1 > 1e-8
    r1 = X[..., :2] / jnp.where(ok_depth1, z1, 1.0)[..., None] - n1
    Xc = angle_axis_rotate_point(
        rotation_aa[..., None, :], X - position[..., None, :]
    )
    z2 = Xc[..., 2]
    ok_depth2 = z2 > 1e-8
    r2 = Xc[..., :2] / jnp.where(ok_depth2, z2, 1.0)[..., None] - n2

    max_r = jnp.asarray(max_reproj_norm, dtype)
    ok_reproj = (jnp.sum(r1 * r1, -1) <= max_r**2) & (
        jnp.sum(r2 * r2, -1) <= max_r**2
    )

    # Triangulation angle between the two observation rays.
    ray1 = X
    ray2 = X - position[..., None, :]
    cosang = jnp.sum(ray1 * ray2, -1) / jnp.maximum(
        jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(ray2, axis=-1), 1e-12
    )
    min_cos = jnp.cos(jnp.deg2rad(jnp.asarray(min_angle_degrees, dtype)))
    ok_angle = cosang <= min_cos

    keep = mask & ok_depth1 & ok_depth2 & ok_reproj & ok_angle
    return X, keep


def refine_relative_pose_batch(
    rotation_aa,
    position,
    n1,
    n2,
    mask,
    max_tri_reproj_norm,
    min_angle_degrees,
    final_reproj_norm,
    ba_iters: int = 15,
):
    """Batched stage 4+5: triangulation gate -> two-view BA -> final gate.

    All inputs carry a leading pair axis. Returns
    (rotation_aa, position, keep_mask) with `keep_mask` the final verified
    correspondence mask per pair. Jittable; the matcher shards the pair axis.
    """
    _, keep = triangulation_gate(
        rotation_aa, position, n1, n2, mask, max_tri_reproj_norm,
        min_angle_degrees,
    )
    aa, pos, X, _cost = bundle_adjust_two_views(
        rotation_aa, position, n1, n2, mask=keep, iters=ba_iters
    )
    # Final reprojection gate on the bundle-adjusted points
    # (two_view_match_geometric_verification.cc:298-312).
    dtype = n1.dtype
    z1 = X[..., 2]
    r1 = X[..., :2] / jnp.where(jnp.abs(z1) < 1e-12, 1e-12, z1)[..., None] - n1
    Xc = angle_axis_rotate_point(aa[..., None, :], X - pos[..., None, :])
    z2 = Xc[..., 2]
    r2 = Xc[..., :2] / jnp.where(jnp.abs(z2) < 1e-12, 1e-12, z2)[..., None] - n2
    fr = jnp.asarray(final_reproj_norm, dtype)
    ok = (
        (jnp.sum(r1 * r1, -1) <= fr**2)
        & (jnp.sum(r2 * r2, -1) <= fr**2)
        & (z1 > 1e-8)
        & (z2 > 1e-8)
    )
    return aa, pos, keep & ok


refine_relative_pose_batch_jit = jax.jit(
    refine_relative_pose_batch, static_argnames=("ba_iters",)
)


class TwoViewMatchGeometricVerification:
    """Single-pair parity API. Parity:
    `theia::TwoViewMatchGeometricVerification`
    (`two_view_match_geometric_verification.h:105-122`)."""

    def __init__(
        self,
        options: TwoViewMatchGeometricVerificationOptions,
        prior1: CameraIntrinsicsPrior,
        prior2: CameraIntrinsicsPrior,
        features1,  # KeypointsAndDescriptors
        features2,
        matches,  # list[(i, j)] indexed feature matches
    ):
        self.options = options
        self.prior1 = prior1
        self.prior2 = prior2
        self.features1 = features1
        self.features2 = features2
        self.matches = list(matches)

    def _correspondences(self, matches):
        i1 = np.array([m[0] for m in matches], np.int64)
        i2 = np.array([m[1] for m in matches], np.int64)
        return (
            np.asarray(self.features1.keypoints)[i1, :2],
            np.asarray(self.features2.keypoints)[i2, :2],
        )

    def count_homography_inliers(self, key, c1, c2) -> int:
        """Parity: `CountHomographyInliers`
        (`two_view_match_geometric_verification.cc:330-366`)."""
        o = self.options.estimate_twoview_info_options
        e1 = compute_resolution_scaled_threshold(
            o.max_sampson_error_pixels,
            self.prior1.image_width,
            self.prior1.image_height,
        )
        e2 = compute_resolution_scaled_threshold(
            o.max_sampson_error_pixels,
            self.prior2.image_width,
            self.prior2.image_height,
        )
        params = engine.RansacParameters(
            failure_probability=1.0 - o.expected_ransac_confidence,
            min_iterations=o.min_ransac_iterations,
            max_iterations=o.max_ransac_iterations,
        )
        _, summary = estimators.estimate_homography(
            key,
            jnp.asarray(c1, jnp.float32),
            jnp.asarray(c2, jnp.float32),
            params,
            quality="mle" if o.use_mle else "inlier",
            error_thresh=jnp.asarray(e1 * e2, jnp.float32),
        )
        return int(summary.num_inliers)

    def verify_matches(self, key=None):
        """Returns (verified_matches list[(i, j)], TwoViewInfo) or None.

        Flow parity: `VerifyMatches`
        (`two_view_match_geometric_verification.cc:114-183`)."""
        opt = self.options
        if len(self.matches) < opt.min_num_inlier_matches:
            return None
        if key is None:
            key = jax.random.PRNGKey(0)
        k_h, k_e = jax.random.split(key)

        c1, c2 = self._correspondences(self.matches)
        num_h_inliers = self.count_homography_inliers(k_h, c1, c2)

        info, inlier_idx = estimate_two_view_info(
            k_e,
            opt.estimate_twoview_info_options,
            self.prior1,
            self.prior2,
            c1,
            c2,
            min_num_inlier_matches=opt.min_num_inlier_matches,
        )
        if info is None:
            return None
        info.num_homography_inliers = num_h_inliers
        matches = [self.matches[i] for i in inlier_idx]

        K1 = _prior_K(self.prior1)
        K2 = _prior_K(self.prior2)
        f1 = info.focal_length_1 or 1.0
        f2 = info.focal_length_2 or 1.0

        if opt.guided_matching:
            from ..matching.guided_epipolar import GuidedEpipolarMatcher

            F = np.asarray(
                fundamental_from_two_view_info(
                    jnp.asarray(info.rotation_2),
                    jnp.asarray(info.position_2),
                    jnp.asarray(K1),
                    jnp.asarray(K2),
                )
            )
            matcher = GuidedEpipolarMatcher(
                max_epipolar_distance=opt.guided_matching_max_distance_pixels,
                lowes_ratio=opt.guided_matching_lowes_ratio,
            )
            matches = matcher.get_matches(
                F, self.features1, self.features2, matches
            )

        if opt.bundle_adjustment and len(matches) > opt.min_num_inlier_matches:
            c1, c2 = self._correspondences(matches)
            n1 = (c1 - K1[:2, 2]) / f1
            n2 = (c2 - K2[:2, 2]) / f2
            geo_mean_f = float(np.sqrt(f1 * f2))
            aa, pos, keep = refine_relative_pose_batch_jit(
                jnp.asarray(info.rotation_2, jnp.float32),
                jnp.asarray(info.position_2, jnp.float32),
                jnp.asarray(n1, jnp.float32),
                jnp.asarray(n2, jnp.float32),
                jnp.ones(len(matches), bool),
                opt.triangulation_max_reprojection_error / geo_mean_f,
                opt.min_triangulation_angle_degrees,
                opt.final_max_reprojection_error / geo_mean_f,
            )
            keep = np.asarray(keep)
            pos = np.asarray(pos, np.float64)
            nrm = np.linalg.norm(pos)
            info.rotation_2 = np.asarray(aa, np.float64)
            info.position_2 = pos / (nrm if nrm > 0 else 1.0)
            matches = [m for m, k in zip(matches, keep) if k]

        info.num_verified_matches = len(matches)
        if len(matches) <= opt.min_num_inlier_matches:
            return None
        return matches, info
