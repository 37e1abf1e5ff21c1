"""RANSAC-wrapped robust estimators — layer 7 of the reference
(`/root/reference/src/theia/sfm/estimators/`).

Each `Estimate*` function mirrors its reference namesake's model type,
minimal solver, and error function exactly (file:line cited per function),
but runs the whole hypothesis budget as one batched device program through
:mod:`pytheiasfm_tpu.ransac.engine`.

Conventions:
  - "normalized correspondences": calibrated image points (intrinsics
    removed), as produced by `pixel_to_camera`.
  - Relative pose models carry `position` = camera-2 center expressed in
    camera-1 coordinates (reference `RelativePose`, estimate_relative_pose.h).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import epipolar, five_point, p3p, triangulation as tri
from ..ops import rotation as rotops
from . import engine

__all__ = [
    "RelativePose",
    "CalibratedAbsolutePose",
    "estimate_relative_pose",
    "estimate_essential_matrix",
    "estimate_fundamental_matrix",
    "estimate_homography",
    "estimate_calibrated_absolute_pose",
    "estimate_uncalibrated_relative_pose",
    "estimate_triangulation",
    "estimate_absolute_pose_with_known_orientation",
    "estimate_relative_pose_with_known_orientation",
    "estimate_calibrated_absolute_pose_typed",
    "estimate_uncalibrated_absolute_pose",
    "estimate_radial_dist_uncalibrated_absolute_pose",
    "estimate_similarity_transformation_2d_3d",
    "estimate_rigid_transformation_2d_3d",
    "estimate_dominant_plane_from_points",
    "estimate_radial_distortion_homography",
    "UncalibratedAbsolutePose",
    "RadialDistUncalibratedAbsolutePose",
    "SimilarityTransformation",
    "RigidTransformation",
    "Plane",
    "RadialHomographyResult",
]


class RelativePose(NamedTuple):
    """Parity: `theia::RelativePose` (estimate_relative_pose.h)."""

    rotation: jax.Array  # [3, 3]
    position: jax.Array  # [3] camera-2 center in camera-1 frame
    essential_matrix: jax.Array  # [3, 3]


class CalibratedAbsolutePose(NamedTuple):
    """Parity: `theia::CalibratedAbsolutePose`
    (estimate_calibrated_absolute_pose.h)."""

    rotation: jax.Array  # [3, 3] world->camera
    position: jax.Array  # [3] camera center in world


class TwoViewData(NamedTuple):
    points1: jax.Array  # [N, 2]
    points2: jax.Array  # [N, 2]


class Corr2D3D(NamedTuple):
    """Parity: `theia::FeatureCorrespondence2D3D`."""

    feature: jax.Array  # [N, 2] normalized image point
    world_point: jax.Array  # [N, 3]


_BIG = 1e12


def _relative_pose_solver(subset: TwoViewData):
    """5-pt -> up to 10 E -> best cheirality pose each.

    Parity: `RelativePoseEstimator::EstimateModel`
    (estimate_relative_pose.cc:75).
    """
    E, valid = five_point.five_point_relative_pose(subset.points1, subset.points2)
    R, pos, _count = epipolar.get_best_pose_from_essential_matrix(
        E, subset.points1[None], subset.points2[None]
    )
    return RelativePose(rotation=R, position=pos, essential_matrix=E), valid


def _relative_pose_residuals(model: RelativePose, data: TwoViewData):
    """Sampson gated by cheirality (estimate_relative_pose.cc:142-152)."""
    sampson = epipolar.squared_sampson_distance(
        model.essential_matrix, data.points1, data.points2
    )
    in_front = tri.is_triangulated_point_in_front_of_cameras(
        data.points1, data.points2, model.rotation, model.position
    )
    return jnp.where(in_front, sampson, _BIG)


def _relative_pose_refine(model: RelativePose, data: TwoViewData, inliers):
    """Non-minimal LO step: 8-point on inliers projected to the essential
    manifold, then best-pose selection (stands in for the reference's
    two-view BA refine, estimate_relative_pose.cc:~100)."""
    F, ok = epipolar.eight_point_fundamental_matrix(
        data.points1, data.points2, mask=inliers
    )
    E = epipolar.project_to_essential(F)
    R, pos, _ = epipolar.get_best_pose_from_essential_matrix(
        E, data.points1, data.points2, mask=inliers
    )
    ok = ok & (jnp.sum(inliers) >= 8)
    return RelativePose(rotation=R, position=pos, essential_matrix=E), ok


def estimate_relative_pose(
    key, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateRelativePose` (estimate_relative_pose.cc:160).

    points1/points2: normalized (calibrated) correspondences [N, 2].
    """
    est = engine.Estimator(
        sample_size=5,
        solve=_relative_pose_solver,
        residuals=_relative_pose_residuals,
        refine=_relative_pose_refine,
    )
    return engine.ransac(
        key, TwoViewData(points1, points2), est, params, mask=mask, **kw
    )


def _essential_solver(subset: TwoViewData):
    E, valid = five_point.five_point_relative_pose(subset.points1, subset.points2)
    return E, valid


def _essential_residuals(E, data: TwoViewData):
    return epipolar.squared_sampson_distance(E, data.points1, data.points2)


def estimate_essential_matrix(
    key, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateEssentialMatrix` (estimate_essential_matrix.cc)."""

    def refine(E, data, inliers):
        F, ok = epipolar.eight_point_fundamental_matrix(
            data.points1, data.points2, mask=inliers
        )
        return epipolar.project_to_essential(F), ok & (jnp.sum(inliers) >= 8)

    est = engine.Estimator(
        sample_size=5,
        solve=_essential_solver,
        residuals=_essential_residuals,
        refine=refine,
    )
    return engine.ransac(
        key, TwoViewData(points1, points2), est, params, mask=mask, **kw
    )


def _fundamental_solver(subset: TwoViewData):
    F, valid = epipolar.seven_point_fundamental_matrix(subset.points1, subset.points2)
    return F, valid


def estimate_fundamental_matrix(
    key, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateFundamentalMatrix`
    (estimate_fundamental_matrix.cc): 7-point minimal solver, Sampson error,
    8-point refit for local optimization."""

    def refine(F, data, inliers):
        F8, ok = epipolar.eight_point_fundamental_matrix(
            data.points1, data.points2, mask=inliers
        )
        return F8, ok & (jnp.sum(inliers) >= 8)

    est = engine.Estimator(
        sample_size=7,
        solve=_fundamental_solver,
        residuals=lambda F, d: epipolar.squared_sampson_distance(
            F, d.points1, d.points2
        ),
        refine=refine,
    )
    return engine.ransac(
        key, TwoViewData(points1, points2), est, params, mask=mask, **kw
    )


def _homography_solver(subset: TwoViewData):
    H, ok = epipolar.four_point_homography(subset.points1, subset.points2)
    return H[None], ok[None]


def _homography_residuals(H, data: TwoViewData):
    """Asymmetric transfer error in image 2 (estimate_homography.cc:108-114)."""
    p1 = jnp.concatenate(
        [data.points1, jnp.ones_like(data.points1[..., :1])], axis=-1
    )
    proj = jnp.einsum("ij,nj->ni", H, p1)
    w = proj[..., 2]
    reproj = proj[..., :2] / jnp.where(jnp.abs(w) < 1e-12, 1.0, w)[..., None]
    err = jnp.sum((data.points2 - reproj) ** 2, axis=-1)
    return jnp.where(jnp.abs(w) < 1e-12, _BIG, err)


def estimate_homography(
    key, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateHomography` (estimate_homography.cc:122)."""

    def refine(H, data, inliers):
        H4, ok = epipolar.four_point_homography(
            data.points1, data.points2, mask=inliers
        )
        return H4, ok & (jnp.sum(inliers) >= 4)

    est = engine.Estimator(
        sample_size=4,
        solve=_homography_solver,
        residuals=_homography_residuals,
        refine=refine,
    )
    return engine.ransac(
        key, TwoViewData(points1, points2), est, params, mask=mask, **kw
    )


def _p3p_solver(subset: Corr2D3D):
    R, t, valid = p3p.pose_from_three_points(subset.feature, subset.world_point)
    # Convert t (p_cam = R p + t) to camera position c = -R^T t.
    pos = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    return CalibratedAbsolutePose(rotation=R, position=pos), valid


def _abs_pose_residuals(model: CalibratedAbsolutePose, data: Corr2D3D):
    """Squared reprojection of normalized features
    (estimate_calibrated_absolute_pose.cc:158-168)."""
    p_cam = jnp.einsum("ij,nj->ni", model.rotation, data.world_point - model.position)
    z = p_cam[..., 2]
    behind = z < 1e-8
    reproj = p_cam[..., :2] / jnp.where(behind, 1.0, z)[..., None]
    err = jnp.sum((reproj - data.feature) ** 2, axis=-1)
    return jnp.where(behind, _BIG, err)


def _abs_pose_refine(model, data: Corr2D3D, inliers):
    """Non-minimal DLT refit on inliers (stands in for the reference's
    single-view BA refine step)."""
    from ..ops import pnp

    R, pos, ok = pnp.dlt_pnp(data.feature, data.world_point, mask=inliers)
    ok = ok & (jnp.sum(inliers) >= 6)
    return CalibratedAbsolutePose(rotation=R, position=pos), ok


def estimate_calibrated_absolute_pose(
    key, feature, world_point, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateCalibratedAbsolutePose`
    (estimate_calibrated_absolute_pose.cc:176; PnPType KNEIP path -> P3P)."""
    est = engine.Estimator(
        sample_size=3,
        solve=_p3p_solver,
        residuals=_abs_pose_residuals,
        refine=_abs_pose_refine,
    )
    return engine.ransac(
        key, Corr2D3D(feature, world_point), est, params, mask=mask, **kw
    )


class UncalibratedRelativePose(NamedTuple):
    """Parity: `theia::UncalibratedRelativePose`
    (estimate_uncalibrated_relative_pose.h)."""

    fundamental_matrix: jax.Array
    focal_length1: jax.Array
    focal_length2: jax.Array
    rotation: jax.Array
    position: jax.Array


def estimate_uncalibrated_relative_pose(
    key, points1, points2, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateUncalibratedRelativePose`
    (estimate_uncalibrated_relative_pose.cc): 8-point F + focal recovery +
    pose from the implied E; Sampson residual on F (pixel units)."""

    def solve(subset: TwoViewData):
        F, ok = epipolar.eight_point_fundamental_matrix(
            subset.points1, subset.points2
        )
        f1, f2, fvalid = epipolar.focal_lengths_from_fundamental_matrix(F)
        E = epipolar.essential_matrix_from_fundamental_matrix(F, f1, f2)
        n1 = subset.points1 / f1[..., None, None]
        n2 = subset.points2 / f2[..., None, None]
        R, pos, _ = epipolar.get_best_pose_from_essential_matrix(E, n1, n2)
        model = UncalibratedRelativePose(
            fundamental_matrix=F[None],
            focal_length1=f1[None],
            focal_length2=f2[None],
            rotation=R[None],
            position=pos[None],
        )
        return model, (ok & fvalid)[None]

    def residuals(model: UncalibratedRelativePose, data: TwoViewData):
        return epipolar.squared_sampson_distance(
            model.fundamental_matrix, data.points1, data.points2
        )

    est = engine.Estimator(sample_size=8, solve=solve, residuals=residuals)
    return engine.ransac(
        key, TwoViewData(points1, points2), est, params, mask=mask, **kw
    )


def estimate_triangulation(
    key, poses, points, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateTriangulation` (estimate_triangulation.cc):
    RANSAC over view pairs, DLT triangulation, squared reprojection residual
    against every observation.

    poses [N, 3, 4] calibrated projection matrices; points [N, 2] normalized
    observations of one track.
    """

    class TriData(NamedTuple):
        poses: jax.Array
        points: jax.Array

    def solve(subset: TriData):
        pt = tri.triangulate_dlt(
            subset.poses[0], subset.poses[1], subset.points[0], subset.points[1]
        )
        return pt[None], jnp.ones((1,), bool)

    def residuals(point4, data: TriData):
        proj = jnp.einsum("nij,j->ni", data.poses, point4)
        z = proj[..., 2]
        bad = jnp.abs(z) < 1e-12
        reproj = proj[..., :2] / jnp.where(bad, 1.0, z)[..., None]
        err = jnp.sum((reproj - data.points) ** 2, axis=-1)
        # Negative depth (w.r.t. homogeneous sign) -> reject.
        w_sign = jnp.sign(point4[3])
        behind = z * w_sign <= 0
        return jnp.where(bad | behind, _BIG, err)

    def refine(point4, data: TriData, inliers):
        pt = tri.triangulate_nview(data.poses, data.points, mask=inliers)
        return pt, jnp.sum(inliers) >= 2

    est = engine.Estimator(
        sample_size=2, solve=solve, residuals=residuals, refine=refine
    )
    return engine.ransac(
        key, TriData(poses, points), est, params, mask=mask, **kw
    )


# ---------------------------------------------------------------------------
# Known-orientation estimators (used by the hybrid pipeline, SURVEY §2.10).


def estimate_absolute_pose_with_known_orientation(
    key, rotated_feature, world_point, params: engine.RansacParameters,
    mask=None, **kw,
):
    """Parity: `theia::EstimateAbsolutePoseWithKnownOrientation`
    (estimators/estimate_absolute_pose_with_known_orientation.cc): 2-point
    position solver on world-aligned (pre-rotated, dehomogenized) features;
    squared reprojection residual in the rotated frame. Returns the camera
    position model."""
    from ..ops import known_rotation as kr

    def solve(subset: Corr2D3D):
        pos, ok = kr.position_from_two_rays(
            subset.feature[0], subset.world_point[0],
            subset.feature[1], subset.world_point[1],
        )
        return pos[None], ok[None]

    def residuals(position, data: Corr2D3D):
        adj = data.world_point - position
        z = adj[..., 2]
        behind = z < 1e-8
        reproj = adj[..., :2] / jnp.where(behind, 1.0, z)[..., None]
        err = jnp.sum((reproj - data.feature) ** 2, axis=-1)
        return jnp.where(behind, _BIG, err)

    est = engine.Estimator(sample_size=2, solve=solve, residuals=residuals)
    return engine.ransac(
        key, Corr2D3D(rotated_feature, world_point), est, params, mask=mask, **kw
    )


def estimate_relative_pose_with_known_orientation(
    key, rotated_points1, rotated_points2, params: engine.RansacParameters,
    mask=None, **kw,
):
    """Parity: `theia::EstimateRelativePoseWithKnownOrientation`
    (estimators/estimate_relative_pose_with_known_orientation.cc): 2-point
    relative-position nullspace solver on world-aligned features; Sampson
    residual on E = [t]_x. Returns the unit relative position."""
    from ..ops import known_rotation as kr

    def solve(subset: TwoViewData):
        pos, ok = kr.relative_pose_from_two_points_with_known_rotation(
            subset.points1, subset.points2
        )
        return pos[None], ok[None]

    def residuals(position, data: TwoViewData):
        t = position
        E = jnp.asarray(
            [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]],
        ).astype(t.dtype)
        return epipolar.squared_sampson_distance(E, data.points1, data.points2)

    est = engine.Estimator(sample_size=2, solve=solve, residuals=residuals)
    return engine.ransac(
        key, TwoViewData(rotated_points1, rotated_points2), est, params,
        mask=mask, **kw,
    )


# ---------------------------------------------------------------------------
# PnPType-dispatched calibrated absolute pose.
# ---------------------------------------------------------------------------


def estimate_calibrated_absolute_pose_typed(
    key, feature, world_point, params: engine.RansacParameters,
    pnp_type: int = 0, mask=None, **kw,
):
    """`EstimateCalibratedAbsolutePose` honoring `PnPType {KNEIP, SQPNP, DLS}`
    (`estimate_calibrated_absolute_pose.cc:66-110`, SampleSize 3 for all).
    pnp_type follows `sfm.estimator_options.PnPType` values."""
    from ..ops import pnp

    if pnp_type == 0:  # KNEIP
        return estimate_calibrated_absolute_pose(
            key, feature, world_point, params, mask=mask, **kw
        )

    def solve(subset: Corr2D3D):
        if pnp_type == 1:  # SQPNP
            R, pos, ok = pnp.sqpnp(subset.feature, subset.world_point)
            return CalibratedAbsolutePose(R[None], pos[None]), ok[None]
        R, pos, ok = pnp.dls_pnp(subset.feature, subset.world_point)  # DLS
        return CalibratedAbsolutePose(R, pos), ok

    est = engine.Estimator(
        sample_size=3,
        solve=solve,
        residuals=_abs_pose_residuals,
        refine=_abs_pose_refine,
    )
    return engine.ransac(
        key, Corr2D3D(feature, world_point), est, params, mask=mask, **kw
    )


# ---------------------------------------------------------------------------
# Uncalibrated absolute pose (P4Pf) and radial-distortion variants.
# ---------------------------------------------------------------------------


class UncalibratedAbsolutePose(NamedTuple):
    """Parity: `theia::UncalibratedAbsolutePose`
    (estimate_uncalibrated_absolute_pose.h:48-52)."""

    rotation: jax.Array  # [3, 3]
    position: jax.Array  # [3]
    focal_length: jax.Array  # scalar


def estimate_uncalibrated_absolute_pose(
    key, feature, world_point, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateUncalibratedAbsolutePose`
    (estimate_uncalibrated_absolute_pose.cc:107): P4Pf minimal solver on
    principal-point-centred PIXEL features, squared pixel reprojection error
    through the candidate P = diag(f,f,1)[R|t]."""
    from ..ops import focal_radial

    def solve(subset: Corr2D3D):
        P, f, valid = focal_radial.four_point_pose_and_focal_length(
            subset.feature, subset.world_point
        )
        return (P, f), valid

    def residuals(model, data: Corr2D3D):
        P, _ = model
        Xh = jnp.concatenate(
            [data.world_point, jnp.ones_like(data.world_point[..., :1])], -1
        )
        proj = jnp.einsum("ij,nj->ni", P, Xh)
        z = proj[..., 2]
        behind = z < 1e-12
        uv = proj[..., :2] / jnp.where(behind, 1.0, z)[..., None]
        err = jnp.sum((uv - data.feature) ** 2, axis=-1)
        return jnp.where(behind, _BIG, err)

    est = engine.Estimator(sample_size=4, solve=solve, residuals=residuals)
    (P, f), summary = engine.ransac(
        key, Corr2D3D(feature, world_point), est, params, mask=mask, **kw
    )
    # Unpack P = diag(f,f,1)[R|t] into the reference's model struct.
    scale = jnp.stack([1.0 / f, 1.0 / f, jnp.ones_like(f)])
    Rt = scale[:, None] * P
    R, t = Rt[:, :3], Rt[:, 3]
    pos = -R.T @ t
    return UncalibratedAbsolutePose(R, pos, f), summary


class RadialDistUncalibratedAbsolutePose(NamedTuple):
    """Parity: `theia::RadialDistUncalibratedAbsolutePose`
    (estimate_radial_dist_uncalibrated_absolute_pose.h:50-55)."""

    rotation: jax.Array  # [3, 3]
    translation: jax.Array  # [3]
    focal_length: jax.Array
    radial_distortion: jax.Array


def estimate_radial_dist_uncalibrated_absolute_pose(
    key, feature, world_point, params: engine.RansacParameters,
    min_focal_length: float = 200.0, max_focal_length: float = 10000.0,
    min_radial_distortion: float = -1e-5, max_radial_distortion: float = -1e-9,
    mask=None, **kw,
):
    """Parity: `theia::EstimateRadialDistUncalibratedAbsolutePose`
    (estimate_radial_dist_uncalibrated_absolute_pose.cc + MetaData bounds):
    P4Pfr minimal solver; residual = squared pixel error after projecting
    and applying the division-model distortion (`radial_homography.
    radial_distort_point`, matching DivisionUndistortionCameraModel)."""
    from ..ops import focal_radial, radial_homography

    def solve(subset: Corr2D3D):
        R, t, k1, f, valid = focal_radial.four_point_pose_focal_length_radial_distortion(
            subset.feature, subset.world_point,
            min_focal_length=min_focal_length, max_focal_length=max_focal_length,
            min_distortion=min_radial_distortion * max_focal_length**2,
            max_distortion=0.0,
        )
        return RadialDistUncalibratedAbsolutePose(R, t, f, k1), valid

    def residuals(model: RadialDistUncalibratedAbsolutePose, data: Corr2D3D):
        p_cam = (
            jnp.einsum("ij,nj->ni", model.rotation, data.world_point)
            + model.translation
        )
        z = p_cam[..., 2]
        behind = z < 1e-12
        distorted = radial_homography.radial_distort_point(
            p_cam, model.focal_length, model.radial_distortion
        )
        err = jnp.sum((distorted - data.feature) ** 2, axis=-1)
        return jnp.where(behind, _BIG, err)

    est = engine.Estimator(sample_size=4, solve=solve, residuals=residuals)
    return engine.ransac(
        key, Corr2D3D(feature, world_point), est, params, mask=mask, **kw
    )


# ---------------------------------------------------------------------------
# Generalized-camera 2D-3D alignment: similarity + rigid.
# ---------------------------------------------------------------------------


class GeneralizedCorr2D3D(NamedTuple):
    """Parity: `theia::CameraAndFeatureCorrespondence2D3D` reduced to its
    ray form (the reference stores a full Camera; the ray origin/direction
    pair is what both solvers and the error consume)."""

    ray_origin: jax.Array  # [N, 3] camera centers
    ray_direction: jax.Array  # [N, 3] unit rays in the rig/world frame
    world_point: jax.Array  # [N, 3]


class SimilarityTransformation(NamedTuple):
    """Parity: `theia::SimilarityTransformation` (sim_transforms.h)."""

    rotation: jax.Array  # [3, 3]
    translation: jax.Array  # [3]
    scale: jax.Array  # scalar


class RigidTransformation(NamedTuple):
    """Parity: `theia::RigidTransformation`."""

    rotation: jax.Array  # [3, 3]
    translation: jax.Array  # [3]


def _ray_alignment_residuals(transformed, data: GeneralizedCorr2D3D):
    """Squared sine of the angle between each observation ray and the
    direction to the transformed point — the angular form of the reference's
    squared reprojection error (estimate_similarity_transformation_2d_3d.cc:
    137-152; multiply the threshold by focal^2 pixels to convert)."""
    v = transformed - data.ray_origin
    n2 = jnp.sum(v * v, axis=-1)
    dot = jnp.sum(v * data.ray_direction, axis=-1)
    sin2 = 1.0 - (dot * dot) / jnp.where(n2 < 1e-18, 1.0, n2)
    behind = dot <= 0
    return jnp.where(behind | (n2 < 1e-18), _BIG, jnp.maximum(sin2, 0.0))


def estimate_similarity_transformation_2d_3d(
    key, ray_origin, ray_direction, world_point,
    params: engine.RansacParameters, mask=None, **kw,
):
    """Parity: `theia::EstimateSimilarityTransformation2D3D`
    (estimate_similarity_transformation_2d_3d.h): gDLS similarity transform
    from 4+ ray / 3D-point correspondences of a generalized camera, scored by
    the angular reprojection residual."""
    from ..ops import generalized_pose

    def solve(subset: GeneralizedCorr2D3D):
        R, t, s, cost = generalized_pose.gdls_similarity_transform(
            subset.ray_origin, subset.ray_direction, subset.world_point
        )
        ok = jnp.isfinite(cost)
        return (
            SimilarityTransformation(R[None], t[None], s[None]),
            ok[None],
        )

    def residuals(model: SimilarityTransformation, data: GeneralizedCorr2D3D):
        transformed = (
            model.scale * jnp.einsum("ij,nj->ni", model.rotation, data.world_point)
            + model.translation
        )
        return _ray_alignment_residuals(transformed, data)

    est = engine.Estimator(sample_size=4, solve=solve, residuals=residuals)
    return engine.ransac(
        key,
        GeneralizedCorr2D3D(ray_origin, ray_direction, world_point),
        est, params, mask=mask, **kw,
    )


def estimate_rigid_transformation_2d_3d(
    key, ray_origin, ray_direction, world_point,
    params: engine.RansacParameters, mask=None, **kw,
):
    """Parity: `theia::EstimateRigidTransformation2D3D`
    (estimate_rigid_transformation_2d_3d.cc:58-135): UPnP on the generalized
    camera's rays (SampleSize 4), angular reprojection residual."""
    from ..ops import generalized_pose

    def solve(subset: GeneralizedCorr2D3D):
        R, t, cost = generalized_pose.upnp(
            subset.ray_origin, subset.ray_direction, subset.world_point
        )
        ok = jnp.isfinite(cost)
        return RigidTransformation(R[None], t[None]), ok[None]

    def residuals(model: RigidTransformation, data: GeneralizedCorr2D3D):
        transformed = (
            jnp.einsum("ij,nj->ni", model.rotation, data.world_point)
            + model.translation
        )
        return _ray_alignment_residuals(transformed, data)

    est = engine.Estimator(sample_size=4, solve=solve, residuals=residuals)
    return engine.ransac(
        key,
        GeneralizedCorr2D3D(ray_origin, ray_direction, world_point),
        est, params, mask=mask, **kw,
    )


# ---------------------------------------------------------------------------
# Dominant plane.
# ---------------------------------------------------------------------------


class Plane(NamedTuple):
    """Parity: `theia::Plane` (estimate_dominant_plane_from_points.h:48-51)."""

    point: jax.Array  # [3]
    unit_normal: jax.Array  # [3]


def estimate_dominant_plane_from_points(
    key, points, params: engine.RansacParameters, mask=None, **kw
):
    """Parity: `theia::EstimateDominantPlaneFromPoints`
    (estimate_dominant_plane_from_points.cc): 3-point plane hypotheses,
    SQUARED point-to-plane distance residual (the reference scores the
    absolute distance; square `error_thresh` accordingly)."""

    def solve(subset):
        p0, p1, p2 = subset[0], subset[1], subset[2]
        n = jnp.cross(p1 - p0, p2 - p0)
        norm = jnp.linalg.norm(n)
        ok = norm > 1e-12
        n = n / jnp.where(ok, norm, 1.0)
        return Plane(p0[None], n[None]), ok[None]

    def residuals(model: Plane, data):
        d = jnp.einsum("nj,j->n", data - model.point, model.unit_normal)
        return d * d

    est = engine.Estimator(sample_size=3, solve=solve, residuals=residuals)
    return engine.ransac(key, points, est, params, mask=mask, **kw)


# ---------------------------------------------------------------------------
# Radial-distortion homography.
# ---------------------------------------------------------------------------


class RadialHomographyResult(NamedTuple):
    """Parity: `theia::RadialHomographyResult`
    (estimate_radial_distortion_homography.h)."""

    H: jax.Array  # [3, 3]
    l1: jax.Array  # radial distortion, left
    l2: jax.Array  # radial distortion, right


def estimate_radial_distortion_homography(
    key, normalized_points1, normalized_points2,
    params: engine.RansacParameters,
    min_radial_distortion: float = -5.0, max_radial_distortion: float = 0.0,
    mask=None, **kw,
):
    """Parity: `theia::EstimateRadialHomographyMatrix`
    (estimate_radial_distortion_homography.cc): 6-point radial-distortion
    homography on focal-normalized distorted points, symmetric-transfer
    residual under the lifted model (`CheckRadialSymmetricError`)."""
    from ..ops import radial_homography

    def solve(subset: TwoViewData):
        H, l1, l2, valid = radial_homography.six_point_radial_distortion_homography(
            subset.points1, subset.points2,
            lmin=min_radial_distortion, lmax=max_radial_distortion,
        )
        return RadialHomographyResult(H, l1, l2), valid

    def residuals(model: RadialHomographyResult, data: TwoViewData):
        return radial_homography.check_radial_symmetric_error(
            model.H, model.l1, model.l2, data.points1, data.points2
        )

    est = engine.Estimator(sample_size=6, solve=solve, residuals=residuals)
    return engine.ransac(
        key, TwoViewData(normalized_points1, normalized_points2), est, params,
        mask=mask, **kw,
    )
