"""2D-3D view localization against the current reconstruction.

Re-design of `/root/reference/src/theia/sfm/localize_view_to_reconstruction.{h,cc}`
(options `localize_view_to_reconstruction.h:55-90`, flow `.cc:137-254`):
gather the view's observations of estimated tracks, RANSAC a calibrated
absolute pose (PnPType-selected KNEIP/SQPnP/DLS hypotheses — batched on
device), gate on inlier count, then single-view bundle adjustment with all
tracks constant.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ba import BundleAdjustmentOptions
from ..ba.entry import bundle_adjust_view
from ..models import camera as cam
from ..models import intrinsics as intr
from ..ransac import engine
from ..ransac.estimators import (
    estimate_absolute_pose_with_known_orientation,
    estimate_calibrated_absolute_pose_typed,
)
from ..ops import rotation as rotops
from .reconstruction_estimator_utils import compute_resolution_scaled_threshold

__all__ = [
    "LocalizeViewToReconstructionOptions",
    "localize_view_to_reconstruction",
    "localize_views_to_reconstruction_batch",
]


@dataclasses.dataclass
class LocalizeViewToReconstructionOptions:
    """Parity: `theia::LocalizeViewToReconstructionOptions`
    (`localize_view_to_reconstruction.h:55-90`)."""

    reprojection_error_threshold_pixels: float = 4.0
    assume_known_orientation: bool = False
    ransac_params: engine.RansacParameters = dataclasses.field(
        default_factory=engine.RansacParameters
    )
    bundle_adjust_view: bool = True
    ba_options: BundleAdjustmentOptions = dataclasses.field(
        default_factory=lambda: BundleAdjustmentOptions(max_num_iterations=10)
    )
    min_num_inliers: int = 30
    # PnPType {0 KNEIP, 1 SQPNP, 2 DLS} (`estimate_calibrated_absolute_pose.h:54`).
    pnp_type: int = 0


def localize_view_to_reconstruction(
    view_id: int,
    options: LocalizeViewToReconstructionOptions,
    recon,
    key: jax.Array | None = None,
):
    """Returns (success, RansacSummary|None). On success the view's
    extrinsics are set and it is flagged estimated."""
    if key is None:
        key = jax.random.PRNGKey(view_id)

    rows = [
        r
        for t, r in recon._view_track_to_obs[view_id].items()
        if recon.track_estimated[t]
    ]
    if len(rows) < max(options.min_num_inliers, 4):
        return False, None

    g = recon.view_group[view_id]
    params = jnp.asarray(recon.intrinsics[g])
    model = int(recon.group_model[g])
    focal = float(recon.intrinsics[g][0])

    # pow2-pad so per-view calls at varying 2D-3D match counts share one
    # compilation.
    k = len(rows)
    pad = 64
    while pad < k:
        pad *= 2
    pix_np = np.zeros((pad, 2), recon.dtype)
    pix_np[:k] = recon.obs_uv[rows]
    rays = cam.pixel_to_normalized_batch(
        params, jnp.asarray(pix_np), model
    )[:k]
    norm_feats = rays[:, :2] / rays[:, 2:3]

    tracks = recon.obs_track[rows]
    w = recon.points[tracks, 3:4]
    pts3 = recon.points[tracks, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)

    # Threshold: pixels -> normalized squared (estimate_calibrated_absolute_pose
    # residuals are squared errors in normalized coords). Resolution-scaled as
    # in localize_view_to_reconstruction.cc.
    prior = recon.view_priors[view_id]
    thresh_px = compute_resolution_scaled_threshold(
        options.reprojection_error_threshold_pixels,
        prior.image_width,
        prior.image_height,
    )
    thresh_norm_sq = (thresh_px / focal) ** 2

    params_r = dataclasses.replace(
        options.ransac_params, error_thresh=thresh_norm_sq
    )
    n = len(rows)
    # Pad correspondence count to a power of two to bound recompiles.
    npad = 8
    while npad < n:
        npad *= 2
    feats_p = jnp.zeros((npad, 2), norm_feats.dtype).at[:n].set(norm_feats)
    pts_p = jnp.zeros((npad, 3), norm_feats.dtype).at[:n].set(jnp.asarray(pts3, norm_feats.dtype))
    mask = jnp.arange(npad) < n

    if options.assume_known_orientation:
        # Position-only path (localize_view_to_reconstruction.cc known-
        # orientation branch): rotate features into the world-aligned frame
        # with the view's current orientation, 2-point position RANSAC.
        aa_cur = recon.view_extrinsics[view_id, 3:]
        R_cur = np.asarray(
            rotops.angle_axis_to_rotation_matrix(jnp.asarray(aa_cur))
        )
        rays = np.concatenate(
            [np.asarray(feats_p), np.ones((npad, 1), np.asarray(feats_p).dtype)],
            axis=-1,
        ) @ R_cur  # R^T x per row
        rot_feats = jnp.asarray(rays[:, :2] / rays[:, 2:3])
        model_best, summary = estimate_absolute_pose_with_known_orientation(
            key, rot_feats, pts_p, params_r, mask=mask, num_data=n
        )
        if int(summary.num_inliers) < options.min_num_inliers:
            return False, summary
        recon.view_extrinsics[view_id, :3] = np.asarray(model_best)
        recon.view_estimated[view_id] = True
    else:
        model_best, summary = estimate_calibrated_absolute_pose_typed(
            key, feats_p, pts_p, params_r,
            pnp_type=int(options.pnp_type), mask=mask, num_data=n,
        )
        if int(summary.num_inliers) < options.min_num_inliers:
            return False, summary

        from ..ops.rotation_np import rotation_matrix_to_angle_axis_np

        R = np.asarray(model_best.rotation)
        pos = np.asarray(model_best.position)
        aa = rotation_matrix_to_angle_axis_np(R)
        recon.view_extrinsics[view_id, :3] = pos
        recon.view_extrinsics[view_id, 3:] = aa
        recon.view_estimated[view_id] = True

    if options.bundle_adjust_view:
        ba_summary = bundle_adjust_view(options.ba_options, view_id, recon)
        if not bool(ba_summary.success):
            recon.view_estimated[view_id] = False
            return False, summary
    return True, summary


# --------------------------------------------------------------- batched


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("params", "pnp_type"))
def _batched_localize_run(keys, feats, pts, mask, thresh, params, pnp_type):
    """vmapped calibrated-absolute-pose RANSAC over the view axis.

    Module-level jit with (params, pnp_type) static so every caller at the
    same shapes shares ONE compilation (the per-view path pays a full
    RANSAC launch per view — at 200+ views that is the incremental loop's
    entire wall clock)."""

    def one(key, f, p, m, th):
        model, summary = estimate_calibrated_absolute_pose_typed(
            key, f, p,
            dataclasses.replace(params, error_thresh=1.0),  # overridden
            pnp_type=pnp_type, mask=m, error_thresh=th,
        )
        return (
            model.rotation,
            model.position,
            summary.num_inliers,
        )

    return jax.vmap(one)(keys, feats, pts, mask, thresh)


def localize_views_to_reconstruction_batch(
    view_ids,
    options: LocalizeViewToReconstructionOptions,
    recon,
    key: jax.Array | None = None,
):
    """Localize a BATCH of views against the current reconstruction in one
    device program — the batched mapping of the reference's
    candidate-list localization sweep (`incremental_reconstruction_
    estimator.cc:221-246`; one `LocalizeViewToReconstruction` per view
    there, one vmapped RANSAC launch here).

    Returns {view_id: num_inliers} for the views that succeeded; their
    extrinsics are written and they are flagged estimated. The per-view
    single-view BA polish of the scalar path is intentionally deferred to
    the caller's partial/full BA (running it per view would serialize the
    batch again)."""
    if key is None:
        key = jax.random.PRNGKey(int(view_ids[0]) if len(view_ids) else 0)

    rows_per_view = []
    kept_views = []
    for v in view_ids:
        rows = [
            r
            for t, r in recon._view_track_to_obs[v].items()
            if recon.track_estimated[t]
        ]
        if len(rows) >= max(options.min_num_inliers, 4):
            kept_views.append(v)
            rows_per_view.append(rows)
    if not kept_views:
        return {}

    B = len(kept_views)
    N = 8
    while N < max(len(r) for r in rows_per_view):
        N *= 2
    # Pad the BATCH axis too (pow2) so sweeps of varying candidate counts
    # share compilations.
    Bp = 4
    while Bp < B:
        Bp *= 2

    dtype = recon.dtype
    feats = np.zeros((Bp, N, 2), dtype)
    pts = np.zeros((Bp, N, 3), dtype)
    mask = np.zeros((Bp, N), bool)
    thresh = np.ones((Bp,), dtype)
    for i, (v, rows) in enumerate(zip(kept_views, rows_per_view)):
        g = recon.view_group[v]
        params = jnp.asarray(recon.intrinsics[g])
        model = int(recon.group_model[g])
        focal = float(recon.intrinsics[g][0])
        k = len(rows)
        pix = np.zeros((N, 2), dtype)
        pix[:k] = recon.obs_uv[rows]
        rays = np.asarray(
            cam.pixel_to_normalized_batch(
                params, jnp.asarray(pix), model
            )
        )[:k]
        feats[i, :k] = rays[:, :2] / rays[:, 2:3]
        tracks = recon.obs_track[rows]
        w = recon.points[tracks, 3:4]
        pts[i, :k] = recon.points[tracks, :3] / np.where(
            np.abs(w) < 1e-12, 1.0, w
        )
        mask[i, :k] = True
        prior = recon.view_priors[v]
        thresh_px = compute_resolution_scaled_threshold(
            options.reprojection_error_threshold_pixels,
            prior.image_width,
            prior.image_height,
        )
        thresh[i] = (thresh_px / focal) ** 2
    for i in range(B, Bp):
        feats[i], pts[i], mask[i], thresh[i] = (
            feats[0], pts[0], mask[0], thresh[0],
        )

    keys = jax.random.split(key, Bp)
    from ..utils import counters

    counters.bump("localize_batch_launch")
    R, pos, ninl = _batched_localize_run(
        keys, jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(thresh), options.ransac_params, int(options.pnp_type),
    )
    R = np.asarray(R)
    pos = np.asarray(pos)
    ninl = np.asarray(ninl)

    from ..ops.rotation_np import rotation_matrix_to_angle_axis_np

    out = {}
    for i, v in enumerate(kept_views):
        if int(ninl[i]) < options.min_num_inliers:
            continue
        recon.view_extrinsics[v, :3] = pos[i]
        recon.view_extrinsics[v, 3:] = rotation_matrix_to_angle_axis_np(R[i])
        recon.view_estimated[v] = True
        out[v] = int(ninl[i])
    return out
