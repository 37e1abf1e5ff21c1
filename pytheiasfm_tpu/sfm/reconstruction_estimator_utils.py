"""Shared helpers for the reconstruction estimators.

Re-design of `/root/reference/src/theia/sfm/reconstruction_estimator_utils.{h,cc}`
and `set_outlier_tracks_to_unestimated.{h,cc}`. The reference walks the
pointer graph per track/view; here reprojection errors for the WHOLE scene
are computed as one batched kernel over the observation table, and the
track/view gating reduces with segment ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models import camera as cam
from ..ops import rotation as rotops

__all__ = [
    "compute_reprojection_errors",
    "set_outlier_tracks_to_unestimated",
    "set_underconstrained_tracks_to_unestimated",
    "set_underconstrained_views_to_unestimated",
    "num_estimated_views",
    "num_estimated_tracks",
    "set_reconstruction_from_estimated_poses",
    "relative_rotations_from_view_graph",
    "create_estimated_subreconstruction",
    "compute_resolution_scaled_threshold",
]

kMinNumObservingViews = 2  # reconstruction_estimator_utils.cc:292
kMinNumObservedTracks = 3  # reconstruction_estimator_utils.cc:323


def compute_resolution_scaled_threshold(
    threshold_pixels: float, image_width: int, image_height: int
) -> float:
    """Parity: `theia::ComputeResolutionScaledThreshold`
    (`reconstruction_estimator_utils.cc`): thresholds are calibrated for a
    1024-px-wide image and scale with the max dimension."""
    max_dim = max(image_width, image_height)
    if max_dim <= 0:
        return threshold_pixels
    return threshold_pixels * max_dim / 1024.0


@partial(jax.jit, static_argnames=("model",))
def _reproject_kernel(ext_o, params_o, pts_o, uv_o, model: int):
    """Per-observation (squared reprojection error [px^2], depth)."""

    from ..models import intrinsics as intr

    def one_obs(e6, params, x3, uv):
        adjusted = x3 - e6[:3]
        p_cam = rotops.angle_axis_rotate_point(e6[3:], adjusted)
        pixel = intr.camera_to_pixel(params, p_cam, model)
        err = jnp.sum((pixel - uv) ** 2)
        return err, p_cam[2]

    return jax.vmap(one_obs)(ext_o, params_o, pts_o, uv_o)


@partial(
    jax.jit,
    static_argnames=("present_models", "num_groups"),
)
def _reproject_all_kernel(
    ext, intrinsics, pts4, obs_view, obs_track, uv, obs_group,
    model_idx, present_models: tuple, num_groups: int,
):
    """(squared error, depth) for EVERY observation row. All gathers run
    on device: the per-call host->device upload is only the parameter
    state ([V,6] + [G,P] + [T,4]), the constant observation table is
    cached on device by `compute_reprojection_errors`."""
    from ..ba.lm import _pixel_of

    e6 = ext[obs_view]
    q = intrinsics[obs_group]
    p4 = pts4[obs_track]
    w = p4[:, 3:4]
    p3 = p4[:, :3] / jnp.where(jnp.abs(w) < 1e-12, 1.0, w)

    def one_obs(e6, q, x3, uv, idx):
        adjusted = x3 - e6[:3]
        p_cam = rotops.angle_axis_rotate_point(e6[3:], adjusted)
        pixel = _pixel_of(q, p_cam, present_models, idx)
        return jnp.sum((pixel - uv) ** 2), p_cam[2]

    return jax.vmap(one_obs)(e6, q, p3, uv, model_idx)


# Device cache of the constant observation table per reconstruction: the
# table never changes inside an estimator's BA loop, so the gathered
# 600k-row arrays are uploaded once, not on every outlier pass. Entries hold the host arrays to pin their
# identity (id() alone can be recycled).
_OBS_DEVICE_CACHE: dict = {}


def _obs_device_arrays(recon):
    key = id(recon)
    ent = _OBS_DEVICE_CACHE.get(key)
    if ent is not None and ent[0] is recon.obs_view:
        return ent[1]
    # A different container with byte-identical content (fresh build of
    # the same scene, checkpoint round-trip) reuses the resident copy —
    # hashing the table is cheaper than uploading it again.
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    # recon.dtype is part of the identity: the cached uv was cast to the
    # builder's dtype, so byte-identical tables at a different precision
    # must not reuse it.
    h.update(np.dtype(recon.dtype).str.encode())
    for a in (recon.obs_view, recon.obs_track, recon.obs_uv,
              recon.view_group, recon.group_model):
        h.update(np.ascontiguousarray(a).tobytes())
    digest = h.digest()
    ent = _OBS_DEVICE_CACHE.get(digest)
    if ent is not None:
        # Evict stale id-keyed entries before aliasing a new one so
        # repeated fresh builds of the same scene keep the cache bounded.
        for k in [k for k in _OBS_DEVICE_CACHE if k not in (key, digest)]:
            del _OBS_DEVICE_CACHE[k]
        _OBS_DEVICE_CACHE[key] = (recon.obs_view, ent[1])
        return ent[1]
    groups = recon.view_group[recon.obs_view]
    present = tuple(sorted({int(m) for m in recon.group_model} or {0}))
    midx = np.asarray(
        [present.index(int(m)) for m in recon.group_model], np.int32
    )[groups]
    arrays = (
        jnp.asarray(recon.obs_view),
        jnp.asarray(recon.obs_track),
        jnp.asarray(np.asarray(recon.obs_uv, recon.dtype)),
        jnp.asarray(groups),
        jnp.asarray(midx),
        present,
    )
    _OBS_DEVICE_CACHE.clear()  # one pipeline at a time; bound the cache
    _OBS_DEVICE_CACHE[key] = (recon.obs_view, arrays)
    _OBS_DEVICE_CACHE[digest] = (recon.obs_view, arrays)
    return arrays


def compute_reprojection_errors(recon, rows: np.ndarray | None = None):
    """Squared pixel reprojection error + depth per observation row.

    Computes ALL rows in one fixed-shape device launch (per-call upload =
    current extrinsics + points only) and slices on host — variable `rows`
    subsets would otherwise recompile per unique selection size."""
    from ..utils import counters

    if recon.num_observations() == 0:
        rows = np.asarray([], np.int64) if rows is None else np.asarray(rows)
        return (
            np.full((len(rows),), np.inf, recon.dtype),
            np.zeros((len(rows),), recon.dtype),
        )
    ov, ot, uv_d, grp_d, midx_d, present = _obs_device_arrays(recon)
    counters.bump("reproject_launch")
    e, d = _reproject_all_kernel(
        jnp.asarray(np.asarray(recon.view_extrinsics, recon.dtype)),
        jnp.asarray(np.asarray(recon.intrinsics, recon.dtype)),
        jnp.asarray(np.asarray(recon.points, recon.dtype)),
        ov, ot, uv_d, grp_d, midx_d,
        present_models=present,
        num_groups=recon.intrinsics.shape[0],
    )
    err_all = np.asarray(e)
    depth_all = np.asarray(d)
    if rows is None:
        return err_all, depth_all
    rows = np.asarray(rows)
    return err_all[rows], depth_all[rows]


@partial(
    jax.jit,
    static_argnames=(
        "present_models", "num_views", "num_groups", "num_params",
        "num_tracks",
    ),
)
def _track_outlier_aggregates(
    state_flat,  # [6V + G*P + 4T] packed (extrinsics | intrinsics | points)
    obs_view, obs_track, uv, obs_group, model_idx,
    row_mask, present_models: tuple, num_views: int, num_groups: int,
    num_params: int, num_tracks: int,
):
    """Per-TRACK outlier statistics in one launch: a stacked [3, T] of
    (sum of squared reprojection errors, observation count,
    any-behind-camera flag) over the masked observation rows. The
    parameter state arrives as ONE packed upload and the result is ONE
    download, instead of a per-observation download plus one transfer per
    array."""
    from ..ba.lm import _pixel_of

    V, G, P, T = num_views, num_groups, num_params, num_tracks
    ext = state_flat[: 6 * V].reshape(V, 6)
    intrinsics = state_flat[6 * V : 6 * V + G * P].reshape(G, P)
    pts4 = state_flat[6 * V + G * P :].reshape(T, 4)

    e6 = ext[obs_view]
    q = intrinsics[obs_group]
    p4 = pts4[obs_track]
    w = p4[:, 3:4]
    p3 = p4[:, :3] / jnp.where(jnp.abs(w) < 1e-12, 1.0, w)

    def one_obs(e6, q, x3, uv, idx):
        adjusted = x3 - e6[:3]
        p_cam = rotops.angle_axis_rotate_point(e6[3:], adjusted)
        pixel = _pixel_of(q, p_cam, present_models, idx)
        return jnp.sum((pixel - uv) ** 2), p_cam[2]

    err, depth = jax.vmap(one_obs)(e6, q, p3, uv, model_idx)
    m = row_mask.astype(err.dtype)
    sum_err = jax.ops.segment_sum(err * m, obs_track, num_segments=T)
    cnt = jax.ops.segment_sum(m, obs_track, num_segments=T)
    bad = jax.ops.segment_max(
        jnp.where(row_mask & (depth < 0), 1.0, 0.0).astype(err.dtype),
        obs_track,
        num_segments=T,
    )
    return jnp.stack([sum_err, cnt, bad])


def set_outlier_tracks_to_unestimated(
    recon,
    max_inlier_reprojection_error: float,
    min_triangulation_angle_degrees: float,
    track_ids=None,
) -> int:
    """Parity: `theia::SetOutlierTracksToUnestimated`
    (`set_outlier_tracks_to_unestimated.cc`): an estimated track is dropped
    when any estimated observing view sees it behind the camera, when the
    MEAN squared reprojection error exceeds the threshold, or when the best
    pair of viewing rays subtends less than the minimum angle."""
    max_sq = max_inlier_reprojection_error**2
    min_cos = np.cos(np.deg2rad(min_triangulation_angle_degrees))
    T = recon.num_tracks()

    cand = np.zeros(T, bool)
    if track_ids is None:
        cand[:] = recon.track_estimated
    else:
        ids = np.asarray(list(track_ids), np.int64)
        if len(ids):
            cand[ids[recon.track_estimated[ids]]] = True
    if not cand.any():
        return 0

    # Rows of estimated views observing candidate tracks — one vectorized
    # mask over the observation table (the per-track Python loop here cost
    # ~4 s per BA round at 100k tracks).
    ov, ot = recon.obs_view, recon.obs_track
    row_mask = cand[ot] & recon.view_estimated[ov]
    rows = np.where(row_mask)[0]
    if len(rows) == 0:
        return 0
    ov_d, ot_d, uv_d, grp_d, midx_d, present = _obs_device_arrays(recon)
    from ..utils import counters

    counters.bump("reproject_launch")
    state_flat = np.concatenate([
        np.asarray(recon.view_extrinsics, recon.dtype).ravel(),
        np.asarray(recon.intrinsics, recon.dtype).ravel(),
        np.asarray(recon.points, recon.dtype).ravel(),
    ])
    agg = np.asarray(
        _track_outlier_aggregates(
            jnp.asarray(state_flat),
            ov_d, ot_d, uv_d, grp_d, midx_d,
            jnp.asarray(row_mask),
            present_models=present,
            num_views=recon.num_views(),
            num_groups=recon.intrinsics.shape[0],
            num_params=recon.intrinsics.shape[1],
            num_tracks=T,
        ),
        np.float64,
    )
    sum_err, cnt, bad_depth = agg[0], agg[1], agg[2] > 0.5
    seen = cnt > 0
    drop = bad_depth | (sum_err > max_sq * np.maximum(cnt, 1.0))

    # Viewing-angle test for the survivors, in a padded [Tc, L] slot
    # layout (best pair of rays must subtend >= the minimum angle);
    # runs entirely on HOST state (points + extrinsics), no download.
    tracks = ot[rows]
    need = np.where(seen & ~drop & cand)[0]
    if len(need):
        sub = rows[np.isin(tracks, need)]
        st = ot[sub]
        order = np.argsort(st, kind="stable")
        sub, st = sub[order], st[order]
        tmap = np.full(T, -1, np.int64)
        tmap[need] = np.arange(len(need))
        stc = tmap[st]
        counts = np.bincount(stc, minlength=len(need))
        L = max(int(counts.max()), 1)
        starts = np.zeros(len(need) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(sub)) - starts[stc]
        w = recon.points[need, 3:4]
        pts3 = recon.points[need, :3] / np.where(
            np.abs(w) < 1e-12, 1.0, w
        )
        dirs = np.zeros((len(need), L, 3))
        valid = np.zeros((len(need), L), bool)
        d = pts3[stc] - recon.view_extrinsics[ov[sub], :3]
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        dirs[stc, pos] = d / np.where(n < 1e-12, 1.0, n)
        valid[stc, pos] = True
        cosang = np.einsum("tli,tmi->tlm", dirs, dirs)
        pair_ok = valid[:, :, None] & valid[:, None, :]
        np.einsum("tll->tl", cosang)[:] = 1.0  # ignore self-pairs
        cosang = np.where(pair_ok, cosang, 1.0)
        narrow = cosang.min(axis=(1, 2)) > min_cos
        drop[need[narrow]] = True

    out = cand & seen & drop
    num_removed = int(out.sum())
    recon.track_estimated[out] = False
    return num_removed


def set_underconstrained_tracks_to_unestimated(recon) -> int:
    """Parity: `theia::SetUnderconstrainedTracksToUnestimated`
    (`reconstruction_estimator_utils.cc:292-316`): estimated tracks need
    >= 2 estimated observing views."""
    good = recon.view_estimated[recon.obs_view]
    cnt = np.bincount(
        recon.obs_track[good], minlength=recon.num_tracks()
    )
    out = recon.track_estimated & (cnt < kMinNumObservingViews)
    recon.track_estimated[out] = False
    return int(out.sum())


def set_underconstrained_views_to_unestimated(recon) -> int:
    """Parity: `theia::SetUnderconstrainedViewsToUnestimated`
    (`reconstruction_estimator_utils.cc:323-347`): estimated views need
    >= 3 estimated observed tracks."""
    good = recon.track_estimated[recon.obs_track]
    cnt = np.bincount(
        recon.obs_view[good], minlength=recon.num_views()
    )
    out = recon.view_estimated & (cnt < kMinNumObservedTracks)
    recon.view_estimated[out] = False
    return int(out.sum())


def num_estimated_views(recon) -> int:
    return int(np.sum(recon.view_estimated))


def num_estimated_tracks(recon) -> int:
    return int(np.sum(recon.track_estimated))


def set_reconstruction_from_estimated_poses(orientations, positions, recon):
    """Parity: `theia::SetReconstructionFromEstimatedPoses`
    (`reconstruction_estimator_utils.cc`): every view with both a rotation
    and a position estimate becomes an estimated view."""
    for v, aa in orientations.items():
        if v not in positions:
            continue
        recon.view_extrinsics[v, :3] = np.asarray(positions[v])
        recon.view_extrinsics[v, 3:] = np.asarray(aa)
        recon.view_estimated[v] = True


def relative_rotations_from_view_graph(view_graph):
    """Parity: `theia::RelativeRotationsFromViewGraph`."""
    return {
        (i, j): np.asarray(info.rotation_2)
        for (i, j), info in view_graph.edges.items()
    }


def create_estimated_subreconstruction(recon):
    """Parity: `theia::CreateEstimatedSubreconstruction`."""
    view_ids = [v for v in range(recon.num_views()) if recon.view_estimated[v]]
    return recon.get_sub_reconstruction(view_ids)
