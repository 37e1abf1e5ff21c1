"""Batched track triangulation: the batched `theia::TrackEstimator`.

Re-design of `/root/reference/src/theia/sfm/estimate_track.{h,cc}`
(options `estimate_track.h:57-116`, chunked ThreadPool dispatch
`estimate_track.cc:165-183`). The reference triangulates one track per task
on a thread pool; here every track is one row of a padded `[T, K]`
observation table and ALL tracks triangulate in a single vmapped kernel —
the thread pool becomes the vector unit (and, across devices, a sharded
track axis).

Per-track acceptance mirrors `estimate_track.cc::EstimateTrack`:
  1. at least one view pair subtends `min_triangulation_angle_degrees`;
  2. triangulation succeeds (MIDPOINT / SVD / L2_MINIMIZATION);
  3. every observing estimated view reprojects within
     `max_acceptable_reprojection_error_pixels` with positive depth.
Optional per-track Gauss-Newton refinement stands in for the reference's
per-track bundle adjustment (`estimate_track.h:73`).
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models import camera as cam
from ..ops import rotation as rotops
from ..ops import triangulation as tri

__all__ = [
    "TriangulationMethodType",
    "TrackEstimatorOptions",
    "TrackEstimatorSummary",
    "triangulate_tracks",
    "estimate_tracks",
    "estimate_all_tracks",
]


class TriangulationMethodType(enum.IntEnum):
    """Parity: `theia::TriangulationMethodType` (`estimate_track.h:49`)."""

    MIDPOINT = 0
    SVD = 1
    L2_MINIMIZATION = 2


@dataclasses.dataclass(frozen=True)
class TrackEstimatorOptions:
    """Parity: `theia::TrackEstimator::Options` (`estimate_track.h:57-101`).
    `num_threads`/`multithreaded_step_size` have no analogue — the batch IS
    the parallelism."""

    max_acceptable_reprojection_error_pixels: float = 5.0
    min_triangulation_angle_degrees: float = 3.0
    bundle_adjustment: bool = True
    ba_iterations: int = 5
    triangulation_method: TriangulationMethodType = TriangulationMethodType.MIDPOINT
    # Optional `jax.sharding.Mesh`: the track axis of the batched
    # triangulation shards across it (embarrassingly parallel — GSPMD
    # splits the vmap with no collectives). SURVEY §7.9; the reference
    # fans tracks out over its ThreadPool instead (estimate_track.cc:
    # 165-183).
    mesh: object = None


@dataclasses.dataclass
class TrackEstimatorSummary:
    """Parity: `theia::TrackEstimator::Summary` (`estimate_track.h:103`)."""

    input_num_estimated_tracks: int = 0
    num_triangulation_attempts: int = 0
    estimated_tracks: set = dataclasses.field(default_factory=set)


def _refine_point_gn(point3, ext, norm_uv, mask, iters: int):
    """Per-track Gauss-Newton on the normalized reprojection residuals —
    the batched stand-in for the reference's per-track single-point BA
    (`estimate_track.cc` bundle_adjustment option)."""

    def residuals(p):
        adjusted = p - ext[:, :3]
        p_cam = jax.vmap(rotops.angle_axis_rotate_point)(ext[:, 3:], adjusted)
        z = p_cam[..., 2]
        safe_z = jnp.where(jnp.abs(z) < 1e-12, 1.0, z)
        r = p_cam[..., :2] / safe_z[..., None] - norm_uv
        return jnp.where(mask[..., None], r, 0.0).reshape(-1)

    def body(p, _):
        r = residuals(p)
        J = jax.jacfwd(residuals)(p)
        H = J.T @ J + 1e-8 * jnp.eye(3, dtype=p.dtype)
        g = J.T @ r
        dp = jnp.linalg.solve(H, -g)
        p_new = p + dp
        better = jnp.sum(residuals(p_new) ** 2) < jnp.sum(r * r)
        return jnp.where(better, p_new, p), None

    point3, _ = jax.lax.scan(body, point3, None, length=iters)
    return point3


@partial(
    jax.jit,
    static_argnames=("method", "bundle_adjustment", "ba_iterations"),
)
def triangulate_tracks(
    track_ext,  # [T, K, 6] extrinsics of the observing (estimated) views
    track_norm_uv,  # [T, K, 2] normalized camera coordinates of the features
    track_focal,  # [T, K] focal length per slot (threshold conversion)
    slot_mask,  # [T, K] bool — valid slots
    max_reproj_px: jax.Array,  # scalar
    min_angle_deg: jax.Array,  # scalar
    method: int = int(TriangulationMethodType.MIDPOINT),
    bundle_adjustment: bool = True,
    ba_iterations: int = 5,
):
    """Triangulate T tracks at once. Returns (points4 [T,4], success [T])."""
    dtype = track_ext.dtype
    min_cos = jnp.cos(jnp.deg2rad(jnp.asarray(min_angle_deg, dtype)))

    def one_track(ext, norm_uv, focal, mask):
        n_obs = jnp.sum(mask)
        origins = ext[:, :3]
        # Unit bearing rays in world frame: R^T [u, v, 1].
        dirs_cam = jnp.concatenate(
            [norm_uv, jnp.ones_like(norm_uv[..., :1])], axis=-1
        )
        dirs_cam = dirs_cam / jnp.linalg.norm(dirs_cam, axis=-1, keepdims=True)
        R = jax.vmap(rotops.angle_axis_to_rotation_matrix)(ext[:, 3:])
        dirs = jnp.einsum("kji,kj->ki", R, dirs_cam)  # R^T d

        # 1. Angle test: any pair of rays subtends >= min angle
        #    (SufficientTriangulationAngle, triangulation.cc).
        cosang = jnp.einsum("ki,li->kl", dirs, dirs)
        pair_mask = mask[:, None] & mask[None, :]
        pair_mask &= ~jnp.eye(mask.shape[0], dtype=bool)
        angle_ok = jnp.any(pair_mask & (cosang < min_cos))

        # 2. Triangulate.
        if method == int(TriangulationMethodType.MIDPOINT):
            point4, tri_ok = tri.triangulate_midpoint(origins, dirs, mask=mask)
        else:
            poses = jnp.concatenate(
                [R, -jnp.einsum("kij,kj->ki", R, origins)[..., None]], axis=-1
            )  # [K, 3, 4]
            point4 = tri.triangulate_nview_svd(poses, norm_uv, mask=mask)
            tri_ok = jnp.isfinite(point4).all()

        w = point4[3]
        point3 = point4[:3] / jnp.where(jnp.abs(w) < 1e-12, 1.0, w)

        if method == int(TriangulationMethodType.L2_MINIMIZATION) or (
            bundle_adjustment and ba_iterations > 0
        ):
            point3 = _refine_point_gn(point3, ext, norm_uv, mask, ba_iterations)

        # 3. Reprojection gate: every observing view within threshold,
        #    positive depth (estimate_track.cc reprojection loop).
        adjusted = point3 - origins
        p_cam = jnp.einsum("kij,kj->ki", R, adjusted)
        z = p_cam[..., 2]
        safe_z = jnp.where(jnp.abs(z) < 1e-12, 1.0, z)
        reproj = p_cam[..., :2] / safe_z[..., None]
        err_px = jnp.linalg.norm(reproj - norm_uv, axis=-1) * focal
        obs_ok = (z > 0) & (err_px <= max_reproj_px)
        reproj_ok = jnp.all(jnp.where(mask, obs_ok, True))

        success = (n_obs >= 2) & angle_ok & tri_ok & reproj_ok
        out4 = jnp.concatenate([point3, jnp.ones((1,), dtype)])
        return out4, success

    return jax.vmap(one_track)(track_ext, track_norm_uv, track_focal, slot_mask)


# --------------------------------------------------------------------- host


def _normalized_obs_by_group(recon, obs_rows: np.ndarray):
    """Normalize pixel features to camera coordinates, batching by
    intrinsics group so each camera model compiles once."""
    norm = np.zeros((len(obs_rows), 2), recon.dtype)
    focal = np.ones((len(obs_rows),), recon.dtype)
    views = recon.obs_view[obs_rows]
    groups = recon.view_group[views]
    # Launch every group's normalization first, then pull ALL results in a
    # single batched device_get: a per-group blocking np.asarray costs one
    # device->host transfer per intrinsics group, and free-intrinsics
    # scenes have one group per camera.
    launched = []
    for g in np.unique(groups):
        sel = groups == g
        rows = obs_rows[sel]
        params = jnp.asarray(recon.intrinsics[g])
        model = int(recon.group_model[g])
        # pow2-pad the batch so repeated calls at nearby sizes share one
        # compilation (a recompile per size costs seconds).
        k = len(rows)
        pad = 64
        while pad < k:
            pad *= 2
        pix = np.zeros((pad, 2), recon.dtype)
        pix[:k] = recon.obs_uv[rows]
        launched.append(
            (sel, g, k,
             cam.pixel_to_normalized_batch(params, jnp.asarray(pix), model))
        )
    from ..utils.fetch import fetch

    pulled = fetch([d for (_, _, _, d) in launched])
    for (sel, g, k, _), n_full in zip(launched, pulled):
        n = np.asarray(n_full)[:k]
        norm[sel] = n[:, :2] / n[:, 2:3]
        focal[sel] = float(recon.intrinsics[g][0])
    return norm, focal


def estimate_tracks(
    recon,
    track_ids,
    options: TrackEstimatorOptions | None = None,
    dtype=np.float32,
) -> TrackEstimatorSummary:
    """Parity: `TrackEstimator::EstimateTracks` (`estimate_track.h:88`).
    Builds the padded [T, K] table from the host container, runs the batched
    kernel, and writes results back."""
    options = options or TrackEstimatorOptions()
    summary = TrackEstimatorSummary(
        input_num_estimated_tracks=int(np.sum(recon.track_estimated))
    )

    candidates = []
    obs_lists = []
    for t in track_ids:
        if recon.track_estimated[t]:
            continue
        rows = [
            r
            for r in recon.track_observations(t)
            if recon.view_estimated[recon.obs_view[r]]
        ]
        if len(rows) >= 2:
            candidates.append(t)
            obs_lists.append(rows)
    summary.num_triangulation_attempts = len(candidates)
    if not candidates:
        return summary

    kmax = max(len(rows) for rows in obs_lists)
    # Pad K to the next power of two >= 2 to bound recompiles.
    K = 2
    while K < kmax:
        K *= 2
    T = len(candidates)

    track_ext = np.zeros((T, K, 6), dtype)
    track_uv = np.zeros((T, K, 2), dtype)
    track_focal = np.ones((T, K), dtype)
    slot_mask = np.zeros((T, K), bool)

    all_rows = np.asarray([r for rows in obs_lists for r in rows], np.int64)
    norm_all, focal_all = _normalized_obs_by_group(recon, all_rows)
    # Vectorized slot fill (the per-candidate Python loop here was ~0.2 s
    # per fountain triangulation pass at 16k tracks).
    lengths = np.asarray([len(rows) for rows in obs_lists])
    i_idx = np.repeat(np.arange(T), lengths)
    starts = np.zeros(T + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    k_idx = np.arange(len(all_rows)) - starts[i_idx]
    views_all = recon.obs_view[all_rows]
    track_ext[i_idx, k_idx] = recon.view_extrinsics[views_all]
    track_uv[i_idx, k_idx] = norm_all
    track_focal[i_idx, k_idx] = focal_all
    slot_mask[i_idx, k_idx] = True

    from ..utils import counters

    counters.bump("triangulate_launch")
    arrays = (track_ext, track_uv, track_focal, slot_mask)
    if options.mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as PS

        from ..parallel import pad_to_multiple

        mesh = options.mesh
        n = int(np.prod(list(mesh.shape.values())))
        sh = NamedSharding(mesh, PS(mesh.axis_names[0]))
        padded = []
        for a in arrays:
            p, _ = pad_to_multiple(a, n)
            padded.append(p)
        padded[3][T:] = False  # padded tracks are fully masked
        arrays = tuple(
            jax.device_put(jnp.asarray(a), sh) for a in padded
        )
    else:
        arrays = tuple(jnp.asarray(a) for a in arrays)
    points4, success = triangulate_tracks(
        *arrays,
        jnp.asarray(options.max_acceptable_reprojection_error_pixels, dtype),
        jnp.asarray(options.min_triangulation_angle_degrees, dtype),
        method=int(options.triangulation_method),
        bundle_adjustment=options.bundle_adjustment,
        ba_iterations=options.ba_iterations,
    )
    from ..utils.fetch import fetch

    points4, success = fetch((points4, success))  # one batched round trip
    points4 = np.asarray(points4, recon.dtype)
    success = np.asarray(success)

    cand = np.asarray(list(candidates), np.int64)
    sel = np.asarray(success[: len(cand)], bool)
    idx = cand[sel]
    if len(idx):
        recon.points[idx] = points4[: len(cand)][sel]
        recon.track_estimated[idx] = True
        summary.estimated_tracks.update(int(t) for t in idx)
    return summary


def estimate_all_tracks(
    recon, options: TrackEstimatorOptions | None = None, dtype=np.float32
) -> TrackEstimatorSummary:
    """Parity: `TrackEstimator::EstimateAllTracks` (`estimate_track.h:85`)."""
    return estimate_tracks(recon, range(recon.num_tracks()), options, dtype)
