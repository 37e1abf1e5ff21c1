"""Bundle-adjustment entry points over the host `Reconstruction` container.

Re-design of `/root/reference/src/theia/sfm/bundle_adjustment/
bundle_adjustment.{h,cc}` (`BundleAdjustReconstruction`,
`BundleAdjustPartialReconstruction`, `BundleAdjustView(s)`,
`BundleAdjustTrack(s)` — decls `bundle_adjustment.h:181-219`). All variants
are ONE batched LM kernel (`ba/lm.py`) with different free-parameter masks;
the reference instead builds a fresh Ceres problem per call.

Padding discipline: the observation count is padded to the next power of
two and V/T paddings ride the container sizes, so repeated calls at similar
scene sizes reuse the jit cache.
"""

from __future__ import annotations

import numpy as np

from .dense_schur import DENSE_SCHUR_MAX_CAMERAS, bundle_adjust_dense
from .iterative_schur import bundle_adjust_iterative
from .lm import (
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    LinearSolverType,
    TrackParametrizationType,
    bundle_adjust,
)

__all__ = [
    "bundle_adjust_reconstruction",
    "bundle_adjust_partial_reconstruction",
    "bundle_adjust_views",
    "bundle_adjust_tracks",
    "bundle_adjust_view",
    "bundle_adjust_track",
    "bundle_adjust_views_with_cov",
    "bundle_adjust_view_with_cov",
    "bundle_adjust_tracks_with_cov",
    "bundle_adjust_track_with_cov",
]


def _pad_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_bucket(n: int, floor: int = 16) -> int:
    """Shape bucket: pow2 up to 64k, then multiples of 64k. Pure pow2
    wastes up to 2x work on big observation tables (600k obs -> 1M rows
    was ~1.7x extra BA wall-clock at Piccadilly scale); 64k steps keep
    the jit-cache hit rate while bounding padding waste at ~10%."""
    if n <= 65536:
        return _pad_pow2(n, floor)
    return -(-n // 65536) * 65536


def _pad_soft(n: int, floor: int, pow2_until: int, step: int) -> int:
    """Pow2 buckets while small (jit-cache reuse as the scene grows),
    fixed steps once large (pow2 waste on the track/view axes multiplies
    every slot-layout cost — 100k tracks -> 131k was 31% extra BA work)."""
    if n <= pow2_until:
        return _pad_pow2(n, floor)
    return -(-n // step) * step


def _gather_problem(recon, view_sel, track_sel, dtype):
    """Build the padded flat BA problem from the host container.

    view_sel/track_sel: boolean arrays — which views/tracks PARTICIPATE
    (residuals included). Observations of non-participating views/tracks are
    excluded entirely, matching BundleAdjustPartialReconstruction.
    """
    ov, ot = recon.obs_view, recon.obs_track
    rows = np.where(view_sel[ov] & track_sel[ot])[0]
    O = len(rows)
    Opad = _pad_bucket(max(O, 1))

    # Camera models present among participating groups; the kernel
    # dispatches per observation via the group's index into this tuple.
    groups_used = {int(g) for g in np.unique(recon.view_group[view_sel])}
    present = tuple(
        sorted({int(recon.group_model[g]) for g in groups_used} or {0})
    )
    model = present[0]

    P = recon.intrinsics.shape[1]
    intr_rows = np.zeros((Opad, P), dtype)
    obs_view = np.zeros((Opad,), np.int32)
    obs_track = np.zeros((Opad,), np.int32)
    obs_uv = np.zeros((Opad, 2), dtype)
    obs_info = np.ones((Opad, 2), dtype)
    obs_mask = np.zeros((Opad,), bool)

    obs_view[:O] = ov[rows]
    obs_track[:O] = ot[rows]
    obs_uv[:O] = recon.obs_uv[rows]
    obs_info[:O] = recon.obs_sqrt_inv_cov[rows]
    obs_mask[:O] = True
    intr_rows[:O] = recon.intrinsics[recon.view_group[ov[rows]]]

    w = recon.points[:, 3:4]
    pts3 = recon.points[:, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)
    return dict(
        extrinsics=recon.view_extrinsics.astype(dtype),
        points=pts3.astype(dtype),
        intrinsics_rows=intr_rows,
        obs_view=obs_view,
        obs_track=obs_track,
        obs_uv=obs_uv,
        obs_sqrt_info=obs_info,
        obs_mask=obs_mask,
        model=model,
        present_models=present,
    )


def _slot_layout(prob, num_tracks: int, dtype):
    """Regroup the flat masked observation table into the padded [T, L]
    track-slot layout consumed by `bundle_adjust_dense`. L is bucketed to
    the next power of two (floor 4) so repeated calls share jit caches."""
    m = prob["obs_mask"]
    rows = np.where(m)[0]
    if len(rows) == 0:
        return None
    ot = prob["obs_track"][rows]
    order = np.argsort(ot, kind="stable")
    rows = rows[order]
    ot = ot[order]
    counts = np.bincount(ot, minlength=num_tracks)
    L = _pad_soft(max(int(counts.max()), 1), 4, 4, 2)
    starts = np.zeros(num_tracks + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(rows)) - starts[ot]
    track_views = np.zeros((num_tracks, L), np.int32)
    uv = np.zeros((num_tracks, L, 2), dtype)
    info = np.ones((num_tracks, L, 2), dtype)
    mask = np.zeros((num_tracks, L), bool)
    track_views[ot, pos] = prob["obs_view"][rows]
    uv[ot, pos] = prob["obs_uv"][rows]
    info[ot, pos] = prob["obs_sqrt_info"][rows]
    mask[ot, pos] = True
    return dict(track_views=track_views, uv=uv, info=info, mask=mask, L=L)


def _rowchunk_layout(slot, num_views: int):
    """Build the view-rowchunk layout (`ba/iterative_schur.py` module doc)
    from the track-slot layout: observations sorted by view, split into
    rows of up to C per view, each row slot indexing back into the flat
    [T*L] track layout. C is chosen from pow2 candidates to minimize
    padded slots; R pads to a pow2 bucket for jit-cache reuse."""
    mask = slot["mask"]
    tv = slot["track_views"]
    flat = np.nonzero(mask.reshape(-1))[0]
    if len(flat) == 0:
        return None
    v_of = tv.reshape(-1)[flat]
    order = np.argsort(v_of, kind="stable")
    flat = flat[order]
    v_sorted = v_of[order]
    counts = np.bincount(v_sorted, minlength=num_views)
    best = None
    for cand in (64, 128, 256, 512, 1024):
        padded = int(np.sum(-(-counts // cand)) * cand)
        if best is None or padded < best[1]:
            best = (cand, padded)
    C = best[0]
    rows_per_view = -(-counts // C)
    R = int(rows_per_view.sum())
    Rp = _pad_soft(max(R, 1), 16, 2048, 512)
    row_view = np.zeros((Rp,), np.int32)
    rc_src = np.zeros((Rp, C), np.int32)
    rc_mask = np.zeros((Rp, C), bool)
    row_base = np.zeros(num_views + 1, np.int64)
    np.cumsum(rows_per_view, out=row_base[1:])
    starts = np.zeros(num_views + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    p = np.arange(len(flat)) - starts[v_sorted]
    row_id = row_base[v_sorted] + p // C
    col = p % C
    rc_src[row_id, col] = flat
    rc_mask[row_id, col] = True
    row_view[:R] = np.repeat(
        np.arange(num_views, dtype=np.int32), rows_per_view
    )
    return dict(row_view=row_view, rc_src=rc_src, rc_mask=rc_mask, R=Rp, C=C)


def _rodrigues_np(aa, pts):
    """Rotate pts [N,3] by angle-axis aa [N,3] (host-side numpy)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = aa / safe
    c = np.cos(theta)
    s = np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=-1, keepdims=True)
    out = pts * c + kxp * s + k * kdp * (1.0 - c)
    return np.where(theta < 1e-12, pts, out)


def _run(
    recon,
    view_sel,
    track_sel,
    camera_free,
    point_free,
    options,
    dtype,
    orientation_constant: bool = False,
):
    import jax.numpy as jnp

    from ..models.intrinsics import intrinsics_subset_mask

    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    # Pad parameter axes so the jitted kernel is reused as the scene grows.
    V, T = recon.num_views(), recon.num_tracks()
    G = recon.intrinsics.shape[0]
    P = recon.intrinsics.shape[1]
    Vp = _pad_soft(V, 8, 512, 256)
    # Track-axis step 16384 once the problem is big enough to hit the
    # iterative kernel's chunked build: divisibility by the preferred scan
    # chunk (16384 measured 1.6x faster than 8192 at Trafalgar scale —
    # fewer serialization points) is worth more than the <=6% extra
    # padding; smaller problems keep the tighter 8192 step.
    Tp = _pad_soft(T, 64, 16384, 16384 if T > 150_000 else 8192)
    mesh = options.mesh
    if mesh is not None:
        # The track axis divides across the mesh (dense path shard_maps it;
        # the iterative path shards its slot arrays over it).
        n_dev = int(np.prod(list(mesh.shape.values())))
        Tp = -(-Tp // n_dev) * n_dev
    # G == 1 keeps its own bucket: the iterative kernel's exact intrinsics
    # elimination specializes on a single shared group.
    Gp = 1 if G <= 1 else _pad_pow2(G, 4)
    ext_in = np.zeros((Vp, 6), dtype)
    ext_in[:V] = prob["extrinsics"]

    # Intrinsics groups: values, view->group, per-group model index into the
    # static present_models tuple, and the per-group free-subset mask
    # (OptimizeIntrinsicsType applied per model, camera_intrinsics_model.h:118).
    present = prob["present_models"]
    intr_in = np.zeros((Gp, P), dtype)
    intr_in[:, 0] = 1.0
    intr_in[:, 1] = 1.0
    intr_in[:G] = recon.intrinsics.astype(dtype)
    view_group = np.zeros((Vp,), np.int32)
    view_group[:V] = recon.view_group
    group_model_idx = np.zeros((Gp,), np.int32)
    intr_free = np.zeros((Gp, P), bool)
    flags = options.intrinsics_to_optimize
    # Only groups owning at least one participating view get free intrinsics
    # (the reference never moves parameter blocks with no residuals).
    free_groups = (
        {int(g) for g in np.unique(recon.view_group[:V][view_sel[:V]])}
        if flags
        else set()
    )
    for g in range(G):
        m = int(recon.group_model[g])
        group_model_idx[g] = present.index(m) if m in present else 0
        if flags and g in free_groups:
            intr_free[g] = intrinsics_subset_mask(recon.group_model[g], flags)[:P]

    # Track parametrization (bundle_adjustment.h:127-131).
    tp = options.track_parametrization_type
    track_ref = np.zeros((Tp,), np.int32)
    track_bearing = np.zeros((Tp, 3), dtype)
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        pts_in = np.zeros((Tp, 1), dtype)
        ref = np.asarray(recon.track_reference_view[:T], np.int64)
        valid_ref = ref >= 0
        ref_safe = np.where(valid_ref, ref, 0)
        c_ref = recon.view_extrinsics[ref_safe, :3]
        aa_ref = recon.view_extrinsics[ref_safe, 3:]
        p_ref = _rodrigues_np(aa_ref, prob["points"][:T] - c_ref)
        depth = np.linalg.norm(p_ref, axis=-1)
        depth = np.where(depth < 1e-9, 1e-9, depth)
        # Bearing from the OBSERVED feature ray in the reference view (the
        # reference stores the undistorted feature bearing, track.h:84 —
        # using the current point estimate instead would freeze its lateral
        # error into the parametrization).
        bearing = p_ref / depth[:, None]
        from ..models.intrinsics import pixel_to_camera

        for g in range(G):
            m = recon.group_model[g]
            rows = [
                (t, recon._view_track_to_obs[int(ref_safe[t])].get(t))
                for t in range(T)
                if valid_ref[t] and int(recon.view_group[ref_safe[t]]) == g
            ]
            rows = [(t, r) for (t, r) in rows if r is not None]
            if not rows:
                continue
            t_idx = np.asarray([t for t, _ in rows])
            uv = recon.obs_uv[[r for _, r in rows]]
            ray = np.asarray(
                pixel_to_camera(
                    np.asarray(recon.intrinsics[g], dtype)[None, :],
                    np.asarray(uv, dtype),
                    m,
                )
            )
            n = np.linalg.norm(ray, axis=-1, keepdims=True)
            bearing[t_idx] = ray / np.where(n < 1e-12, 1.0, n)
            # Depth along the observed ray = projection of the current point.
            depth_ray = np.sum(p_ref[t_idx] * bearing[t_idx], axis=-1)
            depth[t_idx] = np.where(depth_ray > 1e-9, depth_ray, depth[t_idx])
        track_ref[:T] = ref_safe.astype(np.int32)
        track_bearing[:T] = bearing.astype(dtype)
        pts_in[:T, 0] = (1.0 / depth).astype(dtype)
        point_free = point_free & valid_ref
    elif tp == TrackParametrizationType.XYZW_MANIFOLD:
        pts_in = np.zeros((Tp, 4), dtype)
        pts_in[:, 3] = 1.0
        p4 = recon.points[:T].astype(np.float64)
        n = np.linalg.norm(p4, axis=-1, keepdims=True)
        pts_in[:T] = (p4 / np.where(n < 1e-12, 1.0, n)).astype(dtype)
    else:
        pts_in = np.zeros((Tp, 3), dtype)
        pts_in[:T] = prob["points"]

    if orientation_constant:
        # Per-DOF mask: positions free, angle-axis rows frozen (HSfM-style).
        cam_free_p = np.zeros((Vp, 6), bool)
        cam_free_p[:V, :3] = camera_free[:, None]
    else:
        cam_free_p = np.zeros(Vp, bool)
        cam_free_p[:V] = camera_free
    pt_free_p = np.zeros(Tp, bool)
    pt_free_p[:T] = point_free

    # View priors (position/orientation/gravity, bundle_adjuster.cc:292-313).
    priors = None
    if (
        options.use_position_priors
        or options.use_orientation_priors
        or options.use_gravity_priors
    ):
        pp = np.zeros((Vp, 3), dtype)
        psi = np.zeros((Vp, 3, 3), dtype)
        pm = np.zeros((Vp,), dtype)
        op = np.zeros((Vp, 3), dtype)
        osi = np.zeros((Vp, 3, 3), dtype)
        om = np.zeros((Vp,), dtype)
        gp = np.zeros((Vp, 3), dtype)
        gsi = np.zeros((Vp, 3, 3), dtype)
        gm = np.zeros((Vp,), dtype)
        for v, vp in enumerate(recon.view_priors):
            if not view_sel[v]:
                continue
            if options.use_position_priors and vp.position is not None:
                pp[v] = np.asarray(vp.position, dtype)
                psi[v] = (
                    np.asarray(vp.position_sqrt_information, dtype)
                    if vp.position_sqrt_information is not None
                    else np.eye(3, dtype=dtype)
                )
                pm[v] = 1.0
            if options.use_orientation_priors and vp.orientation is not None:
                op[v] = np.asarray(vp.orientation, dtype)
                osi[v] = (
                    np.asarray(vp.orientation_sqrt_information, dtype)
                    if vp.orientation_sqrt_information is not None
                    else np.eye(3, dtype=dtype)
                )
                om[v] = 1.0
            if options.use_gravity_priors and vp.gravity is not None:
                gp[v] = np.asarray(vp.gravity, dtype)
                gsi[v] = (
                    np.asarray(vp.gravity_sqrt_information, dtype)
                    if vp.gravity_sqrt_information is not None
                    else np.eye(3, dtype=dtype)
                )
                gm[v] = 1.0
        priors = tuple(
            jnp.asarray(a) for a in (pp, psi, pm, op, osi, om, gp, gsi, gm)
        )

    O_real = int(np.sum(prob["obs_mask"]))

    # Solver dispatch (reference parity: Ceres SPARSE_SCHUR below
    # min_cameras_for_iterative_solver=1000, ITERATIVE_SCHUR above —
    # `reconstruction_estimator_options.h:291-300`):
    #   dense matmul Schur      — frozen intrinsics, V <= 1024, short tracks
    #   rowchunk iterative   — everything else slot-layout-able, incl.
    #                          free intrinsics and V > 1024
    #   flat implicit PCG    — INVERSE_DEPTH or degenerate slot layouts
    slot = None
    rowchunk = None
    if tp != TrackParametrizationType.INVERSE_DEPTH:
        slot = _slot_layout(prob, Tp, dtype)
    want_dense = options.linear_solver_type in (
        LinearSolverType.AUTO,
        LinearSolverType.DENSE_SCHUR,
    )
    if options.linear_solver_type == LinearSolverType.AUTO:
        want_dense = want_dense and Vp <= DENSE_SCHUR_MAX_CAMERAS
    use_dense = (
        want_dense
        and not flags
        and slot is not None
        and slot["L"] <= 32  # dense slot padding would explode past this
    )
    if slot is not None and not use_dense:
        # Rowchunk kernel unless slot padding dwarfs the real problem
        # (one pathologically long track inflates every track's row), or
        # the slot tensors exceed the kernel's memory envelope (the tiny
        # minor dims of the [T, L, 6, ~10] block intermediates can be
        # padded many times over). The 4M-slot envelope was sized on
        # another accelerator and is untuned on the H100.
        if Tp * slot["L"] <= min(max(4 * O_real, 1 << 16), 4_000_000):
            rowchunk = _rowchunk_layout(slot, Vp)
        if rowchunk is None:
            slot = None

    if use_dense:
        ext, intr_out, pts, summary = bundle_adjust_dense(
            jnp.asarray(ext_in),
            jnp.asarray(intr_in),
            jnp.asarray(pts_in),
            jnp.asarray(view_group),
            jnp.asarray(group_model_idx),
            jnp.asarray(slot["track_views"]),
            jnp.asarray(slot["uv"]),
            jnp.asarray(slot["info"]),
            jnp.asarray(slot["mask"]),
            jnp.asarray(cam_free_p),
            jnp.asarray(pt_free_p),
            present_models=present,
            num_views=Vp,
            num_tracks=Tp,
            max_track_len=slot["L"],
            num_groups=Gp,
            options=options,
            priors=priors,
            mesh=mesh,
        )
    elif rowchunk is not None:
        track_arrays = (
            jnp.asarray(slot["track_views"]),
            jnp.asarray(slot["uv"]),
            jnp.asarray(slot["info"]),
            jnp.asarray(slot["mask"]),
        )
        row_arrays = (
            jnp.asarray(rowchunk["row_view"]),
            jnp.asarray(rowchunk["rc_src"]),
            jnp.asarray(rowchunk["rc_mask"]),
        )
        if mesh is not None:
            # Slot arrays sharded over the track axis, rowchunk arrays
            # over the row axis, parameters replicated — GSPMD inserts
            # the cross-layout collectives.
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as PS

            ax = mesh.axis_names[0]
            sh = NamedSharding(mesh, PS(ax))
            track_arrays = tuple(
                jax.device_put(a, sh) for a in track_arrays
            )
            row_arrays = tuple(jax.device_put(a, sh) for a in row_arrays)
        ext, intr_out, pts, summary = bundle_adjust_iterative(
            jnp.asarray(ext_in),
            jnp.asarray(intr_in),
            jnp.asarray(pts_in),
            jnp.asarray(view_group),
            jnp.asarray(group_model_idx),
            *track_arrays,
            *row_arrays,
            jnp.asarray(cam_free_p),
            jnp.asarray(pt_free_p),
            jnp.asarray(intr_free),
            present_models=present,
            num_views=Vp,
            num_tracks=Tp,
            max_track_len=slot["L"],
            num_rows=rowchunk["R"],
            row_chunk=rowchunk["C"],
            num_groups=Gp,
            options=options,
            priors=priors,
        )
    else:
        ext, intr_out, pts, summary = bundle_adjust(
            jnp.asarray(ext_in),
            jnp.asarray(intr_in),
            jnp.asarray(pts_in),
            jnp.asarray(view_group),
            jnp.asarray(group_model_idx),
            jnp.asarray(prob["obs_view"]),
            jnp.asarray(prob["obs_track"]),
            jnp.asarray(prob["obs_uv"]),
            jnp.asarray(prob["obs_sqrt_info"]),
            jnp.asarray(prob["obs_mask"]),
            jnp.asarray(cam_free_p),
            jnp.asarray(pt_free_p),
            jnp.asarray(intr_free),
            jnp.asarray(track_ref),
            jnp.asarray(track_bearing),
            present_models=present,
            num_views=Vp,
            num_tracks=Tp,
            num_groups=Gp,
            options=options,
            priors=priors,
        )
    # ONE batched device->host pull for the solution arrays AND the summary
    # scalars (see utils/fetch.py: block once, then copy all leaves, instead
    # of one blocking np.asarray/float() each). Materializing the summary
    # here also makes every
    # downstream float(summary.final_cost)/int(summary.num_iterations) free.
    from ..utils.fetch import fetch

    ext, pts, intr_out, summary = fetch((ext, pts, intr_out, summary))
    ext = np.asarray(ext, recon.dtype)[:V]
    pts = np.asarray(pts, recon.dtype)[:T]
    recon.view_extrinsics[camera_free] = ext[camera_free]
    if flags:
        intr_out = np.asarray(intr_out, recon.dtype)[:G]
        moved = intr_free[:G].any(axis=-1)
        recon.intrinsics[moved] = intr_out[moved]
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        rho = pts[:, 0]
        recon.track_inverse_depth[point_free] = rho[point_free]
        depth = 1.0 / np.where(np.abs(rho) < 1e-12, 1e-12, rho)
        ref = track_ref[:T].astype(np.int64)
        c_ref = recon.view_extrinsics[ref, :3]
        aa_ref = recon.view_extrinsics[ref, 3:]
        p_world = c_ref + _rodrigues_np(
            -aa_ref, np.asarray(track_bearing[:T], np.float64) * depth[:, None]
        )
        recon.points[point_free, :3] = p_world[point_free]
        recon.points[point_free, 3] = 1.0
    elif tp == TrackParametrizationType.XYZW_MANIFOLD:
        recon.points[point_free] = pts[point_free]
    else:
        recon.points[point_free, :3] = pts[point_free]
        recon.points[point_free, 3] = 1.0
    return summary


def bundle_adjust_reconstruction(
    options: BundleAdjustmentOptions, recon, dtype=np.float32
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustReconstruction`
    (`bundle_adjustment.cc:188`) — all estimated views + tracks."""
    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    return _run(recon, view_sel, track_sel, view_sel, track_sel, options, dtype)


def bundle_adjust_partial_reconstruction(
    options: BundleAdjustmentOptions,
    views_to_optimize,
    tracks_to_optimize,
    recon,
    dtype=np.float32,
    orientation_constant: bool = False,
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustPartialReconstruction`
    (`bundle_adjustment.h:188`): only the given views/tracks move; their
    residuals still couple to estimated-but-constant neighbors.
    `orientation_constant=True` freezes camera orientations (hybrid/HSfM)."""
    V, T = recon.num_views(), recon.num_tracks()
    cam_free = np.zeros(V, bool)
    pt_free = np.zeros(T, bool)
    for v in views_to_optimize:
        if recon.view_estimated[v]:
            cam_free[v] = True
    for t in tracks_to_optimize:
        if recon.track_estimated[t]:
            pt_free[t] = True
    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    return _run(
        recon, view_sel, track_sel, cam_free, pt_free, options, dtype,
        orientation_constant=orientation_constant,
    )


def bundle_adjust_views(
    options: BundleAdjustmentOptions, view_ids, recon, dtype=np.float32
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustViews` (`bundle_adjustment.h:199`):
    optimize the given views with all tracks constant."""
    return bundle_adjust_partial_reconstruction(
        options, view_ids, [], recon, dtype
    )


def bundle_adjust_view(options, view_id, recon, dtype=np.float32):
    """Parity: `theia::BundleAdjustView` (`bundle_adjustment.h:195`)."""
    return bundle_adjust_views(options, [view_id], recon, dtype)


def bundle_adjust_tracks(
    options: BundleAdjustmentOptions, track_ids, recon, dtype=np.float32
) -> BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustTracks` (`bundle_adjustment.h:214`):
    optimize the given tracks with all views constant."""
    return bundle_adjust_partial_reconstruction(
        options, [], track_ids, recon, dtype
    )


def bundle_adjust_track(options, track_id, recon, dtype=np.float32):
    """Parity: `theia::BundleAdjustTrack` (`bundle_adjustment.h:206`)."""
    return bundle_adjust_tracks(options, [track_id], recon, dtype)


def compute_reconstruction_covariance(
    options: BundleAdjustmentOptions,
    recon,
    constant_views=(),
    dtype=np.float64,
    view_ids=None,
    track_ids=None,
):
    """Joint-problem marginal covariances — the general `ceres::Covariance`
    case on the FULL problem (`bundle_adjuster.cc:660-744`), not the
    block-diagonal other-group-constant approximation of the `*WithCov`
    entries.

    `constant_views`: views held constant to fix the gauge (covariance of
    a gauge-free BA problem is singular — the reference expects the same).
    Returns ({view_id: [6,6]}, {track_id: [3,3]}, variance_factor).

    Two paths, same semantics:
      * `view_ids is None` (everything): exact dense Schur inversion
        (`ba/dense_schur.joint_covariance_dense`) — bounded to
        `DENSE_SCHUR_MAX_CAMERAS` padded views / slot length 32 (it
        materializes the [6V, 6V] complement); larger problems raise
        with a pointer to the selected-block path.
      * `view_ids` given: matrix-free selected-block path
        (`ba/covariance.selected_covariance_pcg`) — block-Jacobi PCG
        solves only the requested columns of S^-1, so it works at ANY
        scale (this is how `ceres::Covariance` stays feasible on large
        problems). `track_ids` marginals additionally need the S^-1
        columns of their observing views, which are added to the solve
        set automatically.
    """
    from .dense_schur import joint_covariance_dense

    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    V, T = recon.num_views(), recon.num_tracks()
    Vp, Tp = _pad_pow2(V, 8), _pad_pow2(T, 64)
    selected = view_ids is not None
    if not selected and Vp > DENSE_SCHUR_MAX_CAMERAS:
        raise ValueError(
            f"compute_reconstruction_covariance(view_ids=None) "
            f"materializes a dense [{6 * Vp}, {6 * Vp}] Schur complement; "
            f"supported up to {DENSE_SCHUR_MAX_CAMERAS} (padded) views, "
            f"got {V}. Pass view_ids=/track_ids= for the matrix-free "
            f"selected-block path (any scale), or use "
            f"bundle_adjust_views_with_cov / bundle_adjust_tracks_with_cov."
        )
    slot = _slot_layout(prob, Tp, dtype)
    if slot is None:
        return {}, {}, 0.0
    if not selected and slot["L"] > 32:
        raise ValueError(
            f"compute_reconstruction_covariance gathers [T, L, L, 6, 6] "
            f"blocks; supported up to slot length 32, got L={slot['L']}. "
            f"Pass view_ids= for the selected-block path."
        )
    ext = np.zeros((Vp, 6), dtype)
    ext[:V] = prob["extrinsics"]
    pts = np.zeros((Tp, 3), dtype)
    pts[:T] = prob["points"]
    G = recon.intrinsics.shape[0]
    P = recon.intrinsics.shape[1]
    Gp = _pad_pow2(max(G, 1), 4)
    intr_in = np.zeros((Gp, P), dtype)
    intr_in[:, 0] = 1.0
    intr_in[:, 1] = 1.0
    intr_in[:G] = recon.intrinsics.astype(dtype)
    view_group = np.zeros((Vp,), np.int32)
    view_group[:V] = recon.view_group
    groups_used = {int(g) for g in np.unique(recon.view_group[:V])}
    present = tuple(sorted({int(recon.group_model[g]) for g in groups_used} or {0}))
    group_model_idx = np.zeros((Gp,), np.int32)
    for g in range(G):
        m = int(recon.group_model[g])
        group_model_idx[g] = present.index(m) if m in present else 0

    cam_free = np.zeros(Vp, bool)
    cam_free[:V] = view_sel
    for v in constant_views:
        cam_free[v] = False
    pt_free = np.zeros(Tp, bool)
    pt_free[:T] = track_sel

    import jax.numpy as jnp

    common_args = (
        jnp.asarray(ext),
        jnp.asarray(intr_in),
        jnp.asarray(pts),
        jnp.asarray(view_group),
        jnp.asarray(group_model_idx),
        jnp.asarray(slot["track_views"]),
        jnp.asarray(slot["uv"]),
        jnp.asarray(slot["info"]),
        jnp.asarray(slot["mask"]),
        jnp.asarray(cam_free),
        jnp.asarray(pt_free),
    )
    common_kw = dict(
        present_models=present,
        num_views=Vp,
        num_tracks=Tp,
        max_track_len=slot["L"],
        num_groups=Gp,
        options=options,
    )
    if selected:
        from .covariance import selected_covariance_pcg

        req_views = [int(v) for v in view_ids if cam_free[v]]
        req_tracks = [
            int(t) for t in (track_ids or ()) if pt_free[t]
        ]
        # Track marginals need S^-1 columns at their observing views.
        solve_views = list(dict.fromkeys(req_views))
        have = set(solve_views)
        for t in req_tracks:
            for row in recon.track_observations(t):
                v = int(recon.obs_view[row])
                if cam_free[v] and v not in have:
                    have.add(v)
                    solve_views.append(v)
        if not solve_views:
            return {}, {}, 0.0
        # Pad the selection to a pow2 so repeated queries share compiles.
        Kp = _pad_pow2(len(solve_views), 4)
        sel_v = np.full((Kp,), solve_views[0], np.int32)
        sel_v[: len(solve_views)] = solve_views
        Ktp = _pad_pow2(max(len(req_tracks), 1), 4)
        sel_t = np.zeros((Ktp,), np.int32)
        sel_t[: len(req_tracks)] = req_tracks
        cam_cov, track_cov, cost, nres, cg_res = selected_covariance_pcg(
            *common_args,
            jnp.asarray(sel_v),
            jnp.asarray(sel_t),
            **common_kw,
        )
        cam_cov = np.asarray(cam_cov)
        track_cov = np.asarray(track_cov)
        n_params = 6 * int(cam_free[:V].sum()) + 3 * int(pt_free[:T].sum())
        dof = max(int(nres) - n_params, 1)
        variance_factor = 2.0 * float(cost) / dof
        pos = {v: i for i, v in enumerate(solve_views)}
        cam_out = {
            v: cam_cov[pos[v]] * variance_factor for v in req_views
        }
        track_out = {
            t: track_cov[i] * variance_factor
            for i, t in enumerate(req_tracks)
        }
        return cam_out, track_out, variance_factor

    cam_cov, track_cov, cost, nres = joint_covariance_dense(
        *common_args, **common_kw
    )
    cam_cov = np.asarray(cam_cov)
    track_cov = np.asarray(track_cov)
    n_params = 6 * int(cam_free[:V].sum()) + 3 * int(pt_free[:T].sum())
    dof = max(int(nres) - n_params, 1)
    variance_factor = 2.0 * float(cost) / dof
    cam_out = {
        v: cam_cov[v] * variance_factor
        for v in range(V)
        if cam_free[v]
    }
    track_out = {
        t: track_cov[t] * variance_factor
        for t in range(T)
        if pt_free[t]
    }
    return cam_out, track_out, variance_factor


def _covariance_blocks(recon, options, dtype):
    """Hessian blocks + empirical variance factor for the current state."""
    import jax.numpy as jnp

    from .lm import hessian_blocks

    view_sel = recon.view_estimated.copy()
    track_sel = recon.track_estimated.copy()
    prob = _gather_problem(recon, view_sel, track_sel, dtype)
    V, T = recon.num_views(), recon.num_tracks()
    Vp, Tp = _pad_pow2(V, 8), _pad_pow2(T, 64)
    ext = np.zeros((Vp, 6), dtype)
    ext[:V] = prob["extrinsics"]
    pts = np.zeros((Tp, 3), dtype)
    pts[:T] = prob["points"]
    U, Vt, cost, n_obs = hessian_blocks(
        jnp.asarray(ext),
        jnp.asarray(pts),
        jnp.asarray(prob["intrinsics_rows"]),
        jnp.asarray(prob["obs_view"]),
        jnp.asarray(prob["obs_track"]),
        jnp.asarray(prob["obs_uv"]),
        jnp.asarray(prob["obs_sqrt_info"]),
        jnp.asarray(prob["obs_mask"]),
        model=prob["model"],
        num_views=Vp,
        num_tracks=Tp,
        options=options,
    )
    return np.asarray(U)[:V], np.asarray(Vt)[:T], float(cost), int(n_obs)


def bundle_adjust_views_with_cov(
    options: BundleAdjustmentOptions, view_ids, recon, dtype=np.float32
):
    """Parity: `theia::BundleAdjustViews` with covariance
    (`bundle_adjustment.h:246-250`): optimize the views (tracks constant),
    then return per-view 6x6 empirical covariances and the empirical
    variance factor sigma^2 = 2*cost / (num_residuals - num_params).
    """
    summary = bundle_adjust_views(options, view_ids, recon, dtype)
    U, _, cost, n_obs = _covariance_blocks(recon, options, dtype)
    dof = max(2 * n_obs - 6 * len(view_ids), 1)
    variance_factor = 2.0 * cost / dof
    covariances = {}
    for v in view_ids:
        try:
            cov = np.linalg.inv(U[v].astype(np.float64))
        except np.linalg.LinAlgError:
            return summary, None, None
        covariances[v] = cov * variance_factor
    return summary, covariances, variance_factor


def bundle_adjust_view_with_cov(options, view_id, recon, dtype=np.float32):
    """Parity: `theia::BundleAdjustView` with covariance
    (`bundle_adjustment.h:239-243`)."""
    summary, covs, vf = bundle_adjust_views_with_cov(
        options, [view_id], recon, dtype
    )
    return summary, (covs or {}).get(view_id), vf


def bundle_adjust_tracks_with_cov(
    options: BundleAdjustmentOptions, track_ids, recon, dtype=np.float32
):
    """Parity: `theia::BundleAdjustTracks` with covariance
    (`bundle_adjustment.h:230-236`): per-track 3x3 covariances."""
    summary = bundle_adjust_tracks(options, track_ids, recon, dtype)
    _, Vt, cost, n_obs = _covariance_blocks(recon, options, dtype)
    dof = max(2 * n_obs - 3 * len(track_ids), 1)
    variance_factor = 2.0 * cost / dof
    covariances = {}
    for t in track_ids:
        try:
            cov = np.linalg.inv(Vt[t].astype(np.float64))
        except np.linalg.LinAlgError:
            return summary, None, None
        covariances[t] = cov * variance_factor
    return summary, covariances, variance_factor


def bundle_adjust_track_with_cov(options, track_id, recon, dtype=np.float32):
    """Parity: `theia::BundleAdjustTrack` with covariance
    (`bundle_adjustment.h:223-228`)."""
    summary, covs, vf = bundle_adjust_tracks_with_cov(
        options, [track_id], recon, dtype
    )
    return summary, (covs or {}).get(track_id), vf
