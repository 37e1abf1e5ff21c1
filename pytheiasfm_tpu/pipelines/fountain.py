"""Fountain-11 tracks -> reconstruction -> Sim3 ATE pipeline.

Library form of the benchmark of `docs/content/performance.md:20`
(reference: median 2.0 mm, mean 2.4 mm, 11/11 cameras, 1.76 s total on a
2016 CPU): load the reference's own serialized feature tracks
(`data/sfm/fountain11.bin`), discard all solved geometry, run two-view
geometric verification + a full reconstruction estimator on the device, and
report the Sim3-aligned camera-center error versus the Strecha GT
(`data/sfm/gt_fountain11.bin`) — the metric of the reference's
`examples/vismatch_sfm/sfm_eval_dataset.py`.

Performance notes (the round-3 wall-clock work):
  - every device call here is shape-bucketed (pair chunks padded to a
    fixed size, pow-2 correspondence padding) so REPEATED runs reuse the
    in-process jit cache entirely — the second run measures device time;
  - `utils.cache.enable_persistent_cache()` (called by the CLI drivers)
    persists compiled executables across processes, amortizing the
    compile cost the way a C++ library amortizes its build.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = [
    "DEFAULT_FOUNTAIN",
    "DEFAULT_GT",
    "load_fountain",
    "strip_geometry",
    "build_view_graph",
    "run_estimator",
    "sim3_ate_mm",
    "evaluate",
]

DEFAULT_FOUNTAIN = "/root/reference/data/sfm/fountain11.bin"
DEFAULT_GT = "/root/reference/data/sfm/gt_fountain11.bin"


def load_fountain(path: str = DEFAULT_FOUNTAIN):
    from ..io.theia_recon import read_theia_reconstruction

    return read_theia_reconstruction(path)


def strip_geometry(recon, max_tracks=None, seed=0):
    """Forget everything the reference solved: poses, points, estimated
    flags. Keep views, intrinsics priors, and the observation table
    (= the matched feature tracks). Optionally subsample tracks."""
    recon.view_extrinsics[:] = 0.0
    recon.view_estimated[:] = False
    recon.points[:] = 0.0
    recon.track_estimated[:] = False
    recon.set_camera_intrinsics_from_priors()
    if max_tracks is not None and recon.num_tracks() > max_tracks:
        lengths = np.asarray(
            [len(recon.track_observations(t)) for t in range(recon.num_tracks())]
        )
        order = np.argsort(-lengths, kind="stable")
        keep = np.zeros(recon.num_tracks(), bool)
        keep[order[:max_tracks]] = True
        return _subsample_tracks(recon, keep)
    return recon


def _subsample_tracks(recon, keep):
    from ..sfm.reconstruction import Reconstruction

    out = Reconstruction(recon.dtype)
    for v in range(recon.num_views()):
        out.add_view(
            recon.view_names[v],
            group_id=int(recon.view_group[v]),
            timestamp=recon.view_timestamps[v],
            prior=recon.view_priors[v],
        )
    out.view_group = recon.view_group.copy()
    out.intrinsics = recon.intrinsics.copy()
    out.group_model = list(recon.group_model)
    for t in range(recon.num_tracks()):
        if not keep[t]:
            continue
        nt = out.add_track()
        for row in recon.track_observations(t):
            out.add_observation(
                int(recon.obs_view[row]),
                nt,
                recon.obs_uv[row],
                recon.obs_sqrt_inv_cov[row],
            )
    return out


def _pair_correspondences(recon, min_inliers):
    """Vectorized host-side pair assembly from the track table.

    Replaces the per-track/per-pair Python dict loop (round-2
    `tools/sfm_eval_fountain.py:99-129`) with numpy: sort observations by
    track, enumerate within-track pairs via offset slicing, then bucket by
    (va, vb) with lexsort. ~100x less Python interpretation.
    """
    O = len(recon.obs_view)
    ot = np.asarray(recon.obs_track[:O])
    order = np.argsort(ot, kind="stable")
    ot_s = ot[order]
    counts = np.bincount(ot_s, minlength=recon.num_tracks())
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    Lmax = int(counts.max()) if len(counts) else 0

    # All within-track ordered pairs (i < j) via slot-offset enumeration.
    ra_list, rb_list = [], []
    pos = np.arange(len(ot_s)) - starts[ot_s]
    for d in range(1, Lmax):
        sel = (pos + d) < counts[ot_s]
        ra_list.append(order[sel])
        rb_list.append(order[np.nonzero(sel)[0] + d])
    if not ra_list:
        return [], {}
    ra = np.concatenate(ra_list)
    rb = np.concatenate(rb_list)
    va = np.asarray(recon.obs_view)[ra]
    vb = np.asarray(recon.obs_view)[rb]
    swap = va > vb
    va2 = np.where(swap, vb, va)
    vb2 = np.where(swap, va, vb)
    ra2 = np.where(swap, rb, ra)
    rb2 = np.where(swap, ra, rb)

    key = va2.astype(np.int64) * recon.num_views() + vb2
    sort2 = np.argsort(key, kind="stable")
    key_s = key[sort2]
    uniq, first = np.unique(key_s, return_index=True)
    ends = np.append(first[1:], len(key_s))
    pairs = []
    pair_rows = {}
    for k, lo, hi in zip(uniq, first, ends):
        if hi - lo < min_inliers:
            continue
        p = (int(k // recon.num_views()), int(k % recon.num_views()))
        pairs.append(p)
        pair_rows[p] = (ra2[sort2[lo:hi]], rb2[sort2[lo:hi]])
    return pairs, pair_rows


def build_view_graph(recon, seed=0, min_inliers=30, max_ransac_iterations=256):
    """Two-view geometric verification over all co-observing pairs
    (parity: the matcher -> EstimateTwoViewInfo loop of
    `pytests/sfm_pipeline.py:136` driven from the track table)."""
    import jax

    from ..sfm.two_view import (
        EstimateTwoViewInfoOptions,
        estimate_two_view_info_batch,
    )
    from ..sfm.view_graph import ViewGraph

    pairs, pair_rows = _pair_correspondences(recon, min_inliers)
    if not pairs:
        return ViewGraph()
    N = max(len(pair_rows[k][0]) for k in pairs)
    Np = 1 << (N - 1).bit_length()
    P = len(pairs)

    # Fixed chunk geometry: every device call has the SAME (chunk, Np)
    # shape (the final chunk is padded with replicas of pair 0 and
    # discarded), so exactly one program is compiled and reused. The
    # engine scores hypotheses in blocks of 256 (ransac/engine.py), so the
    # peak live tensor is [chunk, 256, Np] — the budget bounds it to
    # ~1 GB. Each chunk launch runs a mostly-sequential RANSAC depth, so
    # FEWER, BIGGER chunks win: fountain's 55 pairs verify in ONE launch.
    chunk = min(P, max(1, int(2.5e8 // (256 * Np))))
    n_chunks = -(-P // chunk)

    pts1 = np.zeros((n_chunks * chunk, Np, 2))
    pts2 = np.zeros((n_chunks * chunk, Np, 2))
    masks = np.zeros((n_chunks * chunk, Np), bool)
    priors1 = []
    priors2 = []
    for i, (vaa, vbb) in enumerate(pairs):
        ra, rb = pair_rows[(vaa, vbb)]
        n = len(ra)
        pts1[i, :n] = recon.obs_uv[ra]
        pts2[i, :n] = recon.obs_uv[rb]
        masks[i, :n] = True
        priors1.append(recon.view_priors[vaa])
        priors2.append(recon.view_priors[vbb])
    for i in range(P, n_chunks * chunk):
        pts1[i] = pts1[0]
        pts2[i] = pts2[0]
        masks[i] = masks[0]
        priors1.append(priors1[0])
        priors2.append(priors2[0])

    key = jax.random.PRNGKey(seed)
    results = []
    from ..utils import counters

    # Two-rung adaptive hypothesis budget — the batched mapping of the
    # reference's adaptive termination (ComputeMaxIterations,
    # `sample_consensus_estimator.h`): every pair first gets a 64-sample
    # launch; only pairs whose adaptive iteration requirement at the
    # observed inlier ratio exceeds 64 are re-verified at the full budget.
    # High-inlier collections (fountain: ~80% inliers -> ~15 required
    # iterations) finish entirely in the cheap rung with the same
    # failure-probability guarantee.
    rung1 = min(64, max_ransac_iterations)
    opts1 = EstimateTwoViewInfoOptions(max_ransac_iterations=rung1)
    for c in range(n_chunks):
        lo, hi = c * chunk, (c + 1) * chunk
        key, sub = jax.random.split(key)
        counters.bump("verify_chunk")
        results.extend(
            estimate_two_view_info_batch(
                sub, opts1, priors1[lo:hi], priors2[lo:hi],
                pts1[lo:hi], pts2[lo:hi], masks[lo:hi],
            )
        )
    results = results[:P]
    if max_ransac_iterations > rung1:
        confidence = 1.0 - opts1.expected_ransac_confidence
        redo = []
        for i, (vaa, vbb) in enumerate(pairs):
            info, inliers = results[i]
            n = len(pair_rows[(vaa, vbb)][0])
            ninl = 0 if info is None else len(inliers)
            p_good = max(ninl / max(n, 1), 1e-9) ** 5
            needed = np.log(confidence) / min(np.log1p(-min(p_good, 1 - 1e-12)), -1e-12)
            if needed > rung1:
                redo.append(i)
        if redo:
            opts2 = EstimateTwoViewInfoOptions(
                max_ransac_iterations=max_ransac_iterations
            )
            # Same fixed chunk geometry as rung 1 (pad with replicas).
            n2 = -(-len(redo) // chunk) * chunk
            sel = redo + [redo[0]] * (n2 - len(redo))
            for c in range(n2 // chunk):
                lo, hi = c * chunk, (c + 1) * chunk
                key, sub = jax.random.split(key)
                counters.bump("verify_chunk")
                out = estimate_two_view_info_batch(
                    sub, opts2,
                    [priors1[i] for i in sel[lo:hi]],
                    [priors2[i] for i in sel[lo:hi]],
                    pts1[sel[lo:hi]], pts2[sel[lo:hi]], masks[sel[lo:hi]],
                )
                for j, i in enumerate(sel[lo:hi]):
                    if lo + j < len(redo):
                        results[i] = out[j]
    graph = ViewGraph()
    for (vaa, vbb), (info, inliers) in zip(pairs, results[:P]):
        if info is None or len(inliers) < min_inliers:
            continue
        info.num_verified_matches = len(inliers)
        graph.add_edge(vaa, vbb, info)
    return graph


def run_estimator(
    recon, graph, estimator_type: str = "global", seed: int = 0,
    calibrated: bool = False,
):
    """`calibrated=True` holds intrinsics at their priors (XYZW tracks) —
    the reference's own Strecha methodology (its fountain-11 benchmark
    feeds per-camera calibration files, performance.md:12); the default
    keeps the reference-default free focal+radial configuration."""
    from ..ba.lm import OptimizeIntrinsicsType, TrackParametrizationType
    from ..sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from ..sfm.reconstruction_estimator import create_reconstruction_estimator

    options = ReconstructionEstimatorOptions(
        reconstruction_estimator_type={
            "global": ReconstructionEstimatorType.GLOBAL,
            "incremental": ReconstructionEstimatorType.INCREMENTAL,
            "hybrid": ReconstructionEstimatorType.HYBRID,
        }[estimator_type],
        rng_seed=seed,
    )
    if calibrated:
        options.intrinsics_to_optimize = OptimizeIntrinsicsType.NONE
        options.track_parametrization_type = TrackParametrizationType.XYZW
    estimator = create_reconstruction_estimator(options)
    return estimator.estimate(graph, recon)


def sim3_ate_mm(recon, gt_recon):
    """Sim3-align estimated camera centers to GT by name; return per-camera
    position errors in mm (parity: sfm_eval_dataset.py)."""
    from ..transforms.alignment import align_point_clouds_umeyama

    est, gt = [], []
    for v in range(recon.num_views()):
        if not recon.view_estimated[v]:
            continue
        g = gt_recon.view_id_from_name(recon.view_names[v])
        if g < 0:
            continue
        est.append(recon.view_extrinsics[v, :3])
        gt.append(gt_recon.view_extrinsics[g, :3])
    est = np.asarray(est)
    gt = np.asarray(gt)
    from ..utils.fetch import fetch

    # one batched pull instead of 3 sequential blocking pulls
    R, t, s = fetch(align_point_clouds_umeyama(est, gt))
    aligned = s * est @ np.asarray(R).T + np.asarray(t)
    err_m = np.linalg.norm(aligned - gt, axis=-1)
    return err_m * 1000.0, len(est)


def evaluate(
    estimator_type: str = "global",
    max_tracks=None,
    seed: int = 0,
    fountain_path: str = DEFAULT_FOUNTAIN,
    gt_path: str = DEFAULT_GT,
    _base_recon=None,
    calibrated: bool = False,
):
    """One full tracks->reconstruction->ATE run with per-phase timings."""
    from ..io.theia_recon import read_theia_reconstruction

    from ..utils import counters

    counters.reset()
    t_all = time.perf_counter()
    recon = _base_recon if _base_recon is not None else load_fountain(fountain_path)
    gt = read_theia_reconstruction(gt_path)
    recon = strip_geometry(recon, max_tracks=max_tracks, seed=seed)

    t0 = time.perf_counter()
    graph = build_view_graph(recon, seed=seed)
    t_verify = time.perf_counter() - t0

    t0 = time.perf_counter()
    summary = run_estimator(recon, graph, estimator_type, seed, calibrated)
    t_sfm = time.perf_counter() - t0

    err_mm, n_est = sim3_ate_mm(recon, gt)
    return dict(
        dispatch_counts=counters.snapshot(),
        dispatch_total=counters.total(),
        median_mm=float(np.median(err_mm)),
        mean_mm=float(np.mean(err_mm)),
        max_mm=float(np.max(err_mm)),
        cameras=n_est,
        edges=graph.num_edges(),
        tracks_used=recon.num_tracks(),
        t_verify_s=t_verify,
        t_sfm_s=t_sfm,
        t_sfm_rotation_s=summary.rotation_estimation_time,
        t_sfm_position_s=summary.position_estimation_time,
        t_sfm_pose_s=summary.pose_estimation_time,
        t_sfm_triangulation_s=summary.triangulation_time,
        t_sfm_ba_s=summary.bundle_adjustment_time,
        t_total_s=time.perf_counter() - t_all,
        success=bool(summary.success),
    )
