"""Global SfM pipeline driver.

Re-design of `/root/reference/src/theia/sfm/global_reconstruction_estimator.{h,cc}`
(pipeline steps 1-9 at `global_reconstruction_estimator.cc:142-271`; SURVEY
§3.2). Host code orchestrates; every numeric stage is a batched device
kernel: rotation averaging (L1+IRLS), 1DSfM filtering, LUD/nonlinear
positions, track triangulation, implicit-Schur LM bundle adjustment.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.log import logger

from ..ba.entry import (
    bundle_adjust_partial_reconstruction,
    bundle_adjust_reconstruction,
)
from ..global_pose import filters
from ..global_pose import position_estimator as pos_est
from ..global_pose import rotation_estimator as rot_est
from ..global_pose.pairwise_translation import (
    optimize_relative_positions_with_known_rotations,
)
from .estimator_options import (
    ReconstructionEstimatorOptions,
    ReconstructionEstimatorSummary,
    set_bundle_adjustment_options,
)
from .reconstruction_estimator_utils import (
    num_estimated_tracks,
    num_estimated_views,
    set_outlier_tracks_to_unestimated,
    set_reconstruction_from_estimated_poses,
    set_underconstrained_tracks_to_unestimated,
    set_underconstrained_views_to_unestimated,
)
from .select_tracks import select_good_tracks_for_bundle_adjustment
from .track_estimator import (
    TrackEstimatorOptions,
    estimate_all_tracks,
    estimate_tracks,
)

__all__ = ["GlobalReconstructionEstimator"]


class GlobalReconstructionEstimator:
    """Parity: `theia::GlobalReconstructionEstimator`
    (`global_reconstruction_estimator.h:71-90`)."""

    def __init__(self, options: ReconstructionEstimatorOptions | None = None):
        self.options = options or ReconstructionEstimatorOptions()

    # ------------------------------------------------------------- pipeline

    def estimate(self, view_graph, recon) -> ReconstructionEstimatorSummary:
        """Steps mirror `GlobalReconstructionEstimator::Estimate`
        (`global_reconstruction_estimator.cc:142`):
        1 filter initial view graph   2 calibrate cameras
        3 estimate global rotations   4 filter rotations
        5 optimize pairwise translations   6 1DSfM translation filter
        7 estimate positions          8 triangulate
        9 BA + outlier-removal + retriangulation loop
        """
        opt = self.options
        summary = ReconstructionEstimatorSummary()
        t_start = time.perf_counter()

        # 1. Filter the initial view graph (min inliers, largest CC)
        #    (.cc:304-325).
        if not self._filter_initial_view_graph(view_graph, recon):
            summary.message = "insufficient view pairs"
            logger.warning("global SfM aborted: insufficient view pairs")
            return summary
        logger.info(
            "initial view graph: %d views, %d edges",
            view_graph.num_views(),
            view_graph.num_edges(),
        )

        # 2. Calibrate any uncalibrated cameras (.cc:166).
        t0 = time.perf_counter()
        recon.set_camera_intrinsics_from_priors()
        summary.camera_intrinsics_calibration_time = time.perf_counter() - t0

        # 3. Global rotations (.cc:327-371).
        t0 = time.perf_counter()
        orientations = rot_est.estimate_rotations(
            view_graph, int(opt.global_rotation_estimator_type),
            mesh=opt.mesh,
        )
        summary.rotation_estimation_time = time.perf_counter() - t0
        logger.info(
            "rotation estimation: %d orientations in %.3fs",
            len(orientations),
            summary.rotation_estimation_time,
        )

        # 4. Filter relative rotations that disagree (.cc:375-381).
        filters.filter_view_pairs_from_orientation(
            view_graph,
            orientations,
            opt.rotation_filtering_max_difference_degrees,
        )
        if opt.extract_maximal_rigid_subgraph:
            # Parity: FilterRotations' rigid-subgraph step
            # (global_reconstruction_estimator.cc; extract_maximally_
            # parallel_rigid_subgraph.h:63).
            filters.extract_maximally_parallel_rigid_subgraph(
                orientations, view_graph
            )
            for v in list(orientations):
                if not view_graph.has_view(v):
                    orientations.pop(v)
        removed = view_graph.remove_disconnected_view_pairs()
        for v in removed:
            orientations.pop(v, None)
        logger.info(
            "rotation filtering: %d edges remain (%d views removed)",
            view_graph.num_edges(),
            len(removed),
        )

        # 5. Refine relative translations with known rotations (.cc:195-202).
        if opt.refine_relative_translations_after_rotation_estimation:
            self._optimize_pairwise_translations(view_graph, orientations, recon)

        # 6. 1DSfM relative-translation filtering (.cc:404).
        if opt.filter_relative_translations_with_1dsfm:
            filters.filter_view_pairs_from_relative_translation(
                view_graph,
                orientations,
                num_iterations=opt.translation_filtering_num_iterations,
                translation_projection_tolerance=(
                    opt.translation_filtering_projection_tolerance
                ),
                rng=np.random.default_rng(opt.rng_seed),
            )
            removed = view_graph.remove_disconnected_view_pairs()
            for v in removed:
                orientations.pop(v, None)

        # 7. Global positions (.cc:418-452).
        t_pos = time.perf_counter()
        positions = pos_est.estimate_positions(
            view_graph,
            orientations,
            int(opt.global_position_estimator_type),
            mesh=opt.mesh,
        )
        summary.position_estimation_time = time.perf_counter() - t_pos
        summary.pose_estimation_time = time.perf_counter() - t0
        logger.info(
            "position estimation: %d positions (R+t phase %.3fs)",
            len(positions),
            summary.pose_estimation_time,
        )

        set_reconstruction_from_estimated_poses(orientations, positions, recon)

        # 8. Triangulate all tracks (.cc:456-472).
        t0 = time.perf_counter()
        self._estimate_structure(recon)
        summary.triangulation_time = time.perf_counter() - t0
        logger.info(
            "triangulation: %d estimated tracks in %.3fs",
            num_estimated_tracks(recon),
            summary.triangulation_time,
        )

        set_underconstrained_tracks_to_unestimated(recon)
        set_underconstrained_views_to_unestimated(recon)

        # 9. Bundle adjustment with retriangulation loops (.cc:233-271).
        t0 = time.perf_counter()
        self._bundle_adjustment_loop(recon)
        summary.bundle_adjustment_time = time.perf_counter() - t0
        logger.info(
            "bundle adjustment: %.3fs", summary.bundle_adjustment_time
        )

        summary.estimated_views = {
            v for v in range(recon.num_views()) if recon.view_estimated[v]
        }
        summary.estimated_tracks = {
            t for t in range(recon.num_tracks()) if recon.track_estimated[t]
        }
        summary.success = (
            num_estimated_views(recon) >= 2 and num_estimated_tracks(recon) > 0
        )
        summary.total_time = time.perf_counter() - t_start
        logger.info(
            "global SfM: %d views, %d tracks in %.3fs",
            num_estimated_views(recon),
            num_estimated_tracks(recon),
            summary.total_time,
        )
        summary.message = (
            f"estimated {num_estimated_views(recon)} views, "
            f"{num_estimated_tracks(recon)} tracks"
        )
        return summary

    # ----------------------------------------------------------- sub-stages

    def _filter_initial_view_graph(self, view_graph, recon) -> bool:
        """Parity: `FilterInitialViewGraph`
        (`global_reconstruction_estimator.cc:304-325`)."""
        opt = self.options
        to_remove = [
            (i, j)
            for (i, j), info in view_graph.edges.items()
            if info.num_verified_matches < opt.min_num_two_view_inliers
        ]
        for i, j in to_remove:
            view_graph.remove_edge(i, j)
        keep = set(view_graph.largest_connected_component_ids())
        for v in list(view_graph.view_ids()):
            if v not in keep:
                view_graph.remove_view(v)
        return view_graph.num_edges() >= 1

    def _optimize_pairwise_translations(self, view_graph, orientations, recon):
        """Parity: `OptimizePairwiseTranslations`
        (`global_reconstruction_estimator.cc:195-202`): refine each edge's
        relative position on the epipolar constraint over the views' shared
        (normalized) features — batched over all edges."""
        import jax.numpy as jnp

        from ..models import camera as cam

        edges = [
            (i, j)
            for (i, j) in view_graph.edges
            if i in orientations and j in orientations
        ]
        if not edges:
            return
        # Shared-track normalized correspondences per edge.
        corr = []
        for (i, j) in edges:
            vi = recon._view_track_to_obs[i]
            vj = recon._view_track_to_obs[j]
            common = [t for t in vi if t in vj]
            corr.append(([vi[t] for t in common], [vj[t] for t in common]))
        K = max((len(c[0]) for c in corr), default=0)
        if K < 5:
            return
        Kp = 8
        while Kp < K:
            Kp *= 2
        E = len(edges)
        dtype = np.float64
        x1 = np.zeros((E, Kp, 2), dtype)
        x2 = np.zeros((E, Kp, 2), dtype)
        mask = np.zeros((E, Kp), bool)
        rot1 = np.zeros((E, 3), dtype)
        rot2 = np.zeros((E, 3), dtype)
        init = np.zeros((E, 3), dtype)

        # Normalize the WHOLE observation table once per intrinsics group
        # (one pow2-padded device call each). A per-edge normalize call
        # would recompile for every distinct correspondence count.
        import jax

        norm_uv = np.zeros((len(recon.obs_view), 2), dtype)
        obs_group = recon.view_group[recon.obs_view]
        # Launch all groups, pull once (a blocking pull per intrinsics
        # group waits for the device each time; free-intrinsics scenes
        # have one group per camera).
        launched = []
        for g in np.unique(obs_group):
            rows = np.nonzero(obs_group == g)[0]
            params = jnp.asarray(recon.intrinsics[g])
            model = int(recon.group_model[g])
            pad = 64
            while pad < len(rows):
                pad *= 2
            pix = np.zeros((pad, 2))
            pix[: len(rows)] = recon.obs_uv[rows]
            launched.append(
                (rows,
                 cam.pixel_to_normalized_batch(params, jnp.asarray(pix), model))
            )
        from ..utils.fetch import fetch

        pulled = fetch([d for (_, d) in launched])
        for (rows, _), ray_full in zip(launched, pulled):
            ray = np.asarray(ray_full)
            norm_uv[rows] = (ray[:, :2] / ray[:, 2:3])[: len(rows)]

        for e, ((i, j), (rows_i, rows_j)) in enumerate(zip(edges, corr)):
            k = len(rows_i)
            if k:
                x1[e, :k] = norm_uv[rows_i]
                x2[e, :k] = norm_uv[rows_j]
                mask[e, :k] = True
            rot1[e] = orientations[i]
            rot2[e] = orientations[j]
            info = view_graph.get_edge(i, j)
            init[e] = np.asarray(info.position_2)

        refined, ok = optimize_relative_positions_with_known_rotations(
            jnp.asarray(rot1),
            jnp.asarray(rot2),
            jnp.asarray(x1),
            jnp.asarray(x2),
            jnp.asarray(mask),
            jnp.asarray(init),
        )
        from ..utils.fetch import fetch

        refined, ok = fetch((refined, ok))  # one batched round trip
        refined = np.asarray(refined)
        ok = np.asarray(ok)
        for e, (i, j) in enumerate(edges):
            if ok[e]:
                view_graph.get_edge(i, j).position_2 = refined[e]

    def _estimate_structure(self, recon, track_ids=None):
        """Parity: `EstimateStructure`
        (`global_reconstruction_estimator.cc:456-472`)."""
        opt = self.options
        te_options = TrackEstimatorOptions(
            max_acceptable_reprojection_error_pixels=(
                opt.triangulation_max_reprojection_error_in_pixels
            ),
            min_triangulation_angle_degrees=opt.min_triangulation_angle_degrees,
            bundle_adjustment=opt.bundle_adjust_tracks,
            triangulation_method=opt.triangulation_method,
            mesh=opt.mesh,
        )
        if track_ids is None:
            return estimate_all_tracks(recon, te_options)
        return estimate_tracks(recon, track_ids, te_options)

    def _bundle_adjustment_loop(self, recon):
        """Parity: the retriangulation + BA loop
        (`global_reconstruction_estimator.cc:233-271,480-498`)."""
        opt = self.options
        ba_options = set_bundle_adjustment_options(
            opt, num_estimated_views(recon)
        )
        import time as _time

        for it in range(opt.num_retriangulation_iterations + 1):
            _t0 = _time.perf_counter()
            round_options = ba_options
            if opt.subsample_tracks_for_bundle_adjustment:
                tracks = select_good_tracks_for_bundle_adjustment(
                    recon,
                    long_track_length_threshold=(
                        opt.track_subset_selection_long_track_length_threshold
                    ),
                    image_grid_cell_size_pixels=(
                        opt.track_selection_image_grid_cell_size_pixels
                    ),
                    min_num_optimized_tracks_per_view=(
                        opt.min_num_optimized_tracks_per_view
                    ),
                )
                views = [
                    v for v in range(recon.num_views()) if recon.view_estimated[v]
                ]
                ba_summary = bundle_adjust_partial_reconstruction(
                    round_options, views, tracks, recon
                )
            else:
                ba_summary = bundle_adjust_reconstruction(round_options, recon)

            _t1 = _time.perf_counter()
            logger.info(
                "BA round %d: %d LM iterations, cost %.4g -> %.4g",
                it, int(ba_summary.num_iterations),
                float(ba_summary.initial_cost),
                float(ba_summary.final_cost),
            )
            num_outliers = set_outlier_tracks_to_unestimated(
                recon,
                opt.max_reprojection_error_in_pixels,
                opt.min_triangulation_angle_degrees,
            )
            set_underconstrained_tracks_to_unestimated(recon)
            _t2 = _time.perf_counter()
            logger.info(
                "BA round %d: solve %.2fs, outlier filter %.2fs (%d outliers)",
                it, _t1 - _t0, _t2 - _t1, num_outliers,
            )
            if it == opt.num_retriangulation_iterations or num_outliers == 0:
                break
            # Retriangulate the dropped tracks.
            unest = [
                t for t in range(recon.num_tracks()) if not recon.track_estimated[t]
            ]
            self._estimate_structure(recon, unest)
            logger.info(
                "BA round %d: retriangulated %d tracks in %.2fs",
                it, len(unest), _time.perf_counter() - _t2,
            )
