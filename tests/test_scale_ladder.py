"""Scale-ladder tests for global pose estimation.

Mirrors the reference's scale ladders (`robust_rotation_estimator_test.cc`:
4 views/6 pairs up to 100 views/800 pairs with 0-2 degree noise sweeps) and
adds a 1DSfM-scale synthetic run (500 views / 4000 pairs) exercising MST
init -> robust rotation averaging -> orientation filter -> 1DSfM translation
filter -> LUD positions, the exact global-SfM chain that runs on the 1DSfM
datasets (BASELINE.md)."""

import time

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pytheiasfm_tpu import global_pose as gp

from test_global_pose import make_scene, position_error, rotation_error_deg


class TestRotationNoiseSweep:
    """100 views / 800 pairs across the reference's noise ladder."""

    @pytest.mark.parametrize(
        "noise_deg,tol_deg",
        [(0.0, 0.01), (0.5, 1.5), (2.0, 5.0)],
    )
    def test_robust_l1l2(self, rng, noise_deg, tol_deg):
        gt_aa, _, graph = make_scene(100, 800, noise_deg, 0.01, rng)
        est = gp.estimate_rotations(graph)
        assert len(est) == 100
        assert rotation_error_deg(gt_aa, est) < tol_deg

    def test_robust_l1l2_outliers_at_scale(self, rng):
        gt_aa, _, graph = make_scene(
            100, 800, 0.5, 0.01, rng, outlier_fraction=0.2
        )
        est = gp.estimate_rotations(graph)
        assert rotation_error_deg(gt_aa, est) < 3.0


class TestPositionNoiseSweep:
    """100 views / 800 pairs position ladder (LUD is the 1DSfM default)."""

    @pytest.mark.parametrize(
        "pos_noise,outliers,tol_frac",
        [(0.0, 0.0, 0.02), (0.05, 0.0, 0.08), (0.05, 0.1, 0.12)],
    )
    def test_lud(self, rng, pos_noise, outliers, tol_frac):
        gt_aa, gt_pos, graph = make_scene(
            100, 800, 0.0, pos_noise, rng, outlier_fraction=outliers
        )
        orient = {i: gt_aa[i] for i in range(100)}
        est = gp.estimate_positions(graph, orient)
        assert len(est) == 100
        scale = np.linalg.norm(gt_pos - gt_pos.mean(0), axis=-1).mean()
        assert position_error(gt_pos, est) < tol_frac * scale


def test_one_dsfm_scale_global_chain(rng):
    """500 views / 4000 pairs: the global-SfM pose chain at 1DSfM scale.

    Mirrors steps 3-7 of `GlobalReconstructionEstimator::Estimate`
    (`global_reconstruction_estimator.cc:327-452`) on a synthetic graph the
    size of the 1DSfM Notre Dame set (553 cams), with noise and 10% outlier
    edges. Asserts accuracy and that the chain completes in bounded time on
    the 2-CPU test host (every solver is one batched device program)."""
    V, E = 500, 4000
    gt_aa, gt_pos, graph = make_scene(
        V, E, 0.5, 0.03, rng, outlier_fraction=0.1
    )
    t0 = time.perf_counter()

    # 3. Rotation averaging from an MST init.
    est_rot = gp.estimate_rotations(graph)
    assert len(est_rot) == V
    rot_err = rotation_error_deg(gt_aa, est_rot)
    assert rot_err < 4.0

    # 4. Orientation filter drops rotation outliers.
    removed_rot = gp.filter_view_pairs_from_orientation(graph, est_rot, 10.0)
    assert removed_rot >= int(0.05 * E)
    graph.remove_disconnected_view_pairs()
    for v in list(est_rot):
        if not graph.has_view(v):
            est_rot.pop(v)

    # 6. 1DSfM relative-translation filter.
    removed_t = gp.filter_view_pairs_from_relative_translation(
        graph, est_rot, num_iterations=24
    )
    graph.remove_disconnected_view_pairs()
    assert graph.num_edges() >= E // 2

    # 7. LUD positions on the surviving graph.
    orient = {v: est_rot[v] for v in graph.view_ids() if v in est_rot}
    est_pos = gp.estimate_positions(graph, orient)
    assert len(est_pos) >= 0.95 * V
    ids = np.array(sorted(est_pos.keys()))
    scale = np.linalg.norm(gt_pos[ids] - gt_pos[ids].mean(0), axis=-1).mean()
    pos_err = position_error(gt_pos, est_pos)
    assert pos_err < 0.15 * scale

    elapsed = time.perf_counter() - t0
    # Generous CPU budget for the test host.
    assert elapsed < 900, f"1DSfM-scale chain took {elapsed:.0f}s"


def test_trafalgar_scale_pipeline_default_config():
    """Trafalgar-scale (5288 views) global pipeline in the REFERENCE-DEFAULT
    configuration (free focal+radial, manifold points). Asserts completion
    and accuracy at the scale of the largest 1DSfM dataset
    (performance.md:68: 880.74 s total / BA 142.10 s on the 2016 CPU
    baseline). Runs on whatever backend the session provides; the CPU tier
    gets a generous wall-clock bound."""
    from pytheiasfm_tpu.pipelines import synthetic_global as sg
    from pytheiasfm_tpu.sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from pytheiasfm_tpu.sfm.reconstruction_estimator import (
        create_reconstruction_estimator,
    )
    from pytheiasfm_tpu.transforms.alignment import align_point_clouds_umeyama

    t0 = time.perf_counter()
    # Exactly the bench.py Trafalgar configuration. The CPU tier runs the
    # f64 math; the wall-clock bound is sized for a 2-CPU test host.
    recon, graph, gt_positions = sg.build_scene(V=5288, T=250_000, seed=0)
    options = ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType.GLOBAL,
        rng_seed=0,
    )
    summary = create_reconstruction_estimator(options).estimate(graph, recon)
    elapsed = time.perf_counter() - t0
    assert summary.success
    est_ids = [
        v for v in range(recon.num_views()) if recon.view_estimated[v]
    ]
    assert len(est_ids) >= 5200, len(est_ids)
    est = recon.view_extrinsics[est_ids, :3]
    gt = gt_positions[est_ids]
    Ra, ta, s = align_point_clouds_umeyama(est, gt)
    aligned = s * est @ np.asarray(Ra).T + np.asarray(ta)
    err = np.linalg.norm(aligned - gt, axis=-1)
    assert np.median(err) < 0.05, np.median(err)
    assert elapsed < 7200, f"Trafalgar-scale pipeline took {elapsed:.0f}s"


def test_incremental_estimator_at_scale():
    """Incremental SfM at 220 views through the batched localization loop
    (FindViewsToLocalize -> one vmapped PnP RANSAC launch per pass ->
    union triangulation -> partial/full BA). Parity target:
    `incremental_reconstruction_estimator.cc:161-298`, which localizes the
    same candidate sweep one view at a time."""
    from pytheiasfm_tpu.pipelines import synthetic_global as sg

    t0 = time.perf_counter()
    out = sg.run(
        V=220, T=12_000, seed=1, estimator_type="incremental"
    )
    elapsed = time.perf_counter() - t0
    assert out["success"]
    assert out["views"] >= 200, out["views"]
    assert out["median_pos_err"] < 0.05, out["median_pos_err"]
    assert elapsed < 1800, f"incremental 220-view run took {elapsed:.0f}s"
