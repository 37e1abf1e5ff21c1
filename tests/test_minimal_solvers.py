"""Minimal solver tests — mirror the reference's pose solver gtest specs
(pose/five_point_relative_pose_test.cc, perspective_three_point_test.cc,
eight_point_fundamental_matrix_test.cc, four_point_homography_test.cc):
project known geometry, solve, compare against ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytheiasfm_tpu.ops import epipolar, five_point, p3p
from pytheiasfm_tpu.ops import rotation as rot


def synth_relative_pose(rng, B, N, noise=0.0):
    """Random relative poses with N correspondences each (normalized)."""
    aa = rng.normal(size=(B, 3)) * 0.3
    R = np.asarray(rot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    t = rng.normal(size=(B, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    pts = rng.uniform(-1, 1, size=(B, N, 3)) + np.asarray([0, 0, 4.0])
    x1 = pts[..., :2] / pts[..., 2:3]
    p2 = np.einsum("bij,bnj->bni", R, pts) + t[:, None, :]
    x2 = p2[..., :2] / p2[..., 2:3]
    if noise:
        x1 = x1 + rng.normal(size=x1.shape) * noise
        x2 = x2 + rng.normal(size=x2.shape) * noise
    E_gt = np.stack([np.cross(np.eye(3), t[b]) @ R[b] for b in range(B)])
    E_gt /= np.linalg.norm(E_gt, axis=(1, 2), keepdims=True)
    return x1, x2, R, t, E_gt, pts


def e_distance(E, E_gt):
    return min(np.abs(E - E_gt).max(), np.abs(E + E_gt).max())


def test_five_point_noiseless(rng):
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 24, 5)
    E, valid = jax.jit(five_point.five_point_relative_pose)(
        jnp.asarray(x1), jnp.asarray(x2)
    )
    E, valid = np.asarray(E), np.asarray(valid)
    recovered = 0
    for b in range(24):
        best = min(
            [e_distance(E[b, k], E_gt[b]) for k in range(10) if valid[b, k]],
            default=np.inf,
        )
        if best < 1e-6:
            recovered += 1
    assert recovered == 24


def test_five_point_epipolar_constraint(rng):
    """All returned candidates must satisfy y^T E x = 0 on the sample."""
    x1, x2, *_ = synth_relative_pose(rng, 8, 5)
    E, valid = five_point.five_point_relative_pose(jnp.asarray(x1), jnp.asarray(x2))
    E, valid = np.asarray(E), np.asarray(valid)
    h1 = np.concatenate([x1, np.ones((8, 5, 1))], -1)
    h2 = np.concatenate([x2, np.ones((8, 5, 1))], -1)
    for b in range(8):
        for k in range(10):
            if valid[b, k]:
                resid = np.abs(np.einsum("ni,ij,nj->n", h2[b], E[b, k], h1[b]))
                assert resid.max() < 1e-6, (b, k, resid.max())


def test_five_point_f32(rng):
    """f32 robustness: the accelerator path runs single precision."""
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 64, 5)
    E, valid = jax.jit(five_point.five_point_relative_pose)(
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    )
    E, valid = np.asarray(E), np.asarray(valid)
    recovered = sum(
        min([e_distance(E[b, k], E_gt[b]) for k in range(10) if valid[b, k]], default=np.inf)
        < 5e-3
        for b in range(64)
    )
    assert recovered > 48  # >75% of minimal samples


def test_p3p_noiseless(rng):
    B = 32
    x1, x2, R, t, _, pts = synth_relative_pose(rng, B, 3)
    # Solve camera 2's pose from world points (= pts in camera-1 frame).
    Rs, ts, valid = jax.jit(p3p.pose_from_three_points)(
        jnp.asarray(x2), jnp.asarray(pts)
    )
    Rs, ts, valid = np.asarray(Rs), np.asarray(ts), np.asarray(valid)
    recovered = 0
    for b in range(B):
        errs = [
            np.abs(Rs[b, k] - R[b]).max() + np.abs(ts[b, k] - t[b]).max()
            for k in range(4)
            if valid[b, k]
        ]
        if errs and min(errs) < 1e-6:
            recovered += 1
    assert recovered == B


def test_p3p_degenerate_collinear(rng):
    """Collinear world points: must return masked/finite, never NaN."""
    world = np.asarray([[0.0, 0, 5], [0.1, 0, 5], [0.2, 0, 5]])[None]
    feat = world[..., :2] / world[..., 2:3]
    Rs, ts, valid = p3p.pose_from_three_points(jnp.asarray(feat), jnp.asarray(world))
    assert np.all(np.isfinite(np.asarray(Rs)))
    assert np.all(np.isfinite(np.asarray(ts)))


def test_eight_point_fundamental(rng):
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 16, 8)
    F, ok = jax.jit(epipolar.eight_point_fundamental_matrix)(
        jnp.asarray(x1), jnp.asarray(x2)
    )
    F, ok = np.asarray(F), np.asarray(ok)
    assert np.all(ok)
    for b in range(16):
        # With normalized (calibrated) inputs, F == E up to sign/scale.
        assert e_distance(F[b], E_gt[b]) < 1e-6


def test_seven_point_fundamental(rng):
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 16, 7)
    F, valid = jax.jit(epipolar.seven_point_fundamental_matrix)(
        jnp.asarray(x1), jnp.asarray(x2)
    )
    F, valid = np.asarray(F), np.asarray(valid)
    recovered = 0
    for b in range(16):
        best = min(
            [e_distance(F[b, k], E_gt[b]) for k in range(3) if valid[b, k]],
            default=np.inf,
        )
        if best < 1e-6:
            recovered += 1
    assert recovered >= 15


def test_four_point_homography(rng):
    B = 16
    H_gt = np.eye(3) + 0.1 * rng.normal(size=(B, 3, 3))
    H_gt /= H_gt[:, 2:3, 2:3]
    x1 = rng.uniform(-1, 1, size=(B, 4, 2))
    h1 = np.concatenate([x1, np.ones((B, 4, 1))], -1)
    h2 = np.einsum("bij,bnj->bni", H_gt, h1)
    x2 = h2[..., :2] / h2[..., 2:3]
    H, ok = jax.jit(epipolar.four_point_homography)(jnp.asarray(x1), jnp.asarray(x2))
    H, ok = np.asarray(H), np.asarray(ok)
    assert np.all(ok)
    np.testing.assert_allclose(H, H_gt, atol=1e-7)


def test_decompose_essential_and_best_pose(rng):
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 16, 20)
    R_best, pos_best, counts = jax.jit(epipolar.get_best_pose_from_essential_matrix)(
        jnp.asarray(E_gt), jnp.asarray(x1), jnp.asarray(x2)
    )
    R_best, pos_best, counts = map(np.asarray, (R_best, pos_best, counts))
    assert np.all(counts == 20)
    for b in range(16):
        np.testing.assert_allclose(R_best[b], R[b], atol=1e-6)
        # Reference convention: position = -R^T t (camera 2 center in cam-1).
        pos_gt = -R[b].T @ t[b]
        np.testing.assert_allclose(pos_best[b], pos_gt, atol=1e-6)


def test_sampson_distance(rng):
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 4, 30)
    d = epipolar.squared_sampson_distance(
        jnp.asarray(E_gt), jnp.asarray(x1), jnp.asarray(x2)
    )
    # Inliers: ~0 error.
    assert np.max(np.asarray(d)) < 1e-12
    # Outliers get large errors.
    x2_bad = x2 + rng.normal(size=x2.shape) * 0.05
    d_bad = epipolar.squared_sampson_distance(
        jnp.asarray(E_gt), jnp.asarray(x1), jnp.asarray(x2_bad)
    )
    assert np.median(np.asarray(d_bad)) > 1e-6


def test_focal_lengths_from_fundamental(rng):
    # Build F = K2^-T E K1^-1 and recover focals.
    x1, x2, R, t, E_gt, _ = synth_relative_pose(rng, 8, 8)
    f1, f2 = 800.0, 1100.0
    F = np.asarray(
        epipolar.compose_fundamental_matrix(
            jnp.asarray([f1] * 8), jnp.asarray([f2] * 8), jnp.asarray(R), jnp.asarray(t)
        )
    )
    rf1, rf2, valid = epipolar.focal_lengths_from_fundamental_matrix(jnp.asarray(F))
    rf1, rf2, valid = np.asarray(rf1), np.asarray(rf2), np.asarray(valid)
    good = valid & np.isfinite(rf1) & np.isfinite(rf2)
    assert good.sum() >= 6
    np.testing.assert_allclose(rf1[good], f1, rtol=1e-4)
    np.testing.assert_allclose(rf2[good], f2, rtol=1e-4)
