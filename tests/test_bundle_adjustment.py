"""Bundle adjustment tests — mirror the reference's pytest suite pattern
(pytests/sfm/bundle_adjuster_test.py + bundle_adjustment_test.cc):
synthesize GT scene -> perturb -> optimize -> assert recovery."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytheiasfm_tpu.ba import BundleAdjustmentOptions, LossFunctionType, bundle_adjust
from pytheiasfm_tpu.models import camera as cam
from pytheiasfm_tpu.models import intrinsics as intr
from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as M
from pytheiasfm_tpu.ops import rotation as rot


def synth_ba_problem(rng, V=8, T=60, pixel_noise=0.0, focal=800.0):
    """Cameras on a ring looking at points near the origin."""
    angles = np.linspace(0, 2 * np.pi, V, endpoint=False)
    positions = np.stack(
        [6 * np.cos(angles), 6 * np.sin(angles), rng.normal(size=V) * 0.3], -1
    )
    # Orient each camera to look at the origin.
    ext = []
    for v in range(V):
        z = -positions[v] / np.linalg.norm(positions[v])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])  # world->cam rows
        aa = np.asarray(rot.rotation_matrix_to_angle_axis(jnp.asarray(R)))
        ext.append(np.concatenate([positions[v], aa]))
    ext = np.asarray(ext)
    points = rng.uniform(-1.5, 1.5, size=(T, 3))
    params = np.asarray(
        intr.make_intrinsics(
            M.PINHOLE, focal_length=focal, principal_point=(512, 384),
            dtype=jnp.float64,
        )
    )

    obs_view, obs_track, obs_uv = [], [], []
    for v in range(V):
        for t in range(T):
            depth, pixel = cam.project_point(
                jnp.asarray(ext[v]), jnp.asarray(params), jnp.asarray(points[t]), M.PINHOLE
            )
            if float(depth) > 0:
                uv = np.asarray(pixel)
                if pixel_noise:
                    uv = uv + rng.normal(size=2) * pixel_noise
                obs_view.append(v)
                obs_track.append(t)
                obs_uv.append(uv)
    return ext, points, params, (
        np.asarray(obs_view, np.int32),
        np.asarray(obs_track, np.int32),
        np.asarray(obs_uv),
    )


def run_ba(ext, points, params, obs, options=None, camera_free=None, point_free=None):
    obs_view, obs_track, obs_uv = obs
    O = len(obs_view)
    V, T = len(ext), len(points)
    P = len(params)
    dtype = jnp.asarray(ext).dtype
    options = options or BundleAdjustmentOptions()
    ext_out, _, pts_out, summary = bundle_adjust(
        jnp.asarray(ext),
        jnp.asarray(params, dtype)[None, :],  # one shared intrinsics group
        jnp.asarray(points),
        jnp.zeros((V,), jnp.int32),
        jnp.zeros((1,), jnp.int32),
        jnp.asarray(obs_view),
        jnp.asarray(obs_track),
        jnp.asarray(obs_uv),
        jnp.ones((O, 2), dtype=dtype),
        jnp.ones((O,), bool),
        jnp.ones((V,), bool) if camera_free is None else jnp.asarray(camera_free),
        jnp.ones((T,), bool) if point_free is None else jnp.asarray(point_free),
        jnp.zeros((1, P), bool),
        jnp.zeros((T,), jnp.int32),
        jnp.zeros((T, 3), dtype),
        present_models=(int(M.PINHOLE),),
        num_views=V,
        num_tracks=T,
        num_groups=1,
        options=options,
    )
    return np.asarray(ext_out), np.asarray(pts_out), summary


def test_ba_recovers_from_perturbation(rng):
    ext, points, params, obs = synth_ba_problem(rng)
    ext_n = ext + rng.normal(size=ext.shape) * 0.02
    pts_n = points + rng.normal(size=points.shape) * 0.05
    # Fix the gauge: first two cameras constant.
    cam_free = np.ones(len(ext), bool)
    cam_free[:2] = False
    ext_n[:2] = ext[:2]
    ext_out, pts_out, summary = run_ba(
        ext_n, pts_n, params, obs, camera_free=cam_free
    )
    assert bool(summary.success)
    assert float(summary.final_cost) < float(summary.initial_cost) * 1e-4
    # Camera positions recovered.
    np.testing.assert_allclose(ext_out[:, :3], ext[:, :3], atol=1e-4)
    np.testing.assert_allclose(pts_out, points, atol=1e-4)


def test_ba_noisy_converges(rng):
    ext, points, params, obs = synth_ba_problem(rng, pixel_noise=0.5)
    ext_n = ext + rng.normal(size=ext.shape) * 0.01
    pts_n = points + rng.normal(size=points.shape) * 0.02
    cam_free = np.ones(len(ext), bool)
    cam_free[:2] = False
    ext_n[:2] = ext[:2]
    ext_out, pts_out, summary = run_ba(ext_n, pts_n, params, obs, camera_free=cam_free)
    assert bool(summary.success)
    # Final RMS reprojection ~ noise level (0.5 px).
    O = len(obs[0])
    rms = np.sqrt(2 * float(summary.final_cost) / O)
    assert rms < 1.0, rms
    # Positions within a few mm of GT (scene scale ~6).
    assert np.abs(ext_out[:, :3] - ext[:, :3]).max() < 0.02


def test_ba_robust_loss_rejects_outliers(rng):
    ext, points, params, obs = synth_ba_problem(rng, pixel_noise=0.2)
    obs_view, obs_track, obs_uv = obs
    # Corrupt 10% of observations.
    n_out = len(obs_view) // 10
    idx = rng.choice(len(obs_view), n_out, replace=False)
    obs_uv = obs_uv.copy()
    obs_uv[idx] += rng.normal(size=(n_out, 2)) * 80.0
    ext_n = ext + rng.normal(size=ext.shape) * 0.01
    cam_free = np.ones(len(ext), bool)
    cam_free[:2] = False
    ext_n[:2] = ext[:2]
    options = BundleAdjustmentOptions(
        loss_function_type=LossFunctionType.HUBER, robust_loss_width=2.0
    )
    ext_out, pts_out, summary = run_ba(
        ext_n, points, params, (obs_view, obs_track, obs_uv), options,
        camera_free=cam_free,
    )
    assert bool(summary.success)
    # Robust loss keeps cameras near GT despite outliers.
    assert np.abs(ext_out[:, :3] - ext[:, :3]).max() < 0.05


def test_ba_points_only(rng):
    """BundleAdjustTracks equivalent: cameras constant, points free."""
    ext, points, params, obs = synth_ba_problem(rng)
    pts_n = points + rng.normal(size=points.shape) * 0.1
    ext_out, pts_out, summary = run_ba(
        ext, pts_n, params, obs, camera_free=np.zeros(len(ext), bool)
    )
    np.testing.assert_allclose(ext_out, ext, atol=0)
    np.testing.assert_allclose(pts_out, points, atol=1e-6)


def test_ba_views_only(rng):
    """BundleAdjustViews equivalent: points constant, cameras free."""
    ext, points, params, obs = synth_ba_problem(rng)
    ext_n = ext + rng.normal(size=ext.shape) * 0.02
    ext_out, pts_out, summary = run_ba(
        ext_n, points, params, obs, point_free=np.zeros(len(points), bool)
    )
    np.testing.assert_allclose(pts_out, points, atol=0)
    np.testing.assert_allclose(ext_out, ext, atol=1e-5)


def test_ba_f32(rng):
    """The accelerator path runs f32: must still converge to sub-pixel cost."""
    ext, points, params, obs = synth_ba_problem(rng)
    ext_n = (ext + rng.normal(size=ext.shape) * 0.01).astype(np.float32)
    pts_n = (points + rng.normal(size=points.shape) * 0.02).astype(np.float32)
    cam_free = np.ones(len(ext), bool)
    cam_free[:2] = False
    ext_n[:2] = ext[:2].astype(np.float32)
    obs_view, obs_track, obs_uv = obs
    ext_out, pts_out, summary = run_ba(
        ext_n, pts_n, np.asarray(params, np.float32),
        (obs_view, obs_track, obs_uv.astype(np.float32)),
        camera_free=cam_free,
    )
    O = len(obs_view)
    rms = np.sqrt(2 * float(summary.final_cost) / O)
    assert rms < 0.1, rms
