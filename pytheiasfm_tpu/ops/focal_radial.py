"""Absolute-pose solvers with unknown focal length / radial distortion.

Batched equivalents of (`src/theia/sfm/pose/`):
  - ``FourPointPoseAndFocalLength``      (four_point_focal_length.h) — P4Pf
  - ``FivePointFocalLengthRadialDistortion``
        (five_point_focal_length_radial_distortion.h) — P5Pfr (1 or 2 k's)
  - ``FourPointsPoseFocalLengthRadialDistortion``
        (four_point_focal_length_radial_distortion.h) — P4Pfr, bounded f/k

The reference solves these with machine-generated Gröbner-basis eliminations
(hundreds of lines of coefficient tables each). A Gröbner action matrix is a
poor fit for batched accelerator code (huge scalar expression trees, numerically brittle in f32).
Instead each solver here is a **batched candidate grid + Gauss-Newton
variable-projection polish**:

  1. a static log-spaced grid of focal candidates (scaled by the observed
     pixel spread) — and distortion candidates where applicable;
  2. for each candidate: P3P on three points (closed-form quartic, batched)
     scored on the remaining point(s);
  3. joint Gauss-Newton on (R, t, f[, k...]) minimizing reprojection over all
     points, fixed iteration count, batched over candidates;
  4. rank candidates by final residual; return masked fixed-size solutions.

All steps are fixed-shape and vmap cleanly over RANSAC sample batches —
the whole hypothesis tensor stays on-chip.

Distortion uses the division model (matching the reference's
DIVISION_UNDISTORTION convention, `pose/five_point_focal_length_radial_
distortion.h:49`): undistorted = distorted / (1 + k1 r^2 [+ k2 r^4]).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import p3p as p3p_mod
from .rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
    rotation_matrix_to_angle_axis,
)

__all__ = [
    "four_point_pose_and_focal_length",
    "five_point_focal_length_radial_distortion",
    "four_point_pose_focal_length_radial_distortion",
]

# Log-spaced multipliers of the observed pixel spread used as focal seeds.
_FOCAL_GRID = np.array([0.4, 0.7, 1.0, 1.5, 2.2, 3.5, 6.0], np.float64)


def _pixel_scale(features):
    """Robust pixel spread: mean |p| over the sample (pp-centred pixels)."""
    return jnp.maximum(jnp.mean(jnp.linalg.norm(features, axis=-1), axis=-1), 1e-8)


def _undistort_div(d, ks):
    """Division-model undistort: d [.., 2], ks [.., K] -> [.., 2]."""
    r2 = jnp.sum(d * d, axis=-1, keepdims=True)
    denom = 1.0 + ks[..., 0:1] * r2
    if ks.shape[-1] > 1:
        denom = denom + ks[..., 1:2] * r2 * r2
    return d / denom


def _p3p_best_pose(norm_feats, world_pts, score_feats, score_pts):
    """P3P on the first three points, pick the candidate that best reprojects
    the scoring points. norm_feats [.., 3, 2]; returns (aa [.., 3], t [.., 3],
    score [..])."""
    R, t, valid = p3p_mod.pose_from_three_points(norm_feats, world_pts)
    # Reproject score points under all 4 candidate poses.
    pc = jnp.einsum("...kij,...nj->...kni", R, score_pts) + t[..., :, None, :]
    z = jnp.where(jnp.abs(pc[..., 2]) < 1e-12, 1e-12, pc[..., 2])
    proj = pc[..., :2] / z[..., None]
    err = jnp.sum((proj - score_feats[..., None, :, :]) ** 2, axis=(-1, -2))
    err = jnp.where(valid & (z > 0).all(axis=-1), err, jnp.inf)
    best = jnp.argmin(err, axis=-1)

    def take(x):
        idx = best.reshape(best.shape + (1,) * (x.ndim - best.ndim))
        return jnp.take_along_axis(x, idx, axis=best.ndim).squeeze(best.ndim)

    R_b = take(R)
    t_b = take(t)
    aa = rotation_matrix_to_angle_axis(R_b)
    return aa, t_b, jnp.min(err, axis=-1)


def _gn_refine(params, features, world_pts, num_k, iters=8):
    """Joint GN on params = [aa(3), t(3), log_f, k...] minimizing pixel
    reprojection with the division model. Batch-safe via per-point jacfwd
    composed with explicit vmap over the parameter axis only."""

    def residuals(p):
        aa, t = p[..., 0:3], p[..., 3:6]
        f = jnp.exp(p[..., 6])
        ks = p[..., 7 : 7 + num_k] if num_k else jnp.zeros(p.shape[:-1] + (1,), p.dtype)
        pc = angle_axis_rotate_point(aa[..., None, :], world_pts) + t[..., None, :]
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-12, 1e-12, pc[..., 2])
        u = pc[..., :2] / z[..., None]  # undistorted normalized
        d = features / f[..., None, None]  # distorted normalized
        ud = _undistort_div(d, jnp.broadcast_to(ks[..., None, :], d.shape[:-1] + (max(num_k, 1),)))
        r = (ud - u) * f[..., None, None]
        return r.reshape(*r.shape[:-2], -1)

    def gn(_, p):
        r = residuals(p)
        # Full Jacobian via forward-mode over each parameter axis element.
        basis = jnp.eye(p.shape[-1], dtype=p.dtype)
        J = jnp.stack(
            [jax.jvp(residuals, (p,), (jnp.broadcast_to(b, p.shape),))[1] for b in basis],
            axis=-1,
        )
        JTJ = jnp.einsum("...ri,...rj->...ij", J, J)
        JTr = jnp.einsum("...ri,...r->...i", J, r)
        damp = 1e-9 * jnp.trace(JTJ, axis1=-2, axis2=-1)[..., None, None] * jnp.eye(
            p.shape[-1], dtype=p.dtype
        )
        delta = jnp.linalg.solve(JTJ + damp, -JTr[..., None])[..., 0]
        p_new = p + delta
        better = jnp.sum(residuals(p_new) ** 2, -1) < jnp.sum(r * r, -1)
        return jnp.where(better[..., None], p_new, p)

    p = jax.lax.fori_loop(0, iters, gn, params)
    final_err = jnp.sum(residuals(p) ** 2, axis=-1)
    return p, final_err


def _grid_solve(features, world_pts, num_k, k_grid, iters, max_solutions):
    """Shared machinery: focal(+k) candidate grid -> P3P init -> GN.

    features [.., N, 2] (principal-point-centred pixels), world [.., N, 3].
    Returns params [.., S, 7+num_k], err [.., S] sorted ascending.
    """
    dtype = features.dtype
    # Normalize pixel spread to O(1): in f32 the GN normal equations are
    # otherwise dominated by the focal column (pixels ~ 1e3) and stall at a
    # few-percent focal error. Work on unit-scale pixels, shift log-f back
    # at the end.
    scale = _pixel_scale(features)  # [..]
    features = features / scale[..., None, None]
    f_cands = jnp.broadcast_to(
        jnp.asarray(_FOCAL_GRID, dtype), scale.shape + (_FOCAL_GRID.shape[0],)
    )  # [.., F]
    if k_grid is None:
        k_grid = np.zeros((1, max(num_k, 1)))
    k_cands = jnp.asarray(k_grid, dtype)  # [K, nk]
    F, K = f_cands.shape[-1], k_cands.shape[0]

    def init_one(f, ks):
        # Undistort + normalize with candidate (f, ks), P3P on 3 pts.
        d = features / f[..., None, None]
        ud = _undistort_div(d, jnp.broadcast_to(ks, d.shape[:-1] + (ks.shape[-1],)))
        aa, t, _ = _p3p_best_pose(
            ud[..., :3, :], world_pts[..., :3, :], ud, world_pts
        )
        parts = [aa, t, jnp.log(f)[..., None]]
        if num_k:
            parts.append(jnp.broadcast_to(ks[: num_k], aa.shape[:-1] + (num_k,)))
        return jnp.concatenate(parts, axis=-1)

    # Build the full candidate tensor [.., F*K, P].
    cand_params = []
    for fi in range(F):
        for ki in range(K):
            cand_params.append(init_one(f_cands[..., fi], k_cands[ki]))
    params0 = jnp.stack(cand_params, axis=-2)  # [.., C, P]

    # GN-polish every candidate (vmap over the candidate axis).
    def refine_slice(p):
        return _gn_refine(p, features, world_pts, num_k, iters)

    params, err = jax.vmap(refine_slice, in_axes=-2, out_axes=(-2, -1))(params0)
    order = jnp.argsort(err, axis=-1)[..., :max_solutions]
    params = jnp.take_along_axis(params, order[..., None], axis=-2)
    err = jnp.take_along_axis(err, order, axis=-1)
    # Undo the pixel normalization: f = exp(log_f_normalized) * scale.
    params = params.at[..., 6].add(jnp.log(scale)[..., None])
    return params, err


def _params_to_pose(params, num_k):
    aa, t = params[..., 0:3], params[..., 3:6]
    f = jnp.exp(params[..., 6])
    R = angle_axis_to_rotation_matrix(aa)
    ks = params[..., 7 : 7 + num_k] if num_k else None
    return R, t, f, ks


def four_point_pose_and_focal_length(features, world_points, iters: int = 10):
    """P4Pf: absolute pose + focal length from four 2D-3D correspondences.

    Parity: `FourPointPoseAndFocalLength` (`pose/four_point_focal_length.h:56`)
    — features are pixels with the principal point subtracted; returns up to
    four candidate projection matrices P = diag(f, f, 1) [R | t].

    Args:
      features [.., 4, 2]; world_points [.., 4, 3].

    Returns:
      (projection_matrices [.., 4, 3, 4], focal_lengths [.., 4], valid [.., 4]).
    """
    params, err = _grid_solve(
        features, world_points, num_k=0, k_grid=None, iters=iters, max_solutions=4
    )
    R, t, f, _ = _params_to_pose(params, 0)
    P = jnp.concatenate([R, t[..., None]], axis=-1)
    Kf = jnp.stack([f, f, jnp.ones_like(f)], axis=-1)
    P = Kf[..., None] * P
    tol = 1e-3 if features.dtype == jnp.float32 else 1e-8
    valid = err < tol
    return P, f, valid


def five_point_focal_length_radial_distortion(
    features, world_points, num_radial_distortion_params: int = 1, iters: int = 10
):
    """P5Pfr: pose + focal + radial distortion from five correspondences.

    Parity: `FivePointFocalLengthRadialDistortion`
    (`pose/five_point_focal_length_radial_distortion.h:77`) — division
    distortion model, returns up to four P = diag(f,f,1)[R|t] with their
    radial distortion parameters.

    Args:
      features [.., 5, 2] (pp-centred pixels); world_points [.., 5, 3];
      num_radial_distortion_params: 1 or 2.

    Returns:
      (projection_matrices [.., 4, 3, 4], focal_lengths [.., 4],
       radial_distortions [.., 4, num_k], valid [.., 4]).
    """
    num_k = int(num_radial_distortion_params)
    k_seeds = np.array([[0.0], [-0.1], [-0.3]], np.float64)
    if num_k == 2:
        k_seeds = np.concatenate([k_seeds, np.zeros_like(k_seeds)], axis=1)
    params, err = _grid_solve(
        features, world_points, num_k=num_k, k_grid=k_seeds, iters=iters,
        max_solutions=4,
    )
    R, t, f, ks = _params_to_pose(params, num_k)
    P = jnp.concatenate([R, t[..., None]], axis=-1)
    Kf = jnp.stack([f, f, jnp.ones_like(f)], axis=-1)
    P = Kf[..., None] * P
    tol = 1e-3 if features.dtype == jnp.float32 else 1e-8
    valid = err < tol
    return P, f, ks, valid


def four_point_pose_focal_length_radial_distortion(
    features,
    world_points,
    min_focal_length: float = 0.0,
    max_focal_length: float = np.inf,
    min_distortion: float = -np.inf,
    max_distortion: float = 0.0,
    iters: int = 10,
):
    """P4Pfr: pose + focal + one radial distortion from four correspondences,
    with bound constraints used as validity filters.

    Parity: `FourPointsPoseFocalLengthRadialDistortion`
    (`pose/four_point_focal_length_radial_distortion.h:56`).

    Returns:
      (rotations [.., 4, 3, 3], translations [.., 4, 3],
       radial_distortions [.., 4], focal_lengths [.., 4], valid [.., 4]).
    """
    k_seeds = np.array([[0.0], [-0.05], [-0.15], [-0.35]], np.float64)
    params, err = _grid_solve(
        features, world_points, num_k=1, k_grid=k_seeds, iters=iters,
        max_solutions=4,
    )
    R, t, f, ks = _params_to_pose(params, 1)
    k1 = ks[..., 0]
    tol = 1e-3 if features.dtype == jnp.float32 else 1e-8
    valid = (
        (err < tol)
        & (f >= min_focal_length)
        & (f <= max_focal_length)
        & (k1 >= min_distortion)
        & (k1 <= max_distortion)
    )
    return R, t, k1, f, valid
