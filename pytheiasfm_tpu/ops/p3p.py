"""Batched P3P: absolute pose from three 2D-3D correspondences.

Batched equivalent of `theia::PoseFromThreePoints`
(`/root/reference/src/theia/sfm/pose/perspective_three_point.h:56`, Kneip's
method). Here the classic Grunert distance formulation is used instead: it
reduces to a single quartic solved in closed form (no branching), which maps
better onto vmapped execution than Kneip's intermediate-frame
construction. The quartic coefficients below were derived symbolically
(sympy resultant of the two Grunert ratio equations) — not transcribed.

Inputs/outputs follow the reference convention:
  feature_points [.., 3, 2]  calibrated (normalized) image points
  world_points   [.., 3, 3]  corresponding 3D points
  -> rotations [.., 4, 3, 3], translations [.., 4, 3], valid [.., 4]
with p_cam = R @ p_world + t (up to four solutions, masked).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import polynomial as poly

__all__ = ["pose_from_three_points", "align_point_triads"]


def align_point_triads(world_pts, cam_pts):
    """Rigid alignment q = R p + t for small point sets (Horn/Umeyama, no
    scale). world_pts/cam_pts [.., N, 3] -> (R [..,3,3], t [..,3])."""
    p_mean = jnp.mean(world_pts, axis=-2, keepdims=True)
    q_mean = jnp.mean(cam_pts, axis=-2, keepdims=True)
    H = jnp.einsum("...ni,...nj->...ij", cam_pts - q_mean, world_pts - p_mean)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = (U * D[..., None, :]) @ Vt
    t = q_mean[..., 0, :] - (R @ p_mean[..., 0, :, None])[..., 0]
    return R, t


def pose_from_three_points(feature_points: jax.Array, world_points: jax.Array):
    """Solve P3P for a batch of minimal samples.

    Grunert's system in the distances s_i = |P_i - C|: with u = s2/s1,
    v = s3/s1 the two ratio equations eliminate to a quartic in v; u follows
    linearly, distances by back-substitution, and the pose by 3-point rigid
    alignment. Parity target: `PoseFromThreePoints`
    (`perspective_three_point.h:56`) — same inputs, up to 4 masked solutions.
    """
    dtype = feature_points.dtype
    ones = jnp.ones_like(feature_points[..., :1])
    bearings = jnp.concatenate([feature_points, ones], axis=-1)
    bearings = bearings / jnp.linalg.norm(bearings, axis=-1, keepdims=True)
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = world_points[..., 0, :], world_points[..., 1, :], world_points[..., 2, :]

    # Squared side lengths and bearing cosines. Normalizing the scene scale
    # keeps the quartic coefficients O(1) — essential in f32.
    A = jnp.sum((P2 - P3) ** 2, axis=-1)  # a^2, opposite P1
    B = jnp.sum((P1 - P3) ** 2, axis=-1)  # b^2
    C = jnp.sum((P1 - P2) ** 2, axis=-1)  # c^2
    scale_sq = (A + B + C) / 3.0
    safe_scale = jnp.maximum(scale_sq, 1e-20)
    A = A / safe_scale
    B = B / safe_scale
    C = C / safe_scale
    ca = jnp.sum(f2 * f3, axis=-1)
    cb = jnp.sum(f1 * f3, axis=-1)
    cg = jnp.sum(f1 * f2, axis=-1)

    # Quartic in v = s3/s1 (sympy-derived; common factor B^2 dropped).
    a4 = A**2 - 2 * A * B - 2 * A * C + B**2 - 4 * B * C * ca**2 + 2 * B * C + C**2
    a3 = 4 * (
        -(A**2) * cb
        + A * B * ca * cg
        + A * B * cb
        + 2 * A * C * cb
        - B**2 * ca * cg
        + 2 * B * C * ca**2 * cb
        + B * C * ca * cg
        - B * C * cb
        - C**2 * cb
    )
    a2 = 2 * (
        2 * A**2 * cb**2
        + A**2
        - 4 * A * B * ca * cb * cg
        - 2 * A * B * cg**2
        - 4 * A * C * cb**2
        - 2 * A * C
        + 2 * B**2 * ca**2
        + 2 * B**2 * cg**2
        - B**2
        - 2 * B * C * ca**2
        - 4 * B * C * ca * cb * cg
        + 2 * C**2 * cb**2
        + C**2
    )
    a1 = 4 * (
        -(A**2) * cb
        + A * B * ca * cg
        + 2 * A * B * cb * cg**2
        - A * B * cb
        + 2 * A * C * cb
        - B**2 * ca * cg
        + B * C * ca * cg
        + B * C * cb
        - C**2 * cb
    )
    a0 = A**2 - 4 * A * B * cg**2 + 2 * A * B - 2 * A * C + B**2 - 2 * B * C + C**2

    v_roots, v_valid = poly.solve_quartic(a4, a3, a2, a1, a0, newton_iters=3)

    # u from the difference of the two ratio equations (linear in u).
    v = v_roots
    Ab = A[..., None]
    Bb = B[..., None]
    Cb = C[..., None]
    cab, cbb, cgb = ca[..., None], cb[..., None], cg[..., None]
    denom = 2.0 * Bb * (cgb - cab * v)
    numer = (Ab - Bb - Cb) * v * v - 2.0 * (Ab - Cb) * cbb * v + (Ab + Bb - Cb)
    safe = jnp.abs(denom) > 1e-12
    u = numer / jnp.where(safe, denom, 1.0)

    # 2D Newton polish of (u, v) on the original Grunert ratio equations —
    # recovers f64-grade roots when running in f32.
    for _ in range(4):
        g1 = Bb * (u * u + v * v - 2.0 * u * v * cab) - Ab * (
            1.0 + v * v - 2.0 * v * cbb
        )
        g2 = Bb * (1.0 + u * u - 2.0 * u * cgb) - Cb * (1.0 + v * v - 2.0 * v * cbb)
        d1u = Bb * (2.0 * u - 2.0 * v * cab)
        d1v = Bb * (2.0 * v - 2.0 * u * cab) - Ab * (2.0 * v - 2.0 * cbb)
        d2u = Bb * (2.0 * u - 2.0 * cgb)
        d2v = -Cb * (2.0 * v - 2.0 * cbb)
        det_j = d1u * d2v - d1v * d2u
        ok_j = jnp.abs(det_j) > 1e-20
        inv_det = 1.0 / jnp.where(ok_j, det_j, 1.0)
        du = (g1 * d2v - g2 * d1v) * inv_det
        dv = (g2 * d1u - g1 * d2u) * inv_det
        u = jnp.where(ok_j, u - du, u)
        v = jnp.where(ok_j, v - dv, v)

    # Distances: s1 from the b^2 equation, then s2 = u s1, s3 = v s1.
    # (Undo the scene-scale normalization here.)
    s1_sq = Bb * safe_scale[..., None] / jnp.maximum(
        1.0 + v * v - 2.0 * v * cbb, 1e-12
    )
    s1 = jnp.sqrt(jnp.maximum(s1_sq, 0.0))
    s2 = u * s1
    s3 = v * s1
    valid = v_valid & safe & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points and rigid alignment per candidate.
    cam_pts = jnp.stack(
        [
            s1[..., None] * f1[..., None, :],
            s2[..., None] * f2[..., None, :],
            s3[..., None] * f3[..., None, :],
        ],
        axis=-2,
    )  # [.., 4, 3, 3]
    world_b = jnp.broadcast_to(world_points[..., None, :, :], cam_pts.shape)
    R, t = align_point_triads(world_b, cam_pts)

    # Sanity: reprojection of the three points must be finite & in front.
    depths = (R @ jnp.swapaxes(world_b, -1, -2) + t[..., :, None])[..., 2, :]
    valid = valid & jnp.all(depths > 0, axis=-1) & jnp.all(jnp.isfinite(t), axis=-1)
    t = jnp.where(valid[..., None], t, 0.0)
    R = jnp.where(valid[..., None, None], R, jnp.eye(3, dtype=dtype))
    return R, t, valid
