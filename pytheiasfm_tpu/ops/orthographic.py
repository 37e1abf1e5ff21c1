"""Planar uncalibrated orthographic pose (pyTheia addition).

Batched equivalent of `PlanarUncalibratedOrthographicPose`
(`/root/reference/src/theia/sfm/pose/orthographic_four_point.h:13,20`):
pose + magnification of an orthographic camera observing a *planar* scene
(world points with z = 0), from >= 4 correspondences.

Model: pixel = m * [r1^T; r2^T] X + t2, with r1, r2 the first two rows of a
rotation matrix and m the magnification (focal * scale). For planar X only
the first two columns of R act, so the data determine a 2x2 affine A and a
2-vector t by linear least squares; the metric upgrade recovers m and the
out-of-plane components in closed form from the orthonormality of (r1, r2)
(single-view Tomasi-Kanade style): with a1, a2 the rows of A,

    |a1|^2 + m^2 r13^2 = m^2,   |a2|^2 + m^2 r23^2 = m^2,
    a1.a2 + m^2 r13 r23 = 0
    =>  m^2 is the larger root of
        x^2 - (|a1|^2 + |a2|^2) x + (|a1|^2 |a2|^2 - (a1.a2)^2) = 0.

Two sign choices of (r13, r23) give the usual planar two-fold ambiguity;
both solutions are returned (matching the reference's solution vector).
Fully batched; closed form (one quadratic), no iteration.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["planar_uncalibrated_orthographic_pose"]


def planar_uncalibrated_orthographic_pose(features, world_points, principal_point=None):
    """Orthographic pose + magnification for a planar scene.

    Args:
      features: [.., N, 2] pixels (N >= 4; reference uses 4).
      world_points: [.., N, 3] planar points (z must be ~0).
      principal_point: optional [.., 2] subtracted from features.

    Returns:
      (rotations [.., 2, 3, 3], translations [.., 2, 3],
       magnification [..], valid [.., 2]).
    """
    dtype = features.dtype
    if principal_point is not None:
        features = features - principal_point[..., None, :]
    xy = world_points[..., :2]

    # Linear least squares for [A | t]: pixel = A xy + t.
    ones = jnp.ones_like(xy[..., :1])
    D = jnp.concatenate([xy, ones], axis=-1)  # [.., N, 3]
    DtD = jnp.einsum("...ni,...nj->...ij", D, D)
    Dtp = jnp.einsum("...ni,...nk->...ik", D, features)  # [.., 3, 2]
    sol = jnp.linalg.solve(DtD, Dtp)  # [.., 3, 2]
    A = jnp.swapaxes(sol[..., :2, :], -1, -2)  # [.., 2, 2] rows a1, a2
    t2 = sol[..., 2, :]  # [.., 2]

    a1, a2 = A[..., 0, :], A[..., 1, :]
    n1 = jnp.sum(a1 * a1, axis=-1)
    n2 = jnp.sum(a2 * a2, axis=-1)
    dot = jnp.sum(a1 * a2, axis=-1)
    # m^2 = larger quadratic root.
    half_b = 0.5 * (n1 + n2)
    disc = jnp.sqrt(jnp.maximum(half_b**2 - (n1 * n2 - dot**2), 0.0))
    m_sq = half_b + disc
    m = jnp.sqrt(jnp.maximum(m_sq, 1e-20))

    r13_sq = jnp.maximum(1.0 - n1 / m_sq, 0.0)
    r23_sq = jnp.maximum(1.0 - n2 / m_sq, 0.0)
    r13 = jnp.sqrt(r13_sq)
    # Sign of r23 fixed by a1.a2 + m^2 r13 r23 = 0.
    r23_mag = jnp.sqrt(r23_sq)
    sign = -jnp.sign(dot)
    sign = jnp.where(sign == 0, 1.0, sign)
    r23 = sign * r23_mag

    def build(r13_s, r23_s):
        r1 = jnp.concatenate([a1 / m[..., None], r13_s[..., None]], axis=-1)
        r2 = jnp.concatenate([a2 / m[..., None], r23_s[..., None]], axis=-1)
        # Re-orthonormalize (numerical safety) and complete with r3.
        r1n = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
        r2o = r2 - jnp.sum(r2 * r1n, axis=-1, keepdims=True) * r1n
        r2n = r2o / jnp.linalg.norm(r2o, axis=-1, keepdims=True)
        r3 = jnp.cross(r1n, r2n)
        return jnp.stack([r1n, r2n, r3], axis=-2)

    R_a = build(r13, r23)
    R_b = build(-r13, -r23)
    rotations = jnp.stack([R_a, R_b], axis=-3)
    # Translation: orthographic z-offset is unobservable; convention t3 = 0,
    # pixel translation stored in (x, y) (matches the reference's
    # [t2; 0] layout scaled by 1/m so that m*[R|t] reprojects).
    t3 = jnp.zeros_like(t2[..., :1])
    trans = jnp.concatenate([t2 / m[..., None], t3], axis=-1)
    translations = jnp.stack([trans, trans], axis=-2)

    # Validity: residual of the metric-upgrade equations.
    resid = jnp.abs(dot + m_sq * r13 * r23) / jnp.maximum(m_sq, 1e-20)
    tol = jnp.asarray(1e-3 if dtype == jnp.float32 else 1e-8, dtype)
    valid = jnp.stack([resid < tol, resid < tol], axis=-1)
    return rotations, translations, m, valid
