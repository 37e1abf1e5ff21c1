"""Two-view bundle adjustment and epipolar refinement.

Batched equivalents of
`/root/reference/src/theia/sfm/bundle_adjustment/bundle_adjust_two_views.h`:
  - ``BundleAdjustTwoViews``          (`:64` — joint pose+points two-view BA)
  - ``BundleAdjustTwoViewsAngular``   (`:79` — angular epipolar error on the
                                       unit sphere, `angular_epipolar_error.h`)
  - ``OptimizeFundamentalMatrix``     (`:88` — F refinement on its 7-DOF
                                       manifold, `fundamental_matrix_parameterization.h`)
  - ``OptimizeHomography``            (`:94` — H refinement,
                                       `homography_error.h`)

All solvers are fixed-iteration damped Gauss-Newton on batched
correspondence tensors — each is jittable and vmaps over pairs, which is how
the matching pipeline runs thousands of pair refinements per device step
(the reference loops pairs over a thread pool and calls Ceres per pair).

Convention: camera 1 is the gauge (identity); the relative pose maps
points from camera-1 frame to camera-2 frame: x2 = R x1 + t (t up to scale,
|t| kept at its input norm for the joint BA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
    rotation_matrix_to_angle_axis,
)
from ..ops import triangulation as tri
from .losses import LossFunctionType, loss_weight

__all__ = [
    "bundle_adjust_two_views",
    "bundle_adjust_two_views_angular",
    "optimize_fundamental_matrix",
    "optimize_homography",
]


def _gn(residual_fn, params, iters, damp0=1e-6):
    """Generic small-problem damped GN with monotone fallback, batch-safe:
    params [.., P], residual_fn [.., P] -> [.., R]."""

    def cost(p):
        r = residual_fn(p)
        return jnp.sum(r * r, axis=-1)

    def step(_, carry):
        p, mu = carry
        r = residual_fn(p)
        basis = jnp.eye(p.shape[-1], dtype=p.dtype)
        J = jnp.stack(
            [
                jax.jvp(residual_fn, (p,), (jnp.broadcast_to(b, p.shape),))[1]
                for b in basis
            ],
            axis=-1,
        )  # [.., R, P]
        JTJ = jnp.einsum("...ri,...rj->...ij", J, J)
        JTr = jnp.einsum("...ri,...r->...i", J, r)
        eye = jnp.eye(p.shape[-1], dtype=p.dtype)
        delta = jnp.linalg.solve(
            JTJ + mu[..., None, None] * eye, -JTr[..., None]
        )[..., 0]
        p_new = p + delta
        better = cost(p_new) < cost(p)
        mu_new = jnp.where(better, mu * 0.3, mu * 8.0)
        p_next = jnp.where(better[..., None], p_new, p)
        return p_next, jnp.clip(mu_new, 1e-12, 1e6)

    mu0 = jnp.full(params.shape[:-1], damp0, params.dtype)
    p, _ = jax.lax.fori_loop(0, iters, lambda i, c: step(i, c), (params, mu0))
    return p, cost(p)


def bundle_adjust_two_views(
    rotation_aa,
    position,
    points1,
    points2,
    mask=None,
    iters: int = 15,
    loss: LossFunctionType = LossFunctionType.TRIVIAL,
    loss_width: float = 1e-2,
):
    """Joint two-view BA: refine (R, t) and triangulated points.

    Parity: `BundleAdjustTwoViews` (`bundle_adjust_two_views.h:64`). Points
    are re-triangulated in closed form each GN step (variable projection —
    the Schur complement taken exactly), so the GN state is just the 6-DOF
    relative pose. points1/points2 are normalized (calibrated) image points.

    Args:
      rotation_aa [.., 3]; position [.., 3] (camera-2 position in camera-1
      frame, i.e. t = -R·position); points1/points2 [.., N, 2]; mask [.., N].

    Returns:
      (rotation_aa, position, points3d [.., N, 3], valid_cost [..]).
    """
    dtype = points1.dtype
    if mask is None:
        mask = jnp.ones(points1.shape[:-1], dtype=bool)
    m = mask.astype(dtype)
    norm_pos = jnp.linalg.norm(position, axis=-1, keepdims=True)

    def triangulate(aa, pos):
        R2 = angle_axis_to_rotation_matrix(aa)
        pose1 = jnp.zeros(pos.shape[:-1] + (3, 4), dtype).at[..., :3, :3].set(
            jnp.eye(3, dtype=dtype)
        )
        t2 = -jnp.einsum("...ij,...j->...i", R2, pos)
        pose2 = jnp.concatenate([R2, t2[..., None]], axis=-1)
        p1b = jnp.broadcast_to(pose1[..., None, :, :], points1.shape[:-1] + (3, 4))
        p2b = jnp.broadcast_to(pose2[..., None, :, :], points1.shape[:-1] + (3, 4))
        X4 = tri.triangulate(p1b, p2b, points1, points2)
        w = jnp.where(jnp.abs(X4[..., 3:4]) < 1e-12, 1e-12, X4[..., 3:4])
        return X4[..., :3] / w

    def residuals(p):
        aa, pos = p[..., :3], p[..., 3:6]
        pos = pos / jnp.maximum(
            jnp.linalg.norm(pos, axis=-1, keepdims=True), 1e-12
        ) * norm_pos
        X = triangulate(aa, pos)
        # View 1 (identity) reprojection.
        z1 = jnp.where(jnp.abs(X[..., 2]) < 1e-12, 1e-12, X[..., 2])
        r1 = X[..., :2] / z1[..., None] - points1
        # View 2.
        Xc = angle_axis_rotate_point(
            aa[..., None, :], X - pos[..., None, :]
        )
        z2 = jnp.where(jnp.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        r2 = Xc[..., :2] / z2[..., None] - points2
        r = jnp.concatenate([r1, r2], axis=-1)
        if loss != LossFunctionType.TRIVIAL:
            s = jnp.sum(r * r, axis=-1)
            r = r * jnp.sqrt(loss_weight(s, loss, loss_width))[..., None]
        return (r * m[..., None]).reshape(*r.shape[:-2], -1)

    p0 = jnp.concatenate([rotation_aa, position], axis=-1)
    p, cost = _gn(residuals, p0, iters)
    aa, pos = p[..., :3], p[..., 3:6]
    pos = pos / jnp.maximum(jnp.linalg.norm(pos, axis=-1, keepdims=True), 1e-12) * norm_pos
    return aa, pos, triangulate(aa, pos), cost


def bundle_adjust_two_views_angular(
    rotation_aa, position, points1, points2, mask=None, iters: int = 15
):
    """Refine relative pose with the angular epipolar error — no points.

    Parity: `BundleAdjustTwoViewsAngular` (`bundle_adjust_two_views.h:79`,
    `angular_epipolar_error.h`): residual is the epipolar constraint on
    unit-sphere bearings, r = f2ᵀ E f1 normalized by the epipolar line
    norms (Sampson on the sphere). Translation lives on the unit sphere.
    """
    dtype = points1.dtype
    if mask is None:
        mask = jnp.ones(points1.shape[:-1], dtype=bool)
    m = mask.astype(dtype)
    ones = jnp.ones_like(points1[..., :1])
    f1 = jnp.concatenate([points1, ones], axis=-1)
    f1 = f1 / jnp.linalg.norm(f1, axis=-1, keepdims=True)
    f2 = jnp.concatenate([points2, ones], axis=-1)
    f2 = f2 / jnp.linalg.norm(f2, axis=-1, keepdims=True)

    def residuals(p):
        aa, pos = p[..., :3], p[..., 3:6]
        t_unit = pos / jnp.maximum(jnp.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)
        R = angle_axis_to_rotation_matrix(aa)
        t = -jnp.einsum("...ij,...j->...i", R, t_unit)
        tx = jnp.stack(
            [
                jnp.stack([jnp.zeros_like(t[..., 0]), -t[..., 2], t[..., 1]], -1),
                jnp.stack([t[..., 2], jnp.zeros_like(t[..., 0]), -t[..., 0]], -1),
                jnp.stack([-t[..., 1], t[..., 0], jnp.zeros_like(t[..., 0])], -1),
            ],
            -2,
        )
        E = tx @ R
        Ef1 = jnp.einsum("...ij,...nj->...ni", E, f1)
        Etf2 = jnp.einsum("...ji,...nj->...ni", E, f2)
        num = jnp.einsum("...ni,...ni->...n", f2, Ef1)
        den = jnp.sqrt(
            jnp.sum(Ef1[..., :2] ** 2, -1) + jnp.sum(Etf2[..., :2] ** 2, -1) + 1e-20
        )
        return (num / den) * m

    p0 = jnp.concatenate([rotation_aa, position], axis=-1)
    p, cost = _gn(residuals, p0, iters)
    aa, pos = p[..., :3], p[..., 3:6]
    pos = pos / jnp.maximum(jnp.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)
    return aa, pos, cost


def optimize_fundamental_matrix(F, points1, points2, mask=None, iters: int = 60):
    """Refine F on its 7-DOF manifold minimizing Sampson distance.

    Parity: `OptimizeFundamentalMatrix` (`bundle_adjust_two_views.h:88`,
    `fundamental_matrix_parameterization.h`). Parametrization: F = U diag(s,
    1-ish…) — here the classic SVD manifold: F(p) with left/right rotation
    perturbations and one singular-value ratio, enforcing rank 2 exactly.

    points are pixels; F maps 1→2 (x2ᵀ F x1 = 0). Returns (F, cost).
    """
    dtype = points1.dtype
    if mask is None:
        mask = jnp.ones(points1.shape[:-1], dtype=bool)
    m = mask.astype(dtype)

    # Hartley normalization: raw pixel coordinates make the Sampson
    # landscape so ill-conditioned that GN stalls in a local minimum.
    def norm_T(pts):
        c = jnp.mean(pts, axis=-2, keepdims=True)
        s = jnp.mean(jnp.linalg.norm(pts - c, axis=-1), axis=-1)
        s = jnp.sqrt(jnp.asarray(2.0, dtype)) / jnp.maximum(s, 1e-12)
        return c[..., 0, :], s

    c1, s1 = norm_T(points1)
    c2, s2 = norm_T(points2)
    points1 = (points1 - c1[..., None, :]) * s1[..., None, None]
    points2 = (points2 - c2[..., None, :]) * s2[..., None, None]

    def T_of(c, s):
        z = jnp.zeros_like(s)
        o = jnp.ones_like(s)
        return jnp.stack(
            [
                jnp.stack([s, z, -s * c[..., 0]], -1),
                jnp.stack([z, s, -s * c[..., 1]], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )

    T1 = T_of(c1, s1)
    T2 = T_of(c2, s2)
    # x2ᵀ F x1 = (T2 x2)ᵀ F_n (T1 x1) with F_n = T2⁻ᵀ F T1⁻¹.
    F = jnp.swapaxes(jnp.linalg.inv(T2), -1, -2) @ F @ jnp.linalg.inv(T1)

    U0, s0, Vt0 = jnp.linalg.svd(F)
    # Rank-2 projection; parameters: [du(3), dv(3), log sigma ratio].
    ratio0 = jnp.log(jnp.maximum(s0[..., 1] / jnp.maximum(s0[..., 0], 1e-20), 1e-8))

    def build_F(p):
        du, dv, lr = p[..., 0:3], p[..., 3:6], p[..., 6]
        Ru = angle_axis_to_rotation_matrix(du)
        Rv = angle_axis_to_rotation_matrix(dv)
        U = U0 @ Ru
        Vt = Rv @ Vt0
        s = jnp.stack(
            [jnp.ones_like(lr), jnp.exp(ratio0 + lr), jnp.zeros_like(lr)], -1
        )
        return (U * s[..., None, :]) @ Vt

    ones = jnp.ones_like(points1[..., :1])
    x1 = jnp.concatenate([points1, ones], -1)
    x2 = jnp.concatenate([points2, ones], -1)

    def residuals(p):
        Fm = build_F(p)
        Fx1 = jnp.einsum("...ij,...nj->...ni", Fm, x1)
        Ftx2 = jnp.einsum("...ji,...nj->...ni", Fm, x2)
        num = jnp.einsum("...ni,...ni->...n", x2, Fx1)
        den = jnp.sqrt(
            jnp.sum(Fx1[..., :2] ** 2, -1) + jnp.sum(Ftx2[..., :2] ** 2, -1) + 1e-20
        )
        return (num / den) * m

    p0 = jnp.zeros(F.shape[:-2] + (7,), dtype)
    p, cost = _gn(residuals, p0, iters)
    # Denormalize: F = T2ᵀ F_n T1, then |F| = 1 convention.
    F_out = jnp.swapaxes(T2, -1, -2) @ build_F(p) @ T1
    F_out = F_out / jnp.maximum(
        jnp.linalg.norm(F_out, axis=(-2, -1), keepdims=True), 1e-20
    )
    return F_out, cost


def optimize_homography(H, points1, points2, mask=None, iters: int = 15):
    """Refine a homography minimizing symmetric transfer error.

    Parity: `OptimizeHomography` (`bundle_adjust_two_views.h:94`,
    `homography_error.h`). H maps 1→2. Returns (H normalized h33=1, cost)."""
    dtype = points1.dtype
    if mask is None:
        mask = jnp.ones(points1.shape[:-1], dtype=bool)
    m = mask.astype(dtype)
    H0 = H / jnp.where(
        jnp.abs(H[..., 2:3, 2:3]) < 1e-12, 1e-12, H[..., 2:3, 2:3]
    )
    ones = jnp.ones_like(points1[..., :1])
    x1 = jnp.concatenate([points1, ones], -1)

    def residuals(p):
        Hm = H0 + p.reshape(*p.shape[:-1], 3, 3)
        Hx1 = jnp.einsum("...ij,...nj->...ni", Hm, x1)
        z = jnp.where(jnp.abs(Hx1[..., 2:3]) < 1e-12, 1e-12, Hx1[..., 2:3])
        fwd = Hx1[..., :2] / z - points2
        return (fwd * m[..., None]).reshape(*fwd.shape[:-2], -1)

    p0 = jnp.zeros(H.shape[:-2] + (9,), dtype)
    # Keep h33 fixed (gauge) by zeroing its update direction via masking in
    # residual parametrization: the GN may still move it; re-normalize after.
    p, cost = _gn(residuals, p0, iters)
    H_out = H0 + p.reshape(*p.shape[:-1], 3, 3)
    H_out = H_out / jnp.where(
        jnp.abs(H_out[..., 2:3, 2:3]) < 1e-12, 1e-12, H_out[..., 2:3, 2:3]
    )
    return H_out, cost
