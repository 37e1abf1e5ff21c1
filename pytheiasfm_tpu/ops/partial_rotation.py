"""Known-rotation-axis ("partial rotation") minimal pose solvers.

Batched equivalents of the reference's known-axis family
(`/root/reference/src/theia/sfm/pose/`):
  - ``TwoPointPosePartialRotation``       (two_point_pose_partial_rotation.h)
  - ``ThreePointRelativePosePartialRotation``
                              (three_point_relative_pose_partial_rotation.h)
  - ``FourPointRelativePosePartialRotation``  (generalized cameras,
                              four_point_relative_pose_partial_rotation.h)
  - ``SimTransformPartialRotation``       (sim_transform_partial_rotation.h)

The reference solves each with a bespoke quaternion elimination (QR/sparse
null-space plus quadratic/quartic in one quaternion component). Here all four
share one accelerator-first mechanism: with the rotation written in tan-half-angle
form about the known unit axis ``a``,

    R(w) = I + (2w/(1+w^2)) [a]_x + (2w^2/(1+w^2)) [a]_x^2 ,
    M(w) = (1+w^2) R(w)   — a *quadratic matrix polynomial* in w,

every constraint set becomes ``G(w) y = 0`` with ``y`` the homogeneous vector
of remaining linear unknowns (translation, scale, 1) and ``G`` polynomial in
w. ``det G(w) = 0`` is a univariate polynomial whose coefficients we recover
by **evaluation + interpolation**: evaluate det G at D+1 Chebyshev nodes (a
batched determinant — pure dense elementwise/matmul work), multiply by a precomputed inverse-
Vandermonde (trace-time numpy constant), then run the branchless real-root
finder. Back-substitution recovers y per root. This is branch-free,
fixed-shape, and vmaps over batches of samples — unlike the reference's
per-sample Eigen eliminations.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import polynomial as poly

__all__ = [
    "two_point_pose_partial_rotation",
    "three_point_relative_pose_partial_rotation",
    "four_point_relative_pose_partial_rotation",
    "sim_transform_partial_rotation",
    "axis_rotation_matrix",
]


def _hat(a):
    zero = jnp.zeros_like(a[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -a[..., 2], a[..., 1]], axis=-1),
            jnp.stack([a[..., 2], zero, -a[..., 0]], axis=-1),
            jnp.stack([-a[..., 1], a[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def axis_rotation_matrix(axis, w):
    """R(w): rotation by angle 2*atan(w) about unit ``axis``.

    ``w`` may carry extra leading batch dims relative to ``axis``.
    """
    K = _hat(axis)
    K2 = K @ K
    denom = 1.0 + w**2
    s = 2.0 * w / denom
    c1 = 2.0 * w**2 / denom
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + s[..., None, None] * K + c1[..., None, None] * K2


def _m_poly(axis, w):
    """M(w) = (1+w^2) I + 2w [a]_x + 2w^2 [a]_x^2 (quadratic in w)."""
    K = _hat(axis)
    K2 = K @ K
    eye = jnp.eye(3, dtype=w.dtype)
    return (
        (1.0 + w**2)[..., None, None] * eye
        + (2.0 * w)[..., None, None] * K
        + (2.0 * w**2)[..., None, None] * K2
    )


def _cheb_nodes(n: int) -> np.ndarray:
    # Chebyshev nodes scaled to a generous root window; tan-half-angle roots
    # of geometric problems are O(1), and interpolation conditioning only
    # needs coverage, not tightness.
    k = np.arange(n)
    return 3.0 * np.cos((2 * k + 1) * np.pi / (2 * n))


def _det_poly_coeffs(det_fn, degree: int, dtype, clear_power: int = 0):
    """Interpolate coeffs (numpy order, highest first) of w -> det_fn(w).

    det_fn maps a [K]-vector of nodes to [.., K] determinant values.
    ``clear_power``: divide samples by (1+w^2)^clear_power — the known
    root-free factor the tan-half-angle clearing introduces. Dividing it out
    drops the interpolation degree by 2*clear_power, which is what keeps the
    monomial-basis Vandermonde well-conditioned in f32/f64.
    """
    eff_degree = degree - 2 * clear_power
    nodes = _cheb_nodes(eff_degree + 1)
    # Vandermonde in numpy (trace-time constant), pseudo-inverse for
    # conditioning; columns ordered highest power first to match polyval.
    V = np.vander(nodes, eff_degree + 1, increasing=False)
    V_pinv = np.linalg.pinv(V).astype(np.float64)
    nodes_j = jnp.asarray(nodes, dtype)
    vals = det_fn(nodes_j)  # [.., K]
    if clear_power:
        vals = vals / (1.0 + nodes_j**2) ** clear_power
    return jnp.einsum("ck,...k->...c", jnp.asarray(V_pinv, dtype), vals)


def _roots_from_det(det_fn, degree: int, dtype, max_roots: int, clear_power: int = 0):
    coeffs = _det_poly_coeffs(det_fn, degree, dtype, clear_power)
    roots, valid = poly.find_real_polynomial_roots(coeffs)
    # Keep the `max_roots` best-conditioned slots (valid ones first).
    order = jnp.argsort(jnp.where(valid, 0.0, 1.0), axis=-1, stable=True)
    take = order[..., :max_roots]
    return (
        jnp.take_along_axis(roots, take, axis=-1),
        jnp.take_along_axis(valid, take, axis=-1),
    )


def _ortho_basis(r):
    """Two orthonormal vectors spanning the plane orthogonal to each unit
    vector r [.., 3] -> [.., 2, 3]."""
    # Pick the seed axis least aligned with r (branch-free).
    abs_r = jnp.abs(r)
    seed = jnp.where(
        (abs_r[..., 0:1] <= abs_r[..., 1:2]) & (abs_r[..., 0:1] <= abs_r[..., 2:3]),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], r.dtype), r.shape),
        jnp.where(
            abs_r[..., 1:2] <= abs_r[..., 2:3],
            jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], r.dtype), r.shape),
            jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], r.dtype), r.shape),
        ),
    )
    b1 = jnp.cross(r, seed)
    b1 = b1 / jnp.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = jnp.cross(r, b1)
    return jnp.stack([b1, b2], axis=-2)


def two_point_pose_partial_rotation(axis, model_points, image_rays):
    """Absolute pose with known rotation axis from two 2D-3D rays.

    Parity: `TwoPointPosePartialRotation`
    (`pose/two_point_pose_partial_rotation.h:56`): camera ray_i is parallel
    to R p_i + t with R a rotation about ``axis``.

    Args:
      axis: [3] unit rotation axis.
      model_points: [.., 2, 3] 3D points.
      image_rays: [.., 2, 3] ray directions in camera frame (need not be unit).

    Returns:
      (rotations [.., 2, 3, 3], translations [.., 2, 3], valid [.., 2]).
    """
    dtype = image_rays.dtype
    rays = image_rays / jnp.linalg.norm(image_rays, axis=-1, keepdims=True)
    B = _ortho_basis(rays)  # [.., 2, 2, 3]
    B_flat = B.reshape(*B.shape[:-3], 4, 3)  # rows: b_{1,1} b_{1,2} b_{2,1} b_{2,2}
    p_sel = jnp.stack(
        [
            model_points[..., 0, :],
            model_points[..., 0, :],
            model_points[..., 1, :],
            model_points[..., 1, :],
        ],
        axis=-2,
    )  # [.., 4, 3]

    def G_of(w):  # w [..] scalar -> [.., 4, 4]
        M = _m_poly(axis.astype(dtype), w)  # [.., 3, 3]
        Mp = jnp.einsum("...jk,...rk->...rj", M, p_sel)  # [.., 4, 3]
        c_last = jnp.sum(B_flat * Mp, axis=-1)  # [.., 4]
        c_t = (1.0 + w**2)[..., None, None] * B_flat
        return jnp.concatenate([c_t, c_last[..., None]], axis=-1)

    def det_fn(nodes):
        def det_at(w):
            wb = jnp.broadcast_to(w, image_rays.shape[:-2])
            return jnp.linalg.det(G_of(wb))

        return jnp.stack([det_at(n) for n in nodes], axis=-1)

    # Columns 1-3 degree 2, column 4 degree 2 -> det degree <= 8.
    roots, valid = _roots_from_det(det_fn, 8, dtype, max_roots=2, clear_power=3)

    def solve_at(w):
        G = G_of(w)
        # t from the first 3 equations: (1+w^2) B[:3] t = -c_last[:3].
        A = G[..., :3, :3]
        b = -G[..., :3, 3]
        t = jnp.linalg.solve(A, b[..., None])[..., 0]
        resid = jnp.abs(
            jnp.einsum("...j,...j->...", G[..., 3, :3], t) + G[..., 3, 3]
        )
        return t, resid

    w_b = jnp.moveaxis(roots, -1, 0)  # [2, ..]
    t_all, resid_all = jax.vmap(solve_at)(w_b)
    R_all = jax.vmap(lambda w: axis_rotation_matrix(axis.astype(dtype), w))(w_b)
    rotations = jnp.moveaxis(R_all, 0, -3)
    translations = jnp.moveaxis(t_all, 0, -2)
    resid = jnp.moveaxis(resid_all, 0, -1)
    tol = jnp.asarray(1e-4 if dtype == jnp.float32 else 1e-8, dtype)
    scale = 1.0 + jnp.linalg.norm(translations, axis=-1)
    valid = valid & (resid < tol * scale)
    return rotations, translations, valid


def three_point_relative_pose_partial_rotation(axis, image1_rays, image2_rays):
    """Relative pose (R about known axis, t up to scale) from 3 ray pairs.

    Parity: `ThreePointRelativePosePartialRotation`
    (`pose/three_point_relative_pose_partial_rotation.h:57`). Constraint per
    correspondence: r2 . (t x R r1) = 0, i.e. t . (R r1 x r2) = 0.

    Args:
      axis: [3] unit axis; image{1,2}_rays: [.., 3, 3].

    Returns:
      (rotations [.., 6, 3, 3], translations [.., 6, 3] unit-norm,
       valid [.., 6]).
    """
    dtype = image1_rays.dtype
    r1 = image1_rays / jnp.linalg.norm(image1_rays, axis=-1, keepdims=True)
    r2 = image2_rays / jnp.linalg.norm(image2_rays, axis=-1, keepdims=True)

    def A_of(w):  # [.., 3, 3]; rows = (M(w) r1_i) x r2_i
        M = _m_poly(axis.astype(dtype), w)
        Mr1 = jnp.einsum("...jk,...ik->...ij", M, r1)
        return jnp.cross(Mr1, r2)

    def det_fn(nodes):
        def det_at(w):
            wb = jnp.broadcast_to(w, image1_rays.shape[:-2])
            return jnp.linalg.det(A_of(wb))

        return jnp.stack([det_at(n) for n in nodes], axis=-1)

    roots, valid = _roots_from_det(det_fn, 6, dtype, max_roots=6)

    def solve_at(w):
        A = A_of(w)
        # Null vector of A via SVD (3x3 — cheap, batched).
        _, s, Vt = jnp.linalg.svd(A)
        t = Vt[..., 2, :]
        resid = s[..., 2] / jnp.maximum(s[..., 0], 1e-20)
        return t, resid

    w_b = jnp.moveaxis(roots, -1, 0)
    t_all, resid_all = jax.vmap(solve_at)(w_b)
    R_all = jax.vmap(lambda w: axis_rotation_matrix(axis.astype(dtype), w))(w_b)
    rotations = jnp.moveaxis(R_all, 0, -3)
    translations = jnp.moveaxis(t_all, 0, -2)
    resid = jnp.moveaxis(resid_all, 0, -1)
    tol = jnp.asarray(1e-3 if dtype == jnp.float32 else 1e-7, dtype)
    valid = valid & (resid < tol)
    return rotations, translations, valid


def _generalized_rows(axis, w, d1, o1, d2, o2, dtype):
    """Rows of the generalized epipolar constraint, polynomial-cleared.

    Per correspondence (X2 = s R X1 + t with s handled by caller):
      t . (R d1 x d2) + (d2 x (s R o1 - o2)) . R d1 = 0
    multiplied through by (1+w^2)^2:
      coeff_t  = (M d1 x d2) (1+w^2)            [.., 3]
      coeff_s  = (d2 x  M o1) . M d1            [..]
      coeff_1  = -(d2 x o2) . M d1 (1+w^2)      [..]
    """
    M = _m_poly(axis.astype(dtype), w)
    Md1 = jnp.einsum("...jk,...ik->...ij", M, d1)
    Mo1 = jnp.einsum("...jk,...ik->...ij", M, o1)
    one = (1.0 + w**2)[..., None]
    coeff_t = jnp.cross(Md1, d2) * one[..., None]
    coeff_s = jnp.einsum("...ij,...ij->...i", jnp.cross(d2, Mo1), Md1)
    coeff_1 = -jnp.einsum("...ij,...ij->...i", jnp.cross(d2, o2), Md1) * one
    return coeff_t, coeff_s, coeff_1


def four_point_relative_pose_partial_rotation(
    axis, image1_directions, image1_origins, image2_directions, image2_origins
):
    """Generalized-camera relative pose with known rotation axis (4 rays).

    Parity: `FourPointRelativePosePartialRotation`
    (`pose/four_point_relative_pose_partial_rotation.h:59`).

    Args:
      axis [3]; image{1,2}_directions/origins: [.., 4, 3].

    Returns:
      (rotations [.., 8, 3, 3], translations [.., 8, 3], valid [.., 8]).
    """
    dtype = image1_directions.dtype
    d1 = image1_directions / jnp.linalg.norm(image1_directions, axis=-1, keepdims=True)
    d2 = image2_directions / jnp.linalg.norm(image2_directions, axis=-1, keepdims=True)

    def G_of(w):  # [.., 4, 4]: [coeff_t | coeff_s + coeff_1] with s=1
        ct, cs, c1 = _generalized_rows(
            axis, w, d1, image1_origins, d2, image2_origins, dtype
        )
        return jnp.concatenate([ct, (cs + c1)[..., None]], axis=-1)

    def det_fn(nodes):
        def det_at(w):
            wb = jnp.broadcast_to(w, d1.shape[:-2])
            return jnp.linalg.det(G_of(wb))

        return jnp.stack([det_at(n) for n in nodes], axis=-1)

    # All columns have degree <= 4 (M is quadratic, the (1+w^2) clearing
    # factor is also quadratic) -> det degree <= 16.
    roots, valid = _roots_from_det(det_fn, 16, dtype, max_roots=8, clear_power=3)

    def t_of(w):
        G = G_of(w)
        return jnp.linalg.solve(G[..., :3, :3], -G[..., :3, 3:4])[..., 0]

    def r_of(w):
        # Generalized epipolar constraint with the reconstructed pose and
        # the translation re-solved exactly (variable projection).
        t = t_of(w)
        R = axis_rotation_matrix(axis.astype(dtype), w)
        Rd1 = jnp.einsum("...jk,...ik->...ij", R, d1)
        Ro1 = jnp.einsum("...jk,...ik->...ij", R, image1_origins)
        lhs = jnp.cross(d2, Ro1 + t[..., None, :] - image2_origins)
        return jnp.einsum("...ij,...ij->...i", lhs, Rd1), lhs

    def solve_at(w):
        # Gauss-Newton polish in the single variable w — recovers accuracy
        # lost to determinant interpolation. jvp is batch-safe (per-batch
        # residuals depend only on their own w).
        def gn(_, w_c):
            r, dr = jax.jvp(lambda u: r_of(u)[0], (w_c,), (jnp.ones_like(w_c),))
            num = jnp.sum(r * dr, axis=-1)
            den = jnp.maximum(jnp.sum(dr * dr, axis=-1), 1e-30)
            return w_c - num / den

        w_r = jax.lax.fori_loop(0, 3, gn, w)
        resid, lhs = r_of(w_r)
        scale = 1.0 + jnp.linalg.norm(lhs, axis=-1)
        return w_r, t_of(w_r), jnp.max(jnp.abs(resid) / scale, axis=-1)

    w_b = jnp.moveaxis(roots, -1, 0)
    w_all, t_all, resid_all = jax.vmap(solve_at)(w_b)
    R_all = jax.vmap(lambda w: axis_rotation_matrix(axis.astype(dtype), w))(w_all)
    rotations = jnp.moveaxis(R_all, 0, -3)
    translations = jnp.moveaxis(t_all, 0, -2)
    resid = jnp.moveaxis(resid_all, 0, -1)
    tol = jnp.asarray(1e-3 if dtype == jnp.float32 else 1e-6, dtype)
    valid = valid & (resid < tol)
    return rotations, translations, valid


def sim_transform_partial_rotation(
    axis, image1_directions, image1_origins, image2_directions, image2_origins
):
    """Similarity transform (scale + known-axis rotation + translation) from
    five generalized ray correspondences.

    Parity: `SimTransformPartialRotation`
    (`pose/sim_transform_partial_rotation.h:61`): X2 = s R X1 + t.

    Args:
      axis [3]; image{1,2}_directions/origins: [.., 5, 3].

    Returns:
      (rotations [.., 8, 3, 3], translations [.., 8, 3], scales [.., 8],
       valid [.., 8]).
    """
    dtype = image1_directions.dtype
    d1 = image1_directions / jnp.linalg.norm(image1_directions, axis=-1, keepdims=True)
    d2 = image2_directions / jnp.linalg.norm(image2_directions, axis=-1, keepdims=True)

    def G_of(w):  # [.., 5, 5]: columns [t(3) | s | 1]
        ct, cs, c1 = _generalized_rows(
            axis, w, d1, image1_origins, d2, image2_origins, dtype
        )
        return jnp.concatenate([ct, cs[..., None], c1[..., None]], axis=-1)

    def det_fn(nodes):
        def det_at(w):
            wb = jnp.broadcast_to(w, d1.shape[:-2])
            return jnp.linalg.det(G_of(wb))

        return jnp.stack([det_at(n) for n in nodes], axis=-1)

    # All five columns have degree <= 4 -> det degree <= 20.
    roots, valid = _roots_from_det(det_fn, 20, dtype, max_roots=8, clear_power=4)

    def y_of(w):
        G = G_of(w)
        return jnp.linalg.solve(G[..., :4, :4], -G[..., :4, 4:5])[..., 0]

    def r_of(w):
        y = y_of(w)
        t, s = y[..., :3], y[..., 3]
        R = axis_rotation_matrix(axis.astype(dtype), w)
        Rd1 = jnp.einsum("...jk,...ik->...ij", R, d1)
        Ro1 = jnp.einsum("...jk,...ik->...ij", R, image1_origins)
        lhs = jnp.cross(
            d2,
            s[..., None, None] * Ro1 + t[..., None, :] - image2_origins,
        )
        return jnp.einsum("...ij,...ij->...i", lhs, Rd1), lhs

    def solve_at(w):
        def gn(_, w_c):
            r, dr = jax.jvp(lambda u: r_of(u)[0], (w_c,), (jnp.ones_like(w_c),))
            num = jnp.sum(r * dr, axis=-1)
            den = jnp.maximum(jnp.sum(dr * dr, axis=-1), 1e-30)
            return w_c - num / den

        w_r = jax.lax.fori_loop(0, 3, gn, w)
        resid, lhs = r_of(w_r)
        scale = 1.0 + jnp.linalg.norm(lhs, axis=-1)
        return w_r, y_of(w_r), jnp.max(jnp.abs(resid) / scale, axis=-1)

    w_b = jnp.moveaxis(roots, -1, 0)
    w_all, y_all, resid_all = jax.vmap(solve_at)(w_b)
    R_all = jax.vmap(lambda w: axis_rotation_matrix(axis.astype(dtype), w))(w_all)
    rotations = jnp.moveaxis(R_all, 0, -3)
    translations = jnp.moveaxis(y_all[..., :3], 0, -2)
    scales = jnp.moveaxis(y_all[..., 3], 0, -1)
    resid = jnp.moveaxis(resid_all, 0, -1)
    tol = jnp.asarray(1e-3 if dtype == jnp.float32 else 1e-6, dtype)
    valid = valid & (resid < tol) & (scales > 0)
    return rotations, translations, scales, valid
