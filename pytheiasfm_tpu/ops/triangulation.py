"""Batched triangulation kernels.

Batched re-design of `src/theia/sfm/triangulation/
triangulation.{h,cc}`. Every routine is a pure function over fixed-shape
batches with validity masks; variable numbers of observations per track are
handled by masking rather than dynamic shapes. All methods of the reference
are provided:

  triangulate            optimal 2-view (epipolar correction + DLT)
                         (triangulation.cc:109-125)
  triangulate_dlt        2-view DLT nullspace      (triangulation.cc:160-178)
  triangulate_midpoint   N-ray closest point       (triangulation.cc:130-157)
  triangulate_nview      L2-minimization via 4x4 eigh (triangulation.cc:200-)
  triangulate_nview_svd  SVD of the [3N, 4+N] design  (triangulation.cc:181-)

plus the cheirality / angle tests used by the two-view pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rotation as rot

__all__ = [
    "essential_matrix_from_two_projection_matrices",
    "find_optimal_image_points",
    "triangulate",
    "triangulate_dlt",
    "triangulate_midpoint",
    "triangulate_nview",
    "triangulate_nview_svd",
    "is_triangulated_point_in_front_of_cameras",
    "sufficient_triangulation_angle",
]


def _homogeneous(p):
    return jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)


def essential_matrix_from_two_projection_matrices(pose1, pose2):
    """E such that x1^T E x2 = 0 for calibrated projections [..,3,4].

    Parity: `theia::EssentialMatrixFromTwoProjectionMatrices`
    (`sfm/pose/util.cc`). E = [t]_x R with R = R1 R2^T, t = t1 - R t2.
    """
    R1, t1 = pose1[..., :3], pose1[..., 3]
    R2, t2 = pose2[..., :3], pose2[..., 3]
    R = R1 @ jnp.swapaxes(R2, -1, -2)
    t = t1 - (R @ t2[..., None])[..., 0]
    return rot.hat(t) @ R


def find_optimal_image_points(ematrix, point1, point2):
    """First-order optimal epipolar correction of a correspondence.

    Parity: `FindOptimalImagePoints` (`triangulation.cc:66-105`, the
    Lindstrom 'niter1' update): returns corrected (point1, point2) with
    x1'^T E x2' ~= 0, minimally displaced from the inputs.
    """
    p1 = _homogeneous(point1)
    p2 = _homogeneous(point2)
    E2 = ematrix[..., :2, :2]

    line1 = (ematrix @ p2[..., None])[..., :2, 0]
    line2 = (jnp.swapaxes(ematrix, -1, -2) @ p1[..., None])[..., :2, 0]

    a = jnp.einsum("...i,...ij,...j->...", line1, E2, line2)
    b = 0.5 * (jnp.sum(line1 * line1, axis=-1) + jnp.sum(line2 * line2, axis=-1))
    c = jnp.einsum("...i,...ij,...j->...", p1, ematrix, p2)
    d = jnp.sqrt(jnp.maximum(b * b - a * c, 0.0))
    lam = c / (b + d)

    line1_new = line1 - lam[..., None] * (E2 @ line1[..., None])[..., 0]
    line2_new = line2 - lam[..., None] * (jnp.swapaxes(E2, -1, -2) @ line2[..., None])[..., 0]
    lam = lam * (2.0 * d) / (
        jnp.sum(line1_new * line1_new, axis=-1) + jnp.sum(line2_new * line2_new, axis=-1)
    )

    c1 = p1 - jnp.concatenate(
        [lam[..., None] * line1_new, jnp.zeros_like(lam)[..., None]], axis=-1
    )
    c2 = p2 - jnp.concatenate(
        [lam[..., None] * line2_new, jnp.zeros_like(lam)[..., None]], axis=-1
    )
    return c1[..., :2] / c1[..., 2:3], c2[..., :2] / c2[..., 2:3]


def triangulate_dlt(pose1, pose2, point1, point2):
    """Two-view DLT: nullspace of the 4x4 design matrix.

    Parity: `theia::TriangulateDLT` (`triangulation.cc:160`). Returns a
    homogeneous [.., 4] point (unit norm, from SVD).
    """
    rows = [
        point1[..., 0:1] * pose1[..., 2, :] - pose1[..., 0, :],
        point1[..., 1:2] * pose1[..., 2, :] - pose1[..., 1, :],
        point2[..., 0:1] * pose2[..., 2, :] - pose2[..., 0, :],
        point2[..., 1:2] * pose2[..., 2, :] - pose2[..., 1, :],
    ]
    design = jnp.stack(rows, axis=-2)
    # Smallest right singular vector via eigh of D^T D (4x4, batched).
    dtd = jnp.swapaxes(design, -1, -2) @ design
    _, vecs = jnp.linalg.eigh(dtd)
    return vecs[..., :, 0]


def triangulate(pose1, pose2, point1, point2):
    """Optimal two-view triangulation: epipolar correction then DLT.

    Parity: `theia::Triangulate` (`triangulation.cc:109-125`).
    """
    E = essential_matrix_from_two_projection_matrices(pose1, pose2)
    c1, c2 = find_optimal_image_points(E, point1, point2)
    return triangulate_dlt(pose1, pose2, c1, c2)


def triangulate_midpoint(origins, directions, mask=None):
    """Closest point to N rays (masked). origins/directions [.., N, 3].

    Parity: `theia::TriangulateMidpoint` (`triangulation.cc:130-157`):
    accumulates A = sum(I - d d^T), b = sum((I - d d^T) o_homog) over rays and
    solves the 4x4 system. Returns ([.., 4] homogeneous point, success).
    """
    d = directions / jnp.linalg.norm(directions, axis=-1, keepdims=True)
    d4 = jnp.concatenate([d, jnp.zeros_like(d[..., :1])], axis=-1)
    eye = jnp.eye(4, dtype=origins.dtype)
    A_terms = eye - d4[..., :, None] * d4[..., None, :]
    o4 = _homogeneous(origins)
    b_terms = (A_terms @ o4[..., None])[..., 0]
    if mask is not None:
        m = mask[..., None, None].astype(origins.dtype)
        A_terms = A_terms * m
        b_terms = b_terms * m[..., 0]
    A = jnp.sum(A_terms, axis=-3)
    b = jnp.sum(b_terms, axis=-2)
    # A is PSD; solve with a ridge-guarded Cholesky solve.
    A = A + 1e-12 * eye
    point = jnp.linalg.solve(A, b[..., None])[..., 0]
    ok = jnp.all(jnp.isfinite(point), axis=-1)
    return point, ok


def triangulate_nview(poses, points, mask=None):
    """N-view L2-minimization triangulation via 4x4 symmetric eigendecomp.

    Parity: `theia::TriangulateNView` (`triangulation.cc:200-217`):
    design = sum_i C_i^T C_i with C_i = P_i - n_i n_i^T P_i where n_i is the
    normalized homogeneous image point; the solution is the eigenvector with
    the smallest eigenvalue. poses [.., N, 3, 4], points [.., N, 2].
    """
    n = _homogeneous(points)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    proj = jnp.einsum("...i,...j,...jk->...ik", n, n, poses)
    cost = poses - proj  # [.., N, 3, 4]
    terms = jnp.einsum("...ij,...ik->...jk", cost, cost)  # [.., N, 4, 4]
    if mask is not None:
        terms = terms * mask[..., None, None].astype(poses.dtype)
    design = jnp.sum(terms, axis=-3)
    _, vecs = jnp.linalg.eigh(design)
    return vecs[..., :, 0]


def triangulate_nview_svd(poses, points, mask=None):
    """N-view SVD triangulation — nullspace of the [3N, 4+N] design matrix.

    Parity: `theia::TriangulateNViewSVD` (`triangulation.cc:181-197`). Masked
    rows are replaced by unit rows touching only the per-view scale column, so
    they contribute a unit singular value and never win the nullspace.
    """
    batch_shape = poses.shape[:-3]
    N = poses.shape[-3]
    dtype = poses.dtype
    design = jnp.zeros(batch_shape + (3 * N, 4 + N), dtype)
    p_homog = _homogeneous(points)
    for i in range(N):
        block = -poses[..., i, :, :]  # [.., 3, 4]
        col = p_homog[..., i, :]  # [.., 3]
        if mask is not None:
            m = mask[..., i, None, None].astype(dtype)
            block = block * m
            col = jnp.where(
                mask[..., i, None], col, jnp.asarray([1.0, 0.0, 0.0], dtype)
            )
        design = design.at[..., 3 * i : 3 * i + 3, 0:4].set(block)
        design = design.at[..., 3 * i : 3 * i + 3, 4 + i].set(col)
    _, _, vt = jnp.linalg.svd(design, full_matrices=True)
    return vt[..., -1, 0:4]


def is_triangulated_point_in_front_of_cameras(point1, point2, rotation, position):
    """Cheirality test without explicit triangulation.

    Parity: `theia::IsTriangulatedPointInFrontOfCameras`
    (`triangulation.cc:219-236`): point1/point2 are normalized image points
    [.., 2], rotation [.., 3, 3] and position [.., 3] the relative pose
    (camera 2 w.r.t. camera 1).
    """
    dir1 = _homogeneous(point1)
    dir2 = (jnp.swapaxes(rotation, -1, -2) @ _homogeneous(point2)[..., None])[..., 0]
    dir1_sq = jnp.sum(dir1 * dir1, axis=-1)
    dir2_sq = jnp.sum(dir2 * dir2, axis=-1)
    dir1_dir2 = jnp.sum(dir1 * dir2, axis=-1)
    dir1_pos = jnp.sum(dir1 * position, axis=-1)
    dir2_pos = jnp.sum(dir2 * position, axis=-1)
    return (dir2_sq * dir1_pos - dir1_dir2 * dir2_pos > 0) & (
        dir1_dir2 * dir1_pos - dir1_sq * dir2_pos > 0
    )


def sufficient_triangulation_angle(ray_directions, min_angle_degrees, mask=None):
    """True when any pair of rays subtends at least the minimum angle.

    Parity: `theia::SufficientTriangulationAngle` (`triangulation.cc:240-`).
    ray_directions [.., N, 3] unit vectors.
    """
    cos_min = jnp.cos(jnp.deg2rad(min_angle_degrees))
    dots = jnp.einsum("...ik,...jk->...ij", ray_directions, ray_directions)
    if mask is not None:
        pair_mask = mask[..., :, None] & mask[..., None, :]
        dots = jnp.where(pair_mask, dots, 1.0)
    N = ray_directions.shape[-2]
    off_diag = ~jnp.eye(N, dtype=bool)
    min_cos = jnp.min(jnp.where(off_diag, dots, 1.0), axis=(-2, -1))
    return min_cos <= cos_min
