"""Epipolar geometry kernels: 7/8-point F, essential-matrix utilities,
Sampson error, focal-length recovery.

Batched re-design of
  /root/reference/src/theia/sfm/pose/eight_point_fundamental_matrix.{h,cc}
  /root/reference/src/theia/sfm/pose/seven_point_fundamental_matrix.{h,cc}
  /root/reference/src/theia/sfm/pose/essential_matrix_utils.{h,cc}
  /root/reference/src/theia/sfm/pose/fundamental_matrix_util.{h,cc}
  /root/reference/src/theia/sfm/pose/util.cc (Sampson, normalization)

Everything is batched over a leading hypothesis/pair axis and mask-based.
Convention (matches the reference five-point/eight-point docs):
``x2^T * F * x1 = 0`` — `points1` live in image 1, `points2` in image 2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rotation as rot
from . import triangulation as tri

__all__ = [
    "normalize_image_points",
    "eight_point_fundamental_matrix",
    "seven_point_fundamental_matrix",
    "four_point_homography",
    "project_to_essential",
    "decompose_essential_matrix",
    "get_best_pose_from_essential_matrix",
    "squared_sampson_distance",
    "fundamental_matrix_from_projection_matrices",
    "focal_lengths_from_fundamental_matrix",
    "shared_focal_lengths_from_fundamental_matrix",
    "essential_matrix_from_fundamental_matrix",
    "compose_fundamental_matrix",
]


def _homog(p):
    return jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)


def normalize_image_points(points: jax.Array, mask: jax.Array | None = None):
    """Hartley isotropic normalization: zero-mean, mean distance sqrt(2).

    points [.., N, 2] -> (normalized points, T [..,3,3]) with x' = T x.
    Parity: `NormalizeImagePoints` (`sfm/pose/util.cc`).
    """
    if mask is None:
        mean = jnp.mean(points, axis=-2, keepdims=True)
        centered = points - mean
        rms = jnp.mean(jnp.linalg.norm(centered, axis=-1), axis=-1)
    else:
        w = mask.astype(points.dtype)[..., None]
        count = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1.0)
        mean = jnp.sum(points * w, axis=-2, keepdims=True) / count
        centered = (points - mean) * w
        rms = jnp.sum(jnp.linalg.norm(centered, axis=-1), axis=-1) / count[..., 0, 0]
    scale = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-12)
    normalized = centered * scale[..., None, None]
    zeros = jnp.zeros_like(scale)
    ones = jnp.ones_like(scale)
    T = jnp.stack(
        [
            jnp.stack([scale, zeros, -scale * mean[..., 0, 0]], axis=-1),
            jnp.stack([zeros, scale, -scale * mean[..., 0, 1]], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return normalized, T


def _epipolar_design_matrix(points1, points2):
    """Rows outer(x2_homog, x1_homog).flatten() so that row @ vec(F) = 0
    encodes x2^T F x1 = 0 with F flattened row-major."""
    p1 = _homog(points1)
    p2 = _homog(points2)
    return (p2[..., :, None] * p1[..., None, :]).reshape(points1.shape[:-1] + (9,))


def eight_point_fundamental_matrix(points1, points2, mask=None):
    """Normalized 8-point algorithm; N >= 8 (masked least squares).

    points1/points2 [.., N, 2] -> (F [.., 3, 3], success). Parity:
    `theia::NormalizedEightPointFundamentalMatrix`
    (`eight_point_fundamental_matrix.h:58`): Hartley normalization, nullspace
    via the smallest eigenvector of A^T A, rank-2 projection, denormalize.
    """
    n1, T1 = normalize_image_points(points1, mask)
    n2, T2 = normalize_image_points(points2, mask)
    A = _epipolar_design_matrix(n1, n2)  # [.., N, 9]
    if mask is not None:
        A = A * mask[..., None].astype(A.dtype)
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    # Enforce rank 2.
    U, s, Vt = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    F = (U * s[..., None, :]) @ Vt
    # Denormalize: x2^T F x1 with normalized coords -> T2^T F T1.
    F = jnp.swapaxes(T2, -1, -2) @ F @ T1
    ok = jnp.abs(jnp.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)) > 1e-12
    F = F / jnp.maximum(
        jnp.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)[..., None, None], 1e-12
    )
    return F, ok


def seven_point_fundamental_matrix(points1, points2):
    """7-point algorithm: 1 or 3 F candidates from the 2D nullspace.

    points1/points2 [.., 7, 2] -> (F [.., 3, 3, 3], valid [.., 3]).
    Parity: `theia::SevenPointFundamentalMatrix`
    (`seven_point_fundamental_matrix.h:52`). det(a F1 + (1-a) F2) = 0 gives a
    cubic in a, solved in closed form.
    """
    from . import polynomial as poly

    A = _epipolar_design_matrix(points1, points2)  # [.., 7, 9]
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    F1 = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    F2 = vecs[..., :, 1].reshape(AtA.shape[:-2] + (3, 3))

    # det(a*F1 + (1-a)*F2) as a cubic in a: evaluate at 4 nodes and
    # interpolate (exact — cheaper than symbolic expansion and accelerator-friendly).
    nodes = jnp.asarray([0.0, 1.0, -1.0, 2.0], dtype=A.dtype)
    dets = jnp.stack(
        [jnp.linalg.det(n * F1 + (1.0 - n) * F2) for n in [0.0, 1.0, -1.0, 2.0]],
        axis=-1,
    )
    V = jnp.stack([nodes**3, nodes**2, nodes, jnp.ones_like(nodes)], axis=-1)
    coeffs = jnp.linalg.solve(
        jnp.broadcast_to(V, dets.shape[:-1] + (4, 4)), dets[..., None]
    )[..., 0]
    roots, valid = poly.solve_cubic(
        coeffs[..., 0], coeffs[..., 1], coeffs[..., 2], coeffs[..., 3]
    )
    # Cubic may degenerate to quadratic when coeff 0 ~ 0; mask those lanes
    # out (rare; RANSAC just draws another sample).
    degenerate = jnp.abs(coeffs[..., 0]) < 1e-12 * jnp.max(jnp.abs(coeffs), axis=-1)
    valid = valid & ~degenerate[..., None]
    a = roots[..., :, None, None]
    F = a * F1[..., None, :, :] + (1.0 - a) * F2[..., None, :, :]
    norm = jnp.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)
    F = F / jnp.maximum(norm[..., None, None], 1e-12)
    return F, valid


def four_point_homography(points1, points2, mask=None):
    """Normalized DLT homography from >= 4 correspondences.

    points1/points2 [.., N, 2] -> (H [.., 3, 3], success) with
    x2 ~ H x1. Parity: `theia::FourPointHomography`
    (`four_point_homography.h:48`).
    """
    n1, T1 = normalize_image_points(points1, mask)
    n2, T2 = normalize_image_points(points2, mask)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    zeros = jnp.zeros_like(x1)
    ones = jnp.ones_like(x1)
    # Two rows per correspondence (standard DLT).
    row1 = jnp.stack(
        [zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], axis=-1
    )
    row2 = jnp.stack(
        [x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], axis=-1
    )
    A = jnp.concatenate([row1, row2], axis=-2)
    if mask is not None:
        m2 = jnp.concatenate([mask, mask], axis=-1)
        A = A * m2[..., None].astype(A.dtype)
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    H = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    H = jnp.linalg.inv(T2) @ H @ T1
    scale = H[..., 2, 2]
    ok = jnp.abs(scale) > 1e-12
    H = H / jnp.where(ok, scale, 1.0)[..., None, None]
    return H, ok


def project_to_essential(E: jax.Array) -> jax.Array:
    """Project onto the essential manifold (singular values (1, 1, 0))."""
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.asarray([1.0, 1.0, 0.0], dtype=E.dtype)
    return (U * d) @ Vt


def decompose_essential_matrix(E: jax.Array):
    """E [.., 3, 3] -> (R1, R2, t): the four pose candidates are
    (R1, +-t), (R2, +-t). Parity: `theia::DecomposeEssentialMatrix`
    (`essential_matrix_utils.h:52`; same candidate set, different method).

    Closed form (Horn, "Recovering baseline and orientation from the
    essential matrix", 1990) instead of the Hartley-Zisserman SVD: with
    E = [b]x R, bb^T = (tr(EE^T)/2) I - EE^T recovers the baseline up to
    sign and R = (cof(E) -+ [b]x E)/(b.b) the two rotations. All
    elementwise/3x3-matmul ops instead of a batched 3x3 SVD per model. A
    Newton orthogonalization step absorbs the (near-)essential input
    error; for exactly essential E the formula is exact."""
    EEt = E @ jnp.swapaxes(E, -1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    bbT = (tr / 2)[..., None, None] * jnp.eye(3, dtype=E.dtype) - EEt
    # Baseline from the strongest column of bb^T (branchless selection).
    diag = jnp.stack([bbT[..., 0, 0], bbT[..., 1, 1], bbT[..., 2, 2]], -1)
    j = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(bbT, j[..., None, None], axis=-1)[..., 0]
    denom = jnp.take_along_axis(diag, j[..., None], axis=-1)[..., 0]
    b = col / jnp.sqrt(jnp.maximum(denom, 1e-30))[..., None]  # |b| = sqrt(tr/2)
    bb = jnp.maximum(jnp.sum(b * b, axis=-1), 1e-30)

    # cof(E) via cross products of columns: adj rows are c1xc2, c2xc0,
    # c0xc1; cof = adj^T.
    c0, c1, c2 = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    adj = jnp.stack(
        [jnp.cross(c1, c2), jnp.cross(c2, c0), jnp.cross(c0, c1)], axis=-2
    )
    cofE = jnp.swapaxes(adj, -1, -2)

    zeros = jnp.zeros_like(b[..., 0])
    Bx = jnp.stack(
        [
            jnp.stack([zeros, -b[..., 2], b[..., 1]], -1),
            jnp.stack([b[..., 2], zeros, -b[..., 0]], -1),
            jnp.stack([-b[..., 1], b[..., 0], zeros], -1),
        ],
        axis=-2,
    )
    BE = Bx @ E
    R1 = (cofE - BE) / bb[..., None, None]
    R2 = (cofE + BE) / bb[..., None, None]

    def _orth(R):
        # One Newton step toward the orthogonal polar factor:
        # R <- R (3I - R^T R)/2; exact rotations are fixed points.
        RtR = jnp.swapaxes(R, -1, -2) @ R
        return R @ (1.5 * jnp.eye(3, dtype=E.dtype) - 0.5 * RtR)

    R1 = _orth(R1)
    R2 = _orth(R2)
    t = b / jnp.sqrt(jnp.maximum(tr / 2, 1e-30))[..., None]
    return R1, R2, t


def get_best_pose_from_essential_matrix(E, points1, points2, mask=None):
    """Choose the pose (R, position) with maximal cheirality support.

    Parity: `theia::GetBestPoseFromEssentialMatrix`
    (`essential_matrix_utils.h:67`): tests the four (R, t) candidates with
    the in-front-of-both-cameras test and returns the winner plus its count.
    Returns (R [..,3,3], position [..,3], count [..]). `position` is the
    camera-2 center in camera-1 coordinates (reference convention:
    position = -R^T t).
    """
    R1, R2, t = decompose_essential_matrix(E)
    candidates_R = [R1, R1, R2, R2]
    candidates_t = [t, -t, t, -t]
    counts = []
    for R, tc in zip(candidates_R, candidates_t):
        pos = -(jnp.swapaxes(R, -1, -2) @ tc[..., None])[..., 0]
        in_front = tri.is_triangulated_point_in_front_of_cameras(
            points1, points2, R[..., None, :, :], pos[..., None, :]
        )
        if mask is not None:
            in_front = in_front & mask
        counts.append(jnp.sum(in_front, axis=-1))
    counts = jnp.stack(counts, axis=-1)  # [.., 4]
    best = jnp.argmax(counts, axis=-1)
    R_all = jnp.stack(candidates_R, axis=-3)
    t_all = jnp.stack(candidates_t, axis=-2)
    R_best = jnp.take_along_axis(R_all, best[..., None, None, None], axis=-3)[..., 0, :, :]
    t_best = jnp.take_along_axis(t_all, best[..., None, None], axis=-2)[..., 0, :]
    pos_best = -(jnp.swapaxes(R_best, -1, -2) @ t_best[..., None])[..., 0]
    best_count = jnp.take_along_axis(counts, best[..., None], axis=-1)[..., 0]
    return R_best, pos_best, best_count


def squared_sampson_distance(F, points1, points2):
    """Squared Sampson distance of correspondences under x2^T F x1 = 0.

    F [.., 3, 3] against points [.., N, 2] (F broadcasts over N). Parity:
    `theia::SquaredSampsonDistance` (`sfm/pose/util.cc`).
    """
    x1 = _homog(points1)
    x2 = _homog(points2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    num = jnp.einsum("...ni,...ni->...n", x2, Fx1)
    denom = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )
    return num * num / jnp.maximum(denom, 1e-30)


def fundamental_matrix_from_projection_matrices(P1, P2):
    """F from two general projection matrices [.., 3, 4].

    Parity: `theia::FundamentalMatrixFromProjectionMatrices`
    (`fundamental_matrix_util.h`). Uses the epipole formulation
    F = [e2]_x P2 P1^+.
    """
    P1_pinv = jnp.linalg.pinv(P1)
    # Camera-1 center: nullspace of P1 via svd.
    _, _, Vt = jnp.linalg.svd(P1)
    c1 = Vt[..., -1, :]
    e2 = (P2 @ c1[..., None])[..., 0]
    return rot.hat(e2) @ (P2 @ P1_pinv)


def compose_fundamental_matrix(f1, f2, R, t):
    """F = K2^-T [t]_x R K1^-1 with diagonal K = diag(f, f, 1).

    Parity: `theia::ComposeFundamentalMatrix` (`fundamental_matrix_util.h`).
    """
    E = rot.hat(t) @ R
    k1 = jnp.stack([1.0 / f1, 1.0 / f1, jnp.ones_like(f1)], axis=-1)
    k2 = jnp.stack([1.0 / f2, 1.0 / f2, jnp.ones_like(f2)], axis=-1)
    return k2[..., :, None] * E * k1[..., None, :]


def essential_matrix_from_fundamental_matrix(F, f1, f2):
    """E = K2^T F K1 with K = diag(f, f, 1).

    Parity: `theia::EssentialMatrixFromFundamentalMatrix`
    (`fundamental_matrix_util.h`).
    """
    k1 = jnp.stack([f1, f1, jnp.ones_like(f1)], axis=-1)
    k2 = jnp.stack([f2, f2, jnp.ones_like(f2)], axis=-1)
    return k2[..., :, None] * F * k1[..., None, :]


def focal_lengths_from_fundamental_matrix(F):
    """Recover the two focal lengths from F (Bougnoux-style closed form).

    Parity: `theia::FocalLengthsFromFundamentalMatrix`
    (`fundamental_matrix_util.h`). Assumes principal points at the origin.
    Returns (f1, f2, valid).
    """
    # Epipoles: right/left nullvectors.
    _, _, Vt = jnp.linalg.svd(F)
    e1 = Vt[..., -1, :]
    _, _, Vt2 = jnp.linalg.svd(jnp.swapaxes(F, -1, -2))
    e2 = Vt2[..., -1, :]
    p = jnp.asarray([0.0, 0.0, 1.0], dtype=F.dtype)
    II = jnp.diag(jnp.asarray([1.0, 1.0, 0.0], dtype=F.dtype))

    def _f_sq(F, e, p):
        # Bougnoux formula (batched einsums — a plain @ chain mixes the
        # batch axis of `p @ ep` into the matrix dims).
        ep = rot.hat(e)
        Ft = jnp.swapaxes(F, -1, -2)
        left = jnp.einsum("i,...ij,jk,...kl->...l", p, ep, II, Ft)
        PP = p[:, None] * p[None, :]
        Fp = jnp.einsum("...ij,j->...i", F, p)
        num = -jnp.einsum("...i,ij,...j->...", left, PP, Fp)
        den = jnp.einsum("...i,ij,...jk,k->...", left, II, F, p)
        return num / jnp.where(jnp.abs(den) < 1e-30, 1.0, den)

    # With the x2^T F x1 = 0 convention, F maps image-1 points to image-2
    # lines: the direct formula recovers the image-2 focal and the transposed
    # one recovers image-1's.
    f2_sq = _f_sq(F, e1, p)
    f1_sq = _f_sq(jnp.swapaxes(F, -1, -2), e2, p)
    valid = (f1_sq > 0) & (f2_sq > 0)
    f1 = jnp.sqrt(jnp.maximum(f1_sq, 0.0))
    f2 = jnp.sqrt(jnp.maximum(f2_sq, 0.0))
    return f1, f2, valid


def shared_focal_lengths_from_fundamental_matrix(F):
    """Single shared focal length from F (Sturm-style iterative on a grid).

    Parity: `theia::SharedFocalLengthsFromFundamentalMatrix`. We minimize the
    deviation of the two recovered squared focals over a candidate grid —
    branchless and batched — then take the geometric mean of the Bougnoux
    pair as the final estimate.
    """
    f1, f2, valid = focal_lengths_from_fundamental_matrix(F)
    f = jnp.sqrt(jnp.maximum(f1 * f2, 1e-12))
    return f, valid
