"""SO(3) operations on angle-axis vectors, rotation matrices and quaternions.

Batched re-design of the reference rotation utilities
(`/root/reference/src/theia/math/rotation.h:49-82` and the Ceres
`AngleAxisRotatePoint` / `RotationMatrixToAngleAxis` routines the reference
relies on). Everything here is a pure, batched, differentiable jnp function:
inputs may carry arbitrary leading batch dimensions, all control flow is
branchless (`jnp.where`), and every function is safe under `jax.jit`,
`jax.vmap` and `jax.grad` (including at the theta -> 0 singularity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "hat",
    "vee",
    "angle_axis_to_rotation_matrix",
    "rotation_matrix_to_angle_axis",
    "angle_axis_rotate_point",
    "angle_axis_to_quaternion",
    "quaternion_to_angle_axis",
    "quaternion_to_rotation_matrix",
    "rotation_matrix_to_quaternion",
    "quaternion_multiply",
    "multiply_rotations",
    "relative_rotation_from_two_rotations",
    "apply_relative_rotation",
    "project_to_so3",
    "align_rotations",
    "align_orientations",
    "so3_log",
    "so3_exp",
]

_SMALL = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [w]_x such that hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_theta(aa: jax.Array):
    """Return (theta, theta_sq, is_small) with a grad-safe sqrt at 0."""
    theta_sq = jnp.sum(aa * aa, axis=-1)
    is_small = theta_sq < _SMALL
    # Guard sqrt(0) whose gradient is inf; the Taylor branch is used there.
    theta = jnp.sqrt(jnp.where(is_small, 1.0, theta_sq))
    theta = jnp.where(is_small, jnp.zeros_like(theta), theta)
    return theta, theta_sq, is_small


def angle_axis_to_rotation_matrix(aa: jax.Array) -> jax.Array:
    """Rodrigues formula, angle-axis [..,3] -> rotation matrix [..,3,3].

    Uses a 2nd-order Taylor expansion of sin/cos coefficients near theta=0 so
    the function (and its gradient) is exact and finite everywhere.
    """
    theta, theta_sq, is_small = _safe_theta(aa)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    sinc = jnp.where(is_small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / jnp.where(is_small, 1.0, theta))
    cosc = jnp.where(
        is_small,
        0.5 - theta_sq / 24.0,
        (1.0 - jnp.cos(theta)) / jnp.where(is_small, 1.0, theta_sq),
    )
    W = hat(aa)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), W.shape)
    return eye + sinc[..., None, None] * W + cosc[..., None, None] * (W @ W)


so3_exp = angle_axis_to_rotation_matrix


def rotation_matrix_to_quaternion(R: jax.Array) -> jax.Array:
    """Rotation matrix [..,3,3] -> unit quaternion [..,4] (w, x, y, z).

    Branchless Shepperd method: compute all four candidate quaternions and
    select the numerically best (largest pivot) with `jnp.where`.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    one = jnp.ones_like(tr)

    # Four candidates, each scaled by 4*q_k^2 = max(0, ...) for pivot k.
    qw2 = jnp.maximum(0.0, one + tr)
    qx2 = jnp.maximum(0.0, one + m00 - m11 - m22)
    qy2 = jnp.maximum(0.0, one - m00 + m11 - m22)
    qz2 = jnp.maximum(0.0, one - m00 - m11 + m22)

    sw = jnp.sqrt(qw2 + 1e-30)
    sx = jnp.sqrt(qx2 + 1e-30)
    sy = jnp.sqrt(qy2 + 1e-30)
    sz = jnp.sqrt(qz2 + 1e-30)

    # Candidate quaternions for each pivot (unnormalized).
    cand_w = jnp.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    cand_x = jnp.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], axis=-1)
    cand_y = jnp.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], axis=-1)
    cand_z = jnp.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], axis=-1)

    pivots = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(pivots, axis=-1)

    cands = jnp.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)  # [..,4 pivots,4]
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonicalize sign: w >= 0.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q


def quaternion_to_rotation_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion [..,4] (w,x,y,z) -> rotation matrix [..,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quaternion_to_angle_axis(q: jax.Array) -> jax.Array:
    """Unit quaternion [..,4] -> angle-axis [..,3] (angle in [0, pi])."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    sin_half = jnp.linalg.norm(q[..., 1:], axis=-1)
    cos_half = q[..., 0]
    angle = 2.0 * jnp.arctan2(sin_half, cos_half)
    small = sin_half < _SMALL
    # angle/sin(angle/2): -> 2 as angle -> 0.
    scale = jnp.where(small, 2.0, angle / jnp.where(small, 1.0, sin_half))
    return scale[..., None] * q[..., 1:]


def angle_axis_to_quaternion(aa: jax.Array) -> jax.Array:
    """Angle-axis [..,3] -> unit quaternion [..,4] (w,x,y,z)."""
    theta, theta_sq, is_small = _safe_theta(aa)
    half = 0.5 * theta
    # sin(t/2)/t with Taylor fallback 0.5 - t^2/48.
    k = jnp.where(
        is_small, 0.5 - theta_sq / 48.0, jnp.sin(half) / jnp.where(is_small, 1.0, theta)
    )
    w = jnp.cos(half)
    return jnp.concatenate([w[..., None], k[..., None] * aa], axis=-1)


def rotation_matrix_to_angle_axis(R: jax.Array) -> jax.Array:
    """Rotation matrix [..,3,3] -> angle-axis [..,3]; robust near 0 and pi."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


so3_log = rotation_matrix_to_angle_axis


def angle_axis_rotate_point(aa: jax.Array, p: jax.Array) -> jax.Array:
    """Rotate point(s) p [..,3] by angle-axis aa [..,3] without forming R.

    Mirrors Ceres `AngleAxisRotatePoint` (used throughout the reference, e.g.
    `/root/reference/src/theia/sfm/camera/reprojection_error.h:84`): uses the
    Rodrigues rotation of a vector, with a first-order (exact-direction)
    fallback for tiny angles.
    """
    theta, theta_sq, is_small = _safe_theta(aa)
    safe_theta = jnp.where(is_small, 1.0, theta)
    axis = aa / safe_theta[..., None]
    cos_t = jnp.cos(theta)[..., None]
    sin_t = jnp.sin(theta)[..., None]
    w_cross_p = jnp.cross(axis, p)
    w_dot_p = jnp.sum(axis * p, axis=-1, keepdims=True)
    rotated = p * cos_t + w_cross_p * sin_t + axis * w_dot_p * (1.0 - cos_t)
    # Small-angle: p + aa x p (exact to first order, differentiable at 0).
    approx = p + jnp.cross(aa, p)
    return jnp.where(is_small[..., None], approx, rotated)


def quaternion_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product of quaternions [..,4] (w,x,y,z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def multiply_rotations(aa1: jax.Array, aa2: jax.Array) -> jax.Array:
    """Angle-axis of R(aa1) @ R(aa2).

    Parity: `theia::MultiplyRotations` (`math/rotation.h:75`).
    Composed in quaternion space (cheaper and better conditioned than
    matrix round-trips).
    """
    q = quaternion_multiply(angle_axis_to_quaternion(aa1), angle_axis_to_quaternion(aa2))
    return quaternion_to_angle_axis(q)


def relative_rotation_from_two_rotations(
    aa1: jax.Array, aa2: jax.Array, noise_quat: jax.Array | None = None
) -> jax.Array:
    """Angle-axis of R2 @ R1^T — the relative rotation taking frame 1 to 2.

    Parity: `theia::RelativeRotationFromTwoRotations` (`math/rotation.h:59`).
    """
    q1 = angle_axis_to_quaternion(aa1)
    q2 = angle_axis_to_quaternion(aa2)
    q1_inv = q1 * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q1.dtype)
    q = quaternion_multiply(q2, q1_inv)
    if noise_quat is not None:
        q = quaternion_multiply(noise_quat, q)
    return quaternion_to_angle_axis(q)


def apply_relative_rotation(aa1: jax.Array, aa_rel: jax.Array) -> jax.Array:
    """Angle-axis of R_rel @ R1 — applies a relative rotation to rotation 1.

    Parity: `theia::ApplyRelativeRotation` (`math/rotation.h`).
    """
    return multiply_rotations(aa_rel, aa1)


def project_to_so3(M: jax.Array) -> jax.Array:
    """Project square matrix [..,3,3] onto SO(3) (closest rotation, Frobenius).

    Parity: `theia::ProjectToSOd` (`math/rotation.h:49`). Computed via SVD
    with a determinant sign correction.
    """
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    return (U * D[..., None, :]) @ Vt


def align_rotations(gt_aa: jax.Array, est_aa: jax.Array) -> jax.Array:
    """Align estimated rotations to ground-truth rotations by a global rotation.

    Finds R_align minimizing sum_i || R_gt_i - R_est_i @ R_align ||_F^2
    (closed-form chordal solution) and returns the aligned estimated
    angle-axis rotations R_est_i @ R_align.

    Parity: `theia::AlignRotations` (`math/rotation.h:66`), which does the
    same gauge fix via nonlinear optimization; here it is one batched SVD.
    """
    R_gt = angle_axis_to_rotation_matrix(gt_aa)
    R_est = angle_axis_to_rotation_matrix(est_aa)
    # Accumulate sum_i R_est_i^T R_gt_i over the single leading batch axis.
    C = jnp.sum(jnp.swapaxes(R_est, -1, -2) @ R_gt, axis=0)
    R_align = project_to_so3(C)
    return rotation_matrix_to_angle_axis(R_est @ R_align)


def align_orientations(gt_aa: jax.Array, est_aa: jax.Array) -> jax.Array:
    """Alias of :func:`align_rotations` over dict-free array inputs.

    Parity: `theia::AlignOrientations` (`math/rotation.h:72`).
    """
    return align_rotations(gt_aa, est_aa)
