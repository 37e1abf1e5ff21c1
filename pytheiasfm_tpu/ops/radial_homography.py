"""Radial-distortion homography (two-sided division model), 6-point solver.

Batched equivalent of `SixPointRadialDistortionHomography` + helpers
(`/root/reference/src/theia/sfm/pose/six_point_radial_distortion_homography.h`,
Kukelova et al. "Radial distortion homography" CVPR 2015 formulation):
estimate a homography H between two fisheye images together with one
division-model distortion parameter per side (l1, l2).

Lifted coordinates: an observed (distorted, normalized) point p = (x, y)
with division parameter l corresponds to the homogeneous undistorted point
u(p, l) = (x, y, 1 + l r^2),  r^2 = x^2 + y^2.

Constraint per correspondence: u(p2, l2) ~ H u(p1, l1).

The reference runs a Gröbner elimination; here (accelerator-first) the two scalar
unknowns are handled by a **static (l1, l2) seed grid + Gauss-Newton with H
projected out** — for fixed (l1, l2), H is the ordinary DLT solution (a
batched 9x9 symmetric eigenproblem), and the residual is the symmetric
lifted transfer error. Fixed shapes, vmappable over RANSAC batches.

Helper parity: `DistortPoint` / `UndistortPoint` /
`CheckRadialSymmetricError` (same header).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "six_point_radial_distortion_homography",
    "radial_distort_point",
    "radial_undistort_point",
    "check_radial_symmetric_error",
]


def _lift(p, l):
    r2 = jnp.sum(p * p, axis=-1, keepdims=True)
    w = 1.0 + l[..., None, None] * r2
    p_b = jnp.broadcast_to(p, w.shape[:-1] + (2,))
    return jnp.concatenate([p_b, w], axis=-1)


def _dlt_h(u1, u2):
    """DLT homography from lifted points u1 -> u2, [.., N, 3] each.

    Returns H [.., 3, 3] (smallest right singular vector of the 2N x 9
    design matrix) — computed via eigh of the 9x9 normal matrix (cheap,
    batched, accelerator-friendly)."""
    zeros = jnp.zeros_like(u1)
    x2, y2, w2 = u2[..., 0:1], u2[..., 1:2], u2[..., 2:3]
    row1 = jnp.concatenate([zeros, -w2 * u1, y2 * u1], axis=-1)  # [.., N, 9]
    row2 = jnp.concatenate([w2 * u1, zeros, -x2 * u1], axis=-1)
    Dm = jnp.concatenate([row1, row2], axis=-2)  # [.., 2N, 9]
    AtA = jnp.einsum("...ni,...nj->...ij", Dm, Dm)
    _, evecs = jnp.linalg.eigh(AtA)
    h = evecs[..., :, 0]
    return h.reshape(*h.shape[:-1], 3, 3)


def _sym_transfer_resid(H, u1, u2):
    """Symmetric lifted transfer error (image-plane, both directions)."""
    Hu1 = jnp.einsum("...ij,...nj->...ni", H, u1)
    z = jnp.where(jnp.abs(Hu1[..., 2:3]) < 1e-12, 1e-12, Hu1[..., 2:3])
    fwd = Hu1[..., :2] / z - u2[..., :2] / u2[..., 2:3]
    Hinv_u2 = jnp.linalg.solve(
        jnp.broadcast_to(H[..., None, :, :], u2.shape[:-1] + (3, 3)),
        u2[..., None],
    )[..., 0]
    z2 = jnp.where(jnp.abs(Hinv_u2[..., 2:3]) < 1e-12, 1e-12, Hinv_u2[..., 2:3])
    bwd = Hinv_u2[..., :2] / z2 - u1[..., :2] / u1[..., 2:3]
    return jnp.sum(fwd * fwd + bwd * bwd, axis=(-1, -2))


def six_point_radial_distortion_homography(
    points1, points2, lmin: float = -5.0, lmax: float = 0.0, iters: int = 8,
    max_solutions: int = 4,
):
    """Estimate (H, l1, l2) from six correspondences.

    Parity: `SixPointRadialDistortionHomography`
    (`six_point_radial_distortion_homography.h:66`). Inputs are normalized
    (focal-divided) distorted image points.

    Args:
      points1, points2: [.., 6, 2]; lmin/lmax: distortion search bounds.

    Returns:
      (H [.., S, 3, 3], l1 [.., S], l2 [.., S], valid [.., S]) with
      S = max_solutions, ranked by residual.
    """
    dtype = points1.dtype
    batch_shape = points1.shape[:-2]

    def residual_of(l_pair):
        u1 = _lift(points1, l_pair[..., 0])
        u2 = _lift(points2, l_pair[..., 1])
        H = _dlt_h(u1, u2)
        return _sym_transfer_resid(H, u1, u2)

    # Multi-resolution 2-D grid search: coarse 9x9 sweep, then `iters`
    # shrink-and-refine levels of a 5x5 local grid around the incumbents.
    # Derivative-free (the DLT's eigh has no usable gradients at clustered
    # eigenvalues) and fully batched — 81 + 25*iters tiny residual evals.
    coarse_1d = np.linspace(lmin, lmax, 9)
    coarse = np.stack(np.meshgrid(coarse_1d, coarse_1d), -1).reshape(-1, 2)
    coarse_j = jnp.asarray(coarse, dtype)  # [81, 2]
    grid0 = jnp.broadcast_to(coarse_j, batch_shape + coarse_j.shape)
    r0 = jax.vmap(residual_of, in_axes=-2, out_axes=-1)(grid0)  # [.., 81]

    # Keep the best `max_solutions` coarse cells as independent incumbents.
    order0 = jnp.argsort(r0, axis=-1)[..., :max_solutions]
    lp = jnp.take_along_axis(grid0, order0[..., None], axis=-2)  # [.., S, 2]
    resid = jnp.take_along_axis(r0, order0, axis=-1)

    offsets_1d = np.linspace(-1.0, 1.0, 5)
    offs = np.stack(np.meshgrid(offsets_1d, offsets_1d), -1).reshape(-1, 2)
    offs_j = jnp.asarray(offs, dtype)  # [25, 2]
    radius0 = (lmax - lmin) / 8.0

    def level(i, carry):
        lp, resid = carry
        radius = radius0 * 0.35**i
        cand = lp[..., None, :] + radius * offs_j  # [.., S, 25, 2]

        def res_slice(c):  # c [.., S, 2]
            return jax.vmap(residual_of, in_axes=-2, out_axes=-1)(c)

        r = jax.vmap(res_slice, in_axes=-2, out_axes=-1)(cand)  # [.., S, 25]
        best = jnp.argmin(r, axis=-1)
        lp_new = jnp.take_along_axis(cand, best[..., None, None], axis=-2)[..., 0, :]
        r_new = jnp.take_along_axis(r, best[..., None], axis=-1)[..., 0]
        keep = r_new < resid
        return jnp.where(keep[..., None], lp_new, lp), jnp.where(keep, r_new, resid)

    lp, resid = jax.lax.fori_loop(0, iters, level, (lp, resid))

    u1 = _lift(points1[..., None, :, :], lp[..., 0])
    u2 = _lift(points2[..., None, :, :], lp[..., 1])
    H = _dlt_h(u1, u2)
    tol = jnp.asarray(1e-6 if dtype == jnp.float32 else 1e-10, dtype)
    valid = resid < tol * 6
    return H, lp[..., 0], lp[..., 1], valid


def radial_distort_point(point_in_camera, focal_length, radial_distortion):
    """Division-model distortion of a 3D camera point to a 2D pixel.

    Parity: `DistortPoint` (`six_point_radial_distortion_homography.h:73`):
    solves the division model forward (quadratic in the distorted radius).
    """
    x, y, z = point_in_camera[..., 0], point_in_camera[..., 1], point_in_camera[..., 2]
    ru = jnp.sqrt(x * x + y * y) / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    # Solve l*rd^2 - rd/ru + 1 = 0 for rd/ru ratio (division model inverse).
    l = radial_distortion
    disc = jnp.sqrt(jnp.maximum(1.0 - 4.0 * l * ru * ru, 0.0))
    rd = jnp.where(
        jnp.abs(l) < 1e-12,
        ru,
        (1.0 - disc) / (2.0 * l * jnp.where(jnp.abs(ru) < 1e-12, 1e-12, ru)),
    )
    scale = jnp.where(jnp.abs(ru) < 1e-12, 1.0, rd / jnp.maximum(ru, 1e-12))
    zz = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    return (focal_length * scale)[..., None] * jnp.stack([x / zz, y / zz], axis=-1)


def radial_undistort_point(distorted_point, focal_length, radial_distortion):
    """Division-model undistortion to a unit-scale 3D ray.

    Parity: `UndistortPoint` (same header)."""
    p = distorted_point / focal_length
    r2 = jnp.sum(p * p, axis=-1, keepdims=True)
    z = 1.0 + radial_distortion * r2[..., 0]
    return jnp.concatenate([p, z[..., None]], axis=-1)


def check_radial_symmetric_error(
    H, l1, l2, point1, point2, focal_length1=1.0, focal_length2=1.0
):
    """Symmetric transfer error under the radial homography (parity:
    `CheckRadialSymmetricError`, same header)."""
    p1 = point1 / focal_length1
    p2 = point2 / focal_length2
    u1 = _lift(p1[..., None, :], jnp.asarray(l1))[..., 0, :]
    u2 = _lift(p2[..., None, :], jnp.asarray(l2))[..., 0, :]
    return _sym_transfer_resid(
        H, u1[..., None, :], u2[..., None, :]
    )
