"""The eight camera intrinsics models as batched, differentiable pure functions.

Batched re-design of the reference camera model hierarchy
(`/root/reference/src/theia/sfm/camera/camera_intrinsics_model.h:83` and the
eight concrete `*_camera_model.h` subclasses). The reference uses a virtual
class hierarchy with static templated project/distort methods so Ceres can
autodiff them; here every model is a pair of pure jnp functions

    camera_to_pixel(params, point3)  -> pixel2       (project + distort)
    pixel_to_camera(params, pixel2)  -> ray3          (undistort + unproject)

that are `vmap`/`jit`/`grad`-safe with arbitrary leading batch dims. The
parameter vectors use exactly the reference's per-model layouts (the
`InternalParametersIndex` enums), padded to ``MAX_INTRINSICS`` so a whole
scene's intrinsics live in one `[G, MAX_INTRINSICS]` array.

Distortion formula parity (math matched, not translated):
  PINHOLE                    pinhole_camera_model.h:86-260
  PINHOLE_RADIAL_TANGENTIAL  pinhole_radial_tangential_camera_model.h:84-
  FISHEYE                    fisheye_camera_model.h:67- (Kannala-Brandt)
  FOV                        fov_camera_model.h:69- (Devernay-Faugeras)
  DIVISION_UNDISTORTION      division_undistortion_camera_model.h:76-
  DOUBLE_SPHERE              double_sphere_camera_model.h:66-
  EXTENDED_UNIFIED           extended_unified_camera_model.h:66-
  ORTHOGRAPHIC               orthographic_camera_model.h:66-
"""

from __future__ import annotations

import enum
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "CameraIntrinsicsModelType",
    "OptimizeIntrinsicsType",
    "MAX_INTRINSICS",
    "NUM_INTRINSICS",
    "camera_to_pixel",
    "pixel_to_camera",
    "default_intrinsics",
    "make_intrinsics",
    "make_intrinsics_np",
    "intrinsics_subset_mask",
    "focal_length",
    "principal_point",
]

MAX_INTRINSICS = 10
_UNDISTORT_ITERS = 50


class CameraIntrinsicsModelType(enum.IntEnum):
    """Parity: `theia::CameraIntrinsicsModelType`
    (`camera_intrinsics_model_type.h:38-48`)."""

    PINHOLE = 0
    PINHOLE_RADIAL_TANGENTIAL = 1
    FISHEYE = 2
    FOV = 3
    DIVISION_UNDISTORTION = 4
    DOUBLE_SPHERE = 5
    EXTENDED_UNIFIED = 6
    ORTHOGRAPHIC = 7


# Number of meaningful parameters per model (reference kIntrinsicsSize).
NUM_INTRINSICS = {
    CameraIntrinsicsModelType.PINHOLE: 7,
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: 10,
    CameraIntrinsicsModelType.FISHEYE: 9,
    CameraIntrinsicsModelType.FOV: 5,
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: 5,
    CameraIntrinsicsModelType.DOUBLE_SPHERE: 7,
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: 7,
    CameraIntrinsicsModelType.ORTHOGRAPHIC: 7,
}

# Which padded slot holds (focal, aspect, ppx, ppy) for each model. All models
# put FOCAL_LENGTH at 0 and ASPECT_RATIO at 1; the principal point position
# varies (FOV / DIVISION_UNDISTORTION have no skew).
_PP_INDEX = {
    CameraIntrinsicsModelType.PINHOLE: 3,
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: 3,
    CameraIntrinsicsModelType.FISHEYE: 3,
    CameraIntrinsicsModelType.FOV: 2,
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: 2,
    CameraIntrinsicsModelType.DOUBLE_SPHERE: 3,
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: 3,
    CameraIntrinsicsModelType.ORTHOGRAPHIC: 3,
}

_HAS_SKEW = {
    CameraIntrinsicsModelType.PINHOLE: True,
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: True,
    CameraIntrinsicsModelType.FISHEYE: True,
    CameraIntrinsicsModelType.FOV: False,
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: False,
    CameraIntrinsicsModelType.DOUBLE_SPHERE: True,
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: True,
    CameraIntrinsicsModelType.ORTHOGRAPHIC: True,
}


def default_intrinsics(model: CameraIntrinsicsModelType, dtype=jnp.float32) -> jax.Array:
    """Padded default parameter vector (focal 1, aspect 1, everything else 0).

    EXTENDED_UNIFIED defaults beta to 1 (reference ctor default alpha=.5,
    beta=1 — `extended_unified_camera_model.cc`); we use alpha=0, beta=1 so
    the default projects like a pinhole.
    """
    p = jnp.zeros((MAX_INTRINSICS,), dtype)
    p = p.at[0].set(1.0).at[1].set(1.0)
    if model == CameraIntrinsicsModelType.EXTENDED_UNIFIED:
        p = p.at[6].set(1.0)
    return p


def make_intrinsics(
    model: CameraIntrinsicsModelType,
    focal_length: float = 1.0,
    aspect_ratio: float = 1.0,
    skew: float = 0.0,
    principal_point=(0.0, 0.0),
    distortion=(),
    dtype=jnp.float32,
) -> jax.Array:
    """Build a padded parameter vector in the reference's per-model layout."""
    p = default_intrinsics(model, dtype)
    p = p.at[0].set(focal_length).at[1].set(aspect_ratio)
    pp = _PP_INDEX[model]
    if _HAS_SKEW[model]:
        p = p.at[2].set(skew)
    p = p.at[pp].set(principal_point[0]).at[pp + 1].set(principal_point[1])
    for i, d in enumerate(distortion):
        p = p.at[pp + 2 + i].set(d)
    return p


class OptimizeIntrinsicsType(enum.IntFlag):
    """Parity: `theia::OptimizeIntrinsicsType` bitmask
    (`bundle_adjustment.h:71-84`)."""

    NONE = 0x00
    FOCAL_LENGTH = 0x01
    ASPECT_RATIO = 0x02
    SKEW = 0x04
    PRINCIPAL_POINTS = 0x08
    RADIAL_DISTORTION = 0x10
    TANGENTIAL_DISTORTION = 0x20
    DISTORTION = RADIAL_DISTORTION | TANGENTIAL_DISTORTION
    FOCAL_LENGTH_RADIAL_DISTORTION = FOCAL_LENGTH | RADIAL_DISTORTION
    ALL = (
        FOCAL_LENGTH
        | ASPECT_RATIO
        | SKEW
        | PRINCIPAL_POINTS
        | RADIAL_DISTORTION
        | TANGENTIAL_DISTORTION
    )


# Per-model parameter slots selected by each OptimizeIntrinsicsType bit
# (parity: the per-model GetSubsetFromOptimizeIntrinsicsType implementations,
# e.g. `pinhole_camera_model.cc:132-162`, `fisheye_camera_model.cc:141-172`,
# `double_sphere_camera_model.cc` — XI/ALPHA/BETA/OMEGA all count as
# RADIAL_DISTORTION in the reference).
_SUBSET_SLOTS = {
    CameraIntrinsicsModelType.PINHOLE: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6),
    },
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6, 7),
        OptimizeIntrinsicsType.TANGENTIAL_DISTORTION: (8, 9),
    },
    CameraIntrinsicsModelType.FISHEYE: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6, 7, 8),
    },
    CameraIntrinsicsModelType.FOV: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (2, 3),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (4,),
    },
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (2, 3),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (4,),
    },
    CameraIntrinsicsModelType.DOUBLE_SPHERE: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6),
    },
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6),
    },
    CameraIntrinsicsModelType.ORTHOGRAPHIC: {
        OptimizeIntrinsicsType.FOCAL_LENGTH: (0,),
        OptimizeIntrinsicsType.ASPECT_RATIO: (1,),
        OptimizeIntrinsicsType.SKEW: (2,),
        OptimizeIntrinsicsType.PRINCIPAL_POINTS: (3, 4),
        OptimizeIntrinsicsType.RADIAL_DISTORTION: (5, 6),
    },
}


def intrinsics_subset_mask(
    model: CameraIntrinsicsModelType, flags: "OptimizeIntrinsicsType"
):
    """Boolean [MAX_INTRINSICS] mask of the parameters freed by `flags` for
    this model (parity: GetSubsetFromOptimizeIntrinsicsType, inverted — the
    reference returns the constant set)."""
    import numpy as np

    mask = np.zeros((MAX_INTRINSICS,), bool)
    for bit, slots in _SUBSET_SLOTS[model].items():
        if flags & bit:
            for s in slots:
                mask[s] = True
    return mask


def make_intrinsics_np(
    model: CameraIntrinsicsModelType,
    focal_length: float = 1.0,
    aspect_ratio: float = 1.0,
    skew: float = 0.0,
    principal_point=(0.0, 0.0),
    distortion=(),
    dtype=None,
):
    """Pure-numpy `make_intrinsics` for host-side containers/IO — building
    intrinsics rows must not touch the device (a jnp round-trip per view
    costs a dispatch and a blocking transfer each)."""
    import numpy as np

    p = np.zeros((MAX_INTRINSICS,), dtype or np.float64)
    p[0], p[1] = focal_length, aspect_ratio
    if model == CameraIntrinsicsModelType.EXTENDED_UNIFIED:
        p[6] = 1.0
    pp = _PP_INDEX[model]
    if _HAS_SKEW[model]:
        p[2] = skew
    p[pp], p[pp + 1] = principal_point[0], principal_point[1]
    for i, d in enumerate(distortion):
        if pp + 2 + i < MAX_INTRINSICS:
            p[pp + 2 + i] = d
    return p


def focal_length(params: jax.Array) -> jax.Array:
    return params[..., 0]


def principal_point(params: jax.Array, model: CameraIntrinsicsModelType) -> jax.Array:
    pp = _PP_INDEX[model]
    return params[..., pp : pp + 2]


# ---------------------------------------------------------------------------
# Shared K / K^-1 application.
# ---------------------------------------------------------------------------


def _apply_calibration(params, pt2, pp_idx, has_skew):
    f = params[..., 0]
    fy = f * params[..., 1]
    ppx = params[..., pp_idx]
    ppy = params[..., pp_idx + 1]
    skew = params[..., 2] if has_skew else jnp.zeros_like(f)
    px = f * pt2[..., 0] + skew * pt2[..., 1] + ppx
    py = fy * pt2[..., 1] + ppy
    return jnp.stack([px, py], axis=-1)


def _remove_calibration(params, pixel, pp_idx, has_skew):
    f = params[..., 0]
    fy = f * params[..., 1]
    ppx = params[..., pp_idx]
    ppy = params[..., pp_idx + 1]
    skew = params[..., 2] if has_skew else jnp.zeros_like(f)
    y = (pixel[..., 1] - ppy) / fy
    x = (pixel[..., 0] - ppx - y * skew) / f
    return jnp.stack([x, y], axis=-1)


def _fixed_point_undistort(distorted, divisor_fn):
    """Generic fixed-point undistortion u_{k+1} = d / divisor(u_k).

    Mirrors the reference's 100-iteration loops with convergence epsilon
    (e.g. `pinhole_camera_model.h` UndistortPoint) as a fixed-count
    `fori_loop` with a convergence freeze — jit/vmap-safe, static shapes.
    """

    def body(_, u):
        div = divisor_fn(u)
        new = distorted / div[..., None]
        delta = jnp.max(jnp.abs(new - u), axis=-1, keepdims=True)
        return jnp.where(delta > 1e-12, new, u)

    return jax.lax.fori_loop(0, _UNDISTORT_ITERS, body, distorted)


# ---------------------------------------------------------------------------
# PINHOLE — params [f, aspect, skew, ppx, ppy, k1, k2].
# ---------------------------------------------------------------------------


def pinhole_distort(params, pt2):
    k1, k2 = params[..., 5], params[..., 6]
    r_sq = jnp.sum(pt2 * pt2, axis=-1)
    d = 1.0 + r_sq * (k1 + k2 * r_sq)
    return pt2 * d[..., None]


def pinhole_undistort(params, pt2):
    k1, k2 = params[..., 5], params[..., 6]

    def divisor(u):
        r_sq = jnp.sum(u * u, axis=-1)
        return 1.0 + r_sq * (k1 + k2 * r_sq)

    return _fixed_point_undistort(pt2, divisor)


def pinhole_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, pinhole_distort(params, norm), 3, True)


def pinhole_pixel_to_camera(params, pixel):
    pt2 = pinhole_undistort(params, _remove_calibration(params, pixel, 3, True))
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# PINHOLE_RADIAL_TANGENTIAL — [f, aspect, skew, ppx, ppy, k1, k2, k3, t1, t2].
# ---------------------------------------------------------------------------


def _radial_tangential_forward(params, u):
    k1, k2, k3 = params[..., 5], params[..., 6], params[..., 7]
    t1, t2 = params[..., 8], params[..., 9]
    x, y = u[..., 0], u[..., 1]
    r_sq = x * x + y * y
    rd = 1.0 + k1 * r_sq + k2 * r_sq * r_sq + k3 * r_sq * r_sq * r_sq
    tx = t2 * (r_sq + 2.0 * x * x) + 2.0 * t1 * x * y
    ty = t1 * (r_sq + 2.0 * y * y) + 2.0 * t2 * x * y
    return jnp.stack([x * rd + tx, y * rd + ty], axis=-1)


def pinhole_radial_tangential_distort(params, pt2):
    return _radial_tangential_forward(params, pt2)


def pinhole_radial_tangential_undistort(params, pt2):
    # Fixed-point on the full radial+tangential map (reference iterates the
    # same way, dividing through the radial term and subtracting tangential).
    def body(_, u):
        k1, k2, k3 = params[..., 5], params[..., 6], params[..., 7]
        t1, t2 = params[..., 8], params[..., 9]
        x, y = u[..., 0], u[..., 1]
        r_sq = x * x + y * y
        rd = 1.0 + k1 * r_sq + k2 * r_sq * r_sq + k3 * r_sq * r_sq * r_sq
        tx = t2 * (r_sq + 2.0 * x * x) + 2.0 * t1 * x * y
        ty = t1 * (r_sq + 2.0 * y * y) + 2.0 * t2 * x * y
        new = jnp.stack(
            [(pt2[..., 0] - tx) / rd, (pt2[..., 1] - ty) / rd], axis=-1
        )
        delta = jnp.max(jnp.abs(new - u), axis=-1, keepdims=True)
        return jnp.where(delta > 1e-12, new, u)

    return jax.lax.fori_loop(0, _UNDISTORT_ITERS, body, pt2)


def pinhole_radial_tangential_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(
        params, pinhole_radial_tangential_distort(params, norm), 3, True
    )


def pinhole_radial_tangential_pixel_to_camera(params, pixel):
    pt2 = pinhole_radial_tangential_undistort(
        params, _remove_calibration(params, pixel, 3, True)
    )
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# FISHEYE (Kannala-Brandt) — [f, aspect, skew, ppx, ppy, k1, k2, k3, k4].
# Distortion acts on the full 3D point: theta = atan2(r, |z|).
# ---------------------------------------------------------------------------


def fisheye_distort3(params, point3):
    k1, k2, k3, k4 = (params[..., 5], params[..., 6], params[..., 7], params[..., 8])
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r_sq = x * x + y * y
    near_center = r_sq < 1e-8
    r = jnp.sqrt(jnp.where(near_center, 1.0, r_sq))
    theta = jnp.arctan2(r, jnp.abs(z))
    th2 = theta * theta
    theta_d = theta * (
        1.0 + k1 * th2 + k2 * th2 * th2 + k3 * th2 * th2 * th2 + k4 * th2 * th2 * th2 * th2
    )
    scale = jnp.where(near_center, 1.0, theta_d / r)
    sign = jnp.where(z < 0.0, -1.0, 1.0)
    out = jnp.stack([scale * x, scale * y], axis=-1) * sign[..., None]
    # Near-center: no distortion (z-positive assumed) — reference returns
    # the input x,y unchanged.
    return jnp.where(near_center[..., None], point3[..., :2], out)


def fisheye_undistort(params, pt2):
    """Undistort a 2D distorted (normalized) point to a unit-plane-scaled 2D
    point, fixed-point on theta_d/r (reference `fisheye_camera_model.h`)."""
    k1, k2, k3, k4 = (params[..., 5], params[..., 6], params[..., 7], params[..., 8])

    def body(_, u):
        r_sq = jnp.sum(u * u, axis=-1)
        near = r_sq < 1e-16
        r = jnp.sqrt(jnp.where(near, 1.0, r_sq))
        theta = jnp.arctan2(r, jnp.ones_like(r))
        th2 = theta * theta
        theta_d = theta * (
            1.0
            + k1 * th2
            + k2 * th2 * th2
            + k3 * th2 * th2 * th2
            + k4 * th2 * th2 * th2 * th2
        )
        new = pt2 * (r / theta_d)[..., None]
        return jnp.where(near[..., None], u, new)

    return jax.lax.fori_loop(0, _UNDISTORT_ITERS, body, pt2)


def fisheye_camera_to_pixel(params, point3):
    return _apply_calibration(params, fisheye_distort3(params, point3), 3, True)


def fisheye_pixel_to_camera(params, pixel):
    pt2 = fisheye_undistort(params, _remove_calibration(params, pixel, 3, True))
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# FOV (Devernay-Faugeras) — [f, aspect, ppx, ppy, omega]. No skew.
# ---------------------------------------------------------------------------


def fov_distort(params, pt2):
    omega = params[..., 4]
    r_u_sq = jnp.sum(pt2 * pt2, axis=-1)
    small_omega = omega < 1e-3
    small_r = r_u_sq < 1e-3

    # Taylor in omega (reference cites COLMAP's derivation).
    rd_small_omega = (omega * omega * r_u_sq) / 3.0 - omega * omega / 12.0 + 1.0
    safe_omega = jnp.where(small_omega, 1.0, omega)
    tan_half = jnp.tan(safe_omega / 2.0)
    rd_small_r = (
        -2.0 * tan_half * (4.0 * r_u_sq * tan_half * tan_half - 3.0)
    ) / (3.0 * safe_omega)
    r_u = jnp.sqrt(jnp.where(small_r, 1.0, r_u_sq))
    rd_general = jnp.arctan(2.0 * r_u * tan_half) / (r_u * safe_omega)

    r_d = jnp.where(small_omega, rd_small_omega, jnp.where(small_r, rd_small_r, rd_general))
    return pt2 * r_d[..., None]


def fov_undistort(params, pt2):
    omega = params[..., 4]
    r_d_sq = jnp.sum(pt2 * pt2, axis=-1)
    small_omega = omega < 1e-3
    small_r = r_d_sq < 1e-3

    ru_small_omega = (omega * omega * r_d_sq) / 3.0 - omega * omega / 12.0 + 1.0
    safe_omega = jnp.where(small_omega, 1.0, omega)
    tan_half = jnp.tan(safe_omega / 2.0)
    ru_small_r = (safe_omega * (safe_omega * safe_omega * r_d_sq + 3.0)) / (
        6.0 * tan_half
    )
    r_d = jnp.sqrt(jnp.where(small_r, 1.0, r_d_sq))
    ru_general = jnp.tan(r_d * safe_omega) / (2.0 * r_d * tan_half)

    r_u = jnp.where(small_omega, ru_small_omega, jnp.where(small_r, ru_small_r, ru_general))
    return pt2 * r_u[..., None]


def fov_camera_to_pixel(params, point3):
    norm = point3[..., :2] / point3[..., 2:3]
    return _apply_calibration(params, fov_distort(params, norm), 2, False)


def fov_pixel_to_camera(params, pixel):
    pt2 = fov_undistort(params, _remove_calibration(params, pixel, 2, False))
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# DIVISION_UNDISTORTION — [f, aspect, ppx, ppy, k]. Distortion in PIXEL units
# about the principal point (reference division_undistortion_camera_model.h).
# ---------------------------------------------------------------------------


def division_distort(params, pt2):
    """pt2 is an undistorted *pixel-scale* point centered at the pp."""
    k = params[..., 4]
    r_u_sq = jnp.sum(pt2 * pt2, axis=-1)
    denom = 2.0 * k * r_u_sq
    inner = 1.0 - 4.0 * k * r_u_sq
    degenerate = (jnp.abs(denom) < 1e-15) | (inner < 0.0)
    scale = (1.0 - jnp.sqrt(jnp.maximum(inner, 0.0))) / jnp.where(
        degenerate, 1.0, denom
    )
    return jnp.where(degenerate[..., None], pt2, pt2 * scale[..., None])


def division_undistort(params, pt2):
    k = params[..., 4]
    r_d_sq = jnp.sum(pt2 * pt2, axis=-1)
    return pt2 / (1.0 + k * r_d_sq)[..., None]


def division_camera_to_pixel(params, point3):
    f = params[..., 0]
    fy = f * params[..., 1]
    norm = point3[..., :2] / point3[..., 2:3]
    undist_px = jnp.stack([f * norm[..., 0], fy * norm[..., 1]], axis=-1)
    dist = division_distort(params, undist_px)
    pp = params[..., 2:4]
    return dist + pp


def division_pixel_to_camera(params, pixel):
    f = params[..., 0]
    fy = f * params[..., 1]
    centered = pixel - params[..., 2:4]
    undist = division_undistort(params, centered)
    pt2 = jnp.stack([undist[..., 0] / f, undist[..., 1] / fy], axis=-1)
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# DOUBLE_SPHERE — [f, aspect, skew, ppx, ppy, xi, alpha].
# ---------------------------------------------------------------------------


def double_sphere_distort3(params, point3):
    xi, alpha = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r2 = x * x + y * y
    d1 = jnp.sqrt(r2 + z * z)
    k = xi * d1 + z
    d2 = jnp.sqrt(r2 + k * k)
    norm = alpha * d2 + (1.0 - alpha) * k
    safe = jnp.abs(norm) > 1e-12
    inv = jnp.where(safe, 1.0 / jnp.where(safe, norm, 1.0), 0.0)
    return jnp.stack([x * inv, y * inv], axis=-1)


def double_sphere_valid3(params, point3):
    """Projection validity (point in front of the model's FOV cone)."""
    xi, alpha = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    d1 = jnp.sqrt(x * x + y * y + z * z)
    w1 = jnp.where(alpha > 0.5, (1.0 - alpha) / jnp.maximum(alpha, 1e-12),
                   alpha / jnp.maximum(1.0 - alpha, 1e-12))
    w2 = (w1 + xi) / jnp.sqrt(jnp.maximum(2.0 * w1 * xi + xi * xi + 1.0, 1e-12))
    return z > -w2 * d1


def double_sphere_undistort(params, pt2):
    xi, alpha = params[..., 5], params[..., 6]
    r2 = jnp.sum(pt2 * pt2, axis=-1)
    sqrt2 = jnp.sqrt(jnp.maximum(1.0 - (2.0 * alpha - 1.0) * r2, 0.0))
    norm2 = alpha * sqrt2 + 1.0 - alpha
    mz = (1.0 - alpha * alpha * r2) / norm2
    mz2 = mz * mz
    norm1 = mz2 + r2
    sqrt1 = jnp.sqrt(jnp.maximum(mz2 + (1.0 - xi * xi) * r2, 0.0))
    k = (mz * xi + sqrt1) / jnp.maximum(norm1, 1e-12)
    return jnp.stack(
        [k * pt2[..., 0], k * pt2[..., 1], k * mz - xi], axis=-1
    )


def double_sphere_camera_to_pixel(params, point3):
    return _apply_calibration(params, double_sphere_distort3(params, point3), 3, True)


def double_sphere_pixel_to_camera(params, pixel):
    return double_sphere_undistort(params, _remove_calibration(params, pixel, 3, True))


# ---------------------------------------------------------------------------
# EXTENDED_UNIFIED — [f, aspect, skew, ppx, ppy, alpha, beta].
# ---------------------------------------------------------------------------


def extended_unified_distort3(params, point3):
    alpha, beta = params[..., 5], params[..., 6]
    x, y, z = point3[..., 0], point3[..., 1], point3[..., 2]
    r2 = x * x + y * y
    rho = jnp.sqrt(jnp.maximum(beta * r2 + z * z, 0.0))
    norm = alpha * rho + (1.0 - alpha) * z
    invalid = norm < 1e-3
    inv = jnp.where(invalid, 0.0, 1.0 / jnp.where(invalid, 1.0, norm))
    return jnp.stack([x * inv, y * inv], axis=-1)


def extended_unified_undistort(params, pt2):
    alpha, beta = params[..., 5], params[..., 6]
    r2 = jnp.sum(pt2 * pt2, axis=-1)
    gamma = 1.0 - alpha
    tmp1 = 1.0 - alpha * alpha * beta * r2
    tmp_sqrt = jnp.sqrt(jnp.maximum(1.0 - (alpha - gamma) * beta * r2, 0.0))
    tmp2 = alpha * tmp_sqrt + gamma
    k = tmp1 / tmp2
    norm = jnp.maximum(jnp.sqrt(r2 + k * k), 1e-12)
    return jnp.stack(
        [pt2[..., 0] / norm, pt2[..., 1] / norm, k / norm], axis=-1
    )


def extended_unified_camera_to_pixel(params, point3):
    return _apply_calibration(
        params, extended_unified_distort3(params, point3), 3, True
    )


def extended_unified_pixel_to_camera(params, pixel):
    return extended_unified_undistort(
        params, _remove_calibration(params, pixel, 3, True)
    )


# ---------------------------------------------------------------------------
# ORTHOGRAPHIC — [f, aspect, skew, ppx, ppy, k1, k2]. Projects (x, y) without
# depth division (telecentric lens).
# ---------------------------------------------------------------------------


def orthographic_camera_to_pixel(params, point3):
    dist = pinhole_distort(params, point3[..., :2])
    return _apply_calibration(params, dist, 3, True)


def orthographic_pixel_to_camera(params, pixel):
    pt2 = pinhole_undistort(params, _remove_calibration(params, pixel, 3, True))
    return jnp.concatenate([pt2, jnp.ones_like(pt2[..., :1])], axis=-1)


# ---------------------------------------------------------------------------
# Dispatch tables.
# ---------------------------------------------------------------------------

_CAMERA_TO_PIXEL: dict[CameraIntrinsicsModelType, Callable] = {
    CameraIntrinsicsModelType.PINHOLE: pinhole_camera_to_pixel,
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: pinhole_radial_tangential_camera_to_pixel,
    CameraIntrinsicsModelType.FISHEYE: fisheye_camera_to_pixel,
    CameraIntrinsicsModelType.FOV: fov_camera_to_pixel,
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: division_camera_to_pixel,
    CameraIntrinsicsModelType.DOUBLE_SPHERE: double_sphere_camera_to_pixel,
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: extended_unified_camera_to_pixel,
    CameraIntrinsicsModelType.ORTHOGRAPHIC: orthographic_camera_to_pixel,
}

_PIXEL_TO_CAMERA: dict[CameraIntrinsicsModelType, Callable] = {
    CameraIntrinsicsModelType.PINHOLE: pinhole_pixel_to_camera,
    CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL: pinhole_radial_tangential_pixel_to_camera,
    CameraIntrinsicsModelType.FISHEYE: fisheye_pixel_to_camera,
    CameraIntrinsicsModelType.FOV: fov_pixel_to_camera,
    CameraIntrinsicsModelType.DIVISION_UNDISTORTION: division_pixel_to_camera,
    CameraIntrinsicsModelType.DOUBLE_SPHERE: double_sphere_pixel_to_camera,
    CameraIntrinsicsModelType.EXTENDED_UNIFIED: extended_unified_pixel_to_camera,
    CameraIntrinsicsModelType.ORTHOGRAPHIC: orthographic_pixel_to_camera,
}


def camera_to_pixel(params: jax.Array, point3: jax.Array, model) -> jax.Array:
    """Project a camera-frame 3D point to a pixel.

    `model` is a *static* `CameraIntrinsicsModelType` — scene batches share a
    model per intrinsics group, so dispatch is resolved at trace time (no
    `lax.switch` in the hot path). Parity:
    `CameraIntrinsicsModel::CameraToPixelCoordinates`
    (`camera_intrinsics_model.h:124`).
    """
    return _CAMERA_TO_PIXEL[CameraIntrinsicsModelType(model)](params, point3)


def pixel_to_camera(params: jax.Array, pixel: jax.Array, model) -> jax.Array:
    """Unproject a pixel to a camera-frame ray (z=1 plane for pinhole-like
    models, unit-ish 3D bearing for DS/EUCM). Parity:
    `CameraIntrinsicsModel::PixelToCameraCoordinates`
    (`camera_intrinsics_model.h:133`)."""
    return _PIXEL_TO_CAMERA[CameraIntrinsicsModelType(model)](params, pixel)
