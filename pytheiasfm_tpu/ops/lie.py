"""SE(3) and Sim(3) Lie-group operations as batched pure functions.

Batched replacement for the Sophus types the reference binds to Python
(`/root/reference/src/pytheia/math/math.cc:92,150` — `Sophus::SE3d`,
`Sophus::Sim3d`) and uses for pose-graph Sim3 optimization
(`sfm/transformation/align_reconstructions_pose_graph_optim.h:43`).

Conventions:
  SE3 elements are `(R [..,3,3], t [..,3])`; tangent vectors are
  `xi = (rho[3], phi[3])` with `exp(xi) = (exp(phi), V(phi) rho)`.
  Sim3 elements are `(s [..], R [..,3,3], t [..,3])`; tangent vectors are
  `xi = (rho[3], phi[3], sigma)` (translation, rotation, log-scale).

All functions are differentiable (Taylor-guarded at the identity) and accept
arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rotation as rot

__all__ = [
    "se3_exp",
    "se3_log",
    "se3_inverse",
    "se3_multiply",
    "se3_action",
    "sim3_exp",
    "sim3_log",
    "sim3_inverse",
    "sim3_multiply",
    "sim3_action",
]

_EPS = 1e-8


def _v_coeffs(phi):
    """Coefficients (a1, a2) of V = I + a1 W + a2 W^2 for SE3 exp."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    small = theta_sq < _EPS
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    a1 = jnp.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta_sq),
    )
    a2 = jnp.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - jnp.sin(theta)) / jnp.where(small, 1.0, theta_sq * theta),
    )
    return a1, a2


def _left_jacobian(phi):
    """V(phi): the left Jacobian of SO(3)."""
    W = rot.hat(phi)
    a1, a2 = _v_coeffs(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + a1[..., None, None] * W + a2[..., None, None] * (W @ W)


def _left_jacobian_inverse(phi):
    """V(phi)^-1 in closed form."""
    W = rot.hat(phi)
    theta_sq = jnp.sum(phi * phi, axis=-1)
    small = theta_sq < _EPS
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    half = 0.5 * theta
    # cot coefficient: (1 - theta/2 * cot(theta/2)) / theta^2, Taylor 1/12.
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / jnp.where(small, 1.0, theta_sq),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * (W @ W)


def se3_exp(xi: jax.Array):
    """Tangent [.., 6] (rho, phi) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = rot.angle_axis_to_rotation_matrix(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    """(R, t) -> tangent [.., 6] (rho, phi)."""
    phi = rot.rotation_matrix_to_angle_axis(R)
    rho = (_left_jacobian_inverse(phi) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_multiply(R1, t1, R2, t2):
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def se3_action(R, t, p):
    return (R @ p[..., None])[..., 0] + t


# ---------------------------------------------------------------------------
# Sim(3): exp via W = c0 I + c1 Omega + c2 Omega^2 with
# c_k = int_0^1 e^{sigma u} * {1, sin(theta u)/theta, (1-cos(theta u))/theta^2} du.
# ---------------------------------------------------------------------------


def _sim3_w_coeffs(theta_sq, sigma):
    dtype = sigma.dtype
    theta_small = theta_sq < _EPS
    sigma_small = jnp.abs(sigma) < _EPS
    theta = jnp.sqrt(jnp.where(theta_small, 1.0, theta_sq))
    s = jnp.exp(sigma)
    safe_sigma = jnp.where(sigma_small, 1.0, sigma)
    denom = sigma * sigma + theta_sq
    safe_denom = jnp.where(denom < _EPS, 1.0, denom)

    # c0 = (e^sigma - 1)/sigma.
    c0 = jnp.where(sigma_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sigma)

    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)

    # c1 general: (s(sigma sin - theta cos) + theta) / (theta (sigma^2+theta^2)).
    c1_general = (s * (sigma * sin_t - theta * cos_t) + theta) / (
        jnp.where(theta_small, 1.0, theta) * safe_denom
    )
    # theta -> 0: int e^{sigma u} u du = (s (sigma - 1) + 1)/sigma^2.
    c1_theta0 = jnp.where(
        sigma_small,
        0.5 + sigma / 3.0,
        (s * (sigma - 1.0) + 1.0) / jnp.where(sigma_small, 1.0, sigma * sigma),
    )
    # sigma -> 0: (1 - cos theta)/theta^2.
    c1_sigma0 = jnp.where(
        theta_small,
        0.5 - theta_sq / 24.0,
        (1.0 - cos_t) / jnp.where(theta_small, 1.0, theta_sq),
    )
    c1 = jnp.where(theta_small, c1_theta0, jnp.where(sigma_small, c1_sigma0, c1_general))

    # c2 general: (c0 - (s(sigma cos + theta sin) - sigma)/(sigma^2+theta^2)) / theta^2.
    c2_general = (
        c0 - (s * (sigma * cos_t + theta * sin_t) - sigma) / safe_denom
    ) / jnp.where(theta_small, 1.0, theta_sq)
    # theta -> 0: int e^{sigma u} u^2/2 du = (s(sigma^2 - 2 sigma + 2) - 2)/(2 sigma^3).
    c2_theta0 = jnp.where(
        sigma_small,
        1.0 / 6.0 + sigma / 8.0,
        (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0)
        / jnp.where(sigma_small, 1.0, 2.0 * sigma**3),
    )
    # sigma -> 0: (theta - sin theta)/theta^3.
    c2_sigma0 = jnp.where(
        theta_small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - sin_t) / jnp.where(theta_small, 1.0, theta_sq * theta),
    )
    c2 = jnp.where(theta_small, c2_theta0, jnp.where(sigma_small, c2_sigma0, c2_general))
    return c0.astype(dtype), c1.astype(dtype), c2.astype(dtype)


def _sim3_w(phi, sigma):
    W = rot.hat(phi)
    c0, c1, c2 = _sim3_w_coeffs(jnp.sum(phi * phi, axis=-1), sigma)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye * c0[..., None, None] + c1[..., None, None] * W + c2[..., None, None] * (W @ W)


def sim3_exp(xi: jax.Array):
    """Tangent [.., 7] (rho, phi, sigma) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = rot.angle_axis_to_rotation_matrix(phi)
    t = (_sim3_w(phi, sigma) @ rho[..., None])[..., 0]
    return jnp.exp(sigma), R, t


def sim3_log(s, R, t):
    """(s, R, t) -> tangent [.., 7]. W is inverted by a 3x3 solve."""
    phi = rot.rotation_matrix_to_angle_axis(R)
    sigma = jnp.log(s)
    W = _sim3_w(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_inverse(s, R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def sim3_multiply(s1, R1, t1, s2, R2, t2):
    return (
        s1 * s2,
        R1 @ R2,
        s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1,
    )


def sim3_action(s, R, t, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t
