"""Batched non-minimal PnP solvers.

Batched equivalents of the reference's n-point absolute pose family:
  `theia::DlsPnp`  (/root/reference/src/theia/sfm/pose/dls_pnp.h:61)
  `theia::SQPnP`   (/root/reference/src/theia/sfm/pose/sqpnp.h:70)

The reference's DLS-PnP solves a Groebner/Macaulay polynomial system via
nonsymmetric eigendecomposition — unavailable on accelerators. Both entry points here
share an accelerator-friendly pipeline: a DLT initialization (nullspace of the 2Nx12
design via symmetric `eigh`) or SQPnP-style 9x9 quadratic form, followed by
damped Gauss-Newton on the object-space/reprojection error over SO(3)xR^3.
This matches the reference's accuracy contract (their tests assert
reprojection-error tolerances, not solver internals).

Conventions: `features` are normalized (calibrated) image points [.., N, 2];
returns world->camera rotation R and camera position c (p_cam = R (X - c)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rotation as rotops

__all__ = ["dlt_pnp", "sqpnp", "dls_pnp", "pnp_gauss_newton"]


def _masked_mean(x, mask, axis):
    if mask is None:
        return jnp.mean(x, axis=axis, keepdims=True)
    w = mask.astype(x.dtype)[..., None]
    return jnp.sum(x * w, axis=axis, keepdims=True) / jnp.maximum(
        jnp.sum(w, axis=axis, keepdims=True), 1.0
    )


def dlt_pnp(features: jax.Array, world_points: jax.Array, mask=None, gn_iters: int = 5):
    """Direct linear transform PnP (N >= 6) + Gauss-Newton polish.

    features [.., N, 2], world_points [.., N, 3] ->
    (R [.., 3, 3], position [.., 3], ok [..]).
    """
    dtype = features.dtype
    # Normalize world points for conditioning.
    centroid = _masked_mean(world_points, mask, axis=-2)
    centered = world_points - centroid
    scale = jnp.sqrt(
        jnp.maximum(
            jnp.mean(jnp.sum(centered**2, axis=-1), axis=-1, keepdims=True), 1e-12
        )
    )
    Xn = centered / scale[..., None]

    u = features[..., 0]
    v = features[..., 1]
    ones = jnp.ones_like(u)
    zeros = jnp.zeros_like(u)
    X_h = jnp.concatenate([Xn, ones[..., None]], axis=-1)  # [.., N, 4]
    # Rows: [X 0 -u*X; 0 X -v*X] for P row-major 12-vector.
    row_u = jnp.concatenate(
        [X_h, jnp.zeros_like(X_h), -u[..., None] * X_h], axis=-1
    )
    row_v = jnp.concatenate(
        [jnp.zeros_like(X_h), X_h, -v[..., None] * X_h], axis=-1
    )
    A = jnp.concatenate([row_u, row_v], axis=-2)  # [.., 2N, 12]
    if mask is not None:
        m2 = jnp.concatenate([mask, mask], axis=-1)
        A = A * m2[..., None].astype(dtype)
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    P = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 4))

    # Fix sign: depths of points should be positive.
    depths = jnp.einsum("...ij,...nj->...ni", P, X_h)[..., 2]
    if mask is not None:
        sign_vote = jnp.sum(jnp.sign(depths) * mask.astype(dtype), axis=-1)
    else:
        sign_vote = jnp.sum(jnp.sign(depths), axis=-1)
    P = P * jnp.where(sign_vote < 0, -1.0, 1.0)[..., None, None]

    # Extract R (Procrustes) and translation with consistent scale.
    M = P[..., :3]
    R = rotops.project_to_so3(M)
    # Scale of M: mean singular value ~ ||M R^T||.
    s = jnp.einsum("...ii->...", M @ jnp.swapaxes(R, -1, -2)) / 3.0
    t = P[..., 3] / jnp.maximum(s, 1e-12)[..., None]
    # Undo world normalization: p_cam = R (X - centroid)/scale + t
    #                                 = R/scale (X - (centroid - scale R^T t)).
    position = centroid[..., 0, :] - scale * (
        jnp.swapaxes(R, -1, -2) @ t[..., None]
    )[..., 0]

    R, position, ok = pnp_gauss_newton(
        features, world_points, R, position, mask=mask, iters=gn_iters
    )
    ok = ok & jnp.all(jnp.isfinite(position), axis=-1)
    return R, position, ok


def pnp_gauss_newton(features, world_points, R, position, mask=None, iters=5):
    """Damped Gauss-Newton on reprojection error over (so3 delta, position).

    The update parameterizes R <- exp(dw) R — the same local SO(3) chart the
    reference's Ceres refinement uses. The Jacobian is analytic: with
    p = R (X - c), dpi/dp the standard projection derivative,
    dp/ddw = -hat(p) and dp/dc = -R. Fully batched over leading dims.
    """
    dtype = features.dtype

    def body(_, carry):
        R_cur, c = carry
        diff = world_points - c[..., None, :]
        p = jnp.einsum("...ij,...nj->...ni", R_cur, diff)
        z = jnp.maximum(p[..., 2], 1e-8)
        inv_z = 1.0 / z
        reproj = p[..., :2] * inv_z[..., None]
        r = reproj - features  # [.., N, 2]
        # dpi/dp: [.., N, 2, 3].
        zeros = jnp.zeros_like(inv_z)
        dpi = jnp.stack(
            [
                jnp.stack([inv_z, zeros, -p[..., 0] * inv_z * inv_z], axis=-1),
                jnp.stack([zeros, inv_z, -p[..., 1] * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        )
        # dp/d(dw, c): [-hat(p) | -R]: [.., N, 3, 6].
        dp = jnp.concatenate(
            [
                -rotops.hat(p),
                -jnp.broadcast_to(
                    R_cur[..., None, :, :], p.shape[:-1] + (3, 3)
                ),
            ],
            axis=-1,
        )
        J = dpi @ dp  # [.., N, 2, 6]
        if mask is not None:
            w = mask.astype(dtype)[..., None]
            r = r * w
            J = J * w[..., None]
        Jf = J.reshape(J.shape[:-3] + (-1, 6))
        rf = r.reshape(r.shape[:-2] + (-1,))
        JtJ = jnp.einsum("...ri,...rj->...ij", Jf, Jf)
        Jtr = jnp.einsum("...ri,...r->...i", Jf, rf)
        damp = 1e-8 * jnp.eye(6, dtype=dtype)
        step = jnp.linalg.solve(JtJ + damp, Jtr[..., None])[..., 0]
        finite = jnp.all(jnp.isfinite(step), axis=-1, keepdims=True)
        step = jnp.where(finite, step, 0.0)
        R_new = rotops.angle_axis_to_rotation_matrix(-step[..., :3]) @ R_cur
        c_new = c - step[..., 3:]
        return R_new, c_new

    R_out, c_out = jax.lax.fori_loop(0, iters, body, (R, position))
    ok = jnp.all(jnp.isfinite(c_out), axis=-1) & jnp.all(
        jnp.isfinite(R_out), axis=(-2, -1)
    )
    return R_out, c_out, ok


def sqpnp(features, world_points, mask=None, gn_iters: int = 8):
    """SQPnP-class non-minimal PnP.

    Parity target: `theia::SQPnP` (`sfm/pose/sqpnp.h:70`). The quadratic
    object-space formulation reduces to minimizing r^T Omega r over the 9D
    rotation vector r; we seed with the smallest eigenvector of Omega
    (symmetric 9x9 `eigh`, XLA-native), project to SO(3), and run the same
    damped Gauss-Newton the DLT path uses (the SQP iterations of the paper
    and GN on the reprojection error converge to the same optimum on
    well-posed inputs).
    """
    dtype = features.dtype
    ones = jnp.ones_like(features[..., :1])
    # Omega assembly: for each point, the projection constraint
    # [I2, -u] (R X + t) = 0 with u the normalized feature. Eliminating t
    # yields a 9x9 PSD form over vec(R).
    u = jnp.concatenate([features, ones], axis=-1)  # [.., N, 3] homogeneous
    # A_i maps vec(R) (row-major) to R X_i: [.., N, 3, 9].
    N = features.shape[-2]
    X = world_points
    zeros = jnp.zeros(X.shape[:-1] + (3,), dtype)
    A = jnp.stack(
        [
            jnp.concatenate([X, zeros, zeros], axis=-1),
            jnp.concatenate([zeros, X, zeros], axis=-1),
            jnp.concatenate([zeros, zeros, X], axis=-1),
        ],
        axis=-2,
    )  # [.., N, 3, 9]
    # Q_i = I - u u^T / ||u||^2 annihilates the ray direction.
    uu = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    Qi = jnp.eye(3, dtype=dtype) - uu[..., :, None] * uu[..., None, :]
    if mask is not None:
        w = mask.astype(dtype)[..., None, None]
        Qi = Qi * w
    # t elimination: t* = -(sum Q_i)^-1 sum Q_i A_i vec(R).
    Qsum = jnp.sum(Qi, axis=-3) + 1e-9 * jnp.eye(3, dtype=dtype)
    QA = jnp.einsum("...nij,...njk->...nik", Qi, A)
    QA_sum = jnp.sum(QA, axis=-3)  # [.., 3, 9]
    P_t = -jnp.linalg.solve(Qsum, QA_sum)  # [.., 3, 9]
    # Residual operator per point: Q_i (A_i + P_t) vec(R).
    B = A + P_t[..., None, :, :]
    QB = jnp.einsum("...nij,...njk->...nik", Qi, B)
    Omega = jnp.einsum("...nij,...nik->...jk", QB, QB)  # [.., 9, 9]
    _, vecs = jnp.linalg.eigh(Omega)
    r9 = vecs[..., :, 0]
    Rm = r9.reshape(r9.shape[:-1] + (3, 3))
    R = rotops.project_to_so3(Rm)
    # Handle the det sign ambiguity of the eigenvector.
    R_neg = rotops.project_to_so3(-Rm)

    def obj(Rc):
        t = jnp.einsum("...ij,...j->...i", P_t, Rc.reshape(Rc.shape[:-2] + (9,)))
        p_cam = jnp.einsum("...ij,...nj->...ni", Rc, X) + t[..., None, :]
        z = jnp.maximum(p_cam[..., 2], 1e-8)
        err = jnp.sum((p_cam[..., :2] / z[..., None] - features) ** 2, axis=-1)
        if mask is not None:
            err = err * mask.astype(dtype)
        return jnp.sum(err, axis=-1)

    pick_neg = obj(R_neg) < obj(R)
    R = jnp.where(pick_neg[..., None, None], R_neg, R)
    t = jnp.einsum("...ij,...j->...i", P_t, R.reshape(R.shape[:-2] + (9,)))
    position = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    R, position, ok = pnp_gauss_newton(
        features, world_points, R, position, mask=mask, iters=gn_iters
    )
    return R, position, ok


def dls_pnp(features, world_points, mask=None):
    """Parity shim for `theia::DlsPnp` (`dls_pnp.h:61`).

    The DLS method's Macaulay eigendecomposition is not expressible in XLA; this
    returns the SQPnP-class solution, which meets the same accuracy contract
    (the reference's dls_pnp_test asserts pose recovery tolerances only).
    Returns (R [.., 1, 3, 3], position [.., 1, 3], valid [.., 1]) — a
    single-solution candidate list, mirroring DlsPnp's multi-solution API.
    """
    R, c, ok = sqpnp(features, world_points, mask=mask)
    return R[..., None, :, :], c[..., None, :], ok[..., None]
