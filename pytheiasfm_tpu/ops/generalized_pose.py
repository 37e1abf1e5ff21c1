"""Generalized-camera and maximum-likelihood absolute pose solvers.

Batched equivalents of (`src/theia/sfm/pose/`):
  - ``Upnp``                  (upnp.h — universal PnP for central and
                               non-central cameras, minimal + least squares)
  - ``MLPnP``                 (mlpnp.h — ML PnP with bearing covariances)
  - ``GdlsSimilarityTransform`` (gdls_similarity_transform.h — generalized
                               DLS similarity transform from ray sets)

The reference uses Gröbner action matrices (UPnP: 10k LoC of generated
tables) and a bespoke null-space QR (MLPnP). Those expression trees are
hostile to XLA compilation; each solver here minimizes the *same* cost with
a **variable-projection Gauss-Newton over rotation only**, batched over a
fixed set of rotation seeds (the translation — and scale for gDLS — is
linear given the rotation and is eliminated exactly each step). This is
branch-free, fixed-shape, vmappable, and reaches the same optimum: UPnP's
cost IS the least-squares ray-alignment cost (`upnp.h:79`), and gDLS's is
the same with scale.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .rotation import (
    angle_axis_rotate_point,
    angle_axis_to_rotation_matrix,
    rotation_matrix_to_angle_axis,
)

__all__ = ["upnp", "mlpnp", "gdls_similarity_transform"]


# 16 rotation seeds: identity, 90/180-degree turns about each axis, and
# 8 "corner" orientations — covers SO(3) to within <62 degrees, inside the
# Gauss-Newton convergence basin for ray-alignment costs.
def _rotation_seeds() -> np.ndarray:
    seeds = [np.zeros(3)]
    for ax in np.eye(3):
        for ang in (np.pi / 2, np.pi, -np.pi / 2):
            seeds.append(ax * ang)
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            aa = np.array([sx, sy, 0.0])
            aa = aa / np.linalg.norm(aa) * (2 * np.pi / 3)
            seeds.append(aa)
    for sz in (-1.0, 1.0):
        aa = np.array([0.0, 1.0, sz])
        aa = aa / np.linalg.norm(aa) * (2 * np.pi / 3)
        seeds.append(aa)
    return np.stack(seeds)  # [16, 3]


_SEEDS = _rotation_seeds()


def _qmat(d):
    """Q_i = I - d_i d_i^T (projector orthogonal to ray direction)."""
    eye = jnp.eye(3, dtype=d.dtype)
    return eye - d[..., :, None] * d[..., None, :]


def _vp_gn(aa0, cost_terms, with_scale, iters):
    """Variable-projection GN over angle-axis; linear (t[, s]) eliminated.

    cost_terms = (Q [.., N, 3, 3], X [.., N, 3], o [.., N, 3]): minimize
    sum_i || Q_i (s R X_i + t - o_i) ||^2 (s fixed to 1 unless with_scale).
    Returns (aa, t, s, cost).
    """

    def solve_linear(aa):
        Q, X, o = cost_terms
        RX = angle_axis_rotate_point(aa[..., None, :], X)  # [.., N, 3]
        Qsum = jnp.sum(Q, axis=-3)  # [.., 3, 3]
        Qo = jnp.einsum("...nij,...nj->...i", Q, o)
        QRX = jnp.einsum("...nij,...nj->...i", Q, RX)
        if with_scale:
            # Unknowns y = [t(3), s]: normal equations of
            # sum ||Q_i (s RX_i + t - o_i)||^2.
            QRXn = jnp.einsum("...nij,...nj->...ni", Q, RX)
            A_ts = QRX  # sum_i Q_i RX_i
            A_ss = jnp.einsum("...ni,...ni->...", QRXn, QRXn)
            b_t = Qo
            b_s = jnp.einsum(
                "...ni,...ni->...", QRXn, jnp.einsum("...nij,...nj->...ni", Q, o)
            )
            A = jnp.concatenate(
                [
                    jnp.concatenate([Qsum, A_ts[..., :, None]], axis=-1),
                    jnp.concatenate([A_ts[..., None, :], A_ss[..., None, None]], axis=-1),
                ],
                axis=-2,
            )
            b = jnp.concatenate([b_t, b_s[..., None]], axis=-1)
            damp = 1e-12 * jnp.eye(4, dtype=aa.dtype)
            y = jnp.linalg.solve(A + damp, b[..., None])[..., 0]
            return y[..., :3], y[..., 3], RX
        damp = 1e-12 * jnp.eye(3, dtype=aa.dtype)
        t = jnp.linalg.solve(Qsum + damp, (Qo - QRX)[..., None])[..., 0]
        return t, jnp.ones_like(aa[..., 0]), RX

    def cost_of(aa):
        Q, X, o = cost_terms
        t, s, RX = solve_linear(aa)
        v = s[..., None, None] * RX + t[..., None, :] - o
        r = jnp.einsum("...nij,...nj->...ni", Q, v)
        return jnp.sum(r * r, axis=(-1, -2))

    def alternate(_, aa):
        # Generalized-ICP style alternation: project the current transform
        # onto the rays to get explicit 3D targets, then solve the closed-
        # form (scaled) Procrustes. Wide convergence basin — escapes the
        # scale-collapse local minima the pure GN can fall into.
        Q, X, o = cost_terms
        t, s, RX = solve_linear(aa)
        v = s[..., None, None] * RX + t[..., None, :] - o
        # Target point on ray i: o + d d^T v (d d^T = I - Q).
        ddT_v = v - jnp.einsum("...nij,...nj->...ni", Q, v)
        targets = o + ddT_v
        # Weighted Procrustes X -> targets with scale (Umeyama).
        Xm = jnp.mean(X, axis=-2, keepdims=True)
        Tm = jnp.mean(targets, axis=-2, keepdims=True)
        Xc = X - Xm
        Tc = targets - Tm
        H = jnp.einsum("...ni,...nj->...ij", Tc, Xc)
        U, sv, Vt = jnp.linalg.svd(H)
        det = jnp.linalg.det(U @ Vt)
        D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
        R_new = (U * D[..., None, :]) @ Vt
        # Rotation update only — (t, s) are re-solved exactly by
        # solve_linear, so scale/translation need not be formed here.
        aa_new = rotation_matrix_to_angle_axis(R_new)
        better = cost_of(aa_new) < cost_of(aa)
        return jnp.where(better[..., None], aa_new, aa)

    def gn(_, aa):
        # GN over the 3 rotation parameters; Jacobian by forward-mode.
        def r_flat(a):
            Q, X, o = cost_terms
            t, s, RX = solve_linear(a)
            v = s[..., None, None] * RX + t[..., None, :] - o
            r = jnp.einsum("...nij,...nj->...ni", Q, v)
            return r.reshape(*r.shape[:-2], -1)

        r = r_flat(aa)
        basis = jnp.eye(3, dtype=aa.dtype)
        J = jnp.stack(
            [jax.jvp(r_flat, (aa,), (jnp.broadcast_to(b, aa.shape),))[1] for b in basis],
            axis=-1,
        )
        JTJ = jnp.einsum("...ri,...rj->...ij", J, J)
        JTr = jnp.einsum("...ri,...r->...i", J, r)
        damp = 1e-10 * (1.0 + jnp.trace(JTJ, axis1=-2, axis2=-1))[..., None, None]
        delta = jnp.linalg.solve(
            JTJ + damp * jnp.eye(3, dtype=aa.dtype), -JTr[..., None]
        )[..., 0]
        aa_new = aa + delta
        better = cost_of(aa_new) < jnp.sum(r * r, axis=-1)
        return jnp.where(better[..., None], aa_new, aa)

    aa = jax.lax.fori_loop(0, iters, alternate, aa0)
    aa = jax.lax.fori_loop(0, iters, gn, aa)
    t, s, _ = solve_linear(aa)
    return aa, t, s, cost_of(aa)


def _multi_seed_solve(cost_terms, with_scale, iters, dtype, batch_shape):
    seeds = jnp.asarray(_SEEDS, dtype)  # [S, 3]
    S = seeds.shape[0]
    aa0 = jnp.broadcast_to(seeds, batch_shape + (S, 3))

    def run(aa_seed):
        return _vp_gn(aa_seed, cost_terms, with_scale, iters)

    aa, t, s, cost = jax.vmap(run, in_axes=-2, out_axes=(-2, -2, -1, -1))(aa0)
    best = jnp.argmin(cost, axis=-1)

    def take_vec(x):
        idx = best.reshape(best.shape + (1,) * (x.ndim - best.ndim))
        return jnp.take_along_axis(x, idx, axis=best.ndim).squeeze(best.ndim)

    return (
        take_vec(aa),
        take_vec(t),
        jnp.take_along_axis(s, best[..., None], axis=-1)[..., 0],
        jnp.take_along_axis(cost, best[..., None], axis=-1)[..., 0],
    )


def upnp(ray_origins, ray_directions, world_points, iters: int = 12):
    """Universal PnP: absolute pose of a (generalized) camera from rays.

    Parity: `Upnp` (`pose/upnp.h:79`): minimizes the ray-alignment
    least-squares cost sum_i ||(I - d_i d_i^T)(R X_i + t - o_i)||^2 over
    rotations and translation. Central cameras pass zero origins.

    Args:
      ray_origins [.., N, 3]; ray_directions [.., N, 3] (unit);
      world_points [.., N, 3].

    Returns:
      (rotation [.., 3, 3], translation [.., 3], cost [..]) — the global
      minimum over a 16-seed GN sweep (matching the reference's contract of
      returning the best minimizer).
    """
    d = ray_directions / jnp.linalg.norm(ray_directions, axis=-1, keepdims=True)
    Q = _qmat(d)
    aa, t, _, cost = _multi_seed_solve(
        (Q, world_points, ray_origins),
        with_scale=False,
        iters=iters,
        dtype=world_points.dtype,
        batch_shape=world_points.shape[:-2],
    )
    return angle_axis_to_rotation_matrix(aa), t, cost


def mlpnp(norm_feature_points, feature_covariances, world_points, iters: int = 10):
    """Maximum-likelihood PnP with per-feature bearing covariances.

    Parity: `MLPnP` (`pose/mlpnp.h:43`): bearings v_i from normalized image
    points; residual is the projection of the transformed point onto the
    tangent plane of v_i (null-space parametrization), whitened by the
    covariance projected into that plane. Returns the single refined pose.

    Args:
      norm_feature_points [.., N, 2]; feature_covariances [.., N, 3, 3]
      (bearing covariance; pass identity when unknown); world_points [.., N, 3].

    Returns:
      (rotation [.., 3, 3], translation [.., 3], cost [..]).
    """
    dtype = world_points.dtype
    ones = jnp.ones_like(norm_feature_points[..., :1])
    v = jnp.concatenate([norm_feature_points, ones], axis=-1)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    # Whitened tangent-plane projector: M_i = W_i (I - v v^T) with
    # W_i = (J^T Sigma J)^{-1/2} lifted back to 3x3 via the projector.
    P = _qmat(v)
    Sigma_t = jnp.einsum("...nij,...njk,...nkl->...nil", P, feature_covariances, P)
    # Inverse square root on the tangent plane: add v v^T to make it full
    # rank (unit eigenvalue along v, which the projector later kills).
    full = Sigma_t + v[..., :, None] * v[..., None, :]
    evals, evecs = jnp.linalg.eigh(full)
    inv_sqrt = jnp.einsum(
        "...nij,...nj,...nkj->...nik",
        evecs,
        1.0 / jnp.sqrt(jnp.maximum(evals, 1e-12)),
        evecs,
    )
    M = jnp.einsum("...nij,...njk->...nik", inv_sqrt, P)
    # Q_i = M_i^T M_i plays the same role as the UPnP projector in the
    # quadratic cost sum ||M_i (R X + t)||^2 — the depth direction is free.
    Q = jnp.einsum("...nji,...njk->...nik", M, M)
    o = jnp.zeros_like(world_points)
    aa, t, _, cost = _multi_seed_solve(
        (Q, world_points, o),
        with_scale=False,
        iters=iters,
        dtype=dtype,
        batch_shape=world_points.shape[:-2],
    )
    return angle_axis_to_rotation_matrix(aa), t, cost


def gdls_similarity_transform(
    ray_origins, ray_directions, world_points, iters: int = 12
):
    """Generalized DLS similarity transform from ray/point correspondences.

    Parity: `GdlsSimilarityTransform` (`pose/gdls_similarity_transform.h:61`):
    finds (s, R, t) minimizing sum_i ||(I - d d^T)(s R X_i + t - o_i)||^2 —
    the gDLS cost (Sweeney et al.).

    Args:
      ray_origins [.., N, 3]; ray_directions [.., N, 3]; world_points [.., N, 3].

    Returns:
      (rotation [.., 3, 3], translation [.., 3], scale [..], cost [..]).
    """
    d = ray_directions / jnp.linalg.norm(ray_directions, axis=-1, keepdims=True)
    Q = _qmat(d)
    aa, t, s, cost = _multi_seed_solve(
        (Q, world_points, ray_origins),
        with_scale=True,
        iters=iters,
        dtype=world_points.dtype,
        batch_shape=world_points.shape[:-2],
    )
    return angle_axis_to_rotation_matrix(aa), t, s, cost
