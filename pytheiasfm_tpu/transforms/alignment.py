"""Point-cloud and reconstruction alignment.

Re-design of `/root/reference/src/theia/sfm/transformation/`:
`align_point_clouds.h:52` (closed-form weighted Umeyama Sim(3)),
`align_reconstructions.h:47-59` (align by common view positions, plus a
RANSAC-robust variant), `transform_reconstruction.h` (apply a similarity to
every camera and point). The Umeyama solve is a single batched SVD — on the device
the [3,3] covariance accumulation is one matmul over the point axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rotation as rotops

__all__ = [
    "align_point_clouds_umeyama",
    "sim3_transform_points",
    "transform_reconstruction",
    "align_reconstructions",
    "align_reconstructions_robust",
]


@jax.jit
def align_point_clouds_umeyama(left, right, weights=None):
    """Weighted Umeyama: find (scale s, rotation R, translation t) minimizing
    sum_i w_i || right_i - (s R left_i + t) ||^2.

    Parity: `theia::AlignPointCloudsUmeyamaWithWeights`
    (`align_point_clouds.h:52+`). left/right [N, 3]; returns (R [3,3],
    t [3], s scalar).
    """
    dtype = left.dtype
    N = left.shape[0]
    w = jnp.ones((N,), dtype) if weights is None else weights.astype(dtype)
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mu_l = jnp.einsum("n,ni->i", w, left) / wsum
    mu_r = jnp.einsum("n,ni->i", w, right) / wsum
    dl = left - mu_l
    dr = right - mu_r
    sigma = jnp.einsum("n,ni,nj->ij", w, dr, dl) / wsum  # cross-covariance
    var_l = jnp.einsum("n,ni,ni->", w, dl, dl) / wsum

    U, D, Vt = jnp.linalg.svd(sigma)
    S = jnp.ones((3,), dtype)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = S.at[2].set(jnp.where(det < 0, -1.0, 1.0))
    R = U @ jnp.diag(S) @ Vt
    s = jnp.sum(D * S) / jnp.maximum(var_l, 1e-12)
    t = mu_r - s * (R @ mu_l)
    return R, t, s


def sim3_transform_points(points, R, t, s):
    """x' = s R x + t (batched)."""
    return s * jnp.einsum("ij,nj->ni", R, points) + t


def transform_reconstruction(recon, R, t, s):
    """Apply a similarity to every camera and point in place.

    Parity: `theia::TransformReconstruction`
    (`transformation/transform_reconstruction.h`): camera position
    c' = s R c + t, camera orientation R_c' = R_c R^T, point
    X' = s R X + t.
    """
    Rnp = np.asarray(R)
    tnp = np.asarray(t)
    snp = float(s)
    V = recon.num_views()
    # Batched host numpy (a device round trip per view is ~ms each).
    from ..ops.rotation_np import (
        angle_axis_to_rotation_matrix_np,
        rotation_matrix_to_angle_axis_np,
    )

    centers = recon.view_extrinsics[:V, :3]
    recon.view_extrinsics[:V, :3] = snp * (centers @ Rnp.T) + tnp
    R_all = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[:V, 3:])
    recon.view_extrinsics[:V, 3:] = rotation_matrix_to_angle_axis_np(
        np.einsum("vij,kj->vik", R_all, Rnp)
    )
    w = recon.points[:, 3:4]
    pts3 = recon.points[:, :3] / np.where(np.abs(w) < 1e-12, 1.0, w)
    recon.points[:, :3] = (snp * (pts3 @ Rnp.T) + tnp) * np.where(
        np.abs(w) < 1e-12, 1.0, w
    )


def _common_view_positions(recon1, recon2):
    names = [
        n
        for n in recon1.view_name_to_id
        if n in recon2.view_name_to_id
        and recon1.view_estimated[recon1.view_name_to_id[n]]
        and recon2.view_estimated[recon2.view_name_to_id[n]]
    ]
    p1 = np.stack(
        [recon1.view_extrinsics[recon1.view_name_to_id[n], :3] for n in names]
    ) if names else np.zeros((0, 3))
    p2 = np.stack(
        [recon2.view_extrinsics[recon2.view_name_to_id[n], :3] for n in names]
    ) if names else np.zeros((0, 3))
    return p1, p2


def align_reconstructions(recon_to_align, reference_recon):
    """Align `recon_to_align` onto `reference_recon` by common (estimated)
    view positions. Parity: `theia::AlignReconstructions`
    (`align_reconstructions.h:47`). Returns (R, t, s)."""
    p_src, p_ref = _common_view_positions(recon_to_align, reference_recon)
    if len(p_src) < 3:
        raise ValueError("need >= 3 common estimated views to align")
    R, t, s = align_point_clouds_umeyama(jnp.asarray(p_src), jnp.asarray(p_ref))
    transform_reconstruction(recon_to_align, R, t, s)
    return np.asarray(R), np.asarray(t), float(s)


def align_reconstructions_robust(
    recon_to_align,
    reference_recon,
    robust_error_threshold: float = 2.0,
    num_iterations: int = 100,
    rng=None,
):
    """RANSAC variant over view-position triples.
    Parity: `theia::AlignReconstructionsRobust`
    (`align_reconstructions.h:55`). Returns (R, t, s)."""
    rng = rng or np.random.default_rng(0)
    p_src, p_ref = _common_view_positions(recon_to_align, reference_recon)
    n = len(p_src)
    if n < 3:
        raise ValueError("need >= 3 common estimated views to align")
    src = jnp.asarray(p_src)
    ref = jnp.asarray(p_ref)

    best = None
    best_inliers = -1
    for _ in range(num_iterations):
        idx = rng.choice(n, size=3, replace=False)
        R, t, s = align_point_clouds_umeyama(src[idx], ref[idx])
        resid = np.linalg.norm(
            np.asarray(sim3_transform_points(src, R, t, s)) - p_ref, axis=-1
        )
        inl = int((resid < robust_error_threshold).sum())
        if inl > best_inliers:
            best_inliers = inl
            best = resid < robust_error_threshold
    R, t, s = align_point_clouds_umeyama(
        src, ref, weights=jnp.asarray(best.astype(np.float64))
    )
    transform_reconstruction(recon_to_align, R, t, s)
    return np.asarray(R), np.asarray(t), float(s)
