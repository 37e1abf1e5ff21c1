"""MVSNet-style view selection for multi-view stereo.

Re-design of `/root/reference/src/theia/mvs/view_selection_mvsnet.{h,cc}`
(`view_selection_mvsnet.h:50-53`): score each view pair (i, j) by summing,
over covisible scene points p, a piecewise-Gaussian of the angle subtended
at p by the two camera centers (Yao et al., "MVSNet", ECCV 2018):

    score(i, j) = sum_p exp(-(theta_ijp - theta0)^2 / (2 sigma^2)),
    sigma = sigma1 if theta <= theta0 else sigma2.

The reference loops view pairs and set-intersects per-view track lists; here
the whole computation is one batched device program: a [V, T] incidence
matrix (covisibility = one bf16-able matmul) and per-track ray-angle scores
accumulated as [T_chunk, V, V] batched outer products — matmul-shaped, chunked
over tracks to bound memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["view_selection_mvsnet", "pairwise_view_scores"]


@partial(jax.jit, static_argnames=())
def _score_chunk(centers, points, incidence, theta0, sigma1, sigma2):
    """centers [V, 3], points [Tc, 3], incidence [V, Tc] float.
    Returns ([V, V] score sum, [V, V] covisibility count) for the chunk."""
    rays = centers[None, :, :] - points[:, None, :]  # [Tc, V, 3]
    rays = rays / jnp.maximum(
        jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-12
    )
    # cos(theta) for every (track, i, j): batched matmul over the track axis.
    cos = jnp.einsum("tik,tjk->tij", rays, rays)
    theta = jnp.rad2deg(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))
    sigma = jnp.where(theta <= theta0, sigma1, sigma2)
    w = jnp.exp(-((theta - theta0) ** 2) / (2.0 * sigma * sigma))
    both = incidence.T[:, :, None] * incidence.T[:, None, :]  # [Tc, V, V]
    score = jnp.sum(w * both, axis=0)
    covis = jnp.sum(both, axis=0)
    return score, covis


def pairwise_view_scores(
    centers,
    points,
    incidence,
    theta0: float = 5.0,
    sigma1: float = 1.0,
    sigma2: float = 10.0,
    chunk: int = 512,
):
    """Dense [V, V] MVSNet pair scores + covisibility counts.

    centers [V, 3]; points [T, 3]; incidence [V, T] bool (view sees track).
    """
    V = centers.shape[0]
    T = points.shape[0]
    score = np.zeros((V, V), np.float64)
    covis = np.zeros((V, V), np.float64)
    c = jnp.asarray(centers, jnp.float32)
    t0 = jnp.asarray(theta0, jnp.float32)
    s1 = jnp.asarray(sigma1, jnp.float32)
    s2 = jnp.asarray(sigma2, jnp.float32)
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        pts = np.zeros((chunk, 3), np.float32)
        inc = np.zeros((V, chunk), np.float32)
        pts[: e - s] = points[s:e]
        inc[:, : e - s] = incidence[:, s:e]
        sc, cv = _score_chunk(
            c, jnp.asarray(pts), jnp.asarray(inc), t0, s1, s2
        )
        score += np.asarray(sc, np.float64)
        covis += np.asarray(cv, np.float64)
    return score, covis


def view_selection_mvsnet(
    recon,
    num_neighbors: int,
    theta0: float = 5.0,
    sigma1: float = 1.0,
    sigma2: float = 10.0,
    min_common_tracks: int = 10,
):
    """Parity: `theia::ViewSelectionMVSNet(reconstruction, num_neighbors,
    theta0, sigma1, sigma2)` (`view_selection_mvsnet.h:50`). Returns
    {view_id: [(score, neighbor_view_id), ...]} with the per-view list sorted
    by descending score and truncated to `num_neighbors`. Neighbor candidates
    need >= `min_common_tracks` covisible tracks (the reference's
    `ViewGraphFromReconstruction(recon, 10, ...)`)."""
    V = recon.num_views()
    est_views = np.flatnonzero(np.asarray(recon.view_estimated))
    est_tracks = np.flatnonzero(np.asarray(recon.track_estimated))
    if len(est_views) < 2 or len(est_tracks) == 0:
        return {int(v): [] for v in est_views}

    tmap = -np.ones(recon.num_tracks(), np.int64)
    tmap[est_tracks] = np.arange(len(est_tracks))
    vmap_ = -np.ones(V, np.int64)
    vmap_[est_views] = np.arange(len(est_views))

    obs_view = np.asarray(recon.obs_view)
    obs_track = np.asarray(recon.obs_track)
    ok = (vmap_[obs_view] >= 0) & (tmap[obs_track] >= 0)
    incidence = np.zeros((len(est_views), len(est_tracks)), bool)
    incidence[vmap_[obs_view[ok]], tmap[obs_track[ok]]] = True

    pts4 = np.asarray(recon.points)[est_tracks]
    w = np.where(pts4[:, 3] == 0, 1.0, pts4[:, 3])
    points = pts4[:, :3] / w[:, None]
    centers = np.asarray(recon.view_extrinsics)[est_views, :3]

    score, covis = pairwise_view_scores(
        centers, points, incidence, theta0, sigma1, sigma2
    )

    out = {}
    for i, v in enumerate(est_views):
        cand = np.flatnonzero(
            (covis[i] >= min_common_tracks) & (np.arange(len(est_views)) != i)
        )
        order = cand[np.argsort(-score[i, cand])][:num_neighbors]
        out[int(v)] = [(float(score[i, j]), int(est_views[j])) for j in order]
    return out
