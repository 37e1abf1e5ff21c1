"""Guided epipolar matching: extra correspondences along epipolar lines.

Re-design of `/root/reference/src/theia/matching/guided_epipolar_matcher.h:53`.
The reference accelerates the epipolar-line search with image grids; on an
accelerator the full [N1, N2] point-to-line distance matrix is cheaper than building
grids: mask it by the epipolar band, add the descriptor-distance matrix,
and run the usual top-2 ratio + symmetry reductions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["guided_epipolar_match", "GuidedEpipolarMatcher"]


@partial(jax.jit, static_argnames=("use_lowes_ratio",))
def guided_epipolar_match(
    F,  # [3, 3] fundamental matrix (image-1 -> lines in image 2)
    points1,  # [N1, 2] pixels
    points2,  # [N2, 2]
    d1,  # [N1, D] descriptors
    d2,  # [N2, D]
    mask1,
    mask2,
    already_matched1,  # [N1] bool — features with existing matches
    already_matched2,  # [N2]
    max_epipolar_distance: jax.Array = 2.0,
    lowes_ratio: jax.Array = 0.8,
    use_lowes_ratio: bool = True,
):
    """Returns (match_idx [N1] into points2 or -1). Only unmatched features
    participate (guided_epipolar_matcher.h behavior)."""
    dtype = jnp.float32
    h1 = jnp.concatenate(
        [points1, jnp.ones_like(points1[..., :1])], axis=-1
    ).astype(dtype)
    h2 = jnp.concatenate(
        [points2, jnp.ones_like(points2[..., :1])], axis=-1
    ).astype(dtype)
    lines = h1 @ F.T.astype(dtype)  # [N1, 3] epipolar lines in image 2
    # Point-line distance |l . x| / ||l_[:2]||.
    num = jnp.abs(lines @ h2.T)  # [N1, N2]
    den = jnp.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    epi_dist = num / jnp.maximum(den, 1e-12)
    in_band = epi_dist <= max_epipolar_distance

    sq1 = jnp.sum(d1.astype(dtype) ** 2, axis=-1)
    sq2 = jnp.sum(d2.astype(dtype) ** 2, axis=-1)
    desc_dist = sq1[:, None] + sq2[None, :] - 2.0 * (d1.astype(dtype) @ d2.astype(dtype).T)

    valid = (
        in_band
        & mask1[:, None]
        & mask2[None, :]
        & ~already_matched1[:, None]
        & ~already_matched2[None, :]
    )
    desc_dist = jnp.where(valid, desc_dist, jnp.inf)

    neg_top2, idx_top2 = jax.lax.top_k(-desc_dist, 2)
    best = -neg_top2[:, 0]
    second = -neg_top2[:, 1]
    ok = jnp.isfinite(best)
    if use_lowes_ratio:
        ok &= best < (lowes_ratio**2) * jnp.where(
            jnp.isfinite(second), second, jnp.inf
        )
    return jnp.where(ok, idx_top2[:, 0], -1).astype(jnp.int32)


class GuidedEpipolarMatcher:
    """Host shim with the reference's GetMatches-style API."""

    def __init__(self, max_epipolar_distance: float = 2.0, lowes_ratio: float = 0.8):
        self.max_epipolar_distance = max_epipolar_distance
        self.lowes_ratio = lowes_ratio

    def get_matches(self, F, feats1, feats2, existing_matches):
        """feats1/feats2: KeypointsAndDescriptors; existing_matches: list of
        (i, j). Returns the augmented match list."""
        n1 = len(feats1.keypoints)
        n2 = len(feats2.keypoints)
        am1 = np.zeros(n1, bool)
        am2 = np.zeros(n2, bool)
        for i, j in existing_matches:
            am1[i] = True
            am2[j] = True
        idx = np.asarray(
            guided_epipolar_match(
                jnp.asarray(F),
                jnp.asarray(feats1.keypoints[:, :2]),
                jnp.asarray(feats2.keypoints[:, :2]),
                jnp.asarray(feats1.descriptors),
                jnp.asarray(feats2.descriptors),
                jnp.ones(n1, bool),
                jnp.ones(n2, bool),
                jnp.asarray(am1),
                jnp.asarray(am2),
                jnp.asarray(self.max_epipolar_distance, jnp.float32),
                jnp.asarray(self.lowes_ratio, jnp.float32),
            )
        )
        out = list(existing_matches)
        for i in np.flatnonzero(idx >= 0):
            out.append((int(i), int(idx[i])))
        return out
