"""Batched brute-force descriptor matching kernels.

Re-design of `/root/reference/src/theia/matching/
brute_force_feature_matcher.cc:48-107` (+ `distance.h:48` L2,
`feature_matcher_utils.h:45` IntersectMatches). The reference loops each
descriptor against every other with `std::partial_sort`; here the L2
distance matrix is ONE matmul (bf16 operands with f32 accumulation —
squared-L2 via the (a-b)^2 = |a|^2 + |b|^2 - 2ab expansion), Lowe's ratio is
a row top-2 reduction, and the symmetric cross-check compares row/column
argmins. A pair batch vmaps along a leading axis and shards across devices.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import counters

__all__ = [
    "choose_matcher",
    "match_descriptor_pair",
    "match_descriptors_batch",
    "match_descriptors_batch_auto",
]

_INF = jnp.inf


def _distance_matrix(d1, d2, use_bf16: bool):
    """Squared-L2 distances [N1, N2] as one matmul."""
    if use_bf16:
        prod = jax.lax.dot_general(
            d1.astype(jnp.bfloat16),
            d2.astype(jnp.bfloat16),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    else:
        prod = d1 @ d2.T
    sq1 = jnp.sum(d1.astype(jnp.float32) ** 2, axis=-1)
    sq2 = jnp.sum(d2.astype(jnp.float32) ** 2, axis=-1)
    return jnp.maximum(sq1[:, None] + sq2[None, :] - 2.0 * prod, 0.0)


@partial(
    jax.jit,
    static_argnames=("use_lowes_ratio", "keep_only_symmetric", "use_bf16"),
)
def match_descriptor_pair(
    d1,  # [N1, D]
    d2,  # [N2, D]
    mask1,  # [N1] valid rows
    mask2,  # [N2]
    lowes_ratio: jax.Array,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
    use_bf16: bool = True,
):
    """Returns (match_idx [N1] int32 — index into d2 or -1, distance [N1]).

    Mirrors the reference's forward Lowe's-ratio pass + symmetric
    intersection (`brute_force_feature_matcher.cc:48-107`).
    """
    dist = _distance_matrix(d1, d2, use_bf16)  # [N1, N2]
    dist = jnp.where(mask2[None, :], dist, _INF)
    dist = jnp.where(mask1[:, None], dist, _INF)

    def top2_min(m):
        """(best, second, argmin) per row; second = inf for 1-wide rows."""
        if m.shape[1] >= 2:
            neg, idx = jax.lax.top_k(-m, 2)
            return -neg[:, 0], -neg[:, 1], idx[:, 0]
        best = m[:, 0]
        return best, jnp.full_like(best, _INF), jnp.zeros(
            m.shape[0], jnp.int32
        )

    # Forward: top-2 smallest per row.
    best, second, fwd_idx = top2_min(dist)
    ok = mask1 & jnp.isfinite(best)
    if use_lowes_ratio:
        ok &= best < (lowes_ratio**2) * second

    if keep_only_symmetric:
        # Reverse: best per column; with the ratio test applied in reverse as
        # in the reference's reverse pass.
        best_r, second_r, rev_idx = top2_min(dist.T)  # rev_idx -> into d1
        ok_r = jnp.isfinite(best_r)
        if use_lowes_ratio:
            ok_r &= best_r < (lowes_ratio**2) * second_r
        sym = (rev_idx[fwd_idx] == jnp.arange(d1.shape[0])) & ok_r[fwd_idx]
        ok &= sym

    return jnp.where(ok, fwd_idx, -1).astype(jnp.int32), best


@partial(
    jax.jit,
    static_argnames=("use_lowes_ratio", "keep_only_symmetric", "use_bf16"),
)
def match_descriptors_batch(
    d1,  # [P, N, D]
    d2,  # [P, N, D]
    mask1,  # [P, N]
    mask2,  # [P, N]
    lowes_ratio: jax.Array,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
    use_bf16: bool = True,
):
    """All image pairs at once — the batched (shardable) entry point.
    Returns (match_idx [P, N], distance [P, N])."""

    def one(a, b, m1, m2):
        return match_descriptor_pair(
            a, b, m1, m2, lowes_ratio,
            use_lowes_ratio=use_lowes_ratio,
            keep_only_symmetric=keep_only_symmetric,
            use_bf16=use_bf16,
        )

    return jax.vmap(one)(d1, d2, mask1, mask2)


def choose_matcher(num_descriptors: int, backend: str | None = None) -> str:
    """Which matcher `match_descriptors_batch_auto` runs: "triton" (the
    fused kernel of `pallas_matcher.py`) on the GPU when the padded
    descriptor count is a power of two >= 128, "xla" otherwise."""
    backend = backend or jax.default_backend()
    N = num_descriptors
    if backend == "gpu" and N >= 128 and (N & (N - 1)) == 0:
        return "triton"
    return "xla"


def match_descriptors_batch_auto(
    d1,
    d2,
    mask1,
    mask2,
    lowes_ratio,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
):
    """Backend dispatch (`choose_matcher`): the fused Triton kernel on the
    GPU, the XLA matcher elsewhere. Each call bumps the counter
    `matcher_<choice>`. This is the entry the pipeline
    (`matching/matcher.py`) uses. A kernel failure raises."""
    choice = choose_matcher(d1.shape[1])
    counters.bump(f"matcher_{choice}")
    if choice == "triton":
        from .pallas_matcher import match_descriptors_batch_pallas

        return match_descriptors_batch_pallas(
            d1, d2, mask1, mask2, lowes_ratio,
            use_lowes_ratio=use_lowes_ratio,
            keep_only_symmetric=keep_only_symmetric,
        )
    return match_descriptors_batch(
        d1, d2, mask1, mask2, lowes_ratio,
        use_lowes_ratio=use_lowes_ratio,
        keep_only_symmetric=keep_only_symmetric,
    )
