"""Fused descriptor matcher: a Pallas kernel lowered through Triton.

The XLA matcher (`brute_force.py`) builds the whole [N, N] f32 distance
matrix per pair (64 MB at N=4096), then reads it again for the row top-2
and once more, transposed, for the column top-2. That is a few hundred MB
of device-memory traffic per pair for ~4.3 GFLOP of bf16 matmul, so the
path is bound by memory, not by the tensor cores. This kernel fuses the
distance matmul with both top-2 reductions so the [N, N] matrix never
leaves the SM.

Layout (grid over `(pair, row tile)`, no cross-program carry):
  1. each program loads its [TI, D] bf16 row tile once and loops over the
     [TJ, D] column tiles of the other image in-kernel;
  2. dist tile [TI, TJ] = |d1|^2 + |d2|^2 - 2 d1 d2^T  (bf16 operands,
     f32 accumulation — the XLA path's numerics);
  3. the row top-2 + argmin is merged into loop-carried registers and
     written once at the end;
  4. the column top-2 + argmin of this program's TI rows is written, per
     column, into a [P, N/TI, N] partial buffer; `merge_column_partials`
     (plain XLA) then reduces the partials over the row-tile axis.

Lowe's ratio + symmetric cross-check run on the [P, N] outputs in XLA
(identical semantics to `brute_force.match_descriptor_pair`).

Reference behavior being accelerated:
`brute_force_feature_matcher.cc:48-107` + `feature_matcher_utils.h:45`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = [
    "DEFAULT_TILES",
    "match_descriptors_batch_pallas",
    "merge_column_partials",
    "streaming_top2",
]

_BIG = 3.4e38  # sentinel "infinity" that survives arithmetic (python float
# so the kernel closes over a compile-time constant, not a traced array)

# (tile_i, tile_j, num_warps, num_stages): the fastest of the sweep in
# `tools/tune_matcher.py` on an H100 at 4096x4096x128, 8 pairs (PERF.md).
DEFAULT_TILES = (32, 128, 2, 2)


def _top2(dist, axis):
    """(min, second min, argmin) of `dist` along `axis`; ties go to the
    lowest index, as `lax.top_k` does in the XLA path."""
    arg = jax.lax.argmin(dist, axis, jnp.int32)
    m1 = jnp.min(dist, axis=axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, dist.shape, axis)
    hit = idx == jnp.expand_dims(arg, axis)
    m2 = jnp.min(jnp.where(hit, _BIG, dist), axis=axis)
    return m1, m2, arg


def _matcher_kernel(
    d1_ref, d2_ref, a1_ref, a2_ref,
    fb1_ref, fb2_ref, fa_ref, cb1_ref, cb2_ref, ca_ref,
    *, tile_j,
):
    TI = d1_ref.shape[0]
    N = d2_ref.shape[0]
    TJ = tile_j
    row0 = pl.program_id(1) * TI
    x = d1_ref[...]  # [TI, D] bf16, loaded once
    a1 = a1_ref[...]  # [TI] f32, +BIG on masked rows

    def body(j, carry):
        b1, b2, ba = carry
        cols = pl.ds(j * TJ, TJ)
        prod = pl.dot(
            x, d2_ref[cols, :], trans_b=True,
            precision=jax.lax.Precision.DEFAULT,
        )  # [TI, TJ] f32
        dist = jnp.maximum(a1[:, None] + a2_ref[cols][None, :] - 2.0 * prod, 0.0)
        # Masked rows/columns carry +BIG norms, so their distances stay
        # >= ~BIG (or inf) and lose every comparison.
        m1, m2, arg = _top2(dist, 1)
        nb1 = jnp.minimum(b1, m1)
        nb2 = jnp.minimum(jnp.maximum(b1, m1), jnp.minimum(b2, m2))
        na = jnp.where(m1 < b1, arg + j * TJ, ba)
        c1, c2, carg = _top2(dist, 0)
        cb1_ref[cols] = c1
        cb2_ref[cols] = c2
        ca_ref[cols] = carg + row0
        return nb1, nb2, na

    init = (
        jnp.full((TI,), _BIG, jnp.float32),
        jnp.full((TI,), _BIG, jnp.float32),
        jnp.zeros((TI,), jnp.int32),
    )
    b1, b2, ba = jax.lax.fori_loop(0, N // TJ, body, init)
    fb1_ref[...] = b1
    fb2_ref[...] = b2
    fa_ref[...] = ba


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile_i", "tile_j", "num_warps", "num_stages", "interpret",
    ),
)
def streaming_top2(
    d1, d2, a1, a2,
    tile_i: int = DEFAULT_TILES[0],
    tile_j: int = DEFAULT_TILES[1],
    num_warps: int = DEFAULT_TILES[2],
    num_stages: int = DEFAULT_TILES[3],
    interpret: bool = False,
):
    """Fused both-direction top-2 over squared-L2 distances.

    d1, d2 [P, N, D] bf16 (N and D powers of two, D >= 16); a1/a2 [P, N]
    = |d|^2 with +BIG on masked rows. Returns (fwd_best1, fwd_best2,
    fwd_arg [P, N] into d2, and the column partials cb1, cb2, ca
    [P, N/TI, N] for `merge_column_partials`).
    """
    P, N, D = d1.shape
    TI, TJ = min(tile_i, N), min(tile_j, N)
    nI = N // TI
    f32 = jnp.float32
    row = pl.BlockSpec((None, TI), lambda p, i: (p, i))
    part = pl.BlockSpec((None, None, N), lambda p, i: (p, i, 0))
    return pl.pallas_call(
        functools.partial(_matcher_kernel, tile_j=TJ),
        grid=(P, nI),
        in_specs=[
            pl.BlockSpec((None, TI, D), lambda p, i: (p, i, 0)),
            pl.BlockSpec((None, N, D), lambda p, i: (p, 0, 0)),
            row,
            pl.BlockSpec((None, N), lambda p, i: (p, 0)),
        ],
        out_specs=[row, row, row, part, part, part],
        out_shape=[
            jax.ShapeDtypeStruct((P, N), f32),
            jax.ShapeDtypeStruct((P, N), f32),
            jax.ShapeDtypeStruct((P, N), jnp.int32),
            jax.ShapeDtypeStruct((P, nI, N), f32),
            jax.ShapeDtypeStruct((P, nI, N), f32),
            jax.ShapeDtypeStruct((P, nI, N), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="fused_top2_matcher",
    )(d1, d2, a1, a2)


def merge_column_partials(cb1, cb2, ca):
    """Reduce per-row-tile column top-2 partials [P, K, N] over K.

    The global best is the smallest tile best (first tile on ties, hence
    the lowest row index); the global second best is the smaller of the
    other tiles' bests and the winning tile's own second best.
    Returns (best1, best2, arg) [P, N]."""
    k = jnp.argmin(cb1, axis=1)[:, None, :]
    best1 = jnp.take_along_axis(cb1, k, axis=1)[:, 0]
    arg = jnp.take_along_axis(ca, k, axis=1)[:, 0]
    own2 = jnp.take_along_axis(cb2, k, axis=1)[:, 0]
    tiles = jax.lax.broadcasted_iota(jnp.int32, cb1.shape, 1)
    other = jnp.min(jnp.where(tiles == k, _BIG, cb1), axis=1)
    return best1, jnp.minimum(own2, other), arg


def _pow2_at_least(n: int, lo: int) -> int:
    return max(lo, 1 << (n - 1).bit_length())


@functools.partial(
    jax.jit,
    static_argnames=(
        "use_lowes_ratio", "keep_only_symmetric", "tile_i", "tile_j",
        "num_warps", "num_stages", "interpret",
    ),
)
def match_descriptors_batch_pallas(
    d1,  # [P, N, D]
    d2,  # [P, N, D]
    mask1,  # [P, N]
    mask2,  # [P, N]
    lowes_ratio,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
    tile_i: int = DEFAULT_TILES[0],
    tile_j: int = DEFAULT_TILES[1],
    num_warps: int = DEFAULT_TILES[2],
    num_stages: int = DEFAULT_TILES[3],
    interpret: bool = False,
):
    """Drop-in equivalent of `brute_force.match_descriptors_batch` running
    the fused kernel (N must be a power of two). Returns
    (match_idx [P, N], distance [P, N]).

    Norms are computed in f32; descriptors reach the kernel in bf16 (the
    precision the XLA path's matmul uses either way), zero-padded along D
    to a power of two >= 16.
    """
    P, N, D = d1.shape
    Dp = _pow2_at_least(D, 16)
    if Dp != D:
        pad = [(0, 0), (0, 0), (0, Dp - D)]
        d1 = jnp.pad(d1, pad)
        d2 = jnp.pad(d2, pad)
    d1 = d1.astype(jnp.float32)
    d2 = d2.astype(jnp.float32)
    a1 = jnp.sum(d1 * d1, axis=-1) + jnp.where(mask1, 0.0, _BIG)
    a2 = jnp.sum(d2 * d2, axis=-1) + jnp.where(mask2, 0.0, _BIG)

    fb1, fb2, fa, cb1, cb2, ca = streaming_top2(
        d1.astype(jnp.bfloat16),
        d2.astype(jnp.bfloat16),
        a1,
        a2,
        tile_i=tile_i,
        tile_j=tile_j,
        num_warps=num_warps,
        num_stages=num_stages,
        interpret=interpret,
    )

    ok = mask1 & (fb1 < _BIG / 2)
    if use_lowes_ratio:
        ratio2 = jnp.asarray(lowes_ratio, jnp.float32) ** 2
        ok &= fb1 < ratio2 * fb2
    if keep_only_symmetric:
        rb1, rb2, ra = merge_column_partials(cb1, cb2, ca)
        ok_r = rb1 < _BIG / 2
        if use_lowes_ratio:
            ok_r &= rb1 < ratio2 * rb2
        rows = jnp.arange(N)[None, :]
        sym = (
            jnp.take_along_axis(ra, fa, axis=1) == rows
        ) & jnp.take_along_axis(ok_r, fa, axis=1)
        ok &= sym
    return jnp.where(ok, fa, -1).astype(jnp.int32), fb1
