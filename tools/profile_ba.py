"""Micro-profile the BA kernel's components on the accelerator.

Times, in isolation, the pieces of one LM iteration on the Notre-Dame-scale
bench problem (553 cams / 50k tracks / 300k obs) to locate where an
iteration's time goes: Jacobian build, segment-sums, gathers, the PCG
matvec.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import build_problem  # noqa: E402


def timeit(fn, *args, reps=5, label=""):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{label:55s} {dt*1e3:10.3f} ms")
    return dt


def main():
    from pytheiasfm_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    prob = build_problem()
    V, T, O = prob["V"], prob["T"], prob["O"]
    print(f"V={V} T={T} O={O}")
    rng = np.random.default_rng(0)

    obs_view = prob["obs_view"]
    obs_track = prob["obs_track"]
    Jc = jnp.asarray(rng.normal(size=(O, 2, 6)).astype(np.float32))
    Jp = jnp.asarray(rng.normal(size=(O, 2, 3)).astype(np.float32))
    r = jnp.asarray(rng.normal(size=(O, 2)).astype(np.float32))
    xc = jnp.asarray(rng.normal(size=(V, 6)).astype(np.float32))
    Vinv = jnp.asarray(rng.normal(size=(T, 3, 3)).astype(np.float32))

    # 1. plain segment-sum [O,6] -> [V,6]
    f1 = jax.jit(lambda v: jax.ops.segment_sum(v, obs_view, num_segments=V))
    timeit(f1, jnp.einsum("ori,or->oi", Jc, r), label="segment_sum [O,6]->[V,6] (unsorted)")

    # sorted variant
    order = np.argsort(np.asarray(obs_view), kind="stable")
    sv = jnp.asarray(np.asarray(obs_view)[order])
    f1s = jax.jit(
        lambda v: jax.ops.segment_sum(v, sv, num_segments=V, indices_are_sorted=True)
    )
    timeit(f1s, jnp.einsum("ori,or->oi", Jc, r), label="segment_sum [O,6]->[V,6] (sorted hint)")

    # 2. segment-sum to tracks [O,3]->[T,3]
    f2 = jax.jit(lambda v: jax.ops.segment_sum(v, obs_track, num_segments=T))
    timeit(f2, jnp.einsum("ori,or->oi", Jp, r), label="segment_sum [O,3]->[T,3] (sorted ids)")

    # 3. gather xc[obs_view]
    f3 = jax.jit(lambda x: x[obs_view])
    timeit(f3, xc, label="gather [V,6] -> [O,6]")

    # 4. einsum Jc xc[obs_view]
    f4 = jax.jit(lambda x: jnp.einsum("ori,oi->or", Jc, x[obs_view]))
    timeit(f4, xc, label="einsum ori,oi->or with gather")

    # 5. one-hot matmul alternative for segment-sum (chunked)
    def onehot_segsum(v):
        # [O, 6] -> [V, 6] via (onehot[O,V])^T @ v in bf16-free f32 matmul
        oh = (obs_view[:, None] == jnp.arange(V)[None, :]).astype(jnp.float32)
        return oh.T @ v

    f5 = jax.jit(onehot_segsum)
    timeit(f5, jnp.einsum("ori,or->oi", Jc, r), label="one-hot matmul segsum [O,6]->[V,6]")

    # 6. full S_mv-ish composite
    def s_mv(x):
        y = jnp.einsum("ori,oi->or", Jc, x[obs_view])
        ac = jax.ops.segment_sum(jnp.einsum("ori,or->oi", Jc, y), obs_view, num_segments=V)
        t = jax.ops.segment_sum(jnp.einsum("ori,or->oi", Jp, y), obs_track, num_segments=T)
        z = jnp.einsum("tij,tj->ti", Vinv, t)
        w = jnp.einsum("ori,oi->or", Jp, z[obs_track])
        bc = jax.ops.segment_sum(jnp.einsum("ori,or->oi", Jc, w), obs_view, num_segments=V)
        return ac - bc

    f6 = jax.jit(s_mv)
    timeit(f6, xc, label="one S_mv (camera-only)")

    # 7. residual+jacobian build
    from pytheiasfm_tpu.ba.lm import _Problem, TrackParametrizationType
    from pytheiasfm_tpu.ba.losses import LossFunctionType

    pr = _Problem(
        (prob["obs_view"], prob["obs_track"], prob["obs_uv"], prob["obs_sqrt_info"], prob["obs_mask"]),
        prob["view_group"],
        prob["track_ref_view"],
        prob["track_bearing"],
        (1,),
        prob["group_model_idx"],
        TrackParametrizationType.XYZW,
        LossFunctionType.TRIVIAL,
        2.0,
        jnp.float32,
    )
    f7 = jax.jit(lambda e, q, p: pr.residuals(e, q, p, with_jac=True))
    timeit(
        f7, prob["extrinsics"], prob["intrinsics"], prob["points"],
        label="residuals + jacobians (with_jac)",
    )
    f8 = jax.jit(lambda e, q, p: pr.residuals(e, q, p, with_jac=False))
    timeit(
        f8, prob["extrinsics"], prob["intrinsics"], prob["points"],
        label="residuals only (cost eval)",
    )

    # 8. block einsum products [O,6,3] style
    f9 = jax.jit(lambda: jnp.einsum("ori,orj->oij", Jc, Jp))
    timeit(f9, label="einsum Wc=[O,6,3]")

    # 9. Vinv
    Vt = jnp.asarray(rng.normal(size=(T, 3, 3)).astype(np.float32))
    Vt = jnp.einsum("tij,tkj->tik", Vt, Vt) + 3 * jnp.eye(3)
    f10 = jax.jit(jnp.linalg.inv)
    timeit(f10, Vt, label="batched 3x3 inv [T,3,3]")

    # 10. dense cholesky at camera-system scale
    n = 6 * V
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    A = A @ A.T + n * jnp.eye(n)
    f11 = jax.jit(jnp.linalg.cholesky)
    timeit(f11, A, label=f"dense cholesky [{n},{n}]")
    b = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    f12 = jax.jit(lambda A, b: jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(A), True), b))
    timeit(f12, A, b, label=f"cholesky+solve [{n},{n}]")

    # 11. segment-sum of 6x6 blocks [O,6,6]->[V,6,6]
    JcJc = jnp.einsum("ori,orj->oij", Jc, Jc)
    f13 = jax.jit(lambda v: jax.ops.segment_sum(v, obs_view, num_segments=V))
    timeit(f13, JcJc, label="segment_sum [O,6,6]->[V,6,6]")


if __name__ == "__main__":
    main()
