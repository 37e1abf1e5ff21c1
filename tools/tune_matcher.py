"""Sweep the fused matcher kernel's Triton tiles on the GPU.

    python -u tools/tune_matcher.py

For each (tile_i, tile_j, num_warps, num_stages) the kernel is compiled,
checked against the XLA matcher once, and timed with the on-device loop of
`bench.matcher_seconds_per_call` at 4096x4096 descriptors, 128-D, 8 pairs.
The XLA matcher is timed first and last in the same process. A config the
compiler refuses is reported as FAIL and the sweep goes on.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = (
    (16, 128, 4, 2), (16, 256, 4, 2), (32, 64, 4, 2), (32, 128, 2, 2),
    (32, 128, 4, 1), (32, 128, 4, 2), (32, 128, 4, 3), (32, 128, 8, 2),
    (32, 256, 4, 2), (32, 256, 8, 2), (64, 64, 4, 2), (64, 128, 4, 2),
    (128, 128, 8, 2),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from pytheiasfm_tpu.matching.brute_force import match_descriptors_batch
    from pytheiasfm_tpu.matching.pallas_matcher import (
        match_descriptors_batch_pallas,
    )
    from pytheiasfm_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"tune_matcher: needs a GPU, found {jax.default_backend()!r}")
    pairs, n_desc, dim = 8, 4096, 128
    d1, d2, _ = bench.matcher_descriptors(n_desc, dim, pairs)
    d1, d2 = jnp.asarray(d1), jnp.asarray(d2)
    m = jnp.ones((pairs, n_desc), bool)
    ratio = jnp.asarray(0.8, jnp.float32)
    flop = pairs * 2.0 * n_desc * n_desc * dim
    print(f"devices: {jax.devices()}", flush=True)

    def xla(a, b):
        return match_descriptors_batch(a, b, m, m, ratio)

    def line(name, dt):
        print(
            f"{name}: {dt * 1e3:8.3f} ms  {pairs / dt:10.1f} pairs/s  "
            f"{flop / dt / 1e12:7.2f} TF/s of distance matmul",
            flush=True,
        )

    ix = np.asarray(xla(d1, d2)[0])
    line("xla (first)", bench.matcher_seconds_per_call(xla, d1, d2, args.reps))
    for ti, tj, w, s in CONFIGS:
        name = f"triton ti={ti:3d} tj={tj:3d} warps={w} stages={s}"

        def kern(a, b, ti=ti, tj=tj, w=w, s=s):
            return match_descriptors_batch_pallas(
                a, b, m, m, ratio, tile_i=ti, tile_j=tj, num_warps=w,
                num_stages=s,
            )

        try:
            agree = float(np.mean(np.asarray(kern(d1, d2)[0]) == ix))
            dt = bench.matcher_seconds_per_call(kern, d1, d2, args.reps)
        except Exception as e:  # compiler refusal: report, try the next
            print(f"{name}: FAIL {type(e).__name__}: {str(e)[:300]}", flush=True)
            continue
        line(f"{name} agree={agree:.5f}", dt)
    line("xla (last)", bench.matcher_seconds_per_call(xla, d1, d2, args.reps))


if __name__ == "__main__":
    main()
