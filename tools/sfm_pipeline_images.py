"""Images -> features -> matches -> reconstruction CLI.

The analogue of the reference's canonical pipeline script
(`pytests/sfm_pipeline.py`), self-contained: feature extraction is the
package's own pure-JAX upright SIFT; matching, verification, and SfM run
as batched device programs.

Usage:
  python tools/sfm_pipeline_images.py IMG [IMG ...]
      [--estimator global|incremental|hybrid] [--max-dim 1024]
      [--max-features 2048] [--ratio 0.85] [--min-inliers 15]
      [--ply out.ply] [--cpu]
Prints one JSON line of stats.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="+")
    ap.add_argument("--estimator", default="global",
                    choices=["global", "incremental", "hybrid"])
    ap.add_argument("--max-dim", type=int, default=1024)
    ap.add_argument("--max-features", type=int, default=2048)
    ap.add_argument("--ratio", type=float, default=0.85)
    ap.add_argument("--min-inliers", type=int, default=15)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from pytheiasfm_tpu.pipelines.images import run_images_pipeline
    from pytheiasfm_tpu.utils.cache import enable_persistent_cache
    from pytheiasfm_tpu.utils.log import set_verbosity

    enable_persistent_cache()
    if args.verbose:
        set_verbosity(1)

    models, stats = run_images_pipeline(
        args.images,
        max_dim=args.max_dim,
        max_features=args.max_features,
        estimator_type=args.estimator,
        lowes_ratio=args.ratio,
        min_num_inlier_matches=args.min_inliers,
    )
    if args.ply and models:
        from pytheiasfm_tpu.io.ply import write_ply_file

        write_ply_file(args.ply, models[0])
        stats["ply"] = args.ply
    stats["metric"] = f"images_pipeline_{args.estimator}"
    stats["value"] = stats["views_estimated"]
    stats["unit"] = "views reconstructed from raw images"
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
