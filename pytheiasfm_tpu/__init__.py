"""pytheiasfm_tpu — an accelerator-native Structure-from-Motion framework.

A brand-new JAX/XLA/Pallas re-design with the capabilities of pyTheiaSfM
(TheiaSfM): batched RANSAC over minimal pose solvers, eight camera models,
view-graph construction and filtering, global/incremental/hybrid
reconstruction, rotation averaging, position estimation, triangulation, and
Levenberg-Marquardt bundle adjustment with a Schur-complement solver —
everything as pure, vmappable functions over struct-of-arrays scene state,
sharded across device meshes with `jax.sharding`/`shard_map`.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometric vision is precision-critical: on the GPU a float32 matmul runs
# in TF32 (10-bit mantissa, about three decimal digits) unless asked for
# more, which is far too coarse for the minimal solvers, the Schur solves
# and the rotation/position averaging. Force true f32 multiplies for
# everything in this framework; kernels that can tolerate reduced precision
# (descriptor matching, bf16 operands with f32 accumulation) opt in locally.
_jax.config.update("jax_default_matmul_precision", "float32")

from . import ops, models  # noqa: F401,E402
