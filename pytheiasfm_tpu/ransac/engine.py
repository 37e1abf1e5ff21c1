"""Batched RANSAC engine: the batched `SampleConsensusEstimator`.

Re-design of `/root/reference/src/theia/solvers/` (layer 3 of SURVEY.md):
`SampleConsensusEstimator<ModelEstimator>` (`sample_consensus_estimator.h:147`)
and its variants `Ransac` (`ransac.h:47`), `Prosac` (`prosac.h:53`), `LMed`
(`lmed.h:55`), `ExhaustiveRansac` (`exhaustive_ransac.h:47`).

The reference runs a sequential hypothesize-and-verify loop with adaptive
termination. Here the whole hypothesis budget is evaluated as ONE batched
tensor program: sample -> vmapped minimal solve -> residuals against all data
-> quality -> argmax, optionally followed by local-optimization (LO-RANSAC)
rounds on the best model's inliers. Adaptive termination becomes *reported*
statistics (the iteration count the sequential algorithm would have needed)
rather than control flow — same statistical behavior, compiler-friendly
shapes.

An estimator is a plain namespace of pure functions (mirrors
`theia::Estimator<Datum, Model>`, `solvers/estimator.h`):

    sample_size: int             minimal sample cardinality
    solve(data_subset) ->        (models pytree with leading axis K,
                                  valid [K])   — minimal solver, K branches
    residuals(model, data) ->    [N] squared errors
    refine(model, data, inlier_mask) -> (model, ok)   (optional, LO step)

`data` is a pytree of arrays with a shared leading axis N.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "RansacParameters",
    "RansacSummary",
    "RansacType",
    "Estimator",
    "ransac",
]


@dataclasses.dataclass(frozen=True)
class RansacParameters:
    """Parity: `theia::RansacParameters`
    (`solvers/sample_consensus_estimator.h:58`). Fields that control the
    sequential loop's wall clock (min_iterations) map onto the fixed
    hypothesis budget here."""

    error_thresh: float = 1e-4  # SQUARED error threshold (as in reference)
    failure_probability: float = 0.01
    max_iterations: int = 512  # hypothesis batch size
    min_iterations: int = 100
    use_mle: bool = False
    # Local optimization (LO-RANSAC), `sample_consensus_estimator.h:88-97`.
    use_lo: bool = False
    lo_iterations: int = 2
    # PROSAC: data assumed sorted by quality when sampler == "prosac".
    sampler: str = "random"  # "random" | "prosac" | "exhaustive"
    # T(d,d)/SPRT preemptive verification (`sample_consensus_estimator.h:99`,
    # `math/probability/sequential_probability_ratio.h:51-65`). The
    # sequential algorithm bails out of verifying a bad hypothesis early; the
    # batched mapping is two-stage verification: every hypothesis is scored
    # on a small data subset, the SPRT rejects hypotheses whose subset
    # likelihood ratio crosses Wald's threshold, and only the best surviving
    # fraction is verified against the full data — saving (1 - 1/keep) of
    # the residual FLOPs at large N with identical static shapes.
    use_Tdd_test: bool = False
    sprt_sigma: float = 0.05  # P(inlier | bad model)
    sprt_epsilon: float = 0.1  # P(inlier | good model) lower bound
    sprt_subset_size: int = 64
    sprt_keep_fraction: float = 0.25


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RansacSummary:
    """Parity: `theia::RansacSummary` (`sample_consensus_estimator.h:129`)."""

    inliers: jax.Array  # [N] bool mask
    num_inliers: jax.Array  # scalar int
    num_iterations: jax.Array  # adaptive-equivalent iteration count
    confidence: jax.Array  # inlier ratio
    best_cost: jax.Array
    num_lo_iterations: int = dataclasses.field(metadata=dict(static=True), default=0)


class RansacType:
    """Parity: `theia::RansacType` enum + factory
    (`sfm/create_and_initialize_ransac_variant.h:52`)."""

    RANSAC = "random"
    PROSAC = "prosac"
    LMED = "lmed"
    EXHAUSTIVE = "exhaustive"


@dataclasses.dataclass(frozen=True)
class Estimator:
    sample_size: int
    solve: Callable[[Any], tuple[Any, jax.Array]]
    residuals: Callable[[Any, Any], jax.Array]
    refine: Optional[Callable[[Any, Any, jax.Array], tuple[Any, jax.Array]]] = None
    # Degeneracy / model check hook (e.g. cheirality), optional.
    is_valid: Optional[Callable[[Any], jax.Array]] = None


def _draw_samples(key, num_data, params: RansacParameters, sample_size, mask=None):
    """[B, sample_size] index draws. Random: Gumbel-top-k without
    replacement (masked data excluded). PROSAC: hypothesis b draws from the
    top-n_b ranked prefix with a linear growth schedule (`prosac_sampler.h`
    behavior, batched)."""
    B = params.max_iterations
    g = jax.random.gumbel(key, (B, num_data))
    if mask is not None:
        g = jnp.where(mask, g, -jnp.inf)
    if params.sampler == "prosac":
        # Growth: hypothesis b samples from prefix of size n_b, ramping from
        # (sample_size + 1) to num_data over the first half of the budget.
        b_idx = jnp.arange(B)
        ramp = jnp.minimum(1.0, 2.0 * (b_idx + 1) / B)
        n_b = jnp.ceil(
            (1.0 - ramp) * (params.max_iterations and sample_size + 2) + ramp * num_data
        ).astype(jnp.int32)
        n_b = jnp.clip(n_b, sample_size + 1, num_data)
        positions = jnp.arange(num_data)
        allowed = positions[None, :] < n_b[:, None]
        g = jnp.where(allowed, g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


def _mle_cost(residuals, thresh):
    """MLESAC-style cost (parity: `mle_quality_measurement.h`): truncated
    quadratic (MSAC) — inliers contribute their error, outliers the
    threshold."""
    return jnp.sum(jnp.minimum(residuals, thresh), axis=-1)


def _inlier_cost(residuals, thresh):
    """Parity: `inlier_support.h` — maximize inlier count."""
    return -jnp.sum(residuals < thresh, axis=-1).astype(residuals.dtype)


def _lmed_cost(residuals, mask=None):
    """Parity: `lmed_quality_measurement.h` — median squared residual."""
    if mask is not None:
        residuals = jnp.where(mask, residuals, jnp.nan)
        return jnp.nanmedian(residuals, axis=-1)
    return jnp.median(residuals, axis=-1)


def ransac(
    key: jax.Array,
    data: Any,
    estimator: Estimator,
    params: RansacParameters,
    num_data: int | None = None,
    mask: jax.Array | None = None,
    quality: str = "inlier",  # "inlier" | "mle" | "lmed"
    error_thresh: jax.Array | None = None,
):
    """Run the full hypothesis budget as one batched program.

    Args:
      key: PRNG key.
      data: pytree of arrays, leading axis N (padded; use `mask`).
      estimator: the model estimator namespace.
      params: RANSAC parameters.
      num_data: true count when data is padded (defaults to N).
      mask: [N] validity of data rows.
      quality: cost function selector (LMed == reference's LMed variant).
      error_thresh: optional traced override of params.error_thresh (lets a
        vmapped caller use per-problem thresholds, e.g. per-pair
        resolution-scaled Sampson bounds).

    Returns:
      (best_model pytree, RansacSummary)
    """
    leaves = jax.tree_util.tree_leaves(data)
    N = leaves[0].shape[0]
    dtype = leaves[0].dtype
    if num_data is None:
        num_data = N
    thresh = jnp.asarray(
        params.error_thresh if error_thresh is None else error_thresh, dtype
    )

    sample_idx = _draw_samples(key, N, params, estimator.sample_size, mask)  # [B, S]

    def solve_one(idx):
        subset = jax.tree_util.tree_map(lambda a: a[idx], data)
        return estimator.solve(subset)

    models, valid = jax.vmap(solve_one)(sample_idx)  # pytree [B, K, ...], [B, K]

    def residuals_one(model):
        return estimator.residuals(model, data)

    # Flatten [B, K] -> [BK] for a single vmap.
    def _flatten(x):
        return x.reshape((-1,) + x.shape[2:])

    flat_models = jax.tree_util.tree_map(_flatten, models)
    flat_valid = _flatten(valid)

    if params.use_Tdd_test:
        # Stage 1: SPRT preemption on a random data subset.
        from ..math.sprt import (
            calculate_sprt_decision_threshold,
            sequential_probability_ratio_test,
        )

        BK = jax.tree_util.tree_leaves(flat_valid)[0].shape[0]
        n1 = min(N, max(params.sprt_subset_size, 4 * estimator.sample_size))
        key, k_sub = jax.random.split(key)
        g_sub = jax.random.gumbel(k_sub, (N,))
        if mask is not None:
            g_sub = jnp.where(mask, g_sub, -jnp.inf)
        _, sub_idx = jax.lax.top_k(g_sub, n1)
        sub_data = jax.tree_util.tree_map(lambda a: a[sub_idx], data)
        sub_mask = mask[sub_idx] if mask is not None else None

        sub_res = jax.vmap(lambda m: estimator.residuals(m, sub_data))(
            flat_models
        )  # [BK, n1]
        if sub_mask is not None:
            sub_res = jnp.where(sub_mask, sub_res, jnp.inf)
        A = calculate_sprt_decision_threshold(
            params.sprt_sigma, params.sprt_epsilon
        )
        passed, _obs = sequential_probability_ratio_test(
            sub_res < thresh, params.sprt_sigma, params.sprt_epsilon, A
        )
        if quality == "lmed":
            sub_cost = _lmed_cost(sub_res, sub_mask)
        else:
            # Rank stage 1 by the truncated-quadratic (MSAC) cost even for
            # inlier-count quality: on a small subset the inlier count
            # saturates and ties would evict the sharpest hypotheses.
            sub_cost = _mle_cost(sub_res, thresh)
        sub_cost = jnp.where(flat_valid & passed, sub_cost, jnp.inf)
        # Stage 2: full verification of the best surviving fraction only.
        M = max(1, int(BK * params.sprt_keep_fraction))
        _, keep_idx = jax.lax.top_k(-sub_cost, M)
        flat_models = jax.tree_util.tree_map(
            lambda a: a[keep_idx], flat_models
        )
        flat_valid = flat_valid[keep_idx] & jnp.isfinite(sub_cost[keep_idx])

    def _scored(res):
        if mask is not None:
            res = jnp.where(mask, res, jnp.inf)
        if quality == "mle":
            return _mle_cost(res, thresh)
        if quality == "lmed":
            return _lmed_cost(res, mask)
        return _inlier_cost(res, thresh)

    BK = flat_valid.shape[0]
    HB = 256  # hypothesis block for scoring
    if BK > HB and BK % HB == 0:
        # Score hypotheses in blocks: the full residual tensor [BK, N]
        # (x pairs under a vmapped caller) was the verification pipeline's
        # peak-memory term — [pairs, 2560, 8192] f32 temps OOMed a 16 GB
        # chip at >20 pairs per launch. Cost is a reduction over N, so
        # blocks of 256 hypotheses stream through a lax.map with 10x less
        # live memory and the same result.
        mblocks = jax.tree_util.tree_map(
            lambda x: x.reshape((BK // HB, HB) + x.shape[1:]), flat_models
        )
        cost = jax.lax.map(
            lambda mb: _scored(jax.vmap(residuals_one)(mb)), mblocks
        ).reshape(BK)
    else:
        cost = _scored(jax.vmap(residuals_one)(flat_models))
    if estimator.is_valid is not None:
        flat_valid = flat_valid & jax.vmap(estimator.is_valid)(flat_models)
    cost = jnp.where(flat_valid, cost, jnp.inf)

    best = jnp.argmin(cost)
    best_model = jax.tree_util.tree_map(lambda x: x[best], flat_models)
    best_cost = cost[best]

    # Local optimization: non-minimal refits on the current inlier set.
    num_lo = 0
    if params.use_lo and estimator.refine is not None:
        for _ in range(params.lo_iterations):
            res = estimator.residuals(best_model, data)
            inl = res < thresh
            if mask is not None:
                inl = inl & mask
            refined, ok = estimator.refine(best_model, data, inl)
            res_ref = estimator.residuals(refined, data)
            if mask is not None:
                res_ref = jnp.where(mask, res_ref, jnp.inf)
            if quality == "lmed":
                cost_ref = _lmed_cost(res_ref[None], mask)[0]
            elif quality == "mle":
                cost_ref = _mle_cost(res_ref[None], thresh)[0]
            else:
                cost_ref = _inlier_cost(res_ref[None], thresh)[0]
            better = ok & (cost_ref <= best_cost)
            best_model = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    jnp.reshape(better, (1,) * old.ndim), new, old
                ),
                refined,
                best_model,
            )
            best_cost = jnp.where(better, cost_ref, best_cost)
            num_lo += 1

    final_res = estimator.residuals(best_model, data)
    inliers = final_res < thresh
    if mask is not None:
        inliers = inliers & mask
    num_inliers = jnp.sum(inliers)
    inlier_ratio = num_inliers / jnp.maximum(num_data, 1)

    # The iteration count the sequential adaptive loop would have used
    # (parity: ComputeMaxIterations, sample_consensus_estimator.h).
    eps = 1e-12
    log_fail = jnp.log(jnp.asarray(params.failure_probability, dtype))
    p_good = jnp.clip(inlier_ratio, eps, 1.0) ** estimator.sample_size
    needed = log_fail / jnp.minimum(jnp.log1p(-jnp.clip(p_good, 0.0, 1 - eps)), -eps)
    num_iterations = jnp.clip(
        jnp.ceil(needed), params.min_iterations, params.max_iterations
    ).astype(jnp.int32)

    summary = RansacSummary(
        inliers=inliers,
        num_inliers=num_inliers,
        num_iterations=num_iterations,
        confidence=inlier_ratio,
        best_cost=best_cost,
        num_lo_iterations=num_lo,
    )
    return best_model, summary
