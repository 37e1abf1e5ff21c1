"""Iterative-Schur LM bundle adjustment in dual slot layouts — the
large-problem path (the reference's ITERATIVE_SCHUR + SCHUR_JACOBI
configuration, `reconstruction_estimator_options.h:291-300`, selected above
`min_cameras_for_iterative_solver` = 1000 cameras).

The round-2/3 implicit kernel (`ba/lm.py`) expressed every reduction as
`segment_sum` over the flat observation table, which lowers to scatters
(atomics on a GPU, with a sum order that varies from run to run). This
kernel
applies the dense-Schur playbook (`ba/dense_schur.py`) to the iterative
case: NO scatter anywhere. Observations live in TWO layouts at once:

  track-slot   [T, L]   (L = max track length) — point-side reductions
               (V_t = Jp^T Jp, bp, back-substitution) are dense sums over
               the slot axis; also where residuals/Jacobians are built.
  view-rowchunk [R, C]  — each row holds up to C observations of ONE view
               (views with more observations span several rows), with
               `rc_src` indexing back into the flat [T*L] track layout.
               Camera-side adjoints (Jc^T y) are a GATHER into this layout,
               a dense sum over C, and a one-hot [V, R] matmul — data
               movement as matmul work, never scatter.

Per PCG iteration the Schur matvec S x = Jc^T (y - Jp V^-1 Jp^T y) + mu D x
is: one gather of x to slots, four dense einsums, one gather of the
residual vector into rowchunks, one dense adjoint einsum, one one-hot
matmul. Everything is HBM-bandwidth bound at ~(|Jc| + |Jp|) bytes per
matvec — the speed-of-light for an implicit Schur operator.

Unlike the dense kernel this path also supports FREE INTRINSICS
(`OptimizeIntrinsicsType` subsets — the reference's default optimizes
focal length + radial distortion, `reconstruction_estimator_options.h:281-284`):
shared-group intrinsics join the PCG state as a [G, P] block with its own
Schur-Jacobi preconditioner, exactly Ceres's treatment of the shared
intrinsics parameter block (`bundle_adjuster.cc:315-341`).

Supports XYZW and XYZW_MANIFOLD track parametrizations, per-DOF camera
freezing, view priors, and bf16 matvec operands under
`use_mixed_precision_solves` (`bundle_adjustment.h:111`). INVERSE_DEPTH
routes to `lm.py` (its reference-view coupling breaks the track-local
point elimination).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .lm import (
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    OptimizeIntrinsicsType,
    TrackParametrizationType,
    _prior_blocks,
    _residual_at_point,
    _point_tangent_basis4,
    inv_small_spd,
    run_launch_chunked,
)
from .losses import loss_rho, loss_weight

__all__ = ["bundle_adjust_iterative"]

# Slot count above which the block build runs as a lax.scan over track
# chunks, to bound the memory of the single-shot build's intermediates
# (module-level so tests can lower it to exercise the scan path). The
# value was sized on another accelerator and is untuned on the H100.
_SCAN_SLOT_THRESHOLD = 1_100_000


def _onehot(ids, n, dtype):
    """[n, len(ids)] one-hot reduction basis (rows = targets)."""
    return (ids[None, :] == jnp.arange(n, dtype=ids.dtype)[:, None]).astype(
        dtype
    )


# Batched small matrix products as explicit broadcast-FMA sums: unrolling
# the tiny contraction of a [BIG, tiny, tiny] einsum into broadcasts
# compiles to fused elementwise ops instead of a batched matmul with
# tiny operands. Chosen on another accelerator; untuned on the H100.


def _atb(a, b):
    """einsum('...ri,...rx->...ix') with tiny r."""
    r = a.shape[-2]
    return sum(a[..., k, :, None] * b[..., k, None, :] for k in range(r))


def _ab(a, b):
    """einsum('...ij,...jk->...ik') with tiny j."""
    j = a.shape[-1]
    return sum(a[..., :, k, None] * b[..., None, k, :] for k in range(j))


def _abt(a, b):
    """einsum('...ik,...jk->...ij') with tiny k."""
    k = a.shape[-1]
    return sum(a[..., :, None, c] * b[..., None, :, c] for c in range(k))


def _av(a, x):
    """einsum('...ij,...j->...i') with tiny j."""
    return jnp.sum(a * x[..., None, :], axis=-1)


@partial(
    jax.jit,
    static_argnames=(
        "present_models",
        "num_views",
        "num_tracks",
        "max_track_len",
        "num_rows",
        "row_chunk",
        "num_groups",
        "options",
    ),
)
def _bundle_adjust_iterative_impl(
    extrinsics,  # [V, 6]
    intrinsics,  # [G, P]
    points,  # [T, 3] | [T, 4] (manifold)
    view_group,  # [V] int32
    group_model_idx,  # [G] int32
    track_views,  # [T, L] int32
    obs_uv,  # [T, L, 2]
    obs_sqrt_info,  # [T, L, 2]
    obs_mask,  # [T, L] bool
    row_view,  # [R] int32 — view of each rowchunk
    rc_src,  # [R, C] int32 — flat [T*L] index of each row slot
    rc_mask,  # [R, C] bool
    camera_free,  # [V] or [V, 6] bool
    point_free,  # [T] bool
    intrinsics_free,  # [G, P] bool
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_rows: int,
    row_chunk: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,
    mu0=None,
):
    """ONE LAUNCH of rowchunk iterative-Schur LM. Returns
    (extrinsics, intrinsics, points, summary)."""
    dtype = extrinsics.dtype
    V, T, L, G = num_views, num_tracks, max_track_len, num_groups
    R, C = num_rows, row_chunk
    O = T * L
    P = intrinsics.shape[1]
    mixed = options.use_mixed_precision_solves
    mm = jnp.bfloat16 if mixed else dtype

    tp = options.track_parametrization_type
    if tp == TrackParametrizationType.INVERSE_DEPTH:
        raise ValueError(
            "bundle_adjust_iterative does not support INVERSE_DEPTH; "
            "use lm.bundle_adjust"
        )
    manifold = tp == TrackParametrizationType.XYZW_MANIFOLD
    K = 3
    has_intr = options.intrinsics_to_optimize != OptimizeIntrinsicsType.NONE
    # Single shared intrinsics group (the common case): eliminate the
    # intrinsics block exactly before PCG. Multiple groups: keep the
    # intrinsics in the PCG state.
    exact_elim = has_intr and G == 1
    joint_intr = has_intr and G > 1
    # Static free-column compression of the intrinsics block: with ONE
    # shared camera model (the exact-elimination case) the optimized
    # subset is known at trace time from the options, so the Jacobian,
    # the pack columns, and the elimination all run on the Fi free
    # columns instead of all P — PINHOLE's reference-default
    # focal+radial is 3 of 10, shrinking Ji from 20 to 6 pack floats per
    # slot and Ug from 100 to 9. `intrinsics_free` may further freeze a
    # SUBSET of these columns (it is applied per-column below); columns
    # outside the options-derived set are frozen by construction, which
    # is the contract the public entry already follows.
    if exact_elim:
        from ..models.intrinsics import intrinsics_subset_mask

        _mask = intrinsics_subset_mask(
            int(present_models[0]), options.intrinsics_to_optimize
        )
        free_cols = tuple(
            i for i in range(P) if i < len(_mask) and bool(_mask[i])
        )
        if not free_cols:
            free_cols = tuple(range(P))
    else:
        free_cols = tuple(range(P))
    Fi = len(free_cols)
    cols = jnp.asarray(free_cols, jnp.int32)
    # Two-level preconditioner (large problems): block-Jacobi kills local
    # error but leaves the long-wavelength camera modes of weakly-connected
    # graphs nearly untouched — measured on the 2152-camera ring, PCG ran
    # its full budget every LM iteration and TRUNCATING it collapsed
    # accuracy (7.8 mm -> 139 mm). The coarse level aggregates runs of
    # `group` consecutive views (container order ~ capture order, so
    # aggregation preserves locality), materializes the EXACT coarse
    # Schur complement R^T S~ R with the dense-Schur placement product at
    # Vc <= ~160 resolution (tiny), Cholesky-factors it once per LM
    # iteration, and adds the coarse solve to the Jacobi preconditioner
    # (additive two-level Schwarz). Gated on problem size so small
    # problems keep exact trajectory parity with the flat kernel.
    #
    # The aggregate size SCALES with V to pin the coarse resolution: the
    # coarse placement/product costs O(T Vc) + O(T Vc^2) FLOPs per LM
    # iteration — at a fixed group of 16, Trafalgar scale (5288 views,
    # Vc=331) spent ~5.9 TFLOP/iter on the preconditioner build alone,
    # more than the whole rest of the iteration.
    # At scan-path scales the coarse operator is additionally built from a
    # strided 1/4 TRACK SUBSAMPLE (scaled x4): it aggregates hundreds of
    # thousands of observations into a [6Vc, 6Vc] system, so a quarter of
    # the tracks estimates the same aggregate and PCG itself stays exact.
    # The sampled build stays in F32: a bf16 variant was measured to
    # DOUBLE the LM iteration count from far-from-optimum pipeline states
    # and to collapse Trafalgar-scale accuracy (9.7 mm -> 143 mm).
    use_coarse = V >= 1024
    _COARSE_TARGET = 160
    group = 16 * max(1, -(-V // (16 * _COARSE_TARGET)))
    Vc = -(-V // group)
    coarse_stride = 4 if T * L > _SCAN_SLOT_THRESHOLD else 1

    if camera_free.ndim == 1:
        camera_free = camera_free[..., None]
    cam_free = (camera_free & options.optimize_cameras).astype(dtype)
    cam_free = jnp.broadcast_to(cam_free, (V, 6))
    pt_free = (point_free & options.optimize_points)[..., None].astype(dtype)
    intr_free = intrinsics_free.astype(dtype)

    # Loop-invariant bases, index maps, and pre-gathered per-slot rows.
    # Anything here is computed ONCE before the LM while_loop — XLA does
    # not hoist gathers out of while bodies.
    row_oh = _onehot(row_view, V, dtype)  # [V, R]
    group_oh = _onehot(view_group, G, dtype)  # [G, V]
    group_slot = view_group[track_views]  # [T, L]
    model_idx_slot = group_model_idx[group_slot]  # [T, L]
    if use_coarse:
        coarse_slot = track_views // group  # [T, L]
        coarse_of_view = jnp.arange(V, dtype=jnp.int32) // group
    rc_m = rc_mask.astype(dtype)
    maskf = obs_mask.astype(dtype)  # [T, L]
    cam_free_slot = cam_free[track_views][:, :, None, :]  # [T,L,1,6]
    pt_free_slot = pt_free[:, None, None, :]  # [T,1,1,1]
    intr_freeF = intr_free[:, cols] if has_intr else None  # [G, Fi]
    if has_intr:
        if G == 1:
            intr_free_slot = intr_freeF[0][None, None, None, :]
        else:
            intr_free_slot = intr_freeF[group_slot][:, :, None, :]
        intr_slot_const = None
    else:
        intr_free_slot = None
        intr_slot_const = (
            jnp.broadcast_to(intrinsics[0], (T, L, P))
            if G == 1
            else intrinsics[group_slot]
        )

    loss = options.loss_function_type
    width = options.robust_loss_width

    def slot_residuals(ext, intr_c, pts, with_jac):
        """Slot-layout-native residual/Jacobian builder.

        Unlike the flat builder (`lm._Problem.residuals`) this never
        gathers per observation on the track side: the point (and the
        manifold tangent basis) enter at the TRACK level of the nested
        vmap and broadcast over the L slots — at Piccadilly scale the
        avoided 600k-row gathers are ~8-13 ms per evaluation.
        Returns (r [T,L,2], Jc, Ji, Jp, s) with robust weights applied.
        """
        ext_slot = ext[track_views]  # [T,L,6]
        if has_intr:
            intr_slot = (
                jnp.broadcast_to(intr_c[0], (T, L, P))
                if G == 1
                else intr_c[group_slot]
            )
        else:
            intr_slot = intr_slot_const
        pm = present_models

        if manifold:
            basis = jax.vmap(_point_tangent_basis4)(pts)  # [T,4,3]
            zeros3 = jnp.zeros((3,), dtype)

            def f(e6, q, d3, x4, B, uv, si, idx):
                x4n = x4 + B @ d3
                w = x4n[3]
                w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
                return _residual_at_point(
                    e6, q, x4n[:3] / w, uv, si, pm, idx
                )

            def one(e6, q, x4, B, uv, si, idx):
                args = (e6, q, zeros3, x4, B, uv, si, idx)
                r = f(*args)
                if not with_jac:
                    return r, 0, 0, 0
                Jc = jax.jacfwd(f, 0)(*args)
                if has_intr:
                    # Differentiate only the statically-free columns.
                    Ji = jax.jacfwd(
                        lambda qf: f(
                            e6, q.at[cols].set(qf), zeros3, x4, B, uv,
                            si, idx,
                        )
                    )(q[cols])
                else:
                    Ji = 0
                Jp = jax.jacfwd(f, 2)(*args)
                return r, Jc, Ji, Jp

            over_l = jax.vmap(one, in_axes=(0, 0, None, None, 0, 0, 0))
            r, Jc, Ji, Jp = jax.vmap(over_l)(
                ext_slot, intr_slot, pts, basis,
                obs_uv, obs_sqrt_info, model_idx_slot,
            )
        else:
            def f(e6, q, p3, uv, si, idx):
                return _residual_at_point(e6, q, p3, uv, si, pm, idx)

            def one(e6, q, p3, uv, si, idx):
                args = (e6, q, p3, uv, si, idx)
                r = f(*args)
                if not with_jac:
                    return r, 0, 0, 0
                Jc = jax.jacfwd(f, 0)(*args)
                if has_intr:
                    Ji = jax.jacfwd(
                        lambda qf: f(e6, q.at[cols].set(qf), p3, uv, si, idx)
                    )(q[cols])
                else:
                    Ji = 0
                Jp = jax.jacfwd(f, 2)(*args)
                return r, Jc, Ji, Jp

            over_l = jax.vmap(one, in_axes=(0, 0, None, 0, 0, 0))
            r, Jc, Ji, Jp = jax.vmap(over_l)(
                ext_slot, intr_slot, pts,
                obs_uv, obs_sqrt_info, model_idx_slot,
            )

        s = jnp.sum(r * r, axis=-1)
        w = loss_weight(s, loss, width) * maskf
        sw = jnp.sqrt(w)[..., None]
        r = r * sw
        if not with_jac:
            return r, None, None, None, s
        scale = sw[..., None]
        Jc = Jc * scale * cam_free_slot
        Jp = Jp * scale * pt_free_slot
        Ji = Ji * scale * intr_free_slot if has_intr else None
        return r, Jc, Ji, Jp, s

    def rows_to_views(vals_r):  # [R, F] -> [V, F]
        return jnp.einsum(
            "vr,rf->vf", row_oh, vals_r, preferred_element_type=dtype
        )

    def views_to_groups(vals_v):  # [V, F] -> [G, F]
        return jnp.einsum(
            "gv,vf->gf", group_oh, vals_v, preferred_element_type=dtype
        )

    def cost_of(state):
        ext, q, pts = state
        r, _, _, _, s = slot_residuals(ext, q, pts, with_jac=False)
        c = 0.5 * jnp.sum(loss_rho(s, loss, width) * maskf)
        if priors is not None:
            r_pr, _ = _prior_blocks(ext, priors, dtype)
            c = c + 0.5 * jnp.sum(r_pr * r_pr)
        return c

    eyeK = jnp.eye(K, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    eyeF = jnp.eye(Fi, dtype=dtype)

    def apply_step(pts, dp):
        if manifold:
            basis = jax.vmap(_point_tangent_basis4)(pts)
            new = pts + jnp.einsum("tij,tj->ti", basis, dp)
            n = jnp.linalg.norm(new, axis=-1, keepdims=True)
            return new / jnp.maximum(n, 1e-12)
        return pts + dp

    def lm_step(state, mu):
        ext_c, intr_c, pts_c = state
        r_t, Jc_t, Ji_t, Jp_t, _ = slot_residuals(
            ext_c, intr_c, pts_c, with_jac=True
        )

        if priors is not None:
            r_pr, J_pr = _prior_blocks(ext_c, priors, dtype)
            J_pr = J_pr * cam_free[:, None, :]
        else:
            r_pr = J_pr = None

        # ---- fused block products, chunked over tracks ----
        # Every J^T-something product shares the pattern einsum(Jx, X);
        # batching the right-hand operands into ONE X fuses what would be
        # 6-10 separate [O, small, small] einsums (measured ~5 ms each at
        # Piccadilly scale — the einsum COUNT, not FLOPs, dominates) into
        # 2-3 launches.
        #   X = [Jc | Jp | r (| Ji)]  ->  Jc^T X = [U | W | a (| .)]
        #                                 Jp^T X-part = [Vt | bp]
        #                                 Ji^T X = [. | Wi | ai | Ug]
        # The build runs as a lax.scan over track chunks: XLA pads the
        # tiny minor dims of the [Tc, L, 6, ~10] intermediates up to ~20x,
        # so full-T materialization OOMed at Trafalgar scale (254k tracks
        # -> a 9.7 GB JcX). Chunking bounds every intermediate to chunk
        # size; the coarse-level placement product and the intrinsics
        # global sums accumulate in the scan carry.

        def build_blocks(Jc_c, Jp_c, r_c, Ji_c, coarse_c):
            Tc = Jc_c.shape[0]
            ops = [Jc_c, Jp_c, r_c[..., None]]
            if has_intr:
                ops.append(Ji_c)
            X = jnp.concatenate(ops, axis=-1)  # [Tc,L,2, 6+K+1(+P)]
            JcX = _atb(Jc_c, X)
            U_slot = JcX[..., :6]  # [Tc,L,6,6]
            W = JcX[..., 6 : 6 + K]  # [Tc,L,6,K]
            a_slot = JcX[..., 6 + K]  # [Tc,L,6]
            d_slot = jnp.einsum("tlii->tli", U_slot)
            # Point blocks are track-local: sum the slot axis directly.
            JpZ = jnp.sum(_atb(Jp_c, X[..., 6 : 6 + K + 1]), axis=1)
            Vt = JpZ[..., :K]
            bp = -JpZ[..., K]
            diagVt = jnp.einsum("tii->ti", Vt)
            Vt_d = (
                Vt
                + mu * (eyeK * jnp.maximum(diagVt, 1e-6)[..., None, :])
                + 1e-10 * eyeK
            )
            Vinv = inv_small_spd(Vt_d, K)
            Y = _ab(W, Vinv[:, None])  # [Tc,L,6,K]
            M_slot = (U_slot - _abt(Y, W)).reshape(Tc, L, 36)
            w0_slot = _av(Y, bp[:, None])
            packs = [M_slot, a_slot, d_slot, w0_slot]
            part = {}
            if has_intr:
                JiX = _atb(Ji_c, X[..., 6:])
                Wi = JiX[..., :K]  # [Tc,L,P,K]
                ai_slot = JiX[..., K]  # [Tc,L,P]
                Ug_slot = JiX[..., K + 1 :]  # [Tc,L,P,P]
            if exact_elim:
                # Free shared intrinsics (single group — the common
                # case): the [P] block couples EVERY camera, which
                # destroys block-Jacobi PCG convergence whenever the
                # intrinsics are off. Since P is tiny, eliminate the
                # block EXACTLY (bordered Schur): PCG runs on
                #   S~ = S_cc - B Sq^-1 B^T
                # with B [V,6,P] the per-view coupling and Sq [P,P] the
                # intrinsics Schur block, both point-eliminated. The
                # point correction needs TRACK-LEVEL sums (W V^-1
                # couples every slot pair of a track), hence Wi_t.
                Wi_t = jnp.sum(Wi, axis=1)  # [Tc,P,K]
                Yi_t = _ab(Wi_t, Vinv)  # [Tc,P,K]
                ji_cross = JcX[..., 6 + K + 1 :]  # [Tc,L,6,Fi]
                B_slot = (ji_cross - _abt(Y, Wi_t[:, None])).reshape(
                    Tc, L, 6 * Fi
                )
                packs.append(B_slot)
                # Global reductions straight from the track layout
                # (P-sized outputs — real matmul contractions, no pack
                # columns needed); summed across chunks by the carry.
                part["Sq1"] = jnp.sum(Ug_slot, axis=(0, 1)) - jnp.einsum(
                    "tik,tjk->ij", Yi_t, Wi_t
                )
                part["bi1"] = -jnp.sum(ai_slot, axis=(0, 1))
                part["di1"] = jnp.einsum("tlii->i", Ug_slot)
                part["wq1"] = jnp.einsum("tik,tk->i", Yi_t, bp)
            elif joint_intr:
                # Multiple shared-intrinsics groups: keep the intrinsics
                # in the PCG state (slot-diagonal preconditioner).
                di_slot = jnp.einsum("tlii->tli", Ug_slot)
                Yi = _ab(Wi, Vinv[:, None])
                Mg_slot = (Ug_slot - _abt(Yi, Wi)).reshape(Tc, L, Fi * Fi)
                wi0_slot = _av(Yi, bp[:, None])
                packs += [Mg_slot, ai_slot, di_slot, wi0_slot]
            # The Jacobian rows needed by the matvec adjoint ride the
            # SAME gather as the pack (a 128-wide f32 row gather costs
            # the same as 64-wide — the gather is index-floor-bound).
            packs.append(Jc_c.reshape(Tc, L, 12))
            if joint_intr:
                packs.append(Ji_c.reshape(Tc, L, 2 * Fi))
            pack_c = jnp.concatenate(packs, axis=-1)
            if use_coarse:
                # Coarse placement product for this chunk:
                # -(R^T W) V^-1 (W^T R) accumulated into [Vc,6,Vc,6].
                # The build stays f32 end-to-end: a bf16 variant was
                # measured harmful here (see module comment).
                cs = coarse_stride
                ohc = (
                    coarse_c[::cs, :, None]
                    == jnp.arange(Vc, dtype=jnp.int32)[None, None, :]
                ).astype(dtype)
                place_dims = (((1,), (1,)), ((0,), (0,)))
                prod_dims = (((0, 3), (0, 3)), ((), ()))
                Wx = jax.lax.dot_general(
                    ohc, W[::cs], place_dims,
                    preferred_element_type=dtype,
                )
                Zx = jax.lax.dot_general(
                    ohc, Y[::cs], place_dims,
                    preferred_element_type=dtype,
                )
                part["Sc_off"] = float(cs) * jax.lax.dot_general(
                    Zx, Wx, prod_dims,
                    preferred_element_type=dtype,
                )
                # Sampled coarse U aggregate, SAME stride and scale as
                # Sc_off: the coarse operator's obs part is then
                # cs * sum_{t in sample} R^T (U_t - W_t V_t^-1 W_t^T) R —
                # a sum of per-track PSD Schur complements, so sampling
                # can never make it indefinite (scaling only the
                # subtracted half could).
                part["Uc"] = float(cs) * jax.lax.dot_general(
                    ohc,
                    U_slot[::cs].reshape(-1, L, 36),
                    (((0, 1), (0, 1)), ((), ())),
                    preferred_element_type=dtype,
                )
            return pack_c, Vinv, bp, diagVt, part

        # Chunk only past the single-shot memory envelope
        # (_SCAN_SLOT_THRESHOLD): the scan serializes the build and loses
        # fusion at sizes that fit, but bounds the intermediates of
        # Trafalgar-scale problems (1.5M+ slots). The candidate chunk sizes
        # were picked on another accelerator and are untuned on the H100.
        TC = T
        if T * L > _SCAN_SLOT_THRESHOLD:
            for cand in (32768, 16384, 8192):
                if T % cand == 0:
                    TC = cand
                    break
        nch = T // TC
        Ji_full = Ji_t if has_intr else jnp.zeros((T, L, 2, 0), dtype)
        cs_full = (
            coarse_slot if use_coarse else jnp.zeros((T, L), jnp.int32)
        )
        if nch > 1:
            def scan_body(carry, xs):
                pack_c, Vinv_c, bp_c, dV_c, part = build_blocks(*xs)
                carry = jax.tree_util.tree_map(
                    lambda a, b: a + b, carry, part
                )
                return carry, (pack_c, Vinv_c, bp_c, dV_c)

            init = {}
            if exact_elim:
                init.update(
                    Sq1=jnp.zeros((Fi, Fi), dtype),
                    bi1=jnp.zeros((Fi,), dtype),
                    di1=jnp.zeros((Fi,), dtype),
                    wq1=jnp.zeros((Fi,), dtype),
                )
            if use_coarse:
                init["Sc_off"] = jnp.zeros((Vc, 6, Vc, 6), dtype)
                init["Uc"] = jnp.zeros((Vc, 36), dtype)
            xs = (
                Jc_t.reshape(nch, TC, L, 2, 6),
                Jp_t.reshape(nch, TC, L, 2, K),
                r_t.reshape(nch, TC, L, 2),
                Ji_full.reshape(nch, TC, L, 2, Ji_full.shape[-1]),
                cs_full.reshape(nch, TC, L),
            )
            part, ys = jax.lax.scan(scan_body, init, xs)
            pack, Vinv, bp, diagVt = (
                y.reshape((T,) + y.shape[2:]) for y in ys
            )
        else:
            pack, Vinv, bp, diagVt, part = build_blocks(
                Jc_t, Jp_t, r_t, Ji_full, cs_full
            )
        if exact_elim:
            Sq1 = part["Sq1"]
            bi1 = part["bi1"]
            Di1 = jnp.maximum(part["di1"], 1e-6)
            gq1 = bi1 - part["wq1"]
        F = pack.shape[-1]
        njc = 12 + (2 * Fi if joint_intr else 0)
        Fred = F - njc  # columns that feed the view reduction
        # Pad the packed row to a 64-float (256-byte) boundary so each
        # gathered row is aligned. Untuned on the H100.
        Fpad = -(-F // 64) * 64
        if Fpad != F:
            pack = jnp.pad(pack, ((0, 0), (0, 0), (0, Fpad - F)))
        # Barrier: stop XLA fusing the pack producers INTO the gather
        # (re-computing pack rows per gathered slot — measured 59 ms vs
        # 15 ms for the materialized-then-gathered form).
        pack = jax.lax.optimization_barrier(pack)
        pack_rc = pack.reshape(O, Fpad)[rc_src] * rc_m[..., None]
        pack_r = jnp.sum(pack_rc[..., :Fred], axis=1)  # [R, Fred]
        red = rows_to_views(pack_r)  # [V, Fred]

        Mv = red[:, :36].reshape(V, 6, 6)
        a_v = red[:, 36:42]
        Dc = red[:, 42:48]
        w0_v = red[:, 48:54]
        off = 54

        bc = -a_v
        if J_pr is not None:
            pr_blocks = jnp.einsum("vri,vrj->vij", J_pr, J_pr)
            bc = bc - jnp.einsum("vri,vr->vi", J_pr, r_pr)
            Dc = Dc + jnp.einsum("vri,vri->vi", J_pr, J_pr)
            Mv = Mv + pr_blocks
        Dc = jnp.maximum(Dc, 1e-6)
        gc = bc - w0_v

        Mv = (
            Mv
            + mu * (eye6 * Dc[..., None, :])
            + (1.0 - cam_free)[..., None, :] * eye6
            + 1e-8 * eye6
        )

        if exact_elim:
            Bv = red[:, off : off + 6 * Fi].reshape(V, 6, Fi)
            Sq_d = (
                Sq1
                + mu * (eyeF * Di1[None, :])
                + eyeF * (1.0 - intr_freeF[0])[None, :]
                + 1e-8 * eyeF
            )
            Sq_inv1 = jnp.linalg.inv(Sq_d)

            def intr_corr(xc):
                """B Sq^-1 B^T xc — the eliminated-block correction."""
                btx = jnp.einsum("vip,vi->p", Bv, xc)
                return jnp.einsum("vip,p->vi", Bv, Sq_inv1 @ btx)

            gc = gc - jnp.einsum("vip,p->vi", Bv, Sq_inv1 @ gq1)
            # Preconditioner = the exact diagonal block of S~.
            Mv = Mv - jnp.einsum("vip,pq,vjq->vij", Bv, Sq_inv1, Bv)
        elif joint_intr:
            gi = views_to_groups(red[:, off:])
            Mg = gi[:, : Fi * Fi].reshape(G, Fi, Fi)
            bi = -gi[:, Fi * Fi : Fi * Fi + Fi]
            Di = jnp.maximum(gi[:, Fi * Fi + Fi : Fi * Fi + 2 * Fi], 1e-6)
            gint = bi - gi[:, Fi * Fi + 2 * Fi :]
            Mg_d = (
                Mg
                + mu * (eyeF * Di[..., None, :])
                + (1.0 - intr_freeF)[..., None, :] * eyeF
                + 1e-8 * eyeF
            )
            Mg_inv = jnp.linalg.inv(Mg_d)

        # Schur-Jacobi preconditioner blocks.
        Mv_inv = inv_small_spd(Mv, 6)

        if use_coarse:
            # Coarse level: Sc = R^T S~ R materialized exactly at Vc
            # resolution with the dense-Schur placement product, then
            # Cholesky-factored (6Vc is a few hundred — trivial as dense work).
            Nc = 6 * Vc
            # Diagonal blocks: the (sampled, scaled) obs U aggregate from
            # the build scan plus the EXACT damping/frozen/ridge/prior
            # extras (all PSD, so they never fight the sampled part).
            extras_v = (
                mu * (eye6 * Dc[..., None, :])
                + (1.0 - cam_free)[..., None, :] * eye6
                + 1e-8 * eye6
            )
            if J_pr is not None:
                extras_v = extras_v + pr_blocks
            coarse_oh = _onehot(coarse_of_view, Vc, dtype)  # [Vc, V]
            Sc4 = jnp.einsum(
                "cv,vij->cij", coarse_oh, extras_v
            ) + part["Uc"].reshape(Vc, 6, 6)
            Sc = jnp.zeros((Vc, 6, Vc, 6), dtype)
            arc = jnp.arange(Vc)
            Sc = Sc.at[arc, :, arc, :].set(Sc4)
            # Off-diagonal (all slot pairs): -(R^T W) V^-1 (W^T R),
            # accumulated chunk-by-chunk in the build scan.
            Sc = Sc - part["Sc_off"]
            if exact_elim:
                Bc = jnp.einsum("cv,vip->cip", coarse_oh, Bv)  # [Vc,6,P]
                Sc = Sc - jnp.einsum(
                    "cip,pq,djq->cidj", Bc, Sq_inv1, Bc
                )
            Sc = Sc.reshape(Nc, Nc)
            Sc = 0.5 * (Sc + Sc.T) + 1e-7 * jnp.eye(Nc, dtype=dtype)
            chol_c = jnp.linalg.cholesky(Sc)

        # Matvec operands (bf16 under mixed precision: the matvec is
        # bandwidth-bound, halving operand bytes ~halves its wall-clock).
        Jc_mv = Jc_t.astype(mm)
        Jp_mv = Jp_t.astype(mm)
        Jc_rc = pack_rc[..., Fred : Fred + 12].reshape(R, C, 2, 6).astype(mm)
        if joint_intr:
            Ji_mv = Ji_t.astype(mm)
            Ji_rc = (
                pack_rc[..., Fred + 12 : Fred + 12 + 2 * Fi]
                .reshape(R, C, 2, Fi)
                .astype(mm)
            )

        def S_mv(xs):
            # bf16 operands upcast at the multiply (fused into the load):
            # accumulation stays f32, reads are half-width under mixed.
            xc = xs[0]
            y = jnp.sum(
                Jc_mv.astype(dtype) * xc[track_views][..., None, :], axis=-1
            )  # [T,L,2]
            if joint_intr:
                y = y + jnp.sum(
                    Ji_mv.astype(dtype) * xs[1][group_slot][..., None, :],
                    axis=-1,
                )
            t_ = jnp.sum(
                Jp_mv.astype(dtype) * y[..., None], axis=(1, 2)
            )  # [T,K]
            z = _av(Vinv, t_)
            w = jnp.sum(
                Jp_mv.astype(dtype) * z[:, None, None, :], axis=-1
            )  # [T,L,2]
            u = (y - w).astype(mm).reshape(O, 2)[rc_src]  # [R, C, 2]
            a_r = jnp.sum(
                Jc_rc.astype(dtype) * u.astype(dtype)[..., None],
                axis=(1, 2),
            )  # [R, 6]
            a = rows_to_views(a_r)
            sc = a + mu * Dc * xc
            if J_pr is not None:
                sc = sc + jnp.einsum("vri,vrj,vj->vi", J_pr, J_pr, xc)
            if exact_elim:
                sc = sc - intr_corr(xc)
            if joint_intr:
                ai_r = jnp.sum(
                    Ji_rc.astype(dtype) * u.astype(dtype)[..., None],
                    axis=(1, 2),
                )
                ai = views_to_groups(rows_to_views(ai_r))
                return (sc, ai + mu * Di * xs[1])
            return (sc,)

        def precond(xs):
            pc = jnp.einsum("vij,vj->vi", Mv_inv, xs[0])
            if use_coarse:
                rc = jnp.einsum("cv,vi->ci", coarse_oh, xs[0])
                zc = jax.scipy.linalg.cho_solve(
                    (chol_c, True), rc.reshape(-1)
                ).reshape(Vc, 6)
                pc = pc + zc[coarse_of_view]
            if joint_intr:
                return (pc, jnp.einsum("gij,gj->gi", Mg_inv, xs[1]))
            return (pc,)

        def dot(a, b):
            return sum(jnp.sum(x * y) for x, y in zip(a, b))

        g = (gc, gint) if joint_intr else (gc,)
        g_norm2 = dot(g, g)
        tol2 = (options.linear_solver_tolerance**2) * g_norm2

        def pcg_cond(carry):
            _, rres, _, _, rz, i = carry
            return (i < options.linear_solver_iterations) & (
                dot(rres, rres) > tol2
            )

        def pcg_body(carry):
            x, rres, z, p, rz, i = carry
            Sp = S_mv(p)
            pSp = dot(p, Sp)
            alpha = rz / jnp.where(pSp == 0, 1.0, pSp)
            x = jax.tree_util.tree_map(lambda a, b: a + alpha * b, x, p)
            rres = jax.tree_util.tree_map(
                lambda a, b: a - alpha * b, rres, Sp
            )
            z_new = precond(rres)
            rz_new = dot(rres, z_new)
            beta = rz_new / jnp.where(rz == 0, 1.0, rz)
            p = jax.tree_util.tree_map(lambda a, b: a + beta * b, z_new, p)
            return x, rres, z_new, p, rz_new, i + 1

        x0 = jax.tree_util.tree_map(jnp.zeros_like, g)
        z0 = precond(g)
        carry = (x0, g, z0, z0, dot(g, z0), jnp.asarray(0, jnp.int32))
        carry = jax.lax.while_loop(pcg_cond, pcg_body, carry)
        dxs = carry[0]
        dc = dxs[0] * cam_free
        if exact_elim:
            # Recover the eliminated intrinsics step:
            # dq = Sq^-1 (gq - B^T dc).
            dq = Sq_inv1 @ (gq1 - jnp.einsum("vip,vi->p", Bv, dc))
            di_f = dq[None, :] * intr_freeF
        elif joint_intr:
            di_f = dxs[1] * intr_freeF
        else:
            di_f = jnp.zeros((G, Fi), dtype)
        # Scatter the compressed step back into the [G, P] state.
        di = jnp.zeros_like(intr_c).at[:, cols].set(di_f)

        # Back-substitute points (full precision — one pass).
        y = jnp.sum(Jc_t * dc[track_views][..., None, :], axis=-1)
        if has_intr:
            y = y + jnp.sum(Ji_t * di_f[group_slot][..., None, :], axis=-1)
        t_ = jnp.sum(Jp_t * y[..., None], axis=(1, 2))
        dp = _av(Vinv, bp - t_) * pt_free

        new_state = (ext_c + dc, intr_c + di, apply_step(pts_c, dp))
        pred = 0.5 * (
            jnp.sum(dc * (mu * Dc * dc + bc))
            + jnp.sum(dp * (mu * jnp.maximum(diagVt, 1e-6) * dp + bp))
        )
        if exact_elim:
            pred = pred + 0.5 * jnp.sum(
                di_f * (mu * Di1[None, :] * di_f + bi1[None, :])
            )
        elif joint_intr:
            pred = pred + 0.5 * jnp.sum(di_f * (mu * Di * di_f + bi))
        ok = (
            jnp.all(jnp.isfinite(dc))
            & jnp.all(jnp.isfinite(dp))
            & jnp.all(jnp.isfinite(di))
        )
        return new_state, pred, ok

    state0 = (extrinsics, intrinsics, points)
    initial_cost = cost_of(state0)

    def while_cond(carry):
        state, mu, cost, it, done = carry
        return (~done) & (it < options.max_num_iterations)

    def while_body(carry):
        state, mu, cost, it, done = carry
        new_state, pred, ok = lm_step(state, mu)
        new_cost = cost_of(new_state)
        actual = cost - new_cost
        accept = ok & (actual > 0) & jnp.isfinite(new_cost)
        gain = actual / jnp.maximum(pred, 1e-30)
        mu_new = jnp.where(
            accept,
            mu
            * jnp.maximum(
                1.0 / 3.0,
                1.0 - (2.0 * jnp.clip(gain, 0.0, 1.0) - 1.0) ** 3,
            ),
            mu * 4.0,
        )
        mu_new = jnp.clip(mu_new, 1e-12, 1e10)
        state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(accept, n, o), new_state, state
        )
        cost_next = jnp.where(accept, new_cost, cost)
        # Sign-insensitive function-tolerance termination (Ceres
        # semantics): |cost change| below tolerance ends the solve whether
        # the step was accepted or rejected — at a converged state every
        # proposal is a near-zero change that LM REJECTS by noise, and the
        # accept-gated check burned the full iteration budget doing
        # nothing (measured: 50 no-progress iterations = 32 s at
        # Trafalgar scale in the post-retriangulation BA round).
        rel_change = jnp.abs(actual) / jnp.maximum(cost, 1e-30)
        done = jnp.isfinite(new_cost) & (
            rel_change < options.function_tolerance
        )
        return state, mu_new, cost_next, it + 1, done

    mu_init = (
        jnp.asarray(1.0 / options.initial_trust_region_radius, dtype)
        if mu0 is None
        else jnp.asarray(mu0, dtype)
    )
    carry = (
        state0,
        mu_init,
        initial_cost,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    carry = jax.lax.while_loop(while_cond, while_body, carry)
    (ext_out, intr_out, pts_out), mu_out, final_cost, iters, done_out = carry

    summary = BundleAdjustmentSummary(
        success=jnp.isfinite(final_cost) & (final_cost <= initial_cost),
        initial_cost=initial_cost,
        final_cost=final_cost,
        num_iterations=iters,
        final_mu=mu_out,
        converged=done_out,
    )
    return ext_out, intr_out, pts_out, summary


def bundle_adjust_iterative(
    extrinsics,
    intrinsics,
    points,
    view_group,
    group_model_idx,
    track_views,
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    row_view,
    rc_src,
    rc_mask,
    camera_free,
    point_free,
    intrinsics_free,
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_rows: int,
    row_chunk: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,
):
    """LM to convergence with the scatter-free rowchunk iterative-Schur
    kernel (see `_bundle_adjust_iterative_impl`). Launched in
    `max_iterations_per_launch`-sized chunks with damping carried."""

    def impl(state, chunk_options, mu0):
        ext, q, pts = state
        ext, q, pts, summary = _bundle_adjust_iterative_impl(
            ext, q, pts,
            view_group, group_model_idx,
            track_views, obs_uv, obs_sqrt_info, obs_mask,
            row_view, rc_src, rc_mask,
            camera_free, point_free, intrinsics_free,
            present_models=present_models,
            num_views=num_views,
            num_tracks=num_tracks,
            max_track_len=max_track_len,
            num_rows=num_rows,
            row_chunk=row_chunk,
            num_groups=num_groups,
            options=chunk_options,
            priors=priors,
            mu0=mu0,
        )
        return (ext, q, pts), summary

    state, summary = run_launch_chunked(
        impl, (extrinsics, intrinsics, points), options
    )
    ext, q, pts = state
    return ext, q, pts, summary
