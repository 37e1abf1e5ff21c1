"""Dense-Schur Levenberg-Marquardt bundle adjustment — the matmul path.

Batched re-design of the reference's small/medium-problem BA
configuration: Ceres SPARSE_SCHUR below `min_cameras_for_iterative_solver`
(=1000) cameras (`/root/reference/src/theia/sfm/reconstruction_estimator_options.h:291-300`,
`bundle_adjuster.cc:315-341`). Ceres eliminates point blocks and runs a
sparse Cholesky on the reduced camera system; on an accelerator the reduced
system for V <= ~1000 cameras is only a [6V, 6V] dense matrix (Notre Dame
at 553 cams: 3318^2 f32 = 44 MB), which one dense Cholesky factorizes. So
this kernel *materializes* the Schur complement with matmuls and solves it
directly — no PCG loop, no scatter:

  layout    observations live in a padded [T, L] track-slot layout
            (L = max track length): the track axis is the "sequence" axis
            of SURVEY §5 — point-side reductions (V_t = J_p^T J_p, b_p)
            become dense sums over L. No segment_sum anywhere.
  scatter-free assembly
            per-slot coupling blocks W[t,l] = J_c^T J_p are placed into a
            dense [6V, 3Tc] matrix per track chunk with a ONE-HOT MATMUL
            over views (einsum 'tlv,tlij->vitj') — data movement expressed
            as matmul work instead of XLA scatter.
  Schur     S = U + mu*D - sum_c Z_c W_c^T with Z = W V^-1: one [6V, 3Tc]
            x [3Tc, 6V] matmul per chunk — the FLOP-dominant op, straight
            as matmuls (optionally bf16 via
            `options.use_mixed_precision_solves`, mirroring
            `bundle_adjustment.h:111`).
  solve     Cholesky + triangular solves on [6V, 6V]; point back-
            substitution is a track-local dense op.

The LM outer loop (damping, gain ratio, accept/reject) is identical to
`lm.py` and runs under one `lax.while_loop` so a whole optimization is one
device program. Supports XYZW and XYZW_MANIFOLD track parametrizations,
mixed camera models, per-DOF camera freezing, view priors, and frozen
intrinsics (free intrinsics and INVERSE_DEPTH route to the implicit-PCG
kernel in `lm.py` — the large-problem ITERATIVE_SCHUR analogue).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .lm import (
    BundleAdjustmentOptions,
    BundleAdjustmentSummary,
    _Problem,
    _prior_blocks,
    inv_small_spd,
    run_launch_chunked,
)

__all__ = [
    "bundle_adjust_dense",
    "joint_covariance_dense",
    "DENSE_SCHUR_MAX_CAMERAS",
]

# Above this the dense [6V, 6V] system stops being the right tool and the
# implicit-PCG kernel takes over — the same crossover rule as the
# reference's `min_cameras_for_iterative_solver` (=1000).
DENSE_SCHUR_MAX_CAMERAS = 1024


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _view_onehot(view_ids, num_views, dtype):
    """[..., V] one-hot of view ids — the scatter-free reduction basis."""
    return (
        view_ids[..., None] == jnp.arange(num_views, dtype=view_ids.dtype)
    ).astype(dtype)


def _view_reduce(values, onehot_flat):
    """sum_o values[o] -> [V, d] via one matmul ([V, O] @ [O, d])."""
    return jnp.einsum(
        "ov,od->vd", onehot_flat, values, preferred_element_type=values.dtype
    )


@partial(
    jax.jit,
    static_argnames=(
        "present_models",
        "num_views",
        "num_tracks",
        "max_track_len",
        "num_groups",
        "options",
        "mesh",
    ),
)
def _bundle_adjust_dense_impl(
    extrinsics,  # [V, 6]
    intrinsics,  # [G, P] (constant — frozen-intrinsics specialization)
    points,  # [T, 3] | [T, 4] (manifold)
    view_group,  # [V] int32
    group_model_idx,  # [G] int32
    track_views,  # [T, L] int32 — views observing each track (padded 0)
    obs_uv,  # [T, L, 2]
    obs_sqrt_info,  # [T, L, 2]
    obs_mask,  # [T, L] bool
    camera_free,  # [V] or [V, 6] bool
    point_free,  # [T] bool
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,
    mesh=None,
    mu0=None,
):
    """ONE LAUNCH of dense-Schur LM (the public `bundle_adjust_dense`
    wrapper chains launches with damping carried).

    Returns (extrinsics, intrinsics, points, summary) like
    `lm.bundle_adjust`. Intrinsics are NOT optimized here (see module doc).

    `mesh` (optional, static): a 1-D `jax.sharding.Mesh` with axis "data".
    When given, the Schur off-diagonal product — the FLOP-dominant stage —
    runs as an EXPLICIT `shard_map` over the track axis with one `psum`
    per chunk (SURVEY §7.9: collectives pinned for multi-host/DCN layouts
    rather than GSPMD-inferred). Requires num_tracks divisible by the mesh
    size.
    """
    dtype = extrinsics.dtype
    V, T, L = num_views, num_tracks, max_track_len
    O = T * L
    N = 6 * V
    mixed = options.use_mixed_precision_solves

    # Flat view of the slot layout so the residual/Jacobian builder is
    # shared with the implicit kernel.
    obs_view = track_views.reshape(O)
    obs_track = jnp.repeat(
        jnp.arange(T, dtype=jnp.int32), L, total_repeat_length=O
    )
    prob = _Problem(
        (
            obs_view,
            obs_track,
            obs_uv.reshape(O, 2),
            obs_sqrt_info.reshape(O, 2),
            obs_mask.reshape(O),
        ),
        view_group,
        jnp.zeros((T,), jnp.int32),
        jnp.zeros((T, 3), dtype),
        present_models,
        group_model_idx,
        options.track_parametrization_type,
        options.loss_function_type,
        options.robust_loss_width,
        dtype,
    )
    if prob.invdepth:
        raise ValueError(
            "bundle_adjust_dense does not support INVERSE_DEPTH; "
            "use lm.bundle_adjust"
        )

    if camera_free.ndim == 1:
        camera_free = camera_free[..., None]
    cam_free = (camera_free & options.optimize_cameras).astype(dtype)
    cam_free = jnp.broadcast_to(cam_free, (V, 6))
    pt_free = (point_free & options.optimize_points)[..., None].astype(dtype)

    # One-hot bases are loop-invariant: XLA hoists them out of the LM loop.
    oh_flat = _view_onehot(obs_view, V, dtype)  # [O, V]
    oh_slot = oh_flat.reshape(T, L, V)  # [T, L, V]

    # Track chunking for the Schur matmul (bounds peak memory at
    # [6V, 3*TCHUNK] per operand).
    TCHUNK = min(T, 4096)
    n_chunks = _round_up(T, TCHUNK) // TCHUNK
    Tpad = n_chunks * TCHUNK

    def cost_of(state):
        ext, pts = state
        c = prob.cost(ext, intrinsics, pts)
        if priors is not None:
            r_pr, _ = _prior_blocks(ext, priors, dtype)
            c = c + 0.5 * jnp.sum(r_pr * r_pr)
        return c

    def lm_step(state, mu):
        ext_c, pts_c = state
        r, Jc, _Jr, _Ji, Jp, _ = prob.residuals(
            ext_c, intrinsics, pts_c, with_jac=True, want_intr_jac=False
        )
        # Freeze constant parameters by zeroing Jacobian columns.
        Jc = Jc * cam_free[obs_view][:, None, :]
        Jp = Jp * pt_free[obs_track][:, None, :]

        Jc_t = Jc.reshape(T, L, 2, 6)
        Jp_t = Jp.reshape(T, L, 2, 3)
        r_t = r.reshape(T, L, 2)

        if priors is not None:
            r_pr, J_pr = _prior_blocks(ext_c, priors, dtype)
            J_pr = J_pr * cam_free[:, None, :]
        else:
            r_pr = J_pr = None

        # ---- point-side blocks: dense sums over the slot axis ----
        Vt = jnp.einsum("tlri,tlrj->tij", Jp_t, Jp_t)  # [T,3,3]
        diagVt = jnp.einsum("tii->ti", Vt)
        eye3 = jnp.eye(3, dtype=dtype)
        Vt_d = (
            Vt
            + mu * (eye3 * jnp.maximum(diagVt, 1e-6)[..., None, :])
            + 1e-10 * eye3
        )
        Vinv = inv_small_spd(Vt_d, 3)
        bp = -jnp.einsum("tlri,tlr->ti", Jp_t, r_t)  # [T,3]

        # Camera-point coupling blocks and their V^-1 product.
        W = jnp.einsum("tlri,tlrj->tlij", Jc_t, Jp_t)  # [T,L,6,3]
        Z = jnp.einsum("tlij,tjk->tlik", W, Vinv)  # [T,L,6,3]

        # ---- camera-side reductions: one-hot matmuls (no scatter) ----
        bc = -_view_reduce(jnp.einsum("ori,or->oi", Jc, r), oh_flat)  # [V,6]
        Dc = _view_reduce(jnp.einsum("ori,ori->oi", Jc, Jc), oh_flat)
        Uv = _view_reduce(
            jnp.einsum("ori,orj->oij", Jc, Jc).reshape(O, 36), oh_flat
        ).reshape(V, 6, 6)
        if J_pr is not None:
            bc = bc - jnp.einsum("vri,vr->vi", J_pr, r_pr)
            Dc = Dc + jnp.einsum("vri,vri->vi", J_pr, J_pr)
            Uv = Uv + jnp.einsum("vri,vrj->vij", J_pr, J_pr)
        Dc = jnp.maximum(Dc, 1e-6)

        # Reduced RHS g = bc - W V^-1 bp  (track-local then view-reduce).
        u = jnp.einsum("tij,tj->ti", Vinv, bp)  # [T,3]
        w_slot = jnp.einsum("tlij,tj->tli", W, u)  # [T,L,6]
        g = bc - _view_reduce(w_slot.reshape(O, 6), oh_flat)  # [V,6]

        # ---- dense Schur complement S [V,6,V,6] ----
        # Diagonal: U blocks + LM damping + frozen-DOF identity.
        S4 = jnp.zeros((V, 6, V, 6), dtype)
        ar = jnp.arange(V)
        eye6 = jnp.eye(6, dtype=dtype)
        diag_blocks = (
            Uv
            + mu * (eye6 * Dc[..., None, :])
            + (1.0 - cam_free)[..., None, :] * eye6
            + 1e-8 * eye6
        )
        S4 = S4.at[ar, :, ar, :].set(diag_blocks)

        # Off-diagonal (and diagonal correction): -W V^-1 W^T via two
        # explicit dot_generals per track chunk, laid out so NO transpose
        # is ever needed:
        #   placement  [Tc,L,V] x [Tc,L,6,3] -(batch t, contract l)->
        #              [Tc,V,6,3]  (each W block lands at its view row)
        #   product    [Tc,V,6,3] x [Tc,V,6,3] -(contract t,k)->
        #              [V,6,V,6]   (3*Tc-deep matmul contraction)
        mm_dtype = jnp.bfloat16 if mixed else dtype
        place_dims = (((1,), (1,)), ((0,), (0,)))
        prod_dims = (((0, 3), (0, 3)), ((), ()))

        def chunk_s_off(ohc, Wc, Zc):
            Wx = jax.lax.dot_general(
                ohc, Wc, place_dims, preferred_element_type=dtype
            )  # [Tc, V, 6, 3]
            Zx = jax.lax.dot_general(
                ohc, Zc, place_dims, preferred_element_type=dtype
            )
            return jax.lax.dot_general(
                Zx.astype(mm_dtype),
                Wx.astype(mm_dtype),
                prod_dims,
                preferred_element_type=dtype,
            )

        if mesh is not None:
            # Explicit-collectives path: tracks sharded over the mesh, one
            # psum combines per-device partial Schur products.
            from jax.sharding import PartitionSpec as PS

            from jax import shard_map

            axis = mesh.axis_names[0]

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(PS(axis), PS(axis), PS(axis)),
                out_specs=PS(),
            )
            def sharded_s_off(ohc, Wc, Zc):
                return jax.lax.psum(chunk_s_off(ohc, Wc, Zc), axis)

            S4 = S4 - sharded_s_off(oh_slot, W, Z)
        else:
            for c in range(n_chunks):
                lo = c * TCHUNK
                hi = min(T, lo + TCHUNK)
                S4 = S4 - chunk_s_off(oh_slot[lo:hi], W[lo:hi], Z[lo:hi])
        S = S4.reshape(N, N)
        S = 0.5 * (S + S.T)

        # ---- direct solve ----
        chol = jnp.linalg.cholesky(S)
        dxc = jax.scipy.linalg.cho_solve((chol, True), g.reshape(N))
        dc = dxc.reshape(V, 6) * cam_free

        # Back-substitute points: dp = V^-1 (bp - W^T dxc).
        dx_slot = dc[track_views]  # [T,L,6]
        s = jnp.einsum("tlij,tli->tj", W, dx_slot)  # [T,3]
        dp = jnp.einsum("tij,tj->ti", Vinv, bp - s) * pt_free

        new_state = (ext_c + dc, prob.apply_step(pts_c, dp))
        pred = 0.5 * (
            jnp.sum(dc * (mu * Dc * dc + bc))
            + jnp.sum(dp * (mu * jnp.maximum(diagVt, 1e-6) * dp + bp))
        )
        ok = jnp.all(jnp.isfinite(dxc))
        return new_state, pred, ok

    state0 = (extrinsics, points)
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
                1.0 / 3.0, 1.0 - (2.0 * jnp.clip(gain, 0.0, 1.0) - 1.0) ** 3
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
    (ext_out, pts_out), mu_out, final_cost, iters, done_out = carry

    summary = BundleAdjustmentSummary(
        success=jnp.isfinite(final_cost) & (final_cost <= initial_cost),
        initial_cost=initial_cost,
        final_cost=final_cost,
        num_iterations=iters,
        final_mu=mu_out,
        converged=done_out,
    )
    return ext_out, intrinsics, pts_out, summary


def bundle_adjust_dense(
    extrinsics,
    intrinsics,
    points,
    view_group,
    group_model_idx,
    track_views,
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    camera_free,
    point_free,
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,
    mesh=None,
):
    """LM to convergence with a dense materialized Schur complement
    (see `_bundle_adjust_dense_impl` for the kernel itself). Launched in
    `max_iterations_per_launch`-sized chunks with damping carried, so no
    single device program runs for long."""

    def impl(state, chunk_options, mu0):
        ext, pts = state
        ext, _q, pts, summary = _bundle_adjust_dense_impl(
            ext, intrinsics, pts,
            view_group, group_model_idx,
            track_views, obs_uv, obs_sqrt_info, obs_mask,
            camera_free, point_free,
            present_models=present_models,
            num_views=num_views,
            num_tracks=num_tracks,
            max_track_len=max_track_len,
            num_groups=num_groups,
            options=chunk_options,
            priors=priors,
            mesh=mesh,
            mu0=mu0,
        )
        return (ext, pts), summary

    state, summary = run_launch_chunked(
        impl, (extrinsics, points), options
    )
    ext, pts = state
    return ext, intrinsics, pts, summary


@partial(
    jax.jit,
    static_argnames=(
        "present_models",
        "num_views",
        "num_tracks",
        "max_track_len",
        "num_groups",
        "options",
    ),
)
def joint_covariance_dense(
    extrinsics,
    intrinsics,
    points,
    view_group,
    group_model_idx,
    track_views,
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    camera_free,  # [V] bool
    point_free,  # [T] bool
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
):
    """EXACT joint-problem marginal covariances via the dense Schur
    complement — the general-case `ceres::Covariance` on the full BA
    problem (`bundle_adjuster.cc:660-744`), not the block-diagonal
    other-group-constant approximation:

      cov(cams)   = sigma^2 * S^-1            (S = U - W V^-1 W^T, mu = 0)
      cov(trk t)  = sigma^2 * (V_t^-1 + Y_t^T S^-1 Y_t),  Y_t = W_t V_t^-1

    (standard block-inverse identities on [[U, W], [W^T, V]]). Frozen
    (gauge) cameras carry identity rows; their returned blocks are
    placeholders. Returns (cam_cov [V,6,6], track_cov [T,3,3], cost,
    num_residuals) WITHOUT the sigma^2 factor — the caller scales by the
    empirical variance factor.
    """
    dtype = extrinsics.dtype
    V, T, L = num_views, num_tracks, max_track_len
    O = T * L
    N = 6 * V

    obs_view = track_views.reshape(O)
    obs_track = jnp.repeat(
        jnp.arange(T, dtype=jnp.int32), L, total_repeat_length=O
    )
    prob = _Problem(
        (
            obs_view,
            obs_track,
            obs_uv.reshape(O, 2),
            obs_sqrt_info.reshape(O, 2),
            obs_mask.reshape(O),
        ),
        view_group,
        jnp.zeros((T,), jnp.int32),
        jnp.zeros((T, 3), dtype),
        present_models,
        group_model_idx,
        options.track_parametrization_type,
        options.loss_function_type,
        options.robust_loss_width,
        dtype,
    )
    cam_free = camera_free.astype(dtype)[:, None]
    pt_free = point_free.astype(dtype)[:, None]

    r, Jc, _Jr, _Ji, Jp, s = prob.residuals(
        extrinsics, intrinsics, points, with_jac=True, want_intr_jac=False
    )
    Jc = Jc * cam_free[obs_view][:, None, :]
    Jp = Jp * pt_free[obs_track][:, None, :]
    Jc_t = Jc.reshape(T, L, 2, 6)
    Jp_t = Jp.reshape(T, L, 2, 3)

    eye3 = jnp.eye(3, dtype=dtype)
    Vt = jnp.einsum("tlri,tlrj->tij", Jp_t, Jp_t)
    Vt = Vt + (1.0 - pt_free)[..., None] * eye3 + 1e-10 * eye3
    Vinv = inv_small_spd(Vt, 3)
    W = jnp.einsum("tlri,tlrj->tlij", Jc_t, Jp_t)  # [T,L,6,3]
    Z = jnp.einsum("tlij,tjk->tlik", W, Vinv)  # [T,L,6,3] = Y_t rows

    oh_flat = _view_onehot(obs_view, V, dtype)
    Uv = _view_reduce(
        jnp.einsum("ori,orj->oij", Jc, Jc).reshape(O, 36), oh_flat
    ).reshape(V, 6, 6)

    eye6 = jnp.eye(6, dtype=dtype)
    S4 = jnp.zeros((V, 6, V, 6), dtype)
    ar = jnp.arange(V)
    S4 = S4.at[ar, :, ar, :].set(
        Uv + (1.0 - cam_free)[..., None, :] * eye6 + 1e-8 * eye6
    )
    place_dims = (((1,), (1,)), ((0,), (0,)))
    prod_dims = (((0, 3), (0, 3)), ((), ()))
    TCHUNK = min(T, 4096)
    for c in range(-(-T // TCHUNK)):
        lo = c * TCHUNK
        hi = min(T, lo + TCHUNK)
        Wx = jax.lax.dot_general(
            oh_flat.reshape(T, L, V)[lo:hi], W[lo:hi], place_dims,
            preferred_element_type=dtype,
        )
        Zx = jax.lax.dot_general(
            oh_flat.reshape(T, L, V)[lo:hi], Z[lo:hi], place_dims,
            preferred_element_type=dtype,
        )
        S4 = S4 - jax.lax.dot_general(
            Zx, Wx, prod_dims, preferred_element_type=dtype
        )
    S = S4.reshape(N, N)
    S = 0.5 * (S + S.T)

    chol = jnp.linalg.cholesky(S)
    Sinv = jax.scipy.linalg.cho_solve((chol, True), jnp.eye(N, dtype=dtype))
    Sb = Sinv.reshape(V, 6, V, 6)
    cam_cov = Sb[ar, :, ar, :]  # [V, 6, 6]

    # Track marginals: V^-1 + sum_{a,b} Z_a^T S^-1[v_a, v_b] Z_b, chunked.
    def track_chunk(lo, hi):
        tv = track_views[lo:hi]  # [Tc, L]
        Sg = Sb[tv[:, :, None], :, tv[:, None, :], :]  # [Tc, L, L, 6, 6]
        return jnp.einsum(
            "taki,tabkl,tblj->tij", Z[lo:hi], Sg, Z[lo:hi]
        )
    TC2 = min(T, 2048)
    parts = [
        track_chunk(c * TC2, min(T, (c + 1) * TC2))
        for c in range(-(-T // TC2))
    ]
    track_cov = Vinv + jnp.concatenate(parts, axis=0)

    # Variance-factor cost: the ROBUST cost rho(s), matching what the
    # Gauss-Newton covariance is defined against for non-TRIVIAL losses
    # (sum of w*s from the IRLS-weighted residuals would under-count the
    # tail contribution of rho).
    from .losses import loss_rho

    cost = jnp.sum(
        loss_rho(s, options.loss_function_type, options.robust_loss_width)
        * prob.obs_mask.astype(dtype)
    )
    nres = 2.0 * jnp.sum(prob.obs_mask)
    return cam_cov, track_cov, 0.5 * cost, nres
