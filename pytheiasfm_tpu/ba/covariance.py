"""Selected-block covariance at scale via matrix-free Schur solves.

The exact joint covariance (`dense_schur.joint_covariance_dense`)
materializes and inverts the full [6V, 6V] camera Schur complement — the
right tool below ~1024 views, an OOM above. The reference's
`ceres::Covariance` path (`bundle_adjuster.cc:660-744`) works at any
scale because it only solves for the REQUESTED blocks; this module is the
Batched equivalent: the columns of S^-1 belonging to the selected
views come from block-Jacobi-preconditioned CG against the IMPLICIT
Schur operator

    S x = U x - sum_t Z_t (W_t^T x|_{views of t})          (mu = 0)

whose per-track pieces (U_v, W_t = Jc^T Jp, Z_t = W_t V_t^-1) are the
same quantities the dense path aggregates — held in their track-slot
form ([T, L, 6, 3] ~ 44 MB at Piccadilly scale) instead of the
[6V, 6V] dense matrix. The camera-side adjoint is a segment-sum (a
covariance query runs CG once, not once per LM iteration, so the
scatter's ~tens of ms/matvec is the right trade against materializing
the rowchunk layout). Track marginals for selected tracks reuse the same
solves: cov_t = V_t^-1 + sum_ab Z_a^T S^-1[v_a, v_b] Z_b needs S^-1
columns only at the track's observing views.

CG runs in HOST-CHUNKED launches (`cg_chunk_iters` per device program)
so one device program stays short at any problem size, with convergence
checked between launches.

Semantics match the dense path exactly: frozen (gauge) cameras carry
identity rows with a 1e-8 ridge, the operator is undamped, and the
caller scales by the empirical variance factor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .dense_schur import _Problem
from .lm import BundleAdjustmentOptions, inv_small_spd
from .losses import loss_rho

__all__ = ["selected_covariance_pcg"]


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
def _cov_blocks(
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
):
    """Build the implicit-operator pieces once:
    (Uv, W, Z, Vinv, Minv, cost, nres)."""
    dtype = extrinsics.dtype
    V, T, L = num_views, num_tracks, max_track_len
    O = T * L

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

    _r, Jc, _Jr, _Ji, Jp, s = prob.residuals(
        extrinsics, intrinsics, points, with_jac=True, want_intr_jac=False
    )
    Jc = Jc * cam_free[obs_view][:, None, :]
    Jp = Jp * pt_free[obs_track][:, None, :]
    Jc_t = Jc.reshape(T, L, 2, 6)
    Jp_t = Jp.reshape(T, L, 2, 3)

    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    Vt = jnp.einsum("tlri,tlrj->tij", Jp_t, Jp_t)
    Vt = Vt + (1.0 - pt_free)[..., None] * eye3 + 1e-10 * eye3
    Vinv = inv_small_spd(Vt, 3)
    W = jnp.einsum("tlri,tlrj->tlij", Jc_t, Jp_t)  # [T,L,6,3]
    Z = jnp.einsum("tlij,tjk->tlik", W, Vinv)  # [T,L,6,3]

    Uo = jnp.einsum("ori,orj->oij", Jc, Jc)  # [O,6,6]
    Uv = jax.ops.segment_sum(Uo, obs_view, num_segments=V)
    Uv = Uv + (1.0 - cam_free)[..., None] * eye6 + 1e-8 * eye6

    # Exact diagonal of S for the block-Jacobi preconditioner: the
    # off-diagonal sum hits the diagonal only where a slot pairs with
    # itself (same-view repeats within a track are rejected upstream).
    ZWt = jnp.einsum("tlij,tlkj->tlik", Z, W).reshape(O, 6, 6)
    Sdiag = Uv - jax.ops.segment_sum(ZWt, obs_view, num_segments=V)
    Minv = inv_small_spd(0.5 * (Sdiag + jnp.swapaxes(Sdiag, -1, -2)), 6)

    cost = jnp.sum(
        loss_rho(s, options.loss_function_type, options.robust_loss_width)
        * prob.obs_mask.astype(dtype)
    )
    nres = 2.0 * jnp.sum(prob.obs_mask)
    return Uv, W, Z, Vinv, Minv, 0.5 * cost, nres


def _matvec(Uv, W, Z, obs_view, x):
    """S x for block x [V, 6, K]."""
    V = Uv.shape[0]
    T, L = W.shape[0], W.shape[1]
    K = x.shape[-1]
    ux = jnp.einsum("vij,vjk->vik", Uv, x)
    xs = x.reshape(V, 6 * K)[obs_view].reshape(T, L, 6, K)
    g = jnp.einsum("tlij,tlik->tjk", W, xs)  # [T, 3, K]
    zg = jnp.einsum("tlij,tjk->tlik", Z, g).reshape(T * L, 6, K)
    off = jax.ops.segment_sum(zg, obs_view, num_segments=V)
    return ux - off


@partial(jax.jit, static_argnames=("iters",))
def _cg_chunk(Uv, W, Z, Minv, obs_view, state, iters: int):
    """Run `iters` PCG iterations; returns the updated state."""

    def dot(a, b):
        return jnp.sum(a * b, axis=(0, 1))

    def precond(rv):
        return jnp.einsum("vij,vjk->vik", Minv, rv)

    def body(_, st):
        x, rv, z, p, rz = st
        Ap = _matvec(Uv, W, Z, obs_view, p)
        denom = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = x + p * alpha[None, None, :]
        rv = rv - Ap * alpha[None, None, :]
        z = precond(rv)
        rz_new = dot(rv, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = z + p * beta[None, None, :]
        return x, rv, z, p, rz_new

    return jax.lax.fori_loop(0, iters, body, state)


@partial(jax.jit, static_argnames=("num_sel",))
def _extract_blocks(X, Vinv, Z, track_views, sel_views, sel_tracks, num_sel):
    """Selected camera 6x6 blocks + selected track 3x3 marginals."""
    V = X.shape[0]
    Km = num_sel
    cols = X.reshape(V, 6, Km, 6)
    cam_cov = cols[sel_views, :, jnp.arange(Km), :]  # [Km, 6, 6]

    pos_of_view = jnp.full((V,), -1, jnp.int32)
    pos_of_view = pos_of_view.at[sel_views].set(
        jnp.arange(Km, dtype=jnp.int32)
    )
    tv_sel = track_views[sel_tracks]  # [Kt, L]
    pos_b = pos_of_view[tv_sel]
    covered = pos_b >= 0
    # S^-1[v_a, v_b] for all slot pairs: cols[v_a, :, pos(v_b), :]
    # -> [Kt, La, Lb, 6, 6] (advanced indices broadcast first).
    Sg = cols[tv_sel[:, :, None], :, jnp.maximum(pos_b, 0)[:, None, :], :]
    pair_ok = (covered[:, :, None] & covered[:, None, :]).astype(X.dtype)
    Sg = Sg * pair_ok[..., None, None]
    Z_sel = Z[sel_tracks]
    corr = jnp.einsum("taki,tabkl,tblj->tij", Z_sel, Sg, Z_sel)
    return cam_cov, Vinv[sel_tracks] + corr


def selected_covariance_pcg(
    extrinsics,
    intrinsics,
    points,
    view_group,
    group_model_idx,
    track_views,  # [T, L]
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    camera_free,
    point_free,
    sel_views,  # [K] int32
    sel_tracks,  # [Kt] int32 (their observing views included in sel_views)
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    max_track_len: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    cg_iterations: int = 4000,
    cg_chunk_iters: int = 200,
):
    """Returns (cam_cov [K,6,6], track_cov [Kt,3,3], cost, num_residuals,
    cg_residual) WITHOUT the sigma^2 factor (caller scales)."""
    dtype = extrinsics.dtype
    V = num_views
    obs_view = track_views.reshape(-1)

    Uv, W, Z, Vinv, Minv, cost, nres = _cov_blocks(
        extrinsics, intrinsics, points, view_group, group_model_idx,
        track_views, obs_uv, obs_sqrt_info, obs_mask,
        camera_free, point_free,
        present_models=present_models, num_views=num_views,
        num_tracks=num_tracks, max_track_len=max_track_len,
        num_groups=num_groups, options=options,
    )

    K6 = int(sel_views.shape[0]) * 6
    rhs = jnp.zeros((V, 6, K6), dtype)
    kk = jnp.arange(K6)
    rhs = rhs.at[sel_views[kk // 6], kk % 6, kk].set(1.0)

    x = jnp.zeros_like(rhs)
    r = rhs - _matvec(Uv, W, Z, obs_view, x)
    z = jnp.einsum("vij,vjk->vik", Minv, r)
    p = z
    rz = jnp.sum(r * z, axis=(0, 1))
    bnorm = float(
        np.maximum(np.sqrt(np.sum(np.asarray(rhs) ** 2, axis=(0, 1))), 1e-30).max()
    )
    tol = 1e-12 if dtype == jnp.float64 else 1e-7

    state = (x, r, z, p, rz)
    done = 0
    rel = np.inf
    prev_rel = np.inf
    while done < cg_iterations:
        it = min(cg_chunk_iters, cg_iterations - done)
        state = _cg_chunk(Uv, W, Z, Minv, obs_view, state, it)
        done += it
        rnorm = np.sqrt(
            np.sum(np.asarray(state[1]) ** 2, axis=(0, 1))
        )
        rel = float(rnorm.max()) / bnorm
        if rel < tol:
            break
        # f32 stagnation: once a chunk stops improving the residual by
        # >=20%, CG is at the operator's noise floor — more iterations
        # only burn time.
        if rel > 0.8 * prev_rel:
            break
        prev_rel = rel

    cam_cov, track_cov = _extract_blocks(
        state[0], Vinv, Z, track_views, sel_views, sel_tracks,
        num_sel=int(sel_views.shape[0]),
    )
    return cam_cov, track_cov, cost, nres, rel
