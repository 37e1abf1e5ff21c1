"""Position averaging from pairwise translation directions.

Re-design of `/root/reference/src/theia/sfm/global_pose_estimation/`:
`least_unsquared_deviation_position_estimator.h:58` (LUD, Ozyesil & Singer
CVPR'15 — convex ‖·‖₂-deviation with scale variables s_ij ≥ 1),
`nonlinear_position_estimator.h:61` (Ceres robust LM over unit-direction
errors) and `linear_position_estimator.cc:195` (smallest-eigenvector linear
method). Every solver runs as fixed-trip jitted iterations with
operator-form CG (gather/segment-sum matvecs) — nothing sparse ever
materializes.

Edge data: for edge (i, j) the view graph stores `position_2` = unit
position of camera j in camera i's frame; the world-frame direction is
t_ij = R_iᵀ · position_2 with c_j − c_i ≈ s_ij t_ij, s_ij > 0.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..math.l1 import conjugate_gradient
from ..ops import rotation as rotops

__all__ = [
    "GlobalPositionEstimatorType",
    "relative_translations_to_world",
    "least_unsquared_deviation_positions",
    "nonlinear_positions",
    "linear_triplet_positions",
    "ligt_positions",
    "bata_positions",
    "estimate_positions",
]


class GlobalPositionEstimatorType:
    """Parity: `GlobalPositionEstimatorType`
    (`reconstruction_estimator_options.h`)."""

    NONLINEAR = 0
    LINEAR_TRIPLET = 1
    LEAST_UNSQUARED_DEVIATION = 2
    LIGT = 3
    # BATA is implemented+tested but not wired into the reference's enum
    # (`bata_position_estimator.h:56`); we expose it as a first-class type.
    BATA = 4


def relative_translations_to_world(orientations, edge_i, rel_positions):
    """t_ij(world) = R_iᵀ · position_2, unit-normalized."""
    R = jax.vmap(rotops.angle_axis_to_rotation_matrix)(orientations)
    Ri = R[edge_i]
    t = jnp.einsum("eba,eb->ea", Ri, rel_positions)
    return t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)


@partial(jax.jit, static_argnames=("num_views", "outer_iters", "cg_iters"))
def least_unsquared_deviation_positions(
    edge_i, edge_j, t_world, free_mask, num_views: int,
    outer_iters: int = 200, cg_iters: int = 30, rho: float = 1.0,
    edge_mask=None,
):
    """LUD: min Σ ‖c_j − c_i − s_ij t_ij‖₂ s.t. s_ij ≥ 1.

    Parity: `LeastUnsquaredDeviationPositionEstimator`
    (`least_unsquared_deviation_position_estimator.h:58`, solved there by
    `ConstrainedL1Solver` ADMM, `.cc:104`). Same splitting here: with
    x = (c, s) and A x the stacked edge residuals,

        min Σ_e ‖z1_e‖₂ + 1_{z2 ≥ 1}   s.t.  A x = z1,  s = z2,

    the x-update is a CG solve of (AᵀA + [0; I_s]) x = Aᵀ(z1−u1) +
    (z2−u2), the z1-update is the group (block-L2) soft threshold — the
    prox of the sum-of-norms objective — and the z2-update projects the
    scales to s ≥ 1 (the constraint that forbids the trivial collapse
    c ≡ 0). A naive IRLS-with-clamping alternative stalls exactly at that
    collapse, which is why the reference carries a dedicated constrained
    solver.
    """
    E = edge_i.shape[0]
    dtype = t_world.dtype
    fm = free_mask.astype(dtype)[:, None]
    nC = num_views * 3

    # Padded edges (mesh-divisibility padding, edge_mask False) carry
    # t_world = 0 and i = j, so A rows are exactly zero; only the degree
    # preconditioner needs masking for the padded problem to match the
    # unpadded one bit-for-bit in trajectory.
    ones = (
        jnp.ones((E,), dtype)
        if edge_mask is None
        else edge_mask.astype(dtype)
    )
    deg = (
        jax.ops.segment_sum(ones, edge_i, num_segments=num_views)
        + jax.ops.segment_sum(ones, edge_j, num_segments=num_views)
    )
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1.0), 1.0)

    def apply_A(x):
        dc = x[:nC].reshape(num_views, 3) * fm
        ds = x[nC:]
        return dc[edge_j] - dc[edge_i] - ds[:, None] * t_world

    def apply_At(re):
        gc = jax.ops.segment_sum(re, edge_j, num_segments=num_views)
        gc -= jax.ops.segment_sum(re, edge_i, num_segments=num_views)
        gs = -jnp.sum(re * t_world, axis=-1)
        return jnp.concatenate([(gc * fm).reshape(-1), gs])

    def matvec(x):
        out = apply_At(apply_A(x))
        # + identity on the s block from the s = z2 constraint.
        return out.at[nC:].add(x[nC:])

    def precond(v):
        pc = (v[:nC].reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)
        return jnp.concatenate([pc, v[nC:] * 0.5])

    def group_shrink(v, kappa):
        nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        scale = jnp.maximum(1.0 - kappa / jnp.maximum(nrm, 1e-12), 0.0)
        return v * scale

    x0 = jnp.concatenate([jnp.zeros((nC,), dtype), jnp.ones((E,), dtype)])
    z1 = jnp.zeros((E, 3), dtype)
    u1 = jnp.zeros((E, 3), dtype)
    z2 = jnp.ones((E,), dtype)
    u2 = jnp.zeros((E,), dtype)

    def step(carry, _):
        x, z1, u1, z2, u2 = carry
        rhs = apply_At(z1 - u1)
        rhs = rhs.at[nC:].add(z2 - u2)
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters, precond=precond)
        Ax = apply_A(x)
        z1 = group_shrink(Ax + u1, 1.0 / rho)
        u1 = u1 + Ax - z1
        s = x[nC:]
        z2 = jnp.maximum(s + u2, 1.0)
        u2 = u2 + s - z2
        return (x, z1, u1, z2, u2), None

    (x, *_), _ = jax.lax.scan(
        step, (x0, z1, u1, z2, u2), None, length=outer_iters
    )
    return x[:nC].reshape(num_views, 3) * fm


@partial(jax.jit, static_argnames=("num_views", "num_iterations", "cg_iters"))
def nonlinear_positions(
    positions, edge_i, edge_j, t_world, edge_weights, free_mask,
    num_views: int, num_iterations: int = 50, cg_iters: int = 30,
    huber_delta: float = 0.1,
):
    """Robust Levenberg-Marquardt over unit-direction errors.

    Parity: `NonlinearPositionEstimator`
    (`nonlinear_position_estimator.h:61`, `pairwise_translation_error.h`):
    residual = w·(t̂_ij − (c_j − c_i)/‖c_j − c_i‖), Huber loss. Jacobian
    matvecs come from `jax.jvp`/`jax.vjp` of the residual closure — autodiff
    is the cost-functor factory here.
    """
    dtype = positions.dtype
    fm = free_mask.astype(dtype)[:, None]
    w_edge = edge_weights.astype(dtype)

    def residuals(c):
        d = c[edge_j] - c[edge_i]
        dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
        return (dn - t_world) * w_edge[:, None]

    def robust_sqrt_weights(r):
        nrm = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(nrm <= huber_delta, 1.0, huber_delta / jnp.maximum(nrm, 1e-12))
        return jnp.sqrt(w)[:, None]

    def step(carry, _):
        c, lam = carry
        r = residuals(c)
        sw = robust_sqrt_weights(r)

        def f(cfree):
            return residuals(c + cfree.reshape(num_views, 3) * fm) * sw

        zero = jnp.zeros((num_views * 3,), dtype)
        r0 = f(zero)
        _, vjp = jax.vjp(f, zero)

        def matvec(v):
            _, jv = jax.jvp(f, (zero,), (v,))
            (jtjv,) = vjp(jv)
            return jtjv + lam * v

        rhs = -vjp(r0)[0]
        dx = conjugate_gradient(matvec, rhs, iters=cg_iters)
        c_new = c + dx.reshape(num_views, 3) * fm
        cost_old = jnp.sum(r0 * r0)
        r_new = residuals(c_new) * sw
        cost_new = jnp.sum(r_new * r_new)
        ok = cost_new < cost_old
        c = jnp.where(ok, c_new, c)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0)
        return (c, lam), None

    (c, _), _ = jax.lax.scan(
        step, (positions, jnp.asarray(1e-3, dtype)), None, length=num_iterations
    )
    return c


@partial(jax.jit, static_argnames=("num_views", "power_iterations"))
def linear_triplet_positions(
    edge_i, edge_j, t_world, edge_weights, num_views: int,
    power_iterations: int = 200,
):
    """Linear position estimation: smallest eigenvector of the direction
    cross-constraint quadratic Σ w ‖(I − t tᵀ)(c_j − c_i)‖².

    Parity target: `LinearPositionEstimator`
    (`linear_position_estimator.cc:195-207`, Spectra shift-invert power
    iteration). Deflation removes the global-translation nullspace; shifted
    power iteration (λ_max I − L) finds the smallest mode on device.
    """
    dtype = t_world.dtype
    w = edge_weights.astype(dtype)
    P = (
        jnp.eye(3, dtype=dtype)[None]
        - t_world[:, :, None] * t_world[:, None, :]
    ) * w[:, None, None]

    deg = 2.0 * (
        jax.ops.segment_sum(w, edge_i, num_segments=num_views)
        + jax.ops.segment_sum(w, edge_j, num_segments=num_views)
    )
    lam = jnp.max(deg) + 1.0

    def apply_L(c):
        d = c[edge_j] - c[edge_i]
        Pd = jnp.einsum("eab,eb->ea", P, d)
        g = jax.ops.segment_sum(Pd, edge_j, num_segments=num_views)
        g -= jax.ops.segment_sum(Pd, edge_i, num_segments=num_views)
        return g

    def deflate(c):
        return c - jnp.mean(c, axis=0, keepdims=True)

    def body(c, _):
        y = lam * c - apply_L(c)
        y = deflate(y)
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-12), None

    key = jax.random.PRNGKey(0)
    c0 = deflate(jax.random.normal(key, (num_views, 3), dtype))
    c0 = c0 / jnp.linalg.norm(c0)
    c, _ = jax.lax.scan(body, c0, None, length=power_iterations)

    # Resolve the sign so most edges have positive scale along t.
    s = jnp.sum((c[edge_j] - c[edge_i]) * t_world, axis=-1)
    sign = jnp.where(jnp.sum(jnp.sign(s)) >= 0, 1.0, -1.0)
    return c * sign


@partial(jax.jit, static_argnames=("num_views", "num_tracks", "power_iterations"))
def ligt_positions(
    obs_view, obs_track, bearings, orientations, num_views: int,
    num_tracks: int, power_iterations: int = 200,
):
    """LiGT: linear global translation from track constraints.

    Parity: `theia::LiGTPositionEstimator` (`LiGT_position_estimator.h:53`,
    Cai et al. "A Pose-only Solution to Visual Reconstruction and
    Navigation", TPAMI 2021). Derivation used here (same constraint set):
    for a track with base observation (b, v_b), the point is
    X = c_b + d R_bᵀ v_b; any other observation (j, v_j) demands
    [v_j]× R_j (X − c_j) = 0. Eliminating the depth d via the cross product
    with a = [v_j]× R_j R_bᵀ v_b yields three equations *linear in camera
    centers only*:

        [a]× B_j (c_b − c_j) = 0,   B_j = [v_j]× R_j .

    The total least-squares solution is the smallest eigenvector of the
    assembled quadratic form — found by deflated shifted power iteration
    (the reference uses an eigensolve below 500 views and power iteration
    above, `LiGT_position_estimator.h:75-80`).

    Args:
      obs_view [O] int32; obs_track [O] int32; bearings [O, 3] unit camera-
      frame bearings; orientations [V, 3] world→camera angle-axis.

    Returns:
      positions [V, 3] (zero-mean, unit-norm gauge, majority-positive depth).
    """
    dtype = bearings.dtype
    R = jax.vmap(rotops.angle_axis_to_rotation_matrix)(orientations)  # [V,3,3]

    # Base observation per track: the first occurrence (segment_min over
    # observation index).
    O = obs_view.shape[0]
    obs_idx = jnp.arange(O)
    base_obs = jax.ops.segment_min(obs_idx, obs_track, num_segments=num_tracks)
    base_obs = jnp.clip(base_obs, 0, O - 1)
    base_view = obs_view[base_obs]  # [T]
    base_bearing = bearings[base_obs]  # [T, 3]

    # Per-observation constraint blocks (vectorized over all O observations;
    # base observations contribute a zero row via masking).
    b_view = base_view[obs_track]  # [O]
    v_b = base_bearing[obs_track]  # [O, 3]
    R_j = R[obs_view]
    R_b = R[b_view]
    ray_b = jnp.einsum("oba,ob->oa", R_b, v_b)  # R_bᵀ v_b, world ray

    def hat(a):
        z = jnp.zeros_like(a[..., 0])
        return jnp.stack(
            [
                jnp.stack([z, -a[..., 2], a[..., 1]], -1),
                jnp.stack([a[..., 2], z, -a[..., 0]], -1),
                jnp.stack([-a[..., 1], a[..., 0], z], -1),
            ],
            -2,
        )

    B_j = hat(bearings) @ R_j  # [O, 3, 3]
    a = jnp.einsum("oij,oj->oi", B_j, ray_b)  # [O, 3]
    M = hat(a) @ B_j  # [O, 3, 3]: M (c_b − c_j) = 0
    is_base = obs_idx == base_obs[obs_track]
    # Scale-balance each constraint (|a| ~ triangulation angle) and mask.
    wnorm = jnp.linalg.norm(a, axis=-1, keepdims=True)
    M = jnp.where(is_base[:, None, None], 0.0, M / jnp.maximum(wnorm[..., None], 1e-12))

    MtM = jnp.einsum("oki,okj->oij", M, M)  # [O, 3, 3]

    def apply_L(c):
        d = c[b_view] - c[obs_view]  # [O, 3]
        Md = jnp.einsum("oij,oj->oi", MtM, d)
        g = jax.ops.segment_sum(Md, b_view, num_segments=num_views)
        g -= jax.ops.segment_sum(Md, obs_view, num_segments=num_views)
        return g

    deg = jax.ops.segment_sum(
        jnp.trace(MtM, axis1=-2, axis2=-1), obs_view, num_segments=num_views
    ) + jax.ops.segment_sum(
        jnp.trace(MtM, axis1=-2, axis2=-1), b_view, num_segments=num_views
    )

    def deflate(c):
        return c - jnp.mean(c, axis=0, keepdims=True)

    # Inverse iteration: repeatedly solve (L + eps I) y = c with CG (each
    # outer step amplifies the near-null GT mode by ~1/eps — orders of
    # magnitude faster than shifted power iteration on this spectrum).
    eps = 1e-8 * jnp.maximum(jnp.mean(deg), 1e-12)

    def matvec(x):
        xv = deflate(x.reshape(num_views, 3))
        return (apply_L(xv) + eps * xv).reshape(-1)

    def body(c, _):
        y = conjugate_gradient(
            matvec, c.reshape(-1), x0=c.reshape(-1), iters=power_iterations
        )
        y = deflate(y.reshape(num_views, 3))
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-30), None

    c0 = deflate(jax.random.normal(jax.random.PRNGKey(0), (num_views, 3), dtype))
    c0 = c0 / jnp.linalg.norm(c0)
    c, _ = jax.lax.scan(body, c0, None, length=8)

    # Sign: majority of depths d = −aᵀw/|a|² must be positive.
    w_vec = jnp.einsum("oij,oj->oi", B_j, c[b_view] - c[obs_view])
    d_est = -jnp.sum(a * w_vec, -1) / jnp.maximum(jnp.sum(a * a, -1), 1e-20)
    d_est = jnp.where(is_base, 0.0, d_est)
    sign = jnp.where(jnp.sum(jnp.sign(d_est)) >= 0, 1.0, -1.0)
    return c * sign


@partial(jax.jit, static_argnames=("num_views", "outer_iters", "cg_iters"))
def bata_positions(
    edge_i, edge_j, t_world, free_mask, num_views: int,
    outer_iters: int = 100, cg_iters: int = 40, alpha_eps: float = 1e-3,
):
    """BATA: bilinear angle-based translation averaging (revised LUD).

    Parity: `theia::RevisedLeastUnsquaredDeviationPositionEstimator`
    (`bata_position_estimator.h:56`, Zhuang et al. "Baseline Desensitizing
    in Translation Averaging", CVPR 2018): minimize
    Σ w_ij ‖ α_ij (c_j − c_i) − t̂_ij ‖² with α_ij = 1/‖c_j − c_i‖
    re-estimated each round (angle-based residual — insensitive to
    baseline length), plus IRLS robust weights.

    Returns positions [V, 3] (zero-mean gauge, mean edge length 1).
    """
    dtype = t_world.dtype
    E = edge_i.shape[0]
    fm = free_mask.astype(dtype)[:, None]

    # Warm start from LUD: the bilinear alternation has spurious fixed
    # points in f32 when started far away; LUD's convex ADMM lands inside
    # the right basin (the reference's BATA is likewise a "revised" LUD).
    c = least_unsquared_deviation_positions(
        edge_i, edge_j, t_world, free_mask, num_views
    )
    c = c - jnp.mean(c, axis=0, keepdims=True)
    dn0 = jnp.linalg.norm(c[edge_j] - c[edge_i], axis=-1)
    c = c / jnp.maximum(jnp.mean(dn0), 1e-12)

    def outer(c, _):
        d = c[edge_j] - c[edge_i]
        # Bilinear alternation (Zhuang et al. eq. 6): the optimal per-edge
        # scale given c is the projection alpha = t̂ᵀd / ‖d‖² (clamped
        # positive) — NOT 1/‖d‖, which collapses short edges.
        dn2 = jnp.sum(d * d, axis=-1)
        alpha = jnp.maximum(jnp.sum(t_world * d, -1), alpha_eps) / jnp.maximum(
            dn2, alpha_eps**2
        )
        r = alpha[:, None] * d - t_world
        # Robust (Cauchy-ish) reweighting on the angular residual.
        w = 1.0 / (1.0 + jnp.sum(r * r, -1) / 0.25)

        reg = 1e-6 * jnp.mean(w * alpha * alpha)

        def deflate_v(xv):
            return xv - jnp.mean(xv, axis=0, keepdims=True)

        def matvec(x):
            # Deflate + tiny Tikhonov: the Laplacian is exactly singular on
            # the translation nullspace, which f32 CG otherwise amplifies.
            xv = deflate_v(x.reshape(num_views, 3)) * fm
            dd = (xv[edge_j] - xv[edge_i]) * (w * alpha * alpha)[:, None]
            g = jax.ops.segment_sum(dd, edge_j, num_segments=num_views)
            g -= jax.ops.segment_sum(dd, edge_i, num_segments=num_views)
            return (deflate_v(g * fm) + reg * xv).reshape(-1)

        rhs_e = t_world * (w * alpha)[:, None]
        rhs = jax.ops.segment_sum(rhs_e, edge_j, num_segments=num_views)
        rhs -= jax.ops.segment_sum(rhs_e, edge_i, num_segments=num_views)
        rhs = deflate_v(rhs * fm).reshape(-1)

        x = conjugate_gradient(matvec, rhs, x0=c.reshape(-1), iters=cg_iters)
        c_new = x.reshape(num_views, 3)
        # Mean-zero gauge only — the alpha-projection makes the cost scale
        # invariant, and rescaling mid-iteration interacts badly with the
        # absolute alpha clamps (it stalls convergence).
        c_new = c_new - jnp.mean(c_new, axis=0, keepdims=True)

        # Monotone guard on the (scale-invariant) angular objective: in f32
        # the CG step direction degenerates to roundoff noise once
        # converged — never let it walk away from the incumbent.
        def ang_obj(cc):
            dd = cc[edge_j] - cc[edge_i]
            al = jnp.maximum(jnp.sum(t_world * dd, -1), alpha_eps) / jnp.maximum(
                jnp.sum(dd * dd, -1), alpha_eps**2
            )
            rr = al[:, None] * dd - t_world
            return jnp.sum(w * jnp.sum(rr * rr, -1))

        better = ang_obj(c_new) < ang_obj(c)
        return jnp.where(better, c_new, c), None

    c, _ = jax.lax.scan(outer, c, None, length=outer_iters)
    # Final gauge: mean edge length 1 (matches the reference convention).
    dn = jnp.linalg.norm(c[edge_j] - c[edge_i], axis=-1)
    return c / jnp.maximum(jnp.mean(dn), 1e-12)


def estimate_positions(
    view_graph,
    orientations: dict,
    estimator_type: int = GlobalPositionEstimatorType.LEAST_UNSQUARED_DEVIATION,
    fixed_views: set | None = None,
    dtype=np.float64,
    mesh=None,
):
    """Host driver: view graph + orientations → {view_id: position}.

    Parity: the `PositionEstimator::EstimatePositions` interface
    (`position_estimator.h:53`) as dispatched by
    `GlobalReconstructionEstimator::EstimatePosition`
    (`global_reconstruction_estimator.cc:418-452`).

    `mesh`: optional `jax.sharding.Mesh` — the edge axis of the LUD/
    nonlinear solves shards across it (SURVEY §7.9). Padded edges carry
    t_world = 0, i = j and a False mask, so the sharded solve matches the
    single-device trajectory exactly.
    """
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, _, rel_pos, weights = view_graph.edge_arrays(dtype)
    ei = np.asarray([index[v] for v in v1], np.int32)
    ej = np.asarray([index[v] for v in v2], np.int32)
    orient = np.zeros((V, 3), dtype)
    for v, aa in orientations.items():
        if v in index:
            orient[index[v]] = aa

    free = np.ones(V, bool)
    if fixed_views:
        for v in fixed_views:
            if v in index:
                free[index[v]] = False
    else:
        free[0] = False

    t_world = relative_translations_to_world(
        jnp.asarray(orient), jnp.asarray(ei), jnp.asarray(rel_pos)
    )

    ei_d, ej_d = jnp.asarray(ei), jnp.asarray(ej)
    edge_mask = None
    if (
        mesh is not None
        and estimator_type
        == GlobalPositionEstimatorType.LEAST_UNSQUARED_DEVIATION
    ):
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as _PS

        from ..parallel import pad_to_multiple

        n = int(np.prod(list(mesh.shape.values())))
        ax = mesh.axis_names[0]
        sh = NamedSharding(mesh, _PS(ax))
        E = len(ei)
        ei_p, _ = pad_to_multiple(ei, n)
        ej_p, _ = pad_to_multiple(ej, n)
        tw_p, _ = pad_to_multiple(np.asarray(t_world), n)
        w_p, _ = pad_to_multiple(np.asarray(weights), n)
        mask_p = np.zeros(len(ei_p), bool)
        mask_p[:E] = True
        ei_d = _jax.device_put(jnp.asarray(ei_p), sh)
        ej_d = _jax.device_put(jnp.asarray(ej_p), sh)
        t_world = _jax.device_put(jnp.asarray(tw_p), sh)
        weights = np.asarray(w_p)
        edge_mask = _jax.device_put(jnp.asarray(mask_p), sh)

    if estimator_type == GlobalPositionEstimatorType.NONLINEAR:
        # Reference initializes randomly (`nonlinear_position_estimator.h:97`)
        # then LM; LUD makes a far better init.
        init = least_unsquared_deviation_positions(
            jnp.asarray(ei), jnp.asarray(ej), t_world, jnp.asarray(free), V
        )
        out = nonlinear_positions(
            init, jnp.asarray(ei), jnp.asarray(ej), t_world,
            jnp.asarray(np.sqrt(weights)), jnp.asarray(free), V,
        )
    elif estimator_type == GlobalPositionEstimatorType.LINEAR_TRIPLET:
        out = linear_triplet_positions(
            jnp.asarray(ei), jnp.asarray(ej), t_world, jnp.asarray(weights), V
        )
    elif estimator_type == GlobalPositionEstimatorType.BATA:
        out = bata_positions(
            jnp.asarray(ei), jnp.asarray(ej), t_world, jnp.asarray(free), V
        )
    else:
        out = least_unsquared_deviation_positions(
            ei_d, ej_d, t_world, jnp.asarray(free), V,
            edge_mask=edge_mask,
        )
    out = np.asarray(out)
    return {v: out[index[v]] for v in view_ids}
