"""Levenberg-Marquardt bundle adjustment with an implicit Schur complement.

Batched replacement for the reference's Ceres-based bundle adjustment
(`/root/reference/src/theia/sfm/bundle_adjustment/bundle_adjuster.{h,cc}`,
`bundle_adjustment.{h,cc}` — call stack SURVEY.md §3.4). Ceres builds a
block-sparse problem (points = Schur group 0, cameras = group 1,
`bundle_adjuster.h:124`) and runs SPARSE_SCHUR / ITERATIVE_SCHUR. Here the
same math is expressed as flat batched tensor ops over the observation table.

Parameter blocks:
  extrinsics   [V, 6]   per view ([position, angle-axis], camera.h:204)
  intrinsics   [G, P]   per shared intrinsics GROUP (reconstruction.cc:131 —
                        Ceres dedups the shared_ptr parameter block; here the
                        group is explicit). The per-model free subset follows
                        `OptimizeIntrinsicsType` (`bundle_adjustment.h:71`,
                        `camera_intrinsics_model.h:118`).
  points       [T, K]   K=3 euclidean/XYZW-tangent, K=1 inverse depth;
                        `TrackParametrizationType`
                        (`reconstruction_estimator_options.h:92-95`,
                        `bundle_adjustment.h:127-131`):
                          XYZW           — dehomogenized 3-vector (same
                                           optimum as the reference's
                                           gauge-redundant 4-vector)
                          XYZW_MANIFOLD  — unit 4-vector, 3-DOF tangent steps
                                           (`SetHomogeneousPointParametrization`,
                                           bundle_adjuster.h:121)
                          INVERSE_DEPTH  — scalar per track w.r.t. a stored
                                           reference-view bearing
                                           (`bundle_adjuster.h:79` AddInvTrack,
                                           track.h:80-88)

Gauss-Newton normal equations, with points eliminated by the Schur
complement. Nothing dense over cameras is materialized: S x is applied
observation-wise

  y   = Jc xc[v(o)] + Jr xc[ref(t(o))] + Ji xi[g(o)]          [O, 2]
  S x = Jcamᵀy − Jcamᵀ Jp V⁻¹ Jpᵀ y + μ D x                   (gathers +
                                                               segment-sums)

and solved by PCG with the block-Jacobi (Schur-Jacobi) preconditioner — the
reference's ITERATIVE_SCHUR + SCHUR_JACOBI configuration
(`reconstruction_estimator_options.h:291-300`) as pure XLA, with the PCG
early-exiting on `linear_solver_tolerance`. Point updates back-substitute
per track. The LM loop (damping, accept/reject) runs as `lax.while_loop`
so one `jit` covers the whole optimization.

Mixed camera models are supported: observations dispatch through
`lax.switch` over the models actually present (one branch = zero overhead).

Masks make the system partial: `BundleAdjustPartialReconstruction`,
`BundleAdjustView(s)`, `BundleAdjustTrack(s)` (`bundle_adjustment.h:181-219`)
are all this kernel with different constant-masks.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp

from ..models import intrinsics as intr
from ..models.intrinsics import OptimizeIntrinsicsType
from ..ops import rotation as rotops
from .losses import LossFunctionType, loss_rho, loss_weight

__all__ = [
    "BundleAdjustmentOptions",
    "BundleAdjustmentSummary",
    "TrackParametrizationType",
    "LinearSolverType",
    "OptimizeIntrinsicsType",
    "bundle_adjust",
    "hessian_blocks",
    "inv3x3",
    "inv_small_spd",
]


class TrackParametrizationType(enum.IntEnum):
    """Parity: `reconstruction_estimator_options.h:93-95`."""

    XYZW = 0
    XYZW_MANIFOLD = 1
    INVERSE_DEPTH = 2


class LinearSolverType(enum.IntEnum):
    """Camera-system solver selection. Parity with the reference's Ceres
    config (`reconstruction_estimator_options.h:291-300`): SPARSE_SCHUR
    below `min_cameras_for_iterative_solver` (=1000), ITERATIVE_SCHUR +
    SCHUR_JACOBI above. Here the small/medium case is a *dense*
    materialized Schur complement + dense Cholesky (`ba/dense_schur.py`);
    the large case is implicit-Schur PCG (`ba/lm.py`)."""

    AUTO = 0
    DENSE_SCHUR = 1
    ITERATIVE_SCHUR = 2


@dataclasses.dataclass(frozen=True)
class BundleAdjustmentOptions:
    """Parity: `theia::BundleAdjustmentOptions`
    (`bundle_adjustment.h:87-167`) — fields that map to this solver."""

    loss_function_type: LossFunctionType = LossFunctionType.TRIVIAL
    robust_loss_width: float = 2.0
    max_num_iterations: int = 100
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    # Camera-system solver: AUTO picks DENSE_SCHUR below
    # `dense_schur.DENSE_SCHUR_MAX_CAMERAS` cameras, ITERATIVE_SCHUR above
    # (the reference's min_cameras_for_iterative_solver crossover).
    linear_solver_type: LinearSolverType = LinearSolverType.AUTO
    # bf16 matmuls (f32 accumulation) for the dense Schur product —
    # parity: `use_mixed_precision_solves` (`bundle_adjustment.h:111`).
    use_mixed_precision_solves: bool = False
    # Implicit-Schur PCG controls (ITERATIVE_SCHUR + SCHUR_JACOBI).
    # Tolerance matches Ceres's ITERATIVE_SCHUR default forcing tolerance
    # eta = 0.1 (the reference never overrides it); LM absorbs the inexact
    # steps, and a tighter 1e-2 setting doubled PCG trips for no ATE gain.
    linear_solver_iterations: int = 40
    linear_solver_tolerance: float = 0.1
    # LM trust region.
    initial_trust_region_radius: float = 1e4
    # LM iterations per DEVICE LAUNCH. The whole LM loop is one XLA
    # program; the host wrapper re-launches the kernel in chunks of this
    # size, carrying damping state — identical math, at most two compiled
    # variants (full chunk + remainder) — so no single device program runs
    # for long, and the host sees progress between chunks. Whether the
    # chunking is needed at all on the GPU is not measured yet.
    max_iterations_per_launch: int = 25
    # What to optimize (mirrors constant_camera_* flags / intrinsics subsets).
    optimize_cameras: bool = True
    optimize_points: bool = True
    # Intrinsics subset optimization (`bundle_adjustment.h:120` —
    # `OptimizeIntrinsicsType` bitmask applied per camera model).
    intrinsics_to_optimize: OptimizeIntrinsicsType = OptimizeIntrinsicsType.NONE
    # Track parametrization (`bundle_adjustment.h:127-131`).
    track_parametrization_type: TrackParametrizationType = (
        TrackParametrizationType.XYZW
    )
    # View priors (`bundle_adjustment.h:154-166`, residuals from
    # position_error.h / orientation_error.h / gravity_error.h).
    use_position_priors: bool = False
    use_orientation_priors: bool = False
    use_gravity_priors: bool = False
    verbose: bool = False
    # Device mesh for multi-chip BA (`jax.sharding.Mesh`, 1-D). Through the
    # public entries (`ba/entry.py`): the dense-Schur path runs its Schur
    # product as an explicit shard_map + psum over the track axis
    # (`dense_schur.py:283`); the rowchunk iterative path shards its slot
    # arrays over the mesh and lets GSPMD insert the collectives. None =
    # single device. (SURVEY §7.9 — no reference analogue; Ceres is
    # single-process.)
    mesh: object = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BundleAdjustmentSummary:
    """Parity: `theia::BundleAdjustmentSummary` (`bundle_adjustment.h:170`).

    `final_mu` carries the LM damping across launch chunks (see
    `BundleAdjustmentOptions.max_iterations_per_launch`); `converged`
    lets the launch-chunking host loop stop when convergence lands
    exactly on a chunk boundary (otherwise indistinguishable from budget
    exhaustion)."""

    success: jax.Array
    initial_cost: jax.Array
    final_cost: jax.Array
    num_iterations: jax.Array
    final_mu: jax.Array = None
    converged: jax.Array = None


# ---------------------------------------------------------------------------
# Residuals.
# ---------------------------------------------------------------------------


def _pixel_of(params, p_cam, present_models, model_idx):
    """Project a camera-frame point through this observation's model.

    With one model present the dispatch is static (no switch in the HLO);
    with a mixed rig `lax.switch` selects among the present models only.
    """
    if len(present_models) == 1:
        return intr.camera_to_pixel(params, p_cam, present_models[0])
    branches = [
        (lambda q, p, m=m: intr.camera_to_pixel(q, p, m)) for m in present_models
    ]
    return jax.lax.switch(model_idx, branches, params, p_cam)


def _residual_at_point(e6, params, p_world, uv, sqrt_info, present_models, model_idx):
    """One observation's weighted reprojection residual (2-vector).

    Mirrors `theia::ReprojectionError` (`camera/reprojection_error.h:50-115`):
    translate, guard near-center points, rotate, project through the camera
    model, weight by the sqrt information of the feature covariance.
    """
    adjusted = p_world - e6[:3]
    # Near-center guard (reprojection_error.h:69-80): freeze the residual
    # rather than dividing by ~0.
    too_close = jnp.sum(adjusted * adjusted) < 1e-8
    p_cam = rotops.angle_axis_rotate_point(e6[3:], adjusted)
    pixel = _pixel_of(params, p_cam, present_models, model_idx)
    r = sqrt_info * (pixel - uv)
    return jnp.where(too_close, jnp.zeros_like(r), r)


def _tangent_basis4(x4):
    """Orthonormal basis [4,3] of the tangent space at unit 4-vector x4
    (Householder construction — the homogeneous-point manifold of
    `SetHomogeneousPointParametrization`, bundle_adjuster.h:121)."""
    n = jnp.linalg.norm(x4)
    xh = x4 / jnp.maximum(n, 1e-12)
    sign = jnp.where(xh[3] >= 0, 1.0, -1.0).astype(x4.dtype)
    v = xh + sign * jnp.asarray([0.0, 0.0, 0.0, 1.0], x4.dtype)
    H = jnp.eye(4, dtype=x4.dtype) - 2.0 * jnp.outer(v, v) / jnp.maximum(
        jnp.dot(v, v), 1e-12
    )
    return H[:, :3]


def _point_tangent_basis4(x4):
    """Well-conditioned projective tangent basis [4,3] at unit 4-vector x4.

    Any basis transverse to span(x4) parametrizes the same local projective
    chart (the update renormalizes), so the basis is a free conditioning
    choice. The orthonormal sphere basis makes the point Jacobian
    Jp = d(pixel)/d(delta) carry a factor ~ 1/w per unit tangent step: its
    normal matrix V_t = Jp^T Jp is then cond(M)^2 ~ 1/w^2 worse-conditioned
    than the Euclidean parametrization's, and in f32 the per-track
    elimination V^-1 turns that into step noise that caps LM convergence —
    measured on the 2152-view ring: sphere basis stalled at cost 106e3 /
    0.21 m median after 50 iterations (more PCG iterations change nothing:
    the matvec itself is noise-limited), while the Euclidean XYZW
    parametrization reached 101e3 / 6.4 mm in 14.

    This basis instead solves  (dp/dx4) B = I_3  on the chart p = xyz/w:
    B = w * B_s inv(M3) with M3 = [I | -p] B_s (invertible on the tangent —
    its kernel span(x4) is transverse). Point-block conditioning becomes
    IDENTICAL to the Euclidean parametrization while the state keeps full
    homogeneous generality. Near w = 0 (points at infinity, where p
    overflows) it falls back to the sphere basis — conditioning there is
    fine because pixels depend only on the direction."""
    n = jnp.linalg.norm(x4)
    xh = x4 / jnp.maximum(n, 1e-12)
    Bs = _tangent_basis4(x4)
    w = xh[3]
    # Guarded chart: |w| >= tau keeps cond(M3) <= ~1/tau (f32-safe).
    tau = jnp.asarray(1e-3, x4.dtype)
    safe = jnp.abs(w) > tau
    wsafe = jnp.where(safe, w, 1.0)
    p = xh[:3] / wsafe
    M3 = Bs[:3, :] - p[:, None] * Bs[3, :][None, :]  # [I | -p] B_s
    Bc = wsafe * (Bs @ inv3x3(M3))
    return jnp.where(safe, Bc, Bs)


def _invdepth_world_point(rho, ref_e6, bearing):
    """World point of an inverse-depth track: X = c_ref + R_refᵀ (b / ρ)
    (parity: the inverse-depth reprojection functor,
    `camera/reprojection_error.h` inverse-depth variant + track.h:80-88)."""
    depth = 1.0 / jnp.where(jnp.abs(rho) < 1e-12, 1e-12, rho)
    p_ref = bearing * depth
    return ref_e6[:3] + rotops.angle_axis_rotate_point(-ref_e6[3:], p_ref)


class _Problem:
    """Static description + per-iteration residual/Jacobian builder."""

    def __init__(
        self,
        obs,
        view_group,
        track_ref_view,
        track_bearing,
        present_models,
        group_model_idx,
        track_param,
        loss,
        loss_width,
        dtype,
    ):
        (self.obs_view, self.obs_track, self.obs_uv, self.obs_info, self.obs_mask) = obs
        self.view_group = view_group
        self.obs_group = view_group[self.obs_view]
        self.track_ref_view = track_ref_view
        self.track_bearing = track_bearing
        self.present_models = present_models
        self.model_idx_o = group_model_idx[self.obs_group]
        self.track_param = track_param
        self.loss = loss
        self.loss_width = loss_width
        self.dtype = dtype
        self.K = 1 if track_param == TrackParametrizationType.INVERSE_DEPTH else 3
        self.invdepth = track_param == TrackParametrizationType.INVERSE_DEPTH
        self.manifold = track_param == TrackParametrizationType.XYZW_MANIFOLD

    def residuals(self, extrinsics, intrinsics, points, with_jac,
                  want_intr_jac=True, intr_rows=None):
        """Robust-weighted residuals r [O,2]; if with_jac also
        (Jc [O,2,6], Jr [O,2,6] or None, Ji [O,2,P] or None, Jp [O,2,K]).

        `want_intr_jac=False` statically drops the intrinsics Jacobian —
        the frozen-intrinsics specialization (the common case: Ceres simply
        has no intrinsics parameter blocks when OptimizeIntrinsicsType is
        NONE, `bundle_adjuster.cc:315`).

        `intr_rows` ([O, P]): pre-gathered per-observation intrinsics. With
        frozen intrinsics the gather is loop-invariant but XLA does not
        hoist gathers out of `while_loop` bodies, so callers hoist it
        themselves."""
        ov, ot = self.obs_view, self.obs_track
        ext_o = extrinsics[ov]
        intr_o = intrinsics[self.obs_group] if intr_rows is None else intr_rows
        pm, mi = self.present_models, self.model_idx_o

        if self.invdepth:
            ref_o = self.track_ref_view[ot]
            ref_e6 = extrinsics[ref_o]
            bearing_o = self.track_bearing[ot]
            rho_o = points[ot][:, 0]

            def f(e6, q, rho, re6, b, uv, si, idx):
                p_w = _invdepth_world_point(rho, re6, b)
                return _residual_at_point(e6, q, p_w, uv, si, pm, idx)

            def rj(e6, q, rho, re6, b, uv, si, idx):
                r = f(e6, q, rho, re6, b, uv, si, idx)
                Jc = jax.jacfwd(f, 0)(e6, q, rho, re6, b, uv, si, idx)
                Ji = (
                    jax.jacfwd(f, 1)(e6, q, rho, re6, b, uv, si, idx)
                    if want_intr_jac
                    else 0
                )
                Jp = jax.jacfwd(f, 2)(e6, q, rho, re6, b, uv, si, idx)[..., None]
                Jr = jax.jacfwd(f, 3)(e6, q, rho, re6, b, uv, si, idx)
                return r, Jc, Jr, Ji, Jp

            fn = rj if with_jac else (lambda *a: (f(*a), 0, 0, 0, 0))
            out = jax.vmap(fn)(
                ext_o, intr_o, rho_o, ref_e6, bearing_o,
                self.obs_uv, self.obs_info, mi,
            )
            r, Jc, Jr, Ji, Jp = out
        elif self.manifold:
            x4_o = points[ot]  # [O, 4]
            basis_o = jax.vmap(_point_tangent_basis4)(points)[ot]  # [O, 4, 3]

            def f(e6, q, d3, x4, B, uv, si, idx):
                x4n = x4 + B @ d3
                w = x4n[3]
                w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
                return _residual_at_point(e6, q, x4n[:3] / w, uv, si, pm, idx)

            zeros3 = jnp.zeros((ext_o.shape[0], 3), self.dtype)

            def rj(e6, q, d3, x4, B, uv, si, idx):
                r = f(e6, q, d3, x4, B, uv, si, idx)
                Jc = jax.jacfwd(f, 0)(e6, q, d3, x4, B, uv, si, idx)
                Ji = (
                    jax.jacfwd(f, 1)(e6, q, d3, x4, B, uv, si, idx)
                    if want_intr_jac
                    else 0
                )
                Jp = jax.jacfwd(f, 2)(e6, q, d3, x4, B, uv, si, idx)
                return r, Jc, None, Ji, Jp

            fn = rj if with_jac else (lambda *a: (f(*a), 0, None, 0, 0))
            r, Jc, Jr, Ji, Jp = jax.vmap(fn)(
                ext_o, intr_o, zeros3, x4_o, basis_o,
                self.obs_uv, self.obs_info, mi,
            )
        else:
            pts_o = points[ot]  # [O, 3]

            def f(e6, q, p3, uv, si, idx):
                return _residual_at_point(e6, q, p3, uv, si, pm, idx)

            def rj(e6, q, p3, uv, si, idx):
                r = f(e6, q, p3, uv, si, idx)
                Jc = jax.jacfwd(f, 0)(e6, q, p3, uv, si, idx)
                Ji = (
                    jax.jacfwd(f, 1)(e6, q, p3, uv, si, idx)
                    if want_intr_jac
                    else 0
                )
                Jp = jax.jacfwd(f, 2)(e6, q, p3, uv, si, idx)
                return r, Jc, None, Ji, Jp

            fn = rj if with_jac else (lambda *a: (f(*a), 0, None, 0, 0))
            r, Jc, Jr, Ji, Jp = jax.vmap(fn)(
                ext_o, intr_o, pts_o, self.obs_uv, self.obs_info, mi
            )

        # Robust IRLS weights on the squared norm.
        s = jnp.sum(r * r, axis=-1)
        w = loss_weight(s, self.loss, self.loss_width) * self.obs_mask.astype(
            self.dtype
        )
        sw = jnp.sqrt(w)[..., None]
        if not with_jac:
            return r * sw, s
        scale = sw[..., None]
        Jc = Jc * scale
        Ji = Ji * scale if want_intr_jac else None
        Jp = Jp * scale
        if self.invdepth:
            Jr = Jr * scale
        return r * sw, Jc, Jr, Ji, Jp, s

    def cost(self, extrinsics, intrinsics, points, intr_rows=None):
        _, s = self.residuals(
            extrinsics, intrinsics, points, with_jac=False,
            intr_rows=intr_rows,
        )
        raw = loss_rho(s, self.loss, self.loss_width) * self.obs_mask.astype(
            self.dtype
        )
        return 0.5 * jnp.sum(raw)

    def apply_step(self, points, dp):
        """Apply the point update in the parametrization's chart."""
        if self.invdepth:
            return points + dp
        if self.manifold:
            basis = jax.vmap(_point_tangent_basis4)(points)
            new = points + jnp.einsum("tij,tj->ti", basis, dp)
            n = jnp.linalg.norm(new, axis=-1, keepdims=True)
            return new / jnp.maximum(n, 1e-12)
        return points + dp


def _segment_sum(values, segment_ids, num_segments):
    return jax.ops.segment_sum(values, segment_ids, num_segments=num_segments)


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det).

    `jnp.linalg.inv` on batched 3x3 lowers to a pivoted LU per matrix; the
    adjugate is a few fused elementwise ops.
    """
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 0, 2]
    d = A[..., 1, 0]
    e = A[..., 1, 1]
    f = A[..., 1, 2]
    g = A[..., 2, 0]
    h = A[..., 2, 1]
    i = A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def inv_small_spd(A, K: int):
    """Batched small SPD inverse without LAPACK loops: closed-form for
    K in {1, 3}, 3+3 block-Schur built on `inv3x3` for K=6.

    (A Newton polish step was tried and REMOVED: for the near-singular
    damped blocks BA produces, X(2I-AX) amplifies the adjugate's rounding
    instead of contracting it.)"""
    if K == 1:
        return 1.0 / jnp.where(jnp.abs(A) < 1e-30, 1e-30, A)
    if K == 3:
        return inv3x3(A)
    if K == 6:
        A11 = A[..., :3, :3]
        A12 = A[..., :3, 3:]
        A22 = A[..., 3:, 3:]
        A11i = inv3x3(A11)
        S = A22 - jnp.einsum("...ji,...jk,...kl->...il", A12, A11i, A12)
        Si = inv3x3(S)
        X = jnp.einsum("...ij,...jk->...ik", A11i, A12)
        B12 = -jnp.einsum("...ij,...jk->...ik", X, Si)
        B11 = A11i - jnp.einsum("...ij,...kj->...ik", B12, X)
        top = jnp.concatenate([B11, B12], axis=-1)
        bot = jnp.concatenate([jnp.swapaxes(B12, -1, -2), Si], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)
    return jnp.linalg.inv(A)


# ---------------------------------------------------------------------------
# Priors (position / orientation / gravity), camera blocks only.
# ---------------------------------------------------------------------------


def _prior_residual(e6, priors_row, dtype):
    """Per-view prior residual [9] = [position(3), orientation(3), gravity(3)].

    Parity: `position_error.h` (sqrt_info (p - p_prior)), `orientation_error.h`
    (sqrt_info log(R R_priorᵀ)), `gravity_error.h`
    (sqrt_info (R (0,0,-1) - g_prior)); masks zero unset priors.
    """
    (pp, psi, pm, op, osi, om, gp, gsi, gm) = priors_row
    r_pos = (psi @ (e6[:3] - pp)) * pm
    R = rotops.angle_axis_to_rotation_matrix(e6[3:])
    Rp = rotops.angle_axis_to_rotation_matrix(op)
    r_ori = (osi @ rotops.rotation_matrix_to_angle_axis(R @ Rp.T)) * om
    g_world = jnp.asarray([0.0, 0.0, -1.0], dtype)
    g_cam = R @ g_world
    r_grav = (gsi @ (g_cam - gp)) * gm
    return jnp.concatenate([r_pos, r_ori, r_grav])


def _prior_blocks(extrinsics, priors, dtype):
    """Residuals + Jacobians of all view priors: ([V, 9], [V, 9, 6])."""

    def rj(e6, *row):
        f = lambda e: _prior_residual(e, row, dtype)
        return f(e6), jax.jacfwd(f)(e6)

    return jax.vmap(rj)(extrinsics, *priors)


# ---------------------------------------------------------------------------
# Covariance support blocks (used by the *WithCov entry points).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("model", "num_views", "num_tracks", "options"))
def hessian_blocks(
    extrinsics,
    points,
    intrinsics_rows,
    obs_view,
    obs_track,
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    model: int,
    num_views: int,
    num_tracks: int,
    options: BundleAdjustmentOptions,
):
    """Per-view [V,6,6] and per-track [T,3,3] Gauss-Newton Hessian blocks
    plus the total robust cost and residual count.

    These are what `ceres::Covariance` inverts when the other parameter
    group is held constant (`bundle_adjuster.cc:660-744`): for
    BundleAdjustView(s)WithCov / BundleAdjustTrack(s)WithCov the problem is
    block-diagonal, so cov(view) = sigma^2 U_v^{-1} exactly.
    """
    dtype = extrinsics.dtype
    loss = options.loss_function_type
    width = options.robust_loss_width

    def f(e6, q, p3, uv, si):
        return _residual_at_point(e6, q, p3, uv, si, (model,), 0)

    def rj(e6, q, p3, uv, si):
        r = f(e6, q, p3, uv, si)
        Jc = jax.jacfwd(f, 0)(e6, q, p3, uv, si)
        Jp = jax.jacfwd(f, 2)(e6, q, p3, uv, si)
        return r, Jc, Jp

    r, Jc, Jp = jax.vmap(rj)(
        extrinsics[obs_view], intrinsics_rows, points[obs_track], obs_uv, obs_sqrt_info
    )
    s = jnp.sum(r * r, axis=-1)
    w = loss_weight(s, loss, width) * obs_mask.astype(dtype)
    sw = jnp.sqrt(w)[..., None]
    r, Jc, Jp = r * sw, Jc * sw[..., None], Jp * sw[..., None]
    U = _segment_sum(jnp.einsum("ori,orj->oij", Jc, Jc), obs_view, num_views)
    Vt = _segment_sum(jnp.einsum("ori,orj->oij", Jp, Jp), obs_track, num_tracks)
    cost = jnp.sum(loss_rho(s, loss, width) * obs_mask.astype(dtype))
    return U, Vt, cost, jnp.sum(obs_mask)


# ---------------------------------------------------------------------------
# The LM kernel.
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "present_models",
        "num_views",
        "num_tracks",
        "num_groups",
        "options",
    ),
)
def _bundle_adjust_impl(
    extrinsics,  # [V, 6]
    intrinsics,  # [G, P] per shared intrinsics group
    points,  # [T, 3] | [T, 4] (manifold) | [T, 1] (inverse depth)
    view_group,  # [V] int32 — intrinsics group of each view
    group_model_idx,  # [G] int32 — index into present_models per group
    obs_view,  # [O]
    obs_track,  # [O]
    obs_uv,  # [O, 2]
    obs_sqrt_info,  # [O, 2]
    obs_mask,  # [O] bool
    camera_free,  # [V] or [V, 6] bool — extrinsic DOFs allowed to move
    point_free,  # [T] bool — points allowed to move
    intrinsics_free,  # [G, P] bool — per-group free intrinsics subset
    track_ref_view,  # [T] int32 (INVERSE_DEPTH only; else zeros)
    track_bearing,  # [T, 3] (INVERSE_DEPTH only; else zeros)
    present_models: tuple,  # static: camera model types present
    num_views: int,
    num_tracks: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,  # optional 9-tuple of per-view prior arrays (see _prior_residual)
    mu0=None,  # optional traced LM damping carried across launches
):
    """One LAUNCH of the LM loop (up to options.max_num_iterations
    iterations). Returns (extrinsics, intrinsics, points, summary); the
    public `bundle_adjust` wrapper chains launches."""
    dtype = extrinsics.dtype
    V, T, G = num_views, num_tracks, num_groups
    P = intrinsics.shape[1]

    prob = _Problem(
        (obs_view, obs_track, obs_uv, obs_sqrt_info, obs_mask),
        view_group,
        track_ref_view,
        track_bearing,
        present_models,
        group_model_idx,
        options.track_parametrization_type,
        options.loss_function_type,
        options.robust_loss_width,
        dtype,
    )
    K = prob.K
    obs_group = prob.obs_group
    invdepth = prob.invdepth
    ref_o = track_ref_view[obs_track] if invdepth else None

    # camera_free may be [V] (whole camera) or [V, 6] (per-DOF — e.g. the
    # hybrid pipeline holds orientations constant, HSfM Cui CVPR'17).
    if camera_free.ndim == 1:
        camera_free = camera_free[..., None]
    cam_free = (camera_free & options.optimize_cameras).astype(dtype)
    cam_free = jnp.broadcast_to(cam_free, (V, 6))
    pt_free = (point_free & options.optimize_points)[..., None].astype(dtype)
    intr_free = intrinsics_free.astype(dtype)

    def cost_of(state):
        ext, q, pts = state
        c = prob.cost(ext, q, pts)
        if priors is not None:
            r_pr, _ = _prior_blocks(ext, priors, dtype)
            c = c + 0.5 * jnp.sum(r_pr * r_pr)
        return c

    # Static frozen-intrinsics specialization: with
    # `intrinsics_to_optimize == NONE` (the common case) there simply are
    # no intrinsics parameter blocks — no Ji, no intrinsics preconditioner,
    # no intrinsics half of the PCG state. The round-2 kernel computed and
    # zeroed all of it at runtime, which cost ~2x.
    has_intr = options.intrinsics_to_optimize != OptimizeIntrinsicsType.NONE

    def lm_step(state, mu):
        """One LM iteration: build blocks, PCG-solve the camera system,
        back-substitute points, propose a step."""
        ext_c, intr_c, pts_c = state
        r, Jc, Jr, Ji, Jp, _ = prob.residuals(
            ext_c, intr_c, pts_c, with_jac=True, want_intr_jac=has_intr
        )

        # Freeze constant parameters by zeroing their Jacobian columns.
        Jc = Jc * cam_free[obs_view][:, None, :]
        if has_intr:
            Ji = Ji * intr_free[obs_group][:, None, :]
        Jp = Jp * pt_free[obs_track][:, None, :]
        if invdepth:
            Jr = Jr * cam_free[ref_o][:, None, :]

        if priors is not None:
            r_pr, J_pr = _prior_blocks(ext_c, priors, dtype)
            J_pr = J_pr * cam_free[:, None, :]
        else:
            r_pr = J_pr = None

        # Gradients (RHS). b = -Jᵀ r per block.
        bc = -_segment_sum(jnp.einsum("ori,or->oi", Jc, r), obs_view, V)
        if invdepth:
            bc = bc - _segment_sum(jnp.einsum("ori,or->oi", Jr, r), ref_o, V)
        bp = -_segment_sum(jnp.einsum("ori,or->oi", Jp, r), obs_track, T)
        if J_pr is not None:
            bc = bc - jnp.einsum("vri,vr->vi", J_pr, r_pr)

        # Damping diagonals D = diag(JᵀJ), clamped away from zero.
        Dc = _segment_sum(jnp.einsum("ori,ori->oi", Jc, Jc), obs_view, V)
        if invdepth:
            Dc = Dc + _segment_sum(jnp.einsum("ori,ori->oi", Jr, Jr), ref_o, V)
        if J_pr is not None:
            Dc = Dc + jnp.einsum("vri,vri->vi", J_pr, J_pr)
        Dc = jnp.maximum(Dc, 1e-6)
        if has_intr:
            bi = -_segment_sum(jnp.einsum("ori,or->oi", Ji, r), obs_group, G)
            Di = jnp.maximum(
                _segment_sum(jnp.einsum("ori,ori->oi", Ji, Ji), obs_group, G),
                1e-6,
            )

        # Point blocks, damped, inverted ([T,K,K] with K in {1,3}).
        Vt = _segment_sum(jnp.einsum("ori,orj->oij", Jp, Jp), obs_track, T)
        diagVt = jnp.einsum("tii->ti", Vt)
        eyeK = jnp.eye(K, dtype=dtype)
        Vt_d = Vt + mu * (eyeK * jnp.maximum(diagVt, 1e-6)[..., None, :]) + 1e-10 * eyeK
        Vinv = inv_small_spd(Vt_d, K)

        # Camera-side operator pieces (observation-wise, never materialized).
        # Vectors over the camera side are length-1 (cams) or length-2
        # (cams, intrinsics) tuples depending on the static `has_intr`.
        def jcam_apply(xs):
            y = jnp.einsum("ori,oi->or", Jc, xs[0][obs_view])
            if invdepth:
                y = y + jnp.einsum("ori,oi->or", Jr, xs[0][ref_o])
            if has_intr:
                y = y + jnp.einsum("ori,oi->or", Ji, xs[1][obs_group])
            return y

        def jcam_adjoint(y):
            gc = _segment_sum(jnp.einsum("ori,or->oi", Jc, y), obs_view, V)
            if invdepth:
                gc = gc + _segment_sum(jnp.einsum("ori,or->oi", Jr, y), ref_o, V)
            if has_intr:
                gi = _segment_sum(jnp.einsum("ori,or->oi", Ji, y), obs_group, G)
                return (gc, gi)
            return (gc,)

        def S_mv(xs):
            y = jcam_apply(xs)
            a = jcam_adjoint(y)
            t = _segment_sum(jnp.einsum("ori,or->oi", Jp, y), obs_track, T)
            z = jnp.einsum("tij,tj->ti", Vinv, t)
            w = jnp.einsum("ori,oi->or", Jp, z[obs_track])
            b = jcam_adjoint(w)
            sc = a[0] - b[0] + mu * Dc * xs[0]
            if J_pr is not None:
                sc = sc + jnp.einsum("vri,vrj,vj->vi", J_pr, J_pr, xs[0])
            if has_intr:
                return (sc, a[1] - b[1] + mu * Di * xs[1])
            return (sc,)

        # Reduced RHS: g = b_cam - Jcamᵀ Jp V⁻¹ bp.
        Vinv_bp = jnp.einsum("tij,tj->ti", Vinv, bp)
        w0 = jnp.einsum("ori,oi->or", Jp, Vinv_bp[obs_track])
        corr = jcam_adjoint(w0)
        g = (
            (bc - corr[0], bi - corr[1]) if has_intr else (bc - corr[0],)
        )

        # Schur-Jacobi preconditioner: diagonal blocks of S per view/group.
        Uv = _segment_sum(jnp.einsum("ori,orj->oij", Jc, Jc), obs_view, V)
        if invdepth:
            Uv = Uv + _segment_sum(jnp.einsum("ori,orj->oij", Jr, Jr), ref_o, V)
        if J_pr is not None:
            Uv = Uv + jnp.einsum("vri,vrj->vij", J_pr, J_pr)
        Wc = jnp.einsum("ori,orj->oij", Jc, Jp)  # [O, 6, K]
        corr_v = _segment_sum(
            jnp.einsum("oij,ojk,olk->oil", Wc, Vinv[obs_track], Wc), obs_view, V
        )
        eye6 = jnp.eye(6, dtype=dtype)
        Mv = Uv - corr_v + mu * (eye6 * Dc[..., None, :])
        Mv = Mv + (1.0 - cam_free)[..., None, :] * eye6 + 1e-8 * eye6
        Mv_inv = inv_small_spd(Mv, 6)

        if has_intr:
            Ug = _segment_sum(jnp.einsum("ori,orj->oij", Ji, Ji), obs_group, G)
            Wi = jnp.einsum("ori,orj->oij", Ji, Jp)  # [O, P, K]
            corr_g = _segment_sum(
                jnp.einsum("oij,ojk,olk->oil", Wi, Vinv[obs_track], Wi),
                obs_group,
                G,
            )
            eyeP = jnp.eye(P, dtype=dtype)
            Mg = Ug - corr_g + mu * (eyeP * Di[..., None, :])
            Mg = Mg + (1.0 - intr_free)[..., None, :] * eyeP + 1e-8 * eyeP
            Mg_inv = jnp.linalg.inv(Mg)

        def precond(xs):
            pc = jnp.einsum("vij,vj->vi", Mv_inv, xs[0])
            if has_intr:
                return (pc, jnp.einsum("gij,gj->gi", Mg_inv, xs[1]))
            return (pc,)

        def dot(a, b):
            return sum(jnp.sum(x * y) for x, y in zip(a, b))

        # PCG on S dx = g with relative-residual early exit
        # (linear_solver_tolerance, mirroring Ceres' per-solve eta).
        g_norm2 = dot(g, g)
        tol2 = (options.linear_solver_tolerance**2) * g_norm2

        def pcg_cond(carry):
            _, rres, _, _, rz, i = carry
            return (i < options.linear_solver_iterations) & (dot(rres, rres) > tol2)

        def pcg_body(carry):
            x, rres, z, p, rz, i = carry
            Sp = S_mv(p)
            pSp = dot(p, Sp)
            alpha = rz / jnp.where(pSp == 0, 1.0, pSp)
            x = jax.tree_util.tree_map(lambda a, b: a + alpha * b, x, p)
            rres = jax.tree_util.tree_map(lambda a, b: a - alpha * b, rres, Sp)
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
        dc = dxs[0]
        di = dxs[1] if has_intr else jnp.zeros_like(intr_c)

        # Back-substitute points: dp = V⁻¹ (bp − Jpᵀ Jcam dx).
        y = jcam_apply(dxs)
        t = _segment_sum(jnp.einsum("ori,or->oi", Jp, y), obs_track, T)
        dp = jnp.einsum("tij,tj->ti", Vinv, bp - t)

        dc = dc * cam_free
        di = di * intr_free
        dp = dp * pt_free
        new_state = (ext_c + dc, intr_c + di, prob.apply_step(pts_c, dp))

        # Predicted reduction for the gain ratio:
        # 0.5 * dxᵀ (mu * D * dx + g) with g = -Jᵀ r (= b here).
        pred = 0.5 * (
            jnp.sum(dc * (mu * Dc * dc + bc))
            + jnp.sum(dp * (mu * jnp.maximum(diagVt, 1e-6) * dp + bp))
        )
        if has_intr:
            pred = pred + 0.5 * jnp.sum(di * (mu * Di * di + bi))
        return new_state, pred

    state0 = (extrinsics, intrinsics, points)
    initial_cost = cost_of(state0)

    def while_cond(carry):
        state, mu, cost, it, done = carry
        return (~done) & (it < options.max_num_iterations)

    def while_body(carry):
        state, mu, cost, it, done = carry
        new_state, pred = lm_step(state, mu)
        new_cost = cost_of(new_state)
        actual = cost - new_cost
        accept = (actual > 0) & jnp.isfinite(new_cost)
        # Damping schedule (classic LM x2 / x3 rules on the gain).
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


def run_launch_chunked(impl, state, options: BundleAdjustmentOptions):
    """Drive an LM kernel launch-by-launch (see
    `BundleAdjustmentOptions.max_iterations_per_launch`): `impl(state,
    chunk_options, mu0)` runs ONE launch and returns (state, summary);
    damping (`summary.final_mu`) carries across launches; a launch that
    stops before its budget means convergence. At most two program
    variants compile (full chunk + remainder)."""
    import dataclasses as _dc

    import jax.core as _core

    tracing = any(
        isinstance(x, _core.Tracer) for x in jax.tree_util.tree_leaves(state)
    )
    if tracing:
        # Called under an outer jit (e.g. a sharded training step): host
        # chunking is impossible — run the whole budget as one launch and
        # let the caller own the execution-length tradeoff.
        return impl(state, options, None)

    total = options.max_num_iterations
    cap = max(int(options.max_iterations_per_launch), 1)
    if total <= 0:
        # Zero-iteration budget: report the current state unchanged (the
        # while loop below would otherwise leave summary undefined).
        state_leaves = jax.tree_util.tree_leaves(state)
        dt = state_leaves[0].dtype if state_leaves else jnp.float32
        zero = jnp.zeros((), dt)
        return state, BundleAdjustmentSummary(
            success=jnp.asarray(True),
            initial_cost=zero,
            final_cost=zero,
            num_iterations=jnp.asarray(0, jnp.int32),
            final_mu=jnp.asarray(
                1.0 / options.initial_trust_region_radius, dt
            ),
        )
    done = 0
    mu = None
    first_initial = None
    summary = None
    from ..utils import counters

    while done < total:
        chunk = min(cap, total - done)
        chunk_options = _dc.replace(options, max_num_iterations=chunk)
        counters.bump("ba_launch")
        state, summary = impl(state, chunk_options, mu)
        # ONE batched pull for the per-chunk control values: each separate
        # int()/bool() is a blocking device->host transfer, and this loop
        # runs once per launch chunk.
        from ..utils.fetch import fetch

        if summary.converged is not None:
            n, conv = fetch((summary.num_iterations, summary.converged))
        else:
            n, conv = fetch(summary.num_iterations), False
        n = int(n)
        done += n
        mu = summary.final_mu
        if first_initial is None:
            first_initial = summary.initial_cost
        if n < chunk:
            break  # converged (or immediately rejected) inside the launch
        if bool(conv):
            break  # convergence exactly on the chunk boundary
    summary = BundleAdjustmentSummary(
        success=jnp.isfinite(summary.final_cost)
        & (summary.final_cost <= first_initial),
        initial_cost=first_initial,
        final_cost=summary.final_cost,
        num_iterations=jnp.asarray(done, jnp.int32),
        final_mu=summary.final_mu,
        converged=summary.converged,
    )
    return state, summary


def bundle_adjust(
    extrinsics,
    intrinsics,
    points,
    view_group,
    group_model_idx,
    obs_view,
    obs_track,
    obs_uv,
    obs_sqrt_info,
    obs_mask,
    camera_free,
    point_free,
    intrinsics_free,
    track_ref_view,
    track_bearing,
    present_models: tuple,
    num_views: int,
    num_tracks: int,
    num_groups: int,
    options: BundleAdjustmentOptions,
    priors=None,
):
    """Run LM to convergence (implicit-Schur PCG kernel). Returns
    (extrinsics, intrinsics, points, summary).

    The device kernel is launched in `max_iterations_per_launch`-sized
    chunks with damping carried across launches (see
    `BundleAdjustmentOptions.max_iterations_per_launch`)."""

    def impl(state, chunk_options, mu0):
        ext, q, pts = state
        ext, q, pts, summary = _bundle_adjust_impl(
            ext, q, pts,
            view_group, group_model_idx,
            obs_view, obs_track, obs_uv, obs_sqrt_info, obs_mask,
            camera_free, point_free, intrinsics_free,
            track_ref_view, track_bearing,
            present_models=present_models,
            num_views=num_views,
            num_tracks=num_tracks,
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
