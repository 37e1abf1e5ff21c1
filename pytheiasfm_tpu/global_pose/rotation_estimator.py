"""Rotation averaging over a view graph.

Re-design of `/root/reference/src/theia/sfm/global_pose_estimation/
robust_rotation_estimator.h:62-166` (L1 then IRLS on the tangent-space
relaxation, Chatterjee & Govindu ICCV'13), `linear_rotation_estimator.h:55`
(Martinec-Pajdla least-squares over rotation matrices) and
`nonlinear_rotation_estimator.h:50` (robust Gauss-Newton on pairwise
rotation errors).

Conventions (matching the rest of the package and `twoview_info.h:54`):
orientations are world→camera angle-axis vectors R_i; an edge (i, j)
carries R_ij with R_j = R_ij · R_i. The tangent relaxation uses
camera-local right perturbations R_i ← R_i · exp(δ_i), giving the
first-order edge equation δ_j − δ_i = log(R_jᵀ R_ij R_i) with the clean
±I incidence structure the reference builds sparsely
(`robust_rotation_estimator.h:116-125`); here A/Aᵀ are gather and
segment-sum kernels so every solve is batched CG on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..math.l1 import admm_l1, conjugate_gradient
from ..math import graph as graphops
from ..ops import rotation as rotops

__all__ = [
    "GlobalRotationEstimatorType",
    "RobustRotationEstimatorOptions",
    "orientations_from_maximum_spanning_tree",
    "robust_rotation_averaging",
    "irls_rotation_refine",
    "linear_rotation_averaging",
    "nonlinear_rotation_averaging",
    "lagrange_dual_rotation_averaging",
    "hybrid_rotation_averaging",
    "l1_rotation_global",
    "estimate_rotations",
]


class GlobalRotationEstimatorType:
    """Parity: `GlobalRotationEstimatorType` enum
    (`reconstruction_estimator_options.h`)."""

    ROBUST_L1L2 = 0
    NONLINEAR = 1
    LINEAR = 2
    LAGRANGE_DUAL = 3
    HYBRID = 4


@dataclasses.dataclass(frozen=True)
class RobustRotationEstimatorOptions:
    """Parity: `RobustRotationEstimator::Options`
    (`robust_rotation_estimator.h:66-77`)."""

    max_num_l1_iterations: int = 5
    max_num_irls_iterations: int = 10
    irls_loss_parameter_sigma: float = np.radians(5.0)
    cg_iterations: int = 50
    admm_iterations: int = 50


def orientations_from_maximum_spanning_tree(view_graph):
    """Initialize orientations by chaining relative rotations along the
    maximum spanning tree (weight = #verified matches).

    Parity: `theia::OrientationsFromMaximumSpanningTree`
    (`view_graph/orientations_from_maximum_spanning_tree.h:50`). Host-side
    BFS; the per-edge rotation composition is cheap.
    Returns {view_id: angle-axis ndarray}.
    """
    v1, v2, rel_rot, _, weights = view_graph.edge_arrays()
    if len(v1) == 0:
        return {}
    edges = np.stack([v1, v2], -1)
    tree = graphops.maximum_spanning_tree(edges, weights)
    adj: dict[int, list[tuple[int, int]]] = {}
    for e in tree:
        adj.setdefault(int(v1[e]), []).append((int(v2[e]), e))
        adj.setdefault(int(v2[e]), []).append((int(v1[e]), e))
    # Host numpy rotation math: a device call per tree node would cost a
    # dispatch and a blocking transfer each.
    from ..ops.rotation_np import (
        angle_axis_to_rotation_matrix_np,
        rotation_matrix_to_angle_axis_np,
    )

    R_rel_all = angle_axis_to_rotation_matrix_np(rel_rot)
    root = int(min(adj.keys()))
    orientations = {root: np.zeros(3)}
    R_cache = {root: np.eye(3)}
    stack = [root]
    while stack:
        cur = stack.pop()
        R_cur = R_cache[cur]
        for (nb, e) in adj[cur]:
            if nb in orientations:
                continue
            R_rel = R_rel_all[e]
            # Edge stores v1->v2: R_{v2} = R_rel · R_{v1}.
            if int(v1[e]) == cur:
                R_nb = R_rel @ R_cur
            else:
                R_nb = R_rel.T @ R_cur
            R_cache[nb] = R_nb
            orientations[nb] = rotation_matrix_to_angle_axis_np(R_nb)
            stack.append(nb)
    return orientations


def _edge_residuals(orientations, edge_i, edge_j, rel_aa):
    """e_ij = log(R_jᵀ R_ij R_i) for every edge, batched."""
    R = jax.vmap(rotops.angle_axis_to_rotation_matrix)(orientations)
    R_rel = jax.vmap(rotops.angle_axis_to_rotation_matrix)(rel_aa)
    Ri = R[edge_i]
    Rj = R[edge_j]
    loop = jnp.einsum("eba,ebc,ecd->ead", Rj, R_rel, Ri)
    return jax.vmap(rotops.rotation_matrix_to_angle_axis)(loop)


def _apply_update(orientations, delta):
    """R_i ← R_i · exp(δ_i) (camera-local right perturbation)."""
    R = jax.vmap(rotops.angle_axis_to_rotation_matrix)(orientations)
    dR = jax.vmap(rotops.angle_axis_to_rotation_matrix)(delta)
    return jax.vmap(rotops.rotation_matrix_to_angle_axis)(
        jnp.einsum("eij,ejk->eik", R, dR)
    )


@partial(jax.jit, static_argnames=("options", "num_views"))
def robust_rotation_averaging(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    options: RobustRotationEstimatorOptions = RobustRotationEstimatorOptions(),
    edge_mask=None,
):
    """L1 stage then IRLS stage, both with per-stage relinearization.

    Parity: `RobustRotationEstimator::EstimateRotations`
    (`robust_rotation_estimator.h:90`): `free_mask` [V] marks views being
    solved (fixed views keep δ = 0 — the reference supports fixing multiple
    views, `robust_rotation_estimator.h:84-88`). `edge_mask` [E] (bool,
    optional) marks valid edges: padded rows (mesh-divisibility padding
    from the sharded entry) contribute nothing to the operator, so the
    padded problem is EXACTLY the unpadded one.
    """
    dtype = orientations.dtype
    fm = free_mask.astype(dtype)[:, None]
    em = (
        jnp.ones((edge_i.shape[0], 1), dtype)
        if edge_mask is None
        else edge_mask.astype(dtype)[:, None]
    )

    # The L1/IRLS stages run thousands of sequential CG steps; at that
    # trip count a scatter-based incidence matvec costs seconds of pure
    # scatter latency (round-3 measurement: 113 s for Notre-Dame-scale).
    # Materialize the signed incidence matrix D [E, V] (one-hot(j) -
    # one-hot(i)) so A x and A^T y are matmuls — loop-invariant, so
    # XLA keeps ONE copy live across the whole scan. Above ~256 MB
    # (Trafalgar-scale graphs) fall back to the scatter form.
    E = edge_i.shape[0]
    use_dense = E * num_views <= 134_000_000
    # The inner CG runs THOUSANDS of normal-equation matvecs; touching the
    # incidence structure per matvec (dense D [E, V] reads, or two
    # scatters) is the phase's entire cost. The materialized graph
    # Laplacian L = DᵀD [V, V] is E/V-fold smaller than D and scatter-free
    # — numerically the identical operator. Built from D when D fits,
    # otherwise assembled once with segment-sums (V² stays modest even at
    # Trafalgar scale: 5288² f32 = 112 MB).
    if use_dense:
        ar = jnp.arange(num_views, dtype=edge_i.dtype)
        D = (edge_j[:, None] == ar[None, :]).astype(dtype) - (
            edge_i[:, None] == ar[None, :]
        ).astype(dtype)
        D = D * em
        Lap = D.T @ D
    else:
        ones = em[:, 0]
        deg = jax.ops.segment_sum(
            ones, edge_i, num_segments=num_views
        ) + jax.ops.segment_sum(ones, edge_j, num_segments=num_views)
        adj = jnp.zeros((num_views, num_views), dtype)
        adj = adj.at[edge_i, edge_j].add(em[:, 0])
        adj = adj + adj.T
        Lap = jnp.diag(deg) - adj

    def apply_A(delta):
        d = delta.reshape(num_views, 3) * fm
        if use_dense:
            return (D @ d).reshape(-1)
        return ((d[edge_j] - d[edge_i]) * em).reshape(-1)

    def apply_At(y):
        yv = y.reshape(-1, 3) * em
        if use_dense:
            return (D.T @ yv * fm).reshape(-1)
        acc = jax.ops.segment_sum(yv, edge_j, num_segments=num_views)
        acc -= jax.ops.segment_sum(yv, edge_i, num_segments=num_views)
        return (acc * fm).reshape(-1)

    def normal_matvec(delta):
        d = delta.reshape(num_views, 3) * fm
        return (Lap @ d * fm).reshape(-1)

    degree = (
        jax.ops.segment_sum(em[:, 0], edge_i, num_segments=num_views)
        + jax.ops.segment_sum(em[:, 0], edge_j, num_segments=num_views)
    )
    inv_deg = jnp.where(degree > 0, 1.0 / jnp.maximum(degree, 1.0), 1.0)

    def precond(r):
        return (r.reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)

    def l1_step(R_aa, _):
        e = (_edge_residuals(R_aa, edge_i, edge_j, rel_aa) * em).reshape(-1)
        delta = admm_l1(
            apply_A, apply_At, e, (num_views * 3,),
            outer_iters=options.admm_iterations,
            cg_iters=options.cg_iterations, precond=precond,
            normal_matvec=normal_matvec,
        )
        delta = delta.reshape(num_views, 3) * fm
        return _apply_update(R_aa, delta), None

    R_aa, _ = jax.lax.scan(l1_step, orientations, None,
                           length=options.max_num_l1_iterations)

    sigma = jnp.asarray(options.irls_loss_parameter_sigma, dtype)

    def irls_step(R_aa, _):
        e = _edge_residuals(R_aa, edge_i, edge_j, rel_aa) * em
        # Geman-McClure weights on the edge residual norm
        # (`robust_rotation_estimator.h:140`).
        nrm2 = jnp.sum(e * e, axis=-1)
        w = ((sigma**2 / (nrm2 + sigma**2)) ** 2) * em[:, 0]
        sw = jnp.sqrt(w)[:, None]

        def apply_Aw(delta):
            return (apply_A(delta).reshape(-1, 3) * sw).reshape(-1)

        def apply_Atw(y):
            return apply_At((y.reshape(-1, 3) * sw).reshape(-1))

        # Weighted Laplacian Dᵀ diag(w) D — one assembly per IRLS
        # relinearization, then V²-sized matvecs.
        if use_dense:
            Lw = D.T @ (D * w[:, None])
        else:
            wdeg = jax.ops.segment_sum(
                w, edge_i, num_segments=num_views
            ) + jax.ops.segment_sum(w, edge_j, num_segments=num_views)
            wadj = jnp.zeros((num_views, num_views), dtype)
            wadj = wadj.at[edge_i, edge_j].add(w)
            wadj = wadj + wadj.T
            Lw = jnp.diag(wdeg) - wadj

        def matvec(v):
            d = v.reshape(num_views, 3) * fm
            return (Lw @ d * fm).reshape(-1)
        rhs = apply_Atw((e * sw).reshape(-1))
        delta = conjugate_gradient(
            matvec, rhs, iters=options.cg_iterations, precond=precond
        )
        delta = delta.reshape(num_views, 3) * fm
        return _apply_update(R_aa, delta), None

    R_aa, _ = jax.lax.scan(irls_step, R_aa, None,
                           length=options.max_num_irls_iterations)
    return R_aa


def irls_rotation_refine(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    num_iterations: int = 10, sigma: float = np.radians(5.0),
    cg_iterations: int = 50,
):
    """IRLS-only local refinement.

    Parity: `theia::IRLSRotationLocalRefiner`
    (`irls_rotation_local_refiner.h:52`) used by the hybrid estimator."""
    opts = RobustRotationEstimatorOptions(
        max_num_l1_iterations=0,
        max_num_irls_iterations=num_iterations,
        irls_loss_parameter_sigma=sigma,
        cg_iterations=cg_iterations,
    )
    return robust_rotation_averaging(
        orientations, edge_i, edge_j, rel_aa, free_mask, num_views, opts
    )


@partial(jax.jit, static_argnames=("num_views", "power_iterations"))
def linear_rotation_averaging(
    edge_i, edge_j, rel_aa, weights, num_views: int, power_iterations: int = 100
):
    """Least-squares rotation averaging à la Martinec-Pajdla.

    Parity: `theia::LinearRotationEstimator`
    (`linear_rotation_estimator.h:55`): find R minimizing
    Σ w_ij ||R_j − R_ij R_i||², i.e. the 3 smallest eigenvectors of the
    graph Laplacian-like operator L = D − M with 3×3 rotation blocks. The
    reference solves this with Spectra shift-invert; the batched equivalent is
    block inverse iteration — each outer step solves (L + εI) Y = X with
    operator-form CG (amplifying the near-null target subspace by 1/ε per
    step) and re-orthonormalizes, followed by per-view SO(3) projection.
    """
    dtype = rel_aa.dtype
    R_rel = jax.vmap(rotops.angle_axis_to_rotation_matrix)(rel_aa)
    w = weights.astype(dtype)

    deg = jax.ops.segment_sum(w, edge_i, num_segments=num_views) + jax.ops.segment_sum(
        w, edge_j, num_segments=num_views
    )

    def apply_L(X):
        # X: [V, 3, 3] block "vector" (3 columns). L X = D X − M X with
        # M_{ji} = w R_ij (and symmetric transpose term).
        Xi = X[edge_i]
        Xj = X[edge_j]
        contrib_j = jnp.einsum("eab,ebc->eac", R_rel, Xi) * w[:, None, None]
        contrib_i = jnp.einsum("eba,ebc->eac", R_rel, Xj) * w[:, None, None]
        MX = jax.ops.segment_sum(contrib_j, edge_j, num_segments=num_views)
        MX += jax.ops.segment_sum(contrib_i, edge_i, num_segments=num_views)
        return deg[:, None, None] * X - MX

    eps = 1e-6 * jnp.max(deg)

    def shifted(v):
        x = v.reshape(num_views, 3)
        xi = x[edge_i]
        xj = x[edge_j]
        cj = jnp.einsum("eab,eb->ea", R_rel, xi) * w[:, None]
        ci = jnp.einsum("eba,eb->ea", R_rel, xj) * w[:, None]
        Mx = jax.ops.segment_sum(cj, edge_j, num_segments=num_views)
        Mx += jax.ops.segment_sum(ci, edge_i, num_segments=num_views)
        return (deg[:, None] * x - Mx + eps * x).reshape(-1)

    def body(X, _):
        cols = []
        for k in range(3):
            y = conjugate_gradient(
                shifted, X[:, :, k].reshape(-1), iters=power_iterations
            )
            cols.append(y)
        Y = jnp.stack(cols, axis=-1)  # [V*3, 3]
        Q, _ = jnp.linalg.qr(Y)
        return Q.reshape(num_views, 3, 3), None

    # Random start: a structured init (e.g. identity blocks) can sit in an
    # invariant subspace orthogonal to parts of the null space and stall.
    X0 = jax.random.normal(jax.random.PRNGKey(0), (num_views, 3, 3), dtype)
    Q0, _ = jnp.linalg.qr(X0.reshape(num_views * 3, 3))
    X, _ = jax.lax.scan(body, Q0.reshape(num_views, 3, 3), None, length=4)

    # Zero residual means X_i = R_i G for a shared 3×3 gauge G; the polar
    # factor of X_i is then R_i · polar(G) — one global right gauge, removed
    # downstream by `align_orientations`. det(X_i) = det(G) for every i: if
    # negative, the per-block det-corrected SVD would flip a *degenerate*
    # direction arbitrarily per view, so flip one column globally first.
    det_sign = jnp.sign(jnp.sum(jnp.linalg.det(X)))
    X = X.at[:, :, 2].multiply(det_sign)
    Rs = jax.vmap(rotops.project_to_so3)(X)
    return jax.vmap(rotops.rotation_matrix_to_angle_axis)(Rs)


@partial(jax.jit, static_argnames=("num_views", "num_iterations"))
def nonlinear_rotation_averaging(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    num_iterations: int = 10, huber_delta: float = 0.1,
):
    """Robust Gauss-Newton over pairwise rotation errors.

    Parity: `theia::NonlinearRotationEstimator`
    (`nonlinear_rotation_estimator.h:50`, Ceres + Huber(0.1) on the
    angle-axis pairwise error). Same linearization as the IRLS stage but
    with Huber reweighting.
    """
    dtype = orientations.dtype
    fm = free_mask.astype(dtype)[:, None]
    # Dense signed incidence (see robust_rotation_averaging): CG matvecs
    # as matmuls instead of scatters; scatter fallback above ~256 MB.
    use_dense = edge_i.shape[0] * num_views <= 134_000_000
    if use_dense:
        ar = jnp.arange(num_views, dtype=edge_i.dtype)
        D = (edge_j[:, None] == ar[None, :]).astype(dtype) - (
            edge_i[:, None] == ar[None, :]
        ).astype(dtype)
    degree = (
        jax.ops.segment_sum(jnp.ones_like(edge_i, dtype), edge_i, num_segments=num_views)
        + jax.ops.segment_sum(jnp.ones_like(edge_j, dtype), edge_j, num_segments=num_views)
    )
    inv_deg = jnp.where(degree > 0, 1.0 / jnp.maximum(degree, 1.0), 1.0)

    def precond(r):
        return (r.reshape(num_views, 3) * inv_deg[:, None]).reshape(-1)

    def step(R_aa, _):
        e = _edge_residuals(R_aa, edge_i, edge_j, rel_aa)
        nrm = jnp.linalg.norm(e, axis=-1)
        # Huber IRLS weight: 1 inside delta, delta/|r| outside.
        w = jnp.where(nrm <= huber_delta, 1.0, huber_delta / jnp.maximum(nrm, 1e-12))
        sw = jnp.sqrt(w)[:, None]

        def apply_Aw(delta):
            d = delta.reshape(num_views, 3) * fm
            ad = (D @ d) if use_dense else (d[edge_j] - d[edge_i])
            return (ad * sw).reshape(-1)

        def apply_Atw(y):
            yv = y.reshape(-1, 3) * sw
            if use_dense:
                return (D.T @ yv * fm).reshape(-1)
            acc = jax.ops.segment_sum(yv, edge_j, num_segments=num_views)
            acc -= jax.ops.segment_sum(yv, edge_i, num_segments=num_views)
            return (acc * fm).reshape(-1)

        matvec = lambda v: apply_Atw(apply_Aw(v))
        rhs = apply_Atw((e * sw).reshape(-1))
        delta = conjugate_gradient(matvec, rhs, iters=50, precond=precond)
        delta = delta.reshape(num_views, 3) * fm
        return _apply_update(R_aa, delta), None

    R_aa, _ = jax.lax.scan(step, orientations, None, length=num_iterations)
    return R_aa


def lagrange_dual_rotation_averaging(
    edge_i, edge_j, rel_aa, num_views: int, options=None
):
    """Rotation averaging by SDP relaxation (strong Lagrangian duality).

    Parity: `theia::LagrangeDualRotationEstimator`
    (`lagrange_dual_rotation_estimator.h:62-115`): relax
    max Σ tr(R_iᵀ R̃_ijᵀ R_j) over SO(3)^n to the block SDP
    min tr(C X), X_ii = I₃, X ⪰ 0 with C_ij = −R̃_ijᵀ, solved via the
    Burer-Monteiro Riemannian staircase (`math/sdp.py`) instead of the
    reference's sequential block-coordinate sweeps; rounding projects the
    top-3 subspace back to SO(3)^n. Returns [V, 3] angle-axis (gauge-free).
    """
    from ..math import sdp as sdpmod

    if options is None:
        options = sdpmod.SDPSolverOptions()
    dtype = rel_aa.dtype
    V = num_views
    R_rel = jax.vmap(rotops.angle_axis_to_rotation_matrix)(rel_aa)  # [E,3,3]
    C = jnp.zeros((3 * V, 3 * V), dtype)
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    # Dense block scatter: C[3i:3i+3, 3j:3j+3] = −R̃ᵀ (and symmetric).
    rows_i = (3 * ei[:, None, None] + np.arange(3)[None, :, None]).repeat(3, 2)
    cols_j = (3 * ej[:, None, None] + np.arange(3)[None, None, :]).repeat(3, 1)
    C = C.at[rows_i, cols_j].add(-jnp.swapaxes(R_rel, -1, -2))
    C = C.at[cols_j.swapaxes(1, 2), rows_i.swapaxes(1, 2)].add(-R_rel)

    Y, obj, lam = sdpmod.riemannian_staircase(C, V, options)
    R = sdpmod.round_block_solution(Y, V)
    return jax.vmap(rotops.rotation_matrix_to_angle_axis)(R), lam


def hybrid_rotation_averaging(
    edge_i, edge_j, rel_aa, free_mask, num_views: int,
    sdp_options=None, irls_iterations: int = 10,
):
    """Lagrange-dual initialization + IRLS local refinement.

    Parity: `theia::HybridRotationEstimator`
    (`hybrid_rotation_estimator.h:51-89`, LD + `IRLSRotationLocalRefiner`).
    """
    aa0, _ = lagrange_dual_rotation_averaging(
        edge_i, edge_j, rel_aa, num_views, sdp_options
    )
    return irls_rotation_refine(
        aa0, edge_i, edge_j, rel_aa, free_mask, num_views,
        num_iterations=irls_iterations,
    )


def l1_rotation_global(
    orientations, edge_i, edge_j, rel_aa, free_mask, num_views: int,
    l1_iterations: int = 5,
):
    """L1-only global rotation estimation.

    Parity: `theia::L1RotationGlobalEstimator`
    (`l1_rotation_global_estimator.h:52`) — the L1 stage of the robust
    estimator without the IRLS polish."""
    opts = RobustRotationEstimatorOptions(
        max_num_l1_iterations=l1_iterations, max_num_irls_iterations=0
    )
    return robust_rotation_averaging(
        orientations, edge_i, edge_j, rel_aa, free_mask, num_views, opts
    )


def estimate_rotations(
    view_graph,
    estimator_type: int = GlobalRotationEstimatorType.ROBUST_L1L2,
    initial_orientations: dict | None = None,
    fixed_views: set | None = None,
    options: RobustRotationEstimatorOptions | None = None,
    dtype=np.float64,
    mesh=None,
):
    """Host driver: view graph → {view_id: angle-axis}.

    Parity: the `RotationEstimator::EstimateRotations` interface
    (`rotation_estimator.h:50`) plus the MST initialization step of
    `GlobalReconstructionEstimator::EstimateGlobalRotations`
    (`global_reconstruction_estimator.cc:327-371`).

    `mesh`: optional `jax.sharding.Mesh` — the edge axis (relative
    rotations, incidence rows) shards across it and GSPMD inserts the
    Laplacian-assembly / adjoint collectives (SURVEY §7.9; the reference
    parallelizes this phase with its ThreadPool instead). Padded edges are
    masked inert, so the sharded solve matches the single-device one.
    """
    view_ids = view_graph.view_ids()
    if not view_ids:
        return {}
    index = {v: i for i, v in enumerate(view_ids)}
    V = len(view_ids)
    v1, v2, rel_rot, _, weights = view_graph.edge_arrays(dtype)
    ei = np.asarray([index[v] for v in v1], np.int32)
    ej = np.asarray([index[v] for v in v2], np.int32)

    if initial_orientations is None:
        initial_orientations = orientations_from_maximum_spanning_tree(view_graph)
    init = np.zeros((V, 3), dtype)
    for v, aa in initial_orientations.items():
        if v in index:
            init[index[v]] = aa

    free = np.ones(V, bool)
    if fixed_views:
        for v in fixed_views:
            if v in index:
                free[index[v]] = False
    else:
        free[0] = False  # gauge: fix the first view

    if estimator_type == GlobalRotationEstimatorType.LINEAR:
        out = linear_rotation_averaging(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel_rot),
            jnp.asarray(weights), V,
        )
        out = np.asarray(out)
        # Gauge-align to the first view's initial orientation.
        aligned = np.asarray(
            rotops.align_orientations(
                jnp.asarray(init), jnp.asarray(out)
            )
        )
        out = aligned
    elif estimator_type == GlobalRotationEstimatorType.LAGRANGE_DUAL:
        aa, _ = lagrange_dual_rotation_averaging(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel_rot), V
        )
        out = np.asarray(
            rotops.align_orientations(jnp.asarray(init), jnp.asarray(aa))
        )
    elif estimator_type == GlobalRotationEstimatorType.HYBRID:
        aa = hybrid_rotation_averaging(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel_rot),
            jnp.asarray(np.ones(V, bool)), V,
        )
        out = np.asarray(
            rotops.align_orientations(jnp.asarray(init), jnp.asarray(aa))
        )
    elif estimator_type == GlobalRotationEstimatorType.NONLINEAR:
        out = np.asarray(
            nonlinear_rotation_averaging(
                jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej),
                jnp.asarray(rel_rot), jnp.asarray(free), V,
            )
        )
    else:
        opts = options or RobustRotationEstimatorOptions()
        edge_args = (jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(rel_rot))
        edge_mask = None
        if mesh is not None:
            import jax as _jax
            from jax.sharding import NamedSharding, PartitionSpec as _PS

            from ..parallel import pad_to_multiple

            n = int(np.prod(list(mesh.shape.values())))
            ax = mesh.axis_names[0]
            sh = NamedSharding(mesh, _PS(ax))
            E = len(ei)
            # Padded edges: i = j = 0 with identity relative rotation and
            # edge_mask False — exact zero rows of the masked operator.
            ei_p, _ = pad_to_multiple(ei, n)
            ej_p, _ = pad_to_multiple(ej, n)
            rel_p, _ = pad_to_multiple(rel_rot, n)
            mask_p = np.zeros(len(ei_p), bool)
            mask_p[:E] = True
            edge_args = tuple(
                _jax.device_put(jnp.asarray(a), sh)
                for a in (ei_p, ej_p, rel_p)
            )
            edge_mask = _jax.device_put(jnp.asarray(mask_p), sh)
        out = np.asarray(
            robust_rotation_averaging(
                jnp.asarray(init), *edge_args,
                jnp.asarray(free), V, opts, edge_mask=edge_mask,
            )
        )
    return {v: out[index[v]] for v in view_ids}
