"""Block-structured SDP solvers (Burer-Monteiro / Riemannian staircase).

Batched equivalents of the reference's SDP family
(`/root/reference/src/theia/math/`):
  - `SDPSolver` base + options        (sdp_solver.h:51, solver_options.h:43)
  - `BCMSDPSolver` / `RBRSDPSolver`   (bcm_sdp_solver.h:49, rbr_sdp_solver.h:66)
  - `RankRestrictedSDPSolver`         (rank_restricted_sdp_solver.h:63)
  - `RiemannianStaircase`             (riemannian_staircase.h:112)

Problem class (all the reference instantiates): rotation-synchronization
SDPs  min tr(C X)  s.t.  X ⪰ 0,  X_ii = I_d  with d = 3 block structure.

The reference's row-by-row block coordinate minimization (RBR) is inherently
sequential (one 3-row block at a time) and its Riemannian staircase leans on
Spectra's Lanczos. Here the factorized (Burer-Monteiro) problem
  min tr(Yᵀ C Y),  Y ∈ (St(r,3))^n   (each 3×r block has orthonormal rows)
is solved with **parallel Riemannian projected-gradient iterations**: the
gradient 2·C·Y is one [3n,3n]×[3n,r] matmul, the retraction is a
batched 3×r polar decomposition (batched SVD), and a 3-candidate step-size
line search keeps it monotone — every step is data-parallel over all blocks.
The staircase escapes saddle points by rank lifting with the most negative
certificate eigenvector (shifted power iteration instead of Spectra).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "SDPSolverOptions",
    "solve_block_sdp",
    "riemannian_staircase",
    "certificate_min_eig",
]


@dataclasses.dataclass(frozen=True)
class SDPSolverOptions:
    """Parity: `math/solver_options.h:43-99` (subset that matters here)."""

    max_iterations: int = 200
    tolerance: float = 1e-8
    rank: int = 3
    max_rank: int = 6  # staircase ceiling (`riemannian_staircase.h:112`)
    power_iterations: int = 64


def _polar_rows(B):
    """Project [.., 3, r] onto matrices with orthonormal rows (closest in
    Frobenius norm): U Vᵀ from the thin SVD."""
    U, _, Vt = jnp.linalg.svd(B, full_matrices=False)
    return U @ Vt


def _objective(C, Y):
    return jnp.einsum("ij,ik,jk->", C, Y, Y)  # tr(Yᵀ C Y)


@partial(jax.jit, static_argnames=("num_blocks", "rank", "iters"))
def solve_block_sdp(C, Y0, num_blocks: int, rank: int, iters: int = 200):
    """Minimize tr(Yᵀ C Y) over block-Stiefel Y [3n, r].

    Parity class: `RankRestrictedSDPSolver::Solve`
    (`rank_restricted_sdp_solver.h:63`) — the factorized BCM solver; this
    implementation replaces sequential row-block sweeps with parallel
    Riemannian gradient steps + polar retraction.

    Args:
      C: [3n, 3n] symmetric cost; Y0: [3n, r] initial block-Stiefel point.

    Returns:
      (Y [3n, r], objective value).
    """
    n = num_blocks
    dtype = C.dtype

    # Lipschitz-ish scale for the initial step: row-sum bound of |C|.
    L = jnp.maximum(jnp.max(jnp.sum(jnp.abs(C), axis=1)), 1e-12)
    base_step = 1.0 / L

    def body(carry, _):
        Y, step = carry
        G = C @ Y  # Euclidean gradient / 2, [3n, r] — matmul.
        f0 = jnp.einsum("ik,ik->", Y, G)

        def try_step(s):
            Y_new = _polar_rows((Y - s * G).reshape(n, 3, rank)).reshape(3 * n, rank)
            return Y_new, jnp.einsum("ik,ik->", Y_new, C @ Y_new)

        # 3-candidate line search (parallel), monotone fallback to Y.
        cands = [try_step(step * m) for m in (2.0, 1.0, 0.25)]
        Ys = jnp.stack([c[0] for c in cands])
        fs = jnp.stack([c[1] for c in cands])
        best = jnp.argmin(fs)
        Y_best = Ys[best]
        f_best = fs[best]
        improved = f_best < f0
        Y_next = jnp.where(improved, Y_best, Y)
        # Grow step if the aggressive candidate won, shrink on failure.
        step_next = jnp.where(
            improved,
            jnp.where(best == 0, step * 2.0, jnp.where(best == 2, step * 0.25, step)),
            step * 0.25,
        )
        step_next = jnp.clip(step_next, base_step * 1e-4, base_step * 1e4)
        return (Y_next, step_next), None

    (Y, _), _ = jax.lax.scan(body, (Y0, jnp.asarray(base_step, dtype)), None, length=iters)
    return Y, _objective(C, Y)


def certificate_min_eig(C, Y, num_blocks: int, power_iterations: int = 64, key=None):
    """Smallest eigenvalue (and vector) of the dual certificate
    S = Λ − C, Λ = blockdiag(sym((C Y) Yᵀ)) — X = Y Yᵀ is globally optimal
    iff S ⪰ 0 (`riemannian_staircase.h` second-order condition).

    Uses shifted power iteration on (σI − S) — no Spectra/Lanczos needed.
    """
    n = num_blocks
    dtype = C.dtype
    CY = C @ Y
    Lam_blocks = jnp.einsum("nik,njk->nij", CY.reshape(n, 3, -1), Y.reshape(n, 3, -1))
    Lam_blocks = 0.5 * (Lam_blocks + jnp.swapaxes(Lam_blocks, -1, -2))

    def S_mv(v):
        vb = v.reshape(n, 3)
        lam_v = jnp.einsum("nij,nj->ni", Lam_blocks, vb).reshape(-1)
        return lam_v - C @ v

    # Upper bound for shift: ||S|| <= max row sum.
    sigma = jnp.max(jnp.sum(jnp.abs(C), axis=1)) + jnp.max(
        jnp.sum(jnp.abs(Lam_blocks), axis=(1, 2))
    )
    if key is None:
        key = jax.random.PRNGKey(0)
    v0 = jax.random.normal(key, (3 * n,), dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = sigma * v - S_mv(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, power_iterations, body, v0)
    lam = jnp.dot(v, S_mv(v))
    return lam, v


def riemannian_staircase(
    C,
    num_blocks: int,
    options: SDPSolverOptions = SDPSolverOptions(),
    Y_init=None,
    key=None,
):
    """Riemannian staircase: solve at increasing rank until certified.

    Parity: `RiemannianStaircase` (`riemannian_staircase.h:112`). The rank
    schedule is static (XLA-friendly): solve at r = rank..max_rank, lifting
    with the negative certificate eigenvector each level; the final result
    is the rank level with the best certified objective.

    Returns:
      (Y [3n, max_rank] zero-padded, objective, min_certificate_eig).
    """
    n = num_blocks
    dtype = C.dtype
    if key is None:
        key = jax.random.PRNGKey(1)

    r = options.rank
    if Y_init is None:
        eye = jnp.tile(jnp.eye(3, dtype=dtype), (n, 1))
        Y = jnp.pad(eye, ((0, 0), (0, r - 3))) if r > 3 else eye
    else:
        Y = Y_init

    Y, obj = solve_block_sdp(C, Y, n, r, options.max_iterations)
    lam, v = certificate_min_eig(C, Y, n, options.power_iterations, key)

    for r_next in range(r + 1, options.max_rank + 1):
        # Lift: append the escape direction as a new column where the
        # certificate found negative curvature; re-polar to stay feasible.
        lift = jnp.concatenate([Y, 1e-2 * v[:, None]], axis=1)
        lift = _polar_rows(lift.reshape(n, 3, r_next)).reshape(3 * n, r_next)
        Y_next, obj_next = solve_block_sdp(C, lift, n, r_next, options.max_iterations)
        lam_next, v_next = certificate_min_eig(
            C, Y_next, n, options.power_iterations, key
        )
        # Accept the lift only if it actually improved the objective.
        if bool(obj_next < obj - options.tolerance * jnp.abs(obj)):
            Y = jnp.pad(Y_next, ((0, 0), (0, 0)))
            obj, lam, v = obj_next, lam_next, v_next
            r = r_next
        else:
            break
        if bool(lam > -options.tolerance):
            break

    pad = options.max_rank - Y.shape[1]
    if pad > 0:
        Y = jnp.pad(Y, ((0, 0), (0, pad)))
    return Y, obj, lam


def round_block_solution(Y, num_blocks: int):
    """Round a rank-r block-Stiefel solution to n rotation matrices.

    Project Y onto its top-3 left singular subspace, then each 3x3 block
    onto SO(3) with a global det-sign fix (the SDP solution is sign/gauge
    ambiguous)."""
    n = num_blocks
    U, s, _ = jnp.linalg.svd(Y, full_matrices=False)
    Y3 = U[:, :3] * s[:3]
    blocks = Y3.reshape(n, 3, 3)
    # Majority det sign.
    dets = jnp.linalg.det(blocks)
    sign = jnp.sign(jnp.sum(jnp.sign(dets)))
    sign = jnp.where(sign == 0, 1.0, sign)
    blocks = blocks * sign
    Ub, _, Vtb = jnp.linalg.svd(blocks)
    det_uv = jnp.linalg.det(jnp.einsum("nij,njk->nik", Ub, Vtb))
    D = jnp.stack([jnp.ones_like(det_uv), jnp.ones_like(det_uv), det_uv], axis=-1)
    R = jnp.einsum("nij,nj,njk->nik", Ub, D, Vtb)
    return R
