"""Quadratic programming and constrained L1 solvers (ADMM).

Batched equivalents of:
  - `theia::QPSolver` (`/root/reference/src/theia/math/qp_solver.h:65`):
    min 1/2 xᵀPx + qᵀx + r  s.t.  l <= x <= u  (box QP, ADMM).
  - `theia::ConstrainedL1Solver`
    (`/root/reference/src/theia/math/constrained_l1_solver.{h,cc}`):
    min ||Ax − b||_1  s.t.  Gx >= h — used by the LUD position estimator
    (`least_unsquared_deviation_position_estimator.cc:104`).

Both run fixed-iteration ADMM with matrix-free operators (matvec closures)
and CG inner solves — branch-free `lax.scan` loops that jit cleanly, instead
of the reference's Eigen sparse Cholesky factorizations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .l1 import conjugate_gradient

__all__ = ["solve_box_qp", "solve_constrained_l1"]


def solve_box_qp(
    P_mv,
    q,
    lower,
    upper,
    x0=None,
    rho: float = 1.0,
    outer_iters: int = 200,
    cg_iters: int = 30,
):
    """Box-constrained QP by ADMM (parity: `QPSolver::Solve`, qp_solver.h:65).

    min 1/2 xᵀPx + qᵀx  s.t. lower <= x <= upper, with `P_mv` a PSD matvec.

    Returns x [n].
    """
    n = q.shape[0]
    dtype = q.dtype
    x = jnp.zeros(n, dtype) if x0 is None else x0
    z = jnp.clip(x, lower, upper)
    u = jnp.zeros(n, dtype)
    rho_ = jnp.asarray(rho, dtype)

    def matvec(v):
        return P_mv(v) + rho_ * v

    def step(carry, _):
        x, z, u = carry
        rhs = rho_ * (z - u) - q
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters)
        z = jnp.clip(x + u, lower, upper)
        u = u + x - z
        return (x, z, u), None

    (x, z, u), _ = jax.lax.scan(step, (x, z, u), None, length=outer_iters)
    return z


def solve_constrained_l1(
    A_mv,
    At_mv,
    b,
    G_mv,
    Gt_mv,
    h,
    n: int,
    x0=None,
    rho: float = 1.0,
    outer_iters: int = 300,
    cg_iters: int = 40,
):
    """min ||Ax − b||_1 s.t. Gx >= h, by ADMM with two splittings.

    Parity: `ConstrainedL1Solver::Solve` (`constrained_l1_solver.h`): the
    reference uses the same ADMM splitting (shrinkage on the residual block,
    projection on the inequality block) with a prefactored sparse normal
    matrix; here the (AᵀA + GᵀG)-solve is matrix-free CG.

    Args:
      A_mv/At_mv: matvec closures for A [m_a x n]; G_mv/Gt_mv for G [m_g x n];
      b [m_a]; h [m_g]; n: number of unknowns.

    Returns x [n].
    """
    dtype = b.dtype
    x = jnp.zeros(n, dtype) if x0 is None else x0
    y = A_mv(x) - b  # residual block
    s = jnp.maximum(G_mv(x) - h, 0.0)  # slack block (>= 0)
    uy = jnp.zeros_like(y)
    us = jnp.zeros_like(s)
    rho_ = jnp.asarray(rho, dtype)

    def shrink(v, kappa):
        return jnp.sign(v) * jnp.maximum(jnp.abs(v) - kappa, 0.0)

    def matvec(v):
        return At_mv(A_mv(v)) + Gt_mv(G_mv(v)) + 1e-12 * v

    def step(carry, _):
        x, y, s, uy, us = carry
        rhs = At_mv(b + y - uy) + Gt_mv(h + s - us)
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters)
        Ax_b = A_mv(x) - b
        Gx_h = G_mv(x) - h
        y = shrink(Ax_b + uy, 1.0 / rho_)
        s = jnp.maximum(Gx_h + us, 0.0)
        uy = uy + Ax_b - y
        us = us + Gx_h - s
        return (x, y, s, uy, us), None

    (x, y, s, uy, us), _ = jax.lax.scan(
        step, (x, y, s, uy, us), None, length=outer_iters
    )
    return x
