"""Robust linear solvers: operator-form ADMM L1 and IRLS least squares.

Re-design of `/root/reference/src/theia/math/l1_solver.h:87` (ADMM
least-absolute-deviation) and the IRLS refinement inside
`robust_rotation_estimator.h:127-140`. The reference factorizes a sparse
normal matrix once with SimplicialLDLT; here the matrix never
materializes — callers pass `matvec` closures (gather + segment-sum
kernels) and every solve is preconditioned conjugate gradient. All loops
are fixed-trip `lax`-friendly so the whole solver jits.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["conjugate_gradient", "admm_l1", "irls_solve"]


def conjugate_gradient(matvec, b, x0=None, iters: int = 50, precond=None):
    """CG for SPD `matvec`. Fixed iteration count (jit-friendly); callers
    choose `iters` from problem size. `precond`: approximate inverse."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precond is None:
        precond = lambda r: r

    def body(carry, _):
        x, r, z, p, rz = carry
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap).real
        alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z).real
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new), None

    r0 = b - matvec(x0)
    z0 = precond(r0)
    carry = (x0, r0, z0, z0, jnp.vdot(r0, z0).real)
    (x, *_), _ = jax.lax.scan(body, carry, None, length=iters)
    return x


def _shrink(v, kappa):
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - kappa, 0.0)


def admm_l1(
    apply_A,
    apply_At,
    b,
    x_shape,
    rho: float = 1.0,
    outer_iters: int = 100,
    cg_iters: int = 30,
    precond=None,
    x0=None,
    normal_matvec=None,
):
    """minimize ||A x - b||_1 by ADMM in operator form.

    Parity: `theia::L1Solver` (`l1_solver.h:70-85`, scaled-dual ADMM).
    x-update solves AᵀA x = Aᵀ(b + z - u) with CG; z-update is soft
    thresholding with 1/rho; u is the scaled dual.

    `normal_matvec`: optional v -> AᵀA v for the inner CG. The reference
    pre-factors AᵀA once (`l1_solver.h:87`); the analogue here is a
    pre-MATERIALIZED normal matrix whose matvec touches |AᵀA| bytes
    instead of 2|A| — for the rotation-averaging incidence operator that
    is E/V-fold less HBM traffic on the solver's hottest loop.
    """
    if x0 is None:
        x = jnp.zeros(x_shape, b.dtype)
    else:
        x = x0
    z = apply_A(x) - b
    u = jnp.zeros_like(b)

    normal = normal_matvec or (lambda v: apply_At(apply_A(v)))

    def body(carry, _):
        x, z, u = carry
        rhs = apply_At(b + z - u)
        x = conjugate_gradient(normal, rhs, x0=x, iters=cg_iters, precond=precond)
        Ax = apply_A(x)
        z = _shrink(Ax - b + u, 1.0 / rho)
        u = u + Ax - b - z
        return (x, z, u), None

    (x, _, _), _ = jax.lax.scan(body, (x, z, u), None, length=outer_iters)
    return x


def irls_solve(
    apply_A,
    apply_At,
    b,
    x_shape,
    weight_fn,
    group_fn=None,
    outer_iters: int = 10,
    cg_iters: int = 30,
    precond=None,
    x0=None,
):
    """Iteratively reweighted least squares: min Σ w(r) r².

    `weight_fn(residual_norms) -> weights` maps per-group residual norms to
    weights (e.g. Geman-McClure for the rotation IRLS stage,
    `robust_rotation_estimator.h:140`); `group_fn(residual) -> norms`
    reduces the raw residual vector to per-group magnitudes (defaults to
    elementwise |r|) and its output is broadcast back by the caller's
    `apply_*` closures taking a `weights` argument.
    """
    if x0 is None:
        x = jnp.zeros(x_shape, b.dtype)
    else:
        x = x0
    if group_fn is None:
        group_fn = jnp.abs

    def body(carry, _):
        x = carry
        r = apply_A(x, None) - b
        w = weight_fn(group_fn(r))

        matvec = lambda v: apply_At(apply_A(v, w), w)
        rhs = apply_At(b, w)
        x = conjugate_gradient(matvec, rhs, x0=x, iters=cg_iters, precond=precond)
        return x, None

    x, _ = jax.lax.scan(body, x, None, length=outer_iters)
    return x
