"""Batched five-point relative pose (essential matrix) solver.

Batched equivalent of `theia::FivePointRelativePose`
(`/root/reference/src/theia/sfm/pose/five_point_relative_pose.h:59`,
Stewenius/Nister formulation, convention ``y^T E x = 0`` with x in image 1
and y in image 2).

The reference solves the polynomial system with symbolic Gauss-Jordan
elimination plus a companion/action-matrix eigendecomposition — nonsymmetric
`eig`, which XLA does not provide on accelerators. This implementation re-derives the
solve as dense batched linear algebra:

  1. The 4D nullspace of the 5x9 epipolar design matrix comes from `eigh` of
     the 9x9 normal matrix (symmetric — XLA-supported).
  2. E(x,y,z) = x X + y Y + z Z + W. The ten cubic constraints
     (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) are expanded over the 20
     monomials of degree <= 3 via static product index tables (built once in
     Python at trace time).
  3. The constraints are grouped as C(z) m(x,y) = 0 where m is the vector of
     the ten monomials in (x, y) of degree <= 3 and C(z) is a 10x10 matrix
     polynomial in z of degree <= 3. det C(z) is the classic degree-10
     univariate polynomial; its coefficients are recovered EXACTLY by
     evaluating the batched 10x10 determinant at 11 Chebyshev nodes and
     solving one 11x11 Vandermonde system (replacing symbolic elimination
     with matmul-friendly dense ops).
  4. Real roots come from the branchless grid/bisection root finder; for
     each root the (x, y) monomial vector is the smallest right singular
     vector of C(z*).

Returns up to 10 essential matrices with a validity mask.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import polynomial as poly

__all__ = ["five_point_relative_pose"]


# --- Static monomial index tables (built once, pure Python) ---------------

# Degree-1 basis over (x, y, z, 1).
_D1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]


@lru_cache(maxsize=None)
def _monomials(max_deg: int):
    out = []
    for i in range(max_deg, -1, -1):
        for j in range(max_deg - i, -1, -1):
            for k in range(max_deg - i - j, -1, -1):
                out.append((i, j, k))
    return out


_D2 = _monomials(2)  # 10 monomials
_D3 = _monomials(3)  # 20 monomials
_D2_INDEX = {m: i for i, m in enumerate(_D2)}
_D3_INDEX = {m: i for i, m in enumerate(_D3)}

# xy-monomial columns of m(x, y): degree <= 3 in (x, y).
_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
_XY_INDEX = {m: i for i, m in enumerate(_XY)}
_X_COL = _XY_INDEX[(1, 0)]
_Y_COL = _XY_INDEX[(0, 1)]
_ONE_COL = _XY_INDEX[(0, 0)]


def _mul_d1_d1(a, b):
    """[.., 4] x [.., 4] -> [.., 10] (degree-2 coefficients)."""
    out = [None] * len(_D2)
    for i, mi in enumerate(_D1):
        for j, mj in enumerate(_D1):
            m = (mi[0] + mj[0], mi[1] + mj[1], mi[2] + mj[2])
            term = a[..., i] * b[..., j]
            k = _D2_INDEX[m]
            out[k] = term if out[k] is None else out[k] + term
    return jnp.stack(out, axis=-1)


def _mul_d2_d1(a, b):
    """[.., 10] x [.., 4] -> [.., 20] (degree-3 coefficients)."""
    out = [None] * len(_D3)
    for i, mi in enumerate(_D2):
        for j, mj in enumerate(_D1):
            m = (mi[0] + mj[0], mi[1] + mj[1], mi[2] + mj[2])
            term = a[..., i] * b[..., j]
            k = _D3_INDEX[m]
            out[k] = term if out[k] is None else out[k] + term
    return jnp.stack(out, axis=-1)


# Map each degree-3 monomial to (xy column, z power) for the C(z) grouping.
_D3_TO_COL_ZP = [( _XY_INDEX[(i, j)], k) for (i, j, k) in _D3]


def _constraints_to_cz(constraints):
    """[.., 10, 20] degree-3 coefficients -> C(z) tensor [.., 10, 10, 4]."""
    batch = constraints.shape[:-2]
    czp = jnp.zeros(batch + (10, 10, 4), constraints.dtype)
    for mono_idx, (col, zp) in enumerate(_D3_TO_COL_ZP):
        czp = czp.at[..., :, col, zp].add(constraints[..., :, mono_idx])
    return czp


def five_point_relative_pose(points1: jax.Array, points2: jax.Array, mask=None):
    """points1/points2 [.., N>=5, 2] -> (E [.., 10, 3, 3], valid [.., 10]).

    A non-minimal (least-squares nullspace) estimate is produced when N > 5,
    matching the reference's behavior (`five_point_relative_pose.h:57-58`).
    """
    dtype = points1.dtype
    x1 = jnp.concatenate([points1, jnp.ones_like(points1[..., :1])], axis=-1)
    x2 = jnp.concatenate([points2, jnp.ones_like(points2[..., :1])], axis=-1)
    # Rows: outer(y, x).flatten() encodes y^T E x with E row-major.
    Q = (x2[..., :, None] * x1[..., None, :]).reshape(points1.shape[:-1] + (9,))
    if mask is not None:
        Q = Q * mask[..., None].astype(dtype)
    # SVD of Q directly (not eigh of Q^T Q) — halves the condition number,
    # which matters for f32 execution.
    _, _, Vt = jnp.linalg.svd(Q, full_matrices=True)
    batch = Q.shape[:-2]
    X = Vt[..., -4, :].reshape(batch + (3, 3))
    Y = Vt[..., -3, :].reshape(batch + (3, 3))
    Z = Vt[..., -2, :].reshape(batch + (3, 3))
    W = Vt[..., -1, :].reshape(batch + (3, 3))

    # E_ij as degree-1 coefficient vectors over (x, y, z, 1).
    E1 = jnp.stack([X, Y, Z, W], axis=-1)  # [.., 3, 3, 4]

    # EEt entries (degree 2).
    def e1(i, j):
        return E1[..., i, j, :]

    eet = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = _mul_d1_d1(e1(i, k), e1(j, k))
                acc = term if acc is None else acc + term
            eet[i][j] = acc
    trace = eet[0][0] + eet[1][1] + eet[2][2]

    # Ten constraints, each a degree-3 coefficient vector [.., 20].
    constraints = []
    # det(E) = e00(e11 e22 - e12 e21) - e01(e10 e22 - e12 e20)
    #        + e02(e10 e21 - e11 e20).
    det = (
        _mul_d2_d1(_mul_d1_d1(e1(1, 1), e1(2, 2)) - _mul_d1_d1(e1(1, 2), e1(2, 1)), e1(0, 0))
        - _mul_d2_d1(_mul_d1_d1(e1(1, 0), e1(2, 2)) - _mul_d1_d1(e1(1, 2), e1(2, 0)), e1(0, 1))
        + _mul_d2_d1(_mul_d1_d1(e1(1, 0), e1(2, 1)) - _mul_d1_d1(e1(1, 1), e1(2, 0)), e1(0, 2))
    )
    constraints.append(det)
    # 2 E E^T E - tr(E E^T) E = 0 (nine entries).
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = _mul_d2_d1(eet[i][k], e1(k, j))
                acc = term if acc is None else acc + term
            entry = 2.0 * acc - _mul_d2_d1(trace, e1(i, j))
            constraints.append(entry)
    constraints = jnp.stack(constraints, axis=-2)  # [.., 10, 20]

    # Row conditioning (constant scaling leaves the root set unchanged).
    row_scale = jnp.max(jnp.abs(constraints), axis=-1, keepdims=True)
    constraints = constraints / jnp.maximum(row_scale, 1e-30)

    czp = _constraints_to_cz(constraints)  # [.., 10, 10, 4]

    # det C(z) at 11 Chebyshev nodes -> exact degree-10 coefficients.
    nodes = np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi)
    zpow = np.stack([nodes**p for p in range(4)], axis=-1)  # [11, 4]
    zpow = jnp.asarray(zpow, dtype)
    Cz = jnp.einsum("...ijp,np->...nij", czp, zpow)  # [.., 11, 10, 10]
    dets = jnp.linalg.det(Cz)  # [.., 11]
    vander = jnp.asarray(np.vander(nodes, 11), dtype)  # [11, 11] degree desc
    coeffs = jnp.linalg.solve(
        jnp.broadcast_to(vander, dets.shape[:-1] + (11, 11)), dets[..., None]
    )[..., 0]  # [.., 11] degree-10 first

    roots, root_valid = poly.find_real_polynomial_roots(coeffs)

    # Nullvector of C(z*) per root -> (x, y), via ridged inverse iteration
    # on the row/column-equilibrated normal matrix C^T C (batched 10x10
    # Cholesky + two triangular solves per sweep) instead of a batched
    # 10x10 SVD of C, at the same f32 recovery rate. The equilibration is what makes f32 work: row scaling leaves the
    # nullvector unchanged; column scaling D maps it to D^-1 m (undone
    # below); together they tame cond(C^T C) = cond(C)^2, worst at
    # large-|z| roots where degree-3 columns dwarf degree-0 ones — without
    # it the scale-relative ridge swamps the small columns and the GN
    # polish below starts outside the right basin. At a root
    # sigma_min(C) ~ 0, so each sweep amplifies the null direction by
    # ~sigma_2^2/ridge >= 1e4; five sweeps are bulletproof.
    zr = roots  # [.., 10]
    zrp = jnp.stack([jnp.ones_like(zr), zr, zr * zr, zr**3], axis=-1)  # [.., 10, 4]
    Cr = jnp.einsum("...ijp,...np->...nij", czp, zrp)  # [.., 10roots, 10, 10]
    rown = jnp.linalg.norm(Cr, axis=-1, keepdims=True)
    Cr = Cr / jnp.maximum(rown, 1e-30)
    coln = jnp.linalg.norm(Cr, axis=-2, keepdims=True)
    Crs = Cr / jnp.maximum(coln, 1e-30)
    CtC = jnp.einsum("...ki,...kj->...ij", Crs, Crs)
    ridge = jnp.asarray(1e-6 if dtype == jnp.float32 else 1e-12, dtype)
    A = CtC + ridge * jnp.eye(10, dtype=dtype)
    Lc = jnp.linalg.cholesky(A)
    # Cholesky of a PD matrix is finite; guard anyway (padded rows etc.).
    chol_ok = jnp.all(jnp.isfinite(Lc), axis=(-2, -1))
    Lc = jnp.where(chol_ok[..., None, None], Lc, jnp.eye(10, dtype=dtype))
    from jax.scipy.linalg import solve_triangular

    m = jnp.ones(Crs.shape[:-1], dtype)
    for _ in range(5):
        y = solve_triangular(Lc, m[..., None], lower=True)
        m = solve_triangular(Lc, y, lower=True, trans=1)[..., 0]
        m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-30)
    m = m / jnp.maximum(coln[..., 0, :], 1e-30)
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-30)
    denom = m[..., _ONE_COL]
    ok_scale = jnp.abs(denom) > 1e-12
    safe = jnp.where(ok_scale, denom, 1.0)
    xr = m[..., _X_COL] / safe
    yr = m[..., _Y_COL] / safe

    # Gauss-Newton polish of (x, y, z) on the 10 original constraints —
    # restores f64-grade accuracy when the degree-10 coefficients were
    # computed in f32.
    def _constraint_values(x, y, z):
        E = (
            x[..., None, None] * X[..., None, :, :]
            + y[..., None, None] * Y[..., None, :, :]
            + z[..., None, None] * Z[..., None, :, :]
            + W[..., None, :, :]
        )
        EEt = E @ jnp.swapaxes(E, -1, -2)
        tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
        M = 2.0 * (EEt @ E) - tr[..., None, None] * E
        det = jnp.linalg.det(E)
        return jnp.concatenate(
            [det[..., None], M.reshape(M.shape[:-2] + (9,))], axis=-1
        )

    def _polish_step(xyz):
        x, y, z = xyz
        r = _constraint_values(x, y, z)  # [.., 10roots, 10]
        eps = jnp.asarray(1e-4 if dtype == jnp.float32 else 1e-7, dtype)
        jx = (_constraint_values(x + eps, y, z) - r) / eps
        jy = (_constraint_values(x, y + eps, z) - r) / eps
        jz = (_constraint_values(x, y, z + eps) - r) / eps
        J = jnp.stack([jx, jy, jz], axis=-1)  # [.., 10roots, 10, 3]
        JtJ = jnp.einsum("...ri,...rj->...ij", J, J)
        Jtr = jnp.einsum("...ri,...r->...i", J, r)
        JtJ = JtJ + 1e-12 * jnp.eye(3, dtype=dtype)
        step = jnp.linalg.solve(JtJ, Jtr[..., None])[..., 0]
        finite = jnp.all(jnp.isfinite(step), axis=-1, keepdims=True)
        step = jnp.where(finite, step, 0.0)
        return (x - step[..., 0], y - step[..., 1], z - step[..., 2])

    xyz = (xr, yr, zr)
    for _ in range(3):
        xyz = _polish_step(xyz)
    xr, yr, zr = xyz

    E = (
        xr[..., None, None] * X[..., None, :, :]
        + yr[..., None, None] * Y[..., None, :, :]
        + zr[..., None, None] * Z[..., None, :, :]
        + W[..., None, :, :]
    )
    norm = jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1)
    E = E / jnp.maximum(norm[..., None, None], 1e-30)
    valid = root_valid & ok_scale & chol_ok & (norm > 1e-12)
    return E, valid
