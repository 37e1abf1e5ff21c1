"""Batched polynomial utilities and real-root finding.

Batched replacement for the reference's polynomial layer
(`/root/reference/src/theia/math/closed_form_polynomial_solver.h`,
`find_polynomial_roots_companion_matrix.{h,cc}`,
`find_polynomial_roots_jenkins_traub.{h,cc}`, `polynomial.{h,cc}`).

The reference finds roots via companion-matrix eigendecomposition or
Jenkins-Traub — both are branch-heavy and need nonsymmetric `eig`, which XLA
does not provide on accelerators. Here real roots are found with a fully branchless,
vmappable scheme: a homogeneous sign sweep over a tan-parameterized grid
covering the whole real line, bisection on each sign change, then Newton
polish. All functions accept arbitrary leading batch dimensions and return
fixed-size root arrays with validity masks (XLA needs static shapes).

Coefficient convention: numpy order, ``coeffs[..., 0]`` multiplies the
highest power.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "polyval",
    "polyder_coeffs",
    "solve_quadratic",
    "solve_cubic",
    "solve_quartic",
    "find_real_polynomial_roots",
]


def polyval(coeffs: jax.Array, x: jax.Array) -> jax.Array:
    """Horner evaluation. coeffs [.., D+1] broadcast against x [..]."""
    result = coeffs[..., 0] + jnp.zeros_like(x)
    for i in range(1, coeffs.shape[-1]):
        result = result * x + coeffs[..., i]
    return result


def polyder_coeffs(coeffs: jax.Array) -> jax.Array:
    """Coefficients of the derivative polynomial; [.., D+1] -> [.., D]."""
    degree = coeffs.shape[-1] - 1
    powers = jnp.arange(degree, 0, -1, dtype=coeffs.dtype)
    return coeffs[..., :-1] * powers


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c.

    Returns (roots [.., 2], valid [.., 2]). Parity:
    `theia::SolveQuadraticReals` (`math/closed_form_polynomial_solver.h`).
    Uses the numerically stable "citardauq" pairing to avoid cancellation.
    """
    a, b, c = jnp.broadcast_arrays(a, b, c)
    disc = b * b - 4.0 * a * c
    has_roots = disc >= 0
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sqrt_disc)
    # When b == 0, sign(b) == 0 -> q = 0; fall back to symmetric form.
    q = jnp.where(b == 0, -0.5 * (b + sqrt_disc), q)
    safe_a = jnp.where(a == 0, 1.0, a)
    safe_q = jnp.where(q == 0, 1.0, q)
    r1 = jnp.where(a == 0, -c / jnp.where(b == 0, 1.0, b), q / safe_a)
    r2 = jnp.where(q == 0, jnp.zeros_like(q), c / safe_q)
    linear = a == 0
    valid1 = jnp.where(linear, b != 0, has_roots)
    valid2 = jnp.where(linear, jnp.zeros_like(has_roots), has_roots)
    return jnp.stack([r1, r2], axis=-1), jnp.stack([valid1, valid2], axis=-1)


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (a assumed nonzero).

    Returns (roots [.., 3], valid [.., 3]). Trigonometric (Viete) method —
    branchless, one or three real roots. Parity: `theia::SolveCubicReals`.
    """
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    inv_a = 1.0 / a
    p = b * inv_a
    q = c * inv_a
    r = d * inv_a
    # Depressed cubic t^3 + A t + B, x = t - p/3.
    A = q - p * p / 3.0
    B = (2.0 * p * p * p - 9.0 * p * q + 27.0 * r) / 27.0
    shift = -p / 3.0

    disc = 0.25 * B * B + A * A * A / 27.0
    three_real = disc <= 0

    # --- Three real roots: trigonometric form (A < 0 here). ---
    mA = jnp.minimum(A, -1e-30)
    m = 2.0 * jnp.sqrt(-mA / 3.0)
    acos_arg = jnp.clip(3.0 * B / (mA * m), -1.0, 1.0)
    phi = jnp.arccos(acos_arg) / 3.0
    two_pi_3 = 2.0943951023931953
    t0 = m * jnp.cos(phi)
    t1 = m * jnp.cos(phi - two_pi_3)
    t2 = m * jnp.cos(phi - 2.0 * two_pi_3)

    # --- One real root: Cardano with cbrt. ---
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-0.5 * B + sq)
    v = jnp.cbrt(-0.5 * B - sq)
    t_single = u + v

    r0 = jnp.where(three_real, t0, t_single) + shift
    r1_ = jnp.where(three_real, t1, t_single) + shift
    r2_ = jnp.where(three_real, t2, t_single) + shift
    roots = jnp.stack([r0, r1_, r2_], axis=-1)
    valid = jnp.stack(
        [jnp.ones_like(three_real), three_real, three_real], axis=-1
    )
    return roots, valid


def solve_quartic(a, b, c, d, e, newton_iters: int = 2):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e.

    Returns (roots [.., 4], valid [.., 4]). Ferrari resolvent-cubic method
    with optional Newton polish (helps f32). Parity:
    `theia::SolveQuarticReals` (`math/closed_form_polynomial_solver.h`).
    """
    a, b, c, d, e = jnp.broadcast_arrays(a, b, c, d, e)
    inv_a = 1.0 / a
    b_, c_, d_, e_ = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    # Depressed quartic y^4 + p y^2 + q y + r, x = y - b/4.
    b2 = b_ * b_
    p = c_ - 3.0 * b2 / 8.0
    q = d_ - 0.5 * b_ * c_ + b2 * b_ / 8.0
    r = e_ - 0.25 * b_ * d_ + b2 * c_ / 16.0 - 3.0 * b2 * b2 / 256.0
    shift = -0.25 * b_

    # Resolvent cubic: z^3 + 2p z^2 + (p^2-4r) z - q^2 = 0; need a root z >= 0.
    zroots, zvalid = solve_cubic(
        jnp.ones_like(p), 2.0 * p, p * p - 4.0 * r, -q * q
    )
    # Pick the largest valid real root (it is >= 0 up to rounding).
    z = jnp.max(jnp.where(zvalid, zroots, -jnp.inf), axis=-1)
    z = jnp.maximum(z, 0.0)
    s = jnp.sqrt(z)

    # y^2 +- s y + (p + z)/2 -+ q/(2s) factorization.
    small_s = s < 1e-12
    safe_s = jnp.where(small_s, 1.0, s)
    t1 = 0.5 * (p + z) - jnp.where(small_s, 0.0, 0.5 * q / safe_s)
    t2 = 0.5 * (p + z) + jnp.where(small_s, 0.0, 0.5 * q / safe_s)
    # If s == 0: biquadratic y^4 + p y^2 + r = 0.
    biq, biq_valid = solve_quadratic(jnp.ones_like(p), p, r)
    y_sq0 = biq[..., 0]
    y_sq1 = biq[..., 1]

    ra, va = solve_quadratic(jnp.ones_like(s), s, t1)
    rb, vb = solve_quadratic(jnp.ones_like(s), -s, t2)

    # Biquadratic fallback roots.
    sq0 = jnp.sqrt(jnp.maximum(y_sq0, 0.0))
    sq1 = jnp.sqrt(jnp.maximum(y_sq1, 0.0))
    biq_roots = jnp.stack([sq0, -sq0, sq1, -sq1], axis=-1)
    biq_mask = jnp.stack(
        [
            biq_valid[..., 0] & (y_sq0 >= 0),
            biq_valid[..., 0] & (y_sq0 >= 0),
            biq_valid[..., 1] & (y_sq1 >= 0),
            biq_valid[..., 1] & (y_sq1 >= 0),
        ],
        axis=-1,
    )

    fact_roots = jnp.concatenate([ra, rb], axis=-1)
    fact_mask = jnp.concatenate([va, vb], axis=-1)

    y = jnp.where(small_s[..., None], biq_roots, fact_roots)
    valid = jnp.where(small_s[..., None], biq_mask, fact_mask)
    roots = y + shift[..., None]

    # Newton polish on the original quartic (f32-critical).
    coeffs = jnp.stack([a, b, c, d, e], axis=-1)
    dcoeffs = polyder_coeffs(coeffs)
    for _ in range(newton_iters):
        f = polyval(coeffs[..., None, :], roots)
        df = polyval(dcoeffs[..., None, :], roots)
        step = f / jnp.where(jnp.abs(df) < 1e-30, 1.0, df)
        roots = jnp.where(jnp.abs(df) < 1e-30, roots, roots - step)
    return roots, valid


def _homogeneous_sign_eval(coeffs: jax.Array, s: jax.Array, c: jax.Array) -> jax.Array:
    """Evaluate sum_i coeffs_i * s^(D-i) * c^i — sign of p(s/c) without overflow.

    With theta in (-pi/2, pi/2), c = cos(theta) > 0, so the sign equals
    sign(p(tan theta)) for any degree.
    """
    result = coeffs[..., 0] + jnp.zeros_like(s)
    for i in range(1, coeffs.shape[-1]):
        result = result * s + coeffs[..., i] * c ** i
    return result


def find_real_polynomial_roots(
    coeffs: jax.Array,
    grid_size: int = 256,
    bisect_iters: int = 48,
    newton_iters: int = 3,
):
    """All real roots of an arbitrary-degree polynomial, batched + branchless.

    Parity: `theia::FindPolynomialRoots*` (companion-matrix / Jenkins-Traub,
    `math/find_polynomial_roots_companion_matrix.h`) restricted to real roots
    — which is all the minimal solvers consume.

    Strategy (accelerator-friendly, no `eig`):
      1. theta-grid over (-pi/2, pi/2); z = tan(theta) covers all reals.
      2. Homogeneous sign evaluation at grid nodes (no overflow).
      3. Sign changes mark root brackets; keep the first D of them.
      4. `bisect_iters` bisection steps in theta per bracket.
      5. `newton_iters` Newton steps on p(z) to polish.

    Args:
      coeffs: [.., D+1] numpy-order coefficients.
      grid_size: number of grid nodes (denser -> fewer missed close pairs).
      bisect_iters: bisection refinement steps.
      newton_iters: Newton polish steps.

    Returns:
      (roots [.., D], valid [.., D]) — masked fixed-size root slots.
    """
    degree = coeffs.shape[-1] - 1
    batch_shape = coeffs.shape[:-1]
    dtype = coeffs.dtype

    # Normalize coefficients for conditioning (sign-preserving).
    scale = jnp.max(jnp.abs(coeffs), axis=-1, keepdims=True)
    coeffs = coeffs / jnp.where(scale == 0, 1.0, scale)

    # Grid nodes strictly inside (-pi/2, pi/2).
    half_pi = jnp.asarray(1.5707963267948966, dtype)
    # Margin sets the largest representable root magnitude:
    # |z|_max = cot(margin * pi/2) ~ 6.4e8 — ample for geometric problems.
    margin = 1e-9
    theta = jnp.linspace(-1.0 + margin, 1.0 - margin, grid_size).astype(dtype) * half_pi
    s = jnp.sin(theta)
    c = jnp.cos(theta)

    # Signs at all nodes: [.., G].
    vals = _homogeneous_sign_eval(coeffs[..., None, :], s, c)
    signs = jnp.sign(vals)
    # Treat exact zeros as positive to still get one bracket on each side.
    signs = jnp.where(signs == 0, 1.0, signs)
    change = signs[..., :-1] * signs[..., 1:] < 0  # [.., G-1]

    # Select up to `degree` bracket start-indices, in order.
    num_cells = grid_size - 1
    cell_idx = jnp.arange(num_cells)
    keyed = jnp.where(change, cell_idx, num_cells)  # invalid -> sentinel
    order = jnp.sort(keyed, axis=-1)[..., :degree]  # [.., D]
    valid = order < num_cells
    safe_idx = jnp.where(valid, order, 0)

    lo = theta[safe_idx]
    hi = theta[jnp.where(valid, safe_idx + 1, 0)]
    sign_lo = jnp.take_along_axis(
        jnp.broadcast_to(signs, batch_shape + (grid_size,)), safe_idx, axis=-1
    )

    # Bisection in theta.
    def bisect_body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        val_mid = _homogeneous_sign_eval(
            coeffs[..., None, :], jnp.sin(mid), jnp.cos(mid)
        )
        sign_mid = jnp.where(jnp.sign(val_mid) == 0, 1.0, jnp.sign(val_mid))
        go_left = sign_mid * sign_lo < 0
        return jnp.where(go_left, lo, mid), jnp.where(go_left, mid, hi)

    lo, hi = jax.lax.fori_loop(0, bisect_iters, bisect_body, (lo, hi))
    roots = jnp.tan(0.5 * (lo + hi))

    # Newton polish on p(z).
    dcoeffs = polyder_coeffs(coeffs)
    for _ in range(newton_iters):
        f = polyval(coeffs[..., None, :], roots)
        df = polyval(dcoeffs[..., None, :], roots)
        step = f / jnp.where(jnp.abs(df) < 1e-30, 1.0, df)
        new_roots = roots - step
        improved = jnp.abs(polyval(coeffs[..., None, :], new_roots)) <= jnp.abs(f)
        roots = jnp.where(improved, new_roots, roots)

    roots = jnp.where(valid, roots, 0.0)
    return roots, valid
