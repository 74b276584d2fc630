"""Closed-form batched solves for the tiny SPD normal-equation systems.

The Gauss-Newton step needs one (k, k) solve per batch element with k = 3
(dim=2) or k = 6 (dim=3) — cf. the reference's ``torch.linalg.inv`` at
dICP/ICP.py:201.  XLA lowers ``jnp.linalg.solve`` to a generic batched LU
with row pivoting (sequential inner loops, poor utilization for k<=6).
These closed forms replace it with a fixed dag of elementwise
multiplies/adds that XLA fuses into a handful of ops:

* k = 3: Cramer's rule (adjugate / determinant) — ~40 flops.
* k = 6: 2x2 block inversion via the Schur complement of the leading 3x3
  block, each 3x3 inverse by adjugate — ~330 flops, no data-dependent
  control flow, no pivoting.

Pivot-free is safe here because the solver always hands us an SPD matrix
(J^T W J + lambda*I with lambda > 0): every principal submatrix — in
particular the leading 3x3 block and its Schur complement — is itself SPD,
so the block elimination never divides by a small pivot that pivoting would
have avoided.  Accuracy vs LU is ~1e-6 relative in f32 on the solver's
systems (see tests/test_smallsolve.py).

All functions broadcast over arbitrary leading batch dims and are
differentiable (plain arithmetic, no custom VJPs needed).
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def solve3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a @ x = b for (..., 3, 3) SPD a and (..., 3) b (Cramer)."""
    return jnp.einsum("...ij,...j->...i", inv3(a), b)


def solve6_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a @ x = b for (..., 6, 6) SPD a and (..., 6) b.

    Schur-complement block elimination on the 2x2 partition of 3x3 blocks:
        [P  Q] [x1]   [b1]          M = S - Qt P^-1 Q        (SPD)
        [Qt S] [x2] = [b2]   =>     x2 = M^-1 (b2 - Qt P^-1 b1)
                                    x1 = P^-1 (b1 - Q x2)
    """
    p = a[..., :3, :3]
    q = a[..., :3, 3:]
    qt = a[..., 3:, :3]
    s = a[..., 3:, 3:]
    b1, b2 = b[..., :3], b[..., 3:]

    p_inv = inv3(p)
    p_inv_q = p_inv @ q                                   # (..., 3, 3)
    m = s - qt @ p_inv_q
    p_inv_b1 = jnp.einsum("...ij,...j->...i", p_inv, b1)
    x2 = solve3(m, b2 - jnp.einsum("...ij,...j->...i", qt, p_inv_b1))
    x1 = p_inv_b1 - jnp.einsum("...ij,...j->...i", p_inv_q, x2)
    return jnp.concatenate([x1, x2], axis=-1)


def solve_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dispatch on the (static) system size; fall back to LU otherwise.

    b is (..., k); returns (..., k).

    Jacobi (diagonal) equilibration is applied first: ICP normal equations
    mix a rotation block scaling with (point radius)^2 and a translation
    block scaling with 1 — a 1e4+ scale disparity that makes the f32 Schur
    complement cancel catastrophically (observed: det -> 0 -> NaN on real
    scan pairs; LU with pivoting survived the same systems).  Scaling by
    D = diag(A)^{-1/2} gives unit diagonal — SPD-ness is preserved and the
    block condition numbers collapse to O(1).
    """
    k = a.shape[-1]
    if k not in (3, 6):
        return jnp.linalg.solve(a, b[..., None])[..., 0]
    d = jnp.sqrt(jnp.clip(jnp.diagonal(a, axis1=-2, axis2=-1), 1e-30, None))
    dinv = 1.0 / d
    a_eq = a * dinv[..., :, None] * dinv[..., None, :]
    b_eq = b * dinv
    y = solve3(a_eq, b_eq) if k == 3 else solve6_spd(a_eq, b_eq)
    return y * dinv
