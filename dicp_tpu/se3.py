"""SE(3) / SO(3) Lie-group math for the ICP solvers.

Closed-form Rodrigues / Baker-Campbell-Hausdorff expressions instead of the
reference's generic ``torch.matrix_exp`` (dICP/ICP.py:210) — a dense matrix
exponential is a Padé/scaling-squaring iteration that XLA cannot fuse well,
while Rodrigues is a handful of elementwise ops.  This module also
replaces the external ``pylgmath`` dependency the reference test-suite uses
for ground truth (tests/test_ICP.py:11-13): ``vec2tran``/``tran2vec`` follow
the same convention, T = [[exp(phi^), J(phi) rho], [0, 1]] for xi = [rho, phi].

All functions are pure, dtype-preserving, broadcast over arbitrary leading
batch dimensions, and safe under ``jax.jit`` / ``jax.grad`` / ``jax.vmap``
(small-angle branches are implemented with ``jnp.where`` on safe operands so
no NaN leaks into gradients).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# These 3x3/3x1 matmuls are tiny, but a reduced-precision default (TF32 on
# the GPU) truncates them to ~3 decimal digits — enough to corrupt any
# transform-error metric computed outside the solvers' pinned-precision
# scope.  Pin full precision at every matmul in this module.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

def _small(dtype) -> float:
    """Angle below which Taylor series replace the exact trig expressions.

    Must be dtype-aware: with the f64 threshold (1e-6) in float32, ``1 - cos``
    underflows to 0 and ``arccos`` is evaluated at exactly 1.0 with a live
    tangent (infinite slope), producing wrong values and NaN gradients.  At
    0.1 the dropped Taylor terms are O(theta^6) ~ 1e-9 relative — below f32
    resolution — while the exact branches (``1 - cos``, ``1 - cot``) keep
    >= 4 significant digits.
    """
    return 1e-6 if jnp.finfo(dtype).bits >= 64 else 0.1


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric (cross-product) matrix of ``v`` with shape (..., 3).

    Returns (..., 3, 3) such that ``skew(v) @ u == cross(v, u)``.
    Mirrors the batched operator at dICP/ICP.py:513-531.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    return rows


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`skew`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _safe_theta(theta2: jnp.ndarray):
    """(small_mask, theta) with theta = 1 where small — sqrt never sees 0, so
    no inf/NaN leaks through ``jnp.where`` in reverse mode."""
    small = theta2 < _small(theta2.dtype) ** 2
    theta = jnp.sqrt(jnp.where(small, jnp.ones_like(theta2), theta2))
    return small, theta


def _sin_theta_over_theta(theta2: jnp.ndarray) -> jnp.ndarray:
    small, theta = _safe_theta(theta2)
    exact = jnp.sin(theta) / theta
    taylor = 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0
    return jnp.where(small, taylor, exact)


def _one_minus_cos_over_theta2(theta2: jnp.ndarray) -> jnp.ndarray:
    small, theta = _safe_theta(theta2)
    exact = (1.0 - jnp.cos(theta)) / jnp.where(small, jnp.ones_like(theta2), theta2)
    taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    return jnp.where(small, taylor, exact)


def exp_so3(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation: exp(phi^) for phi (..., 3) -> (..., 3, 3).

    Numerically equivalent (to ~1e-15) to the reference's
    ``torch.matrix_exp(skew(phi))`` at dICP/ICP.py:210 but closed-form.
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    a = _sin_theta_over_theta(theta2)
    b = _one_minus_cos_over_theta2(theta2)
    k = skew(phi)
    kk = _mm(k, k)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * kk


def log_so3(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation log map: (..., 3, 3) -> (..., 3). Robust near identity.

    Angles near pi are handled with the symmetric-part fallback.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - _small(cos_theta.dtype) ** 2 / 2.0  # theta < ~_small
    # arccos has infinite slope at 1 — mask its input so no NaN grad leaks
    # through jnp.where into the small-angle branch.
    theta = jnp.arccos(jnp.where(small, jnp.zeros_like(cos_theta), cos_theta))
    theta2 = theta * theta

    # Generic branch: phi = theta / (2 sin(theta)) * vee(R - R^T)
    w = vee(rot - jnp.swapaxes(rot, -1, -2))  # = 2 sin(theta) * axis
    sin_theta = jnp.sin(theta)
    near_pi = (sin_theta < 1e-6) & ~small
    safe_sin = jnp.where(small | near_pi, jnp.ones_like(sin_theta), sin_theta)
    factor_exact = theta / (2.0 * safe_sin)
    # Small branch: theta^2 ~ |w|^2 / 4 is smooth in R (w = 2 sin(theta) axis).
    t2s = 0.25 * jnp.sum(w * w, axis=-1)
    # factor = arcsin(s)/(2s) expanded in s^2 = sin^2(theta) (t2s is sin^2,
    # NOT theta^2): 1/2 + s^2/12 + 3 s^4/80 + ...  The theta^2-expansion
    # coefficient 7/720 here cost ~2 digits near the branch switch
    # (code-review r3; verified 1.8e-6 -> 1.2e-8 rel err at s=0.09).
    factor_taylor = 0.5 + t2s / 12.0 + 27.0 * t2s * t2s / 720.0
    factor = jnp.where(small, factor_taylor, factor_exact)
    phi_generic = factor[..., None] * w

    # Near-pi branch: axis from the dominant diagonal of (R + I) / 2.
    rr = (rot + jnp.broadcast_to(jnp.eye(3, dtype=rot.dtype), rot.shape)) * 0.5
    diag = jnp.stack([rr[..., 0, 0], rr[..., 1, 1], rr[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip(diag, 0.0, None)
    k = jnp.argmax(axis_sq, axis=-1)
    axis_k = jnp.sqrt(jnp.clip(jnp.take_along_axis(axis_sq, k[..., None], axis=-1)[..., 0], 1e-12, None))
    # column k of rr gives axis * axis_k
    col = jnp.take_along_axis(rr, k[..., None, None], axis=-1)[..., 0]
    axis = col / axis_k[..., None]
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    # fix sign with w (w = 2 sin(theta) axis, ~0 at pi, but keep best effort)
    sign = jnp.where(jnp.sum(axis * w, axis=-1) < 0.0, -1.0, 1.0)
    phi_pi = (sign * theta)[..., None] * axis

    return jnp.where(near_pi[..., None] & ~small[..., None], phi_pi, phi_generic)


def left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J(phi): (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    small, theta = _safe_theta(theta2)
    b = _one_minus_cos_over_theta2(theta2)  # (1-cos)/theta^2
    # (theta - sin theta)/theta^3
    safe3 = jnp.where(small, jnp.ones_like(theta2), theta2 * theta)
    c_exact = (theta - jnp.sin(theta)) / safe3
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0
    c = jnp.where(small, c_taylor, c_exact)
    k = skew(phi)
    kk = _mm(k, k)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * kk


def left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse SO(3) left Jacobian: (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    small, theta = _safe_theta(theta2)
    half = 0.5 * theta
    cot_term_exact = half / jnp.tan(half)
    cot_term_taylor = 1.0 - theta2 / 12.0 - theta2 * theta2 / 720.0
    cot = jnp.where(small, cot_term_taylor, cot_term_exact)
    k = skew(phi)
    kk = _mm(k, k)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    d_exact = (1.0 - cot) / safe_t2
    d_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    d = jnp.where(small, d_taylor, d_exact)
    return eye - 0.5 * k + d[..., None, None] * kk


def vec2tran(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential, pylgmath convention: xi = [rho, phi] (..., 6) -> (..., 4, 4).

    T = [[exp(phi^), J(phi) @ rho], [0, 1]].  Same convention as the ground
    truth builder used by the reference tests (tests/test_ICP.py:45-47).
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = exp_so3(phi)
    r = _mm(left_jacobian(phi), rho[..., None])[..., 0]
    top = jnp.concatenate([rot, r[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def tran2vec(tran: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log map (..., 4, 4) -> (..., 6), inverse of :func:`vec2tran`.

    Replaces ``pylgmath.se3op.tran2vec`` used for test error metrics
    (tests/test_ICP.py:65).
    """
    rot = tran[..., :3, :3]
    r = tran[..., :3, 3]
    phi = log_so3(rot)
    rho = _mm(left_jacobian_inv(phi), r[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def tran_inv(tran: jnp.ndarray) -> jnp.ndarray:
    """Fast SE(3) inverse: [[C, r], [0, 1]]^-1 = [[C^T, -C^T r], [0, 1]]."""
    rot_t = jnp.swapaxes(tran[..., :3, :3], -1, -2)
    r = tran[..., :3, 3:]
    top = jnp.concatenate([rot_t, -_mm(rot_t, r)], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def compose(t_ab: jnp.ndarray, t_bc: jnp.ndarray) -> jnp.ndarray:
    """Compose transforms: T_ac = T_ab @ T_bc (broadcasting matmul)."""
    return _mm(t_ab, t_bc)
