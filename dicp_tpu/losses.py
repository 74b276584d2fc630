"""Robust-loss IRLS weight functions.

Pure-function equivalents of the reference's ``loss`` class
(dICP/loss.py:3-58) — in a functional JAX design the "loss object" is just a
weight function applied inside the jitted Gauss-Newton step, letting XLA fuse
the reweighting into the residual/Jacobian computation (a single pass)
instead of a separate kernel launch.

All functions take ``err`` of shape (..., d) and reduce over the LAST axis
(matching the reference, which reduces over axis 1 for 2-D and axis 2 for 3-D
inputs — i.e. always the trailing component axis, dICP/loss.py:25-26,:38-39,
:47-52).  Weights are returned with shape (...,).
"""

from __future__ import annotations

import jax.numpy as jnp

VALID_LOSSES = ("huber", "cauchy", "welsch", "gm", "trim")


def _err_norm(err: jnp.ndarray) -> jnp.ndarray:
    """|err| over the last axis with a zero subgradient at 0.

    torch.linalg.norm defines the gradient at 0 as 0; jnp.linalg.norm yields
    NaN (d sqrt at 0).  Exact zeros DO occur: the test clouds are exact
    transforms of each other, so at convergence many residuals are 0.0 and a
    naive norm would poison the whole backward pass.
    """
    sq = jnp.sum(err * err, axis=-1)
    zero = sq == 0.0
    safe = jnp.where(zero, jnp.ones_like(sq), sq)
    return jnp.where(zero, jnp.zeros_like(sq), jnp.sqrt(safe))


def huber_weight(err: jnp.ndarray, metric: float, differentiable: bool = True) -> jnp.ndarray:
    """Huber IRLS weight.

    differentiable=True uses the pseudo-Huber weight k^2/(k^2 + |e|^2)
    (dICP/loss.py:30) — written on |e|^2 directly so it is smooth everywhere;
    False uses the classic min(1, k/|e|) (dICP/loss.py:32).
    """
    if differentiable:
        m2 = metric * metric
        return m2 / (m2 + jnp.sum(err * err, axis=-1))
    err_norm = _err_norm(err)
    # safe denominator: differentiating metric/err_norm at err_norm == 0
    # through jnp.where gives 0 * inf = NaN (exact-zero residuals are real
    # on the test clouds — the trap _err_norm exists for; code-review r3)
    safe = jnp.where(err_norm > metric, err_norm, jnp.ones_like(err_norm))
    return jnp.where(err_norm > metric, metric / safe,
                     jnp.ones_like(err_norm))


def cauchy_weight(err: jnp.ndarray, metric: float, differentiable: bool = True) -> jnp.ndarray:
    """Cauchy IRLS weight 1/(1 + (|e|/k)^2); smooth in both modes
    (dICP/loss.py:41), written on |e|^2 so the gradient is defined at 0."""
    del differentiable  # same expression either way, kept for uniform signature
    return 1.0 / (1.0 + jnp.sum(err * err, axis=-1) / (metric * metric))


def welsch_weight(err: jnp.ndarray, metric: float, differentiable: bool = True) -> jnp.ndarray:
    """Welsch/Leclerc IRLS weight exp(-|e|^2 / k^2).

    No reference counterpart; the redescending kernel used by
    Fast-and-Robust ICP (Zhang et al. 2021, arXiv:2007.07627) — rejects
    gross outliers completely (weight -> 0 exponentially) while staying
    smooth everywhere.  Same expression in both modes.
    """
    del differentiable
    return jnp.exp(-jnp.sum(err * err, axis=-1) / (metric * metric))


def gm_weight(err: jnp.ndarray, metric: float, differentiable: bool = True) -> jnp.ndarray:
    """Geman-McClure IRLS weight k^4/(k^2 + |e|^2)^2 (redescending; smooth).

    No reference counterpart; standard in LiDAR bundle adjustment.
    """
    del differentiable
    m2 = metric * metric
    d = m2 + jnp.sum(err * err, axis=-1)
    return (m2 / d) ** 2


def trim_weight(
    err: jnp.ndarray,
    metric: float,
    differentiable: bool = True,
    tanh_steepness: float = 5.0,
) -> jnp.ndarray:
    """Outlier-trimming gate.

    differentiable=True: soft step 0.5*tanh(s*(k - |e|) - 3) + 0.5
    (dICP/loss.py:54, the -3.0 offset shifts the transition inside the bound);
    False: hard indicator |e| < k (dICP/loss.py:58).
    """
    err_norm = _err_norm(err)
    if differentiable:
        return 0.5 * jnp.tanh(tanh_steepness * (metric - err_norm) - 3.0) + 0.5
    return jnp.where(err_norm < metric, jnp.ones_like(err_norm), jnp.zeros_like(err_norm))


def robust_weight(
    name: str,
    err: jnp.ndarray,
    metric: float,
    differentiable: bool = True,
    tanh_steepness: float = 5.0,
) -> jnp.ndarray:
    """Dispatch by loss name, mirroring loss.get_weight (dICP/loss.py:11-19)."""
    if name == "huber":
        return huber_weight(err, metric, differentiable)
    if name == "cauchy":
        return cauchy_weight(err, metric, differentiable)
    if name == "welsch":
        return welsch_weight(err, metric, differentiable)
    if name == "gm":
        return gm_weight(err, metric, differentiable)
    if name == "trim":
        return trim_weight(err, metric, differentiable, tanh_steepness)
    raise ValueError(f"Invalid loss name: {name}")
