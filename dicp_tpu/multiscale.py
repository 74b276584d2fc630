"""Coarse-to-fine multiscale ICP (voxel pyramid).

No reference counterpart: the reference registers raw clouds at a single
scale (dICP/ICP.py:49-303).  This is the standard production recipe (cf.
Open3D ``multi_scale_icp``) for two wins the single-scale solver cannot
offer:

* a wider convergence basin — coarse voxel centroids smooth the cost
  surface, so a poor ``T_init`` that strands the full-resolution solver in
  a local minimum is first pulled into the basin at low resolution;
* fewer full-resolution iterations — the expensive final level starts from
  an almost-converged pose and only polishes.

Design
------
Each level is a STATIC-shape solve: the dynamic number of occupied voxels
is re-packed into a fixed per-level slot budget by :func:`subsample_packed`
(a systematic gather over the packed centroids — exact when the budget
holds everything, a spatially unbiased stride otherwise, since the packed
order is lexicographic in cell coordinates).  The level loop is a static
Python loop, so the whole pyramid traces into ONE jitted XLA program; no
host sync, no dynamic shapes, vmap/pjit-compatible.

Per-voxel source weights are EXACT: the user weight rides through the
voxel average as an extra column, and ``mean(w) * count == sum(w)`` over
each voxel's members, so a coarse level solves the same weighted
least-squares objective as full resolution restricted to centroids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from dicp_tpu.config import ICPConfig
from dicp_tpu.ops.voxel import voxel_downsample
from dicp_tpu.registration import ICPResult, register


class ScaleLevel(NamedTuple):
    """One pyramid level.

    voxel_size <= 0 means full resolution (no downsampling; the slot
    budgets are ignored and the original clouds are used verbatim).
    ``trim_dist=None`` inherits the solver config's value; coarse levels
    usually want it scaled up with the voxel size (residuals are larger
    before alignment).
    """

    voxel_size: float
    n_source: int = 0
    m_target: int = 0
    max_iterations: int = 20
    tolerance: float = 1e-6
    trim_dist: Optional[float] = None
    # correspondence backend override: a coarse few-thousand-centroid level
    # should not pay the cluster-index build the 100k final level needs
    nn_method: Optional[str] = None


class MultiscaleResult(NamedTuple):
    result: ICPResult            # final (finest) level, full contract
    level_T: jnp.ndarray         # (L, N, 4, 4) pose after each level
    level_iterations: jnp.ndarray  # (L, N) iterations spent per level


def subsample_packed(points: jnp.ndarray, weight: jnp.ndarray,
                     count: jnp.ndarray, cap: int
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Re-pack ``count`` valid leading rows into a static ``cap`` slots.

    When ``count <= cap``: identity on the valid rows, zero-weight
    duplicates of the last valid row after (a valid coordinate, so a
    hard-NN target can use it as padding — duplicates are harmless there,
    and zero weight makes it a no-op as a source row).

    When ``count > cap``: a systematic stride ``(i * count) // cap`` over
    the packed rows — every selected row is valid and keeps its own
    weight; because the packing is lexicographic in voxel coordinates the
    stride is a spatially unbiased subsample, not a "first cap cells"
    spatial crop.
    """
    n = points.shape[0]
    i = jnp.arange(cap)
    cnt = jnp.maximum(count, 1)
    idx_over = (i * cnt) // cap
    idx_under = jnp.minimum(i, cnt - 1)
    over = cnt > cap
    idx = jnp.clip(jnp.where(over, idx_over, idx_under), 0, n - 1)
    valid = jnp.where(over, True, i < cnt)
    return points[idx], weight[idx] * valid.astype(weight.dtype)


def _renormalize_normals(cloud: jnp.ndarray) -> jnp.ndarray:
    """Voxel-averaged normals (cols 3:6) back to unit length.

    A voxel whose member normals cancel (norm ~ 0) keeps the zero normal:
    the pt2pl residual of a zero-normal row is 0, a safe no-op, matching
    the solver's zero-row padding convention (registration.py:105).
    """
    nrm = cloud[:, 3:6]
    length = jnp.linalg.norm(nrm, axis=1, keepdims=True)
    unit = nrm / jnp.maximum(length, 1e-12)
    unit = jnp.where(length > 1e-6, unit, 0.0)
    return jnp.concatenate([cloud[:, :3], unit, cloud[:, 6:]], axis=1)


def _downsample_cloud(cloud: jnp.ndarray, weight: Optional[jnp.ndarray],
                      voxel_size: float, cap: int
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One unbatched cloud -> (cap, d) centroids + (cap,) summed weights.

    The user weight rides through the voxel mean as an extra column so the
    per-voxel weight is exactly ``sum`` of its members' weights (see module
    docstring); rows with weight 0 therefore contribute nothing beyond a
    centroid shift of an already-zero-weight voxel.
    """
    d = cloud.shape[1]
    if weight is None:
        weight = jnp.ones((cloud.shape[0],), cloud.dtype)
    vr = voxel_downsample(
        jnp.concatenate([cloud, weight[:, None]], axis=1), voxel_size)
    pts, mean_w = vr.points[:, :d], vr.points[:, d]
    w = mean_w * vr.weight  # mean * count == sum of member weights
    if d >= 6:
        pts = _renormalize_normals(pts)
    return subsample_packed(pts, w, vr.count, cap)


def register_multiscale(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    levels: Sequence[ScaleLevel] = (),
    key: Optional[jax.Array] = None,
    warmup_stop_gradient: bool = True,
) -> MultiscaleResult:
    """Coarse-to-fine batched registration over a static level pyramid.

    Same batched contract as :func:`dicp_tpu.registration.register`
    ((N, n, 3|6), (N, m, 3|6), (N, 4, 4)); ``levels`` must be a static
    Python sequence of :class:`ScaleLevel`, coarsest first; the last level
    is conventionally full resolution (``voxel_size <= 0``).

    ``warmup_stop_gradient`` (default) cuts reverse-mode AD at the
    inter-level pose handoffs: with a differentiable cfg, gradients are
    those of the FINAL level's solve alone.  Under the implicit-function
    theorem this loses nothing — the final fixed point does not depend on
    its initialization — and it avoids unrolling the coarse levels'
    iterations.  Set False to differentiate through the whole pyramid.

    Coarse levels run with ``collect_histories=False`` (their per-iteration
    histories have no reference contract and their shapes differ per
    level); the final level runs the user's cfg verbatim, so the returned
    ``result`` honors the full results contract.
    """
    if not levels:
        raise ValueError("levels must be a non-empty static sequence of "
                         "ScaleLevel (coarsest first)")
    for lv in levels:
        if lv.voxel_size > 0 and (lv.n_source <= 0 or lv.m_target <= 0):
            raise ValueError(
                f"level {lv}: downsampled levels need positive static slot "
                f"budgets n_source/m_target")
    if cfg.use_gumbel and cfg.differentiable:
        if key is None:
            raise ValueError("Gumbel NN requires an explicit PRNG key")
        keys = list(jax.random.split(key, len(levels)))
    else:
        keys = [None] * len(levels)

    T = T_init
    level_T, level_iters = [], []
    result = None
    for li, lv in enumerate(levels):
        last = li == len(levels) - 1
        over = {}
        if lv.trim_dist is not None:
            over["trim_dist"] = lv.trim_dist
        if lv.nn_method is not None:
            over["nn_method"] = lv.nn_method
        lcfg = cfg.with_(max_iterations=lv.max_iterations,
                         tolerance=lv.tolerance, **over)
        if not last:
            lcfg = lcfg.with_(collect_histories=False)
        if lv.voxel_size > 0:
            src, w = jax.vmap(
                lambda c, wt: _downsample_cloud(c, wt, lv.voxel_size,
                                                lv.n_source)
            )(source, weight) if weight is not None else jax.vmap(
                lambda c: _downsample_cloud(c, None, lv.voxel_size,
                                            lv.n_source))(source)
            tgt, _ = jax.vmap(
                lambda c: _downsample_cloud(c, None, lv.voxel_size,
                                            lv.m_target))(target)
        else:
            src, w, tgt = source, weight, target
        res = register(src, tgt, T, w, lcfg, keys[li])
        T = res.T
        level_T.append(T)
        level_iters.append(res.iterations)
        if warmup_stop_gradient and not last:
            T = jax.lax.stop_gradient(T)
        result = res
    return MultiscaleResult(result=result,
                            level_T=jnp.stack(level_T),
                            level_iterations=jnp.stack(level_iters))
