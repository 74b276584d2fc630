"""Stochastic mini-batch ICP (SGD-ICP) — O(k·m) per iteration, k ≪ n.

No reference counterpart (the reference always iterates over the full
cloud, dICP/ICP.py:132); this implements the retrieved technique paper
"Speeding Up Iterative Closest Point Using Stochastic Gradient Descent"
[Maken, Ramos, Ott, arXiv:1907.09133]: each iteration samples a mini-batch
of k source points, finds THEIR nearest neighbors only, and takes a
stochastic step on the se(3) pose.  Per-iteration cost drops from O(n·m)
to O(k·m) — the regime where the correspondence search dominates the
GN iteration at 100k points.

Three update rules on the mini-batch normal equations / gradient:

* ``'gn'`` (default) — stochastic Gauss-Newton: solve the mini-batch 6x6
  system (ops/smallsolve.solve_spd, Levenberg-damped).  Converges in
  near-full-ICP iteration counts at k ≥ a few hundred; the practical
  choice, and the only curvature-aware rule.
* ``'sgd'`` — the paper's plain SGD with a 1/(1 + decay·t) learning-rate
  schedule.
* ``'adam'`` — diagonal-moment SGD (the paper's Adam variant).

Conditioning note (measured, tests/test_sgd_icp.py): on the paper's own
objective (pt2pt) the first-order rules drive the pose error to ~1e-9 in
~300 iterations; on pt2pl over gently curved scenes the pose Hessian is
ill-conditioned (the flattest direction carries 0.1-rad error at ~1e-5
cost) and first-order updates stall — use ``'gn'`` there (1e-15 on the
same scene in ≤60 iterations).

Structure (mirrors dicp_tpu.registration / gicp):
- one jitted program; fixed-trip ``lax.scan`` driver (static shapes, and
  reverse-mode differentiable by construction — the mini-batch indices are
  PRNG-keyed constants, so gradients flow through the gathered values with
  the repo's hard-diff semantics, knn.py:68);
- convergence freezing on ``patience`` consecutive sub-tolerance steps
  (a single stochastic step can dip below by minibatch luck) — converged
  elements carry their pose forward bit-identically (batch == serial);
- explicit PRNG keys (SURVEY §4 note 2: the reference's unseeded sampling
  is a defect to fix, not port);
- mini-batch NN is a dense (k, m) pass — k·m stays small by construction;
  robust/trim weights reuse dicp_tpu.losses verbatim.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import losses, se3
from dicp_tpu.ops.normals import estimate_normals
from dicp_tpu.ops.smallsolve import solve_spd


class SGDICPResult(NamedTuple):
    T: jnp.ndarray            # (N, 4, 4) source -> target
    iterations: jnp.ndarray   # (N,) float — iteration the streak crossed
    converged: jnp.ndarray    # (N,) bool
    cost: jnp.ndarray         # (N,) EMA of the mini-batch robust cost


def _minibatch_system(T, idx, src, tgt, tgt_n, weight, nn_fn, *, icp_type,
                      loss_name, loss_metric, trim_dist, differentiable):
    """Mini-batch residuals -> (H (6,6), g (6,), cost) at pose T.

    H is the mini-batch J^T W J (only used by the 'gn' rule); g is the
    IRLS gradient J^T W e shared by every rule.  ``nn_fn(p) -> (nn_idx,
    valid)`` supplies correspondences (dense argmin or cluster-index
    query; the index is detached either way — hard-diff semantics).
    """
    dt = src.dtype
    k = idx.shape[0]
    p0 = src[idx]                                        # (k, 3)
    w0 = weight[idx]                                     # (k,)
    R, t = T[:3, :3], T[:3, 3]
    p = p0 @ R.T + t

    nn, valid = nn_fn(p)
    if valid is not None:
        w0 = w0 * valid.astype(dt)
    q = tgt[nn]
    r3 = p - q                                           # (k, 3)

    if icp_type == "pt2pl":
        n_q = tgt_n[nn]
        e = jnp.sum(r3 * n_q, axis=-1)                   # (k,)
        loss_err = e[:, None]
    else:
        e = r3
        loss_err = r3

    w = w0
    if trim_dist is not None:
        w = w * losses.trim_weight(r3, trim_dist, differentiable)
    if loss_name is not None:
        w = w * losses.robust_weight(loss_name, loss_err, loss_metric,
                                     differentiable)

    if icp_type == "pt2pl":
        # J = n^T [I | -skew(p)] = [n | p x n]  ->  (k, 6)
        J = jnp.concatenate([n_q, jnp.cross(p, n_q)], axis=-1)
        He = jnp.einsum("ki,k,kj->ij", J, w, J)
        g = jnp.einsum("ki,k->i", J, w * e)
        cost = jnp.sum(w * e * e)
    else:
        Jr = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3, dtype=dt), (k, 3, 3)),
             -se3.skew(p)], axis=-1)                     # (k, 3, 6)
        He = jnp.einsum("kci,k,kcj->ij", Jr, w, Jr)
        g = jnp.einsum("kci,kc->i", Jr, w[:, None] * e)
        cost = jnp.sum(w[:, None] * e * e)
    wsum = jnp.maximum(jnp.sum(w), 1e-10)
    return He / wsum, g / wsum, cost / wsum


def _step_delta(H, g, m1, m2, it, *, optimizer, lr, lr_decay, b1, b2, dt):
    """One update delta (6,) + new Adam moments for the chosen rule."""
    if optimizer == "gn":
        lam = 1e-8 * jnp.trace(H) / 6.0 + 1e-12
        return (-solve_spd(H + lam * jnp.eye(6, dtype=dt), g)), m1, m2
    lr_t = lr / (1.0 + lr_decay * it)
    if optimizer == "sgd":
        return -lr_t * g, m1, m2
    # adam
    m1 = b1 * m1 + (1.0 - b1) * g
    m2 = b2 * m2 + (1.0 - b2) * g * g
    c1 = 1.0 - b1 ** (it + 1.0)
    c2 = 1.0 - b2 ** (it + 1.0)
    return (-lr_t * (m1 / c1) / (jnp.sqrt(m2 / c2) + 1e-8)), m1, m2


def _dense_nn_fn(tgt):
    def nn_fn(p):
        d2 = (jnp.sum(p * p, 1)[:, None] + jnp.sum(tgt * tgt, 1)[None, :]
              - 2.0 * p @ tgt.T)                         # (k, m)
        return jnp.argmin(d2, axis=1), None
    return nn_fn


def _cluster_nn_fn(tgt, group, probes, fixup):
    """Index built ONCE per solve (tgt is constant across iterations); each
    mini-batch query is O(k·probes·group) instead of O(k·m).  Uncertified
    queries beyond the fixup budget are dropped for that iteration via the
    valid gate (an unbiased stochastic solver tolerates dropped samples;
    the certificate may under-claim but never lies)."""
    from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_nn

    index = build_cluster_index(tgt, group)

    def nn_fn(p):
        idx, _, cert = cluster_nn(index, lax.stop_gradient(p), probes=probes,
                                  fixup=fixup)
        return idx, cert
    return nn_fn


def _solve_one(src, tgt, tgt_n, weight, T0, key, *, icp_type, loss_name,
               loss_metric, trim_dist, differentiable, minibatch, iterations,
               optimizer, lr, lr_decay, tolerance, ema_beta, patience,
               nn_method, cluster_group, cluster_probes, cluster_fixup):
    dt = src.dtype
    n = src.shape[0]
    if nn_method == "cluster":
        nn_fn = _cluster_nn_fn(tgt, cluster_group, cluster_probes,
                               cluster_fixup)
    else:
        nn_fn = _dense_nn_fn(tgt)
    sys_fn = partial(_minibatch_system, src=src, tgt=tgt, tgt_n=tgt_n,
                     weight=weight, nn_fn=nn_fn, icp_type=icp_type,
                     loss_name=loss_name, loss_metric=loss_metric,
                     trim_dist=trim_dist, differentiable=differentiable)

    def body(c, it):
        T, m1, m2, streak, cost_ema, done, num_it = c
        # uniform with replacement (static shape; the paper samples the
        # mini-batch uniformly at random each iteration)
        idx = jax.random.randint(jax.random.fold_in(key, it), (minibatch,),
                                 0, n)
        H, g, cost = sys_fn(T, idx)
        delta, m1n, m2n = _step_delta(
            H, g, m1, m2, it.astype(dt), optimizer=optimizer, lr=lr,
            lr_decay=lr_decay, b1=0.9, b2=0.999, dt=dt)
        T_new = se3.vec2tran(delta) @ T
        # stochastic stopping: `patience` CONSECUTIVE sub-tolerance steps
        # (one step can dip below by minibatch luck; an EMA of step norms
        # has a long geometric tail that lags GN's fast convergence)
        streak_new = jnp.where(jnp.linalg.norm(delta) < tolerance,
                               streak + 1, 0)
        cost_new = jnp.where(it == 0, cost,
                             ema_beta * cost_ema + (1.0 - ema_beta) * cost)
        below = streak_new >= patience
        # convergence freezing (batch == serial): converged elements carry
        # pose/streak forward bit-identically
        T_out = jnp.where(done, T, T_new)
        streak_out = jnp.where(done, streak, streak_new)
        cost_out = jnp.where(done, cost_ema, cost_new)
        m1o = jnp.where(done, m1, m1n)
        m2o = jnp.where(done, m2, m2n)
        done_out = done | below
        num_out = jnp.where(below & (num_it == 0), it.astype(dt) + 1.0,
                            num_it)
        return (T_out, m1o, m2o, streak_out, cost_out, done_out, num_out), ()

    init = (T0, jnp.zeros(6, dt), jnp.zeros(6, dt), jnp.int32(0),
            jnp.asarray(jnp.inf, dt), jnp.asarray(False),
            jnp.asarray(0.0, dt))
    (T, _, _, _, cost_ema, done, num_it), _ = lax.scan(
        body, init, jnp.arange(iterations))
    num_it = jnp.where(num_it == 0, float(iterations), num_it)
    return T, num_it, done, cost_ema


def _per_element_keys(key, N):
    """One independent PRNG stream per batch element.

    A single key is split N ways; an already-batched key array (typed keys
    with shape (N,), or legacy uint32 (N, 2)) is used as-is — that makes
    batch == serial testable and lets callers pin element streams across
    batch compositions.
    """
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        if key.ndim == 0:
            return jax.random.split(key, N)
        if key.shape == (N,):
            return key
    else:  # legacy uint32 keys
        if key.ndim == 1:
            return jax.random.split(key, N)
        if key.shape[0] == N and key.ndim == 2:
            return key
    raise ValueError(
        f"key must be a single PRNG key or a batch of {N} keys; got shape "
        f"{key.shape}")


def register_sgd(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    key: jax.Array,
    weight: Optional[jnp.ndarray] = None,
    *,
    icp_type: str = "pt2pl",
    minibatch: int = 512,
    iterations: int = 100,
    optimizer: str = "gn",
    lr: float = 0.1,
    lr_decay: float = 0.05,
    loss_name: Optional[str] = "huber",
    loss_metric: float = 1.0,
    trim_dist: Optional[float] = None,
    tolerance: float = 1e-6,
    ema_beta: float = 0.9,
    patience: int = 3,
    differentiable: bool = False,
    k_normals: int = 16,
    nn_method: str = "auto",
    cluster_group: int = 128,
    cluster_probes: int = 16,
) -> SGDICPResult:
    """Batched stochastic mini-batch ICP: (N, n, 3), (N, m, 3|6), (N, 4, 4).

    ``key`` seeds the mini-batch sampling (one independent stream per batch
    element — results are reproducible under a fixed key and independent of
    batch composition).  ``target`` columns 3:6 are used as normals for
    pt2pl when present, otherwise estimated in-program.  ``optimizer`` is
    ``'gn'`` (stochastic Gauss-Newton — the practical default), ``'sgd'``
    (paper schedule: lr/(1 + decay·t)), or ``'adam'``.

    The stopping rule is ``patience`` consecutive steps below
    ``tolerance`` (one step can dip below by minibatch luck); the scan
    driver is fixed-trip with convergence freezing, so it is reverse-mode differentiable as-is when
    ``differentiable=True`` (smooth robust/trim weights, gradient through
    gathered values).

    ``nn_method``: 'dense' computes the (k, m) distance block per
    iteration; 'cluster' builds the Hilbert cluster index once per solve
    (the target is constant) and answers each mini-batch in
    O(k·probes·group) — 'auto' picks 'cluster' for targets ≥ 16384 points
    (same threshold as the full solver).  Cluster queries past the fixup
    budget that remain uncertified are dropped for that iteration via the
    weight gate (the certificate may under-claim, never lie).

    Accuracy note: SGD/Adam converge to a noise ball around the optimum
    scaled by the final learning rate; ``'gn'`` with k ≳ 256 reaches the
    full-batch fixed point to ~1e-5 on well-posed scenes (tests).  For
    exact fixed points use :func:`dicp_tpu.registration.register` or polish
    a SGD result with a few full GN iterations.
    """
    if source.ndim != 3 or target.ndim != 3 or T_init.ndim != 3:
        raise ValueError("register_sgd expects batched (N, n, 3), "
                         "(N, m, 3|6), (N, 4, 4)")
    if icp_type not in ("pt2pt", "pt2pl"):
        raise ValueError(f"icp_type must be pt2pt|pt2pl, got {icp_type}")
    if optimizer not in ("gn", "sgd", "adam"):
        raise ValueError(f"optimizer must be gn|sgd|adam, got {optimizer}")
    if nn_method not in ("auto", "dense", "cluster"):
        raise ValueError(f"nn_method must be auto|dense|cluster, "
                         f"got {nn_method}")
    if nn_method == "auto":
        # cluster pruning pays once the target is large (same threshold as
        # ICPConfig.resolved_nn_method); dense keeps small problems fused
        nn_method = "cluster" if target.shape[1] >= 16384 else "dense"
    dt = source.dtype
    src = source[..., :3]
    tgt = target[..., :3]
    N = src.shape[0]
    with jax.default_matmul_precision("float32"):
        if icp_type == "pt2pl":
            if target.shape[-1] >= 6:
                tgt_n = target[..., 3:6]
            else:
                tgt_n = estimate_normals(tgt, k=k_normals)
        else:
            tgt_n = jnp.zeros_like(tgt)
        if weight is None:
            weight = jnp.ones(src.shape[:-1], dt)
        keys = _per_element_keys(key, N)
        solve = partial(_solve_one, icp_type=icp_type, loss_name=loss_name,
                        loss_metric=float(loss_metric),
                        trim_dist=None if trim_dist is None
                        else float(trim_dist),
                        differentiable=differentiable,
                        minibatch=int(minibatch), iterations=int(iterations),
                        optimizer=optimizer, lr=float(lr),
                        lr_decay=float(lr_decay), tolerance=float(tolerance),
                        ema_beta=float(ema_beta), patience=int(patience),
                        nn_method=nn_method,
                        cluster_group=int(cluster_group),
                        cluster_probes=int(cluster_probes),
                        cluster_fixup=min(int(minibatch),
                                          max(64, int(minibatch) // 16)))
        T, it, done, cost = jax.vmap(solve)(src, tgt, tgt_n, weight,
                                            T_init.astype(dt), keys)
    return SGDICPResult(T=T, iterations=it, converged=done, cost=cost)


register_sgd_jit = jax.jit(
    register_sgd,
    static_argnames=("icp_type", "minibatch", "iterations", "optimizer",
                     "lr", "lr_decay", "loss_name", "loss_metric",
                     "trim_dist", "tolerance", "ema_beta", "patience",
                     "differentiable", "k_normals", "nn_method",
                     "cluster_group", "cluster_probes"))
