"""Chained LiDAR odometry and pose-graph optimization.

No reference counterpart (the reference is a single-pair solver); this is the
application layer BASELINE.json's north star asks for: chain scan pairs into
a trajectory, optimize the pose graph, measure ATE.

Design choices:

* all consecutive scan pairs are registered in ONE batched solve
  (``register_jit`` over the (S-1)-pair batch) — the whole odometry
  front-end is a single XLA program;
* pose composition along the chain uses ``lax.associative_scan`` (parallel
  prefix over SE(3) matmuls, log-depth on device) instead of a Python loop;
* the pose-graph back-end is batched Gauss-Newton on se(3) residuals
  log(T_meas^-1 · T_i^-1 T_j) with a dense normal-equation solve —
  adequate for thousands of keyframes; multi-host Schur partitioning rides
  the same 6x6 block structure.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import register, register_jit


class OdometryResult(NamedTuple):
    poses: jnp.ndarray        # (S, 4, 4) world-from-scan_i (first = identity)
    rel_transforms: jnp.ndarray  # (S-1, 4, 4) T_{i, i+1} scan-to-scan
    converged: jnp.ndarray    # (S-1,) bool per pair
    iterations: jnp.ndarray   # (S-1,)


def compose_chain(rel: jnp.ndarray) -> jnp.ndarray:
    """Prefix-compose relative transforms into absolute poses.

    rel (K, 4, 4) with rel[i] = T_{frame_i <- frame_{i+1}}; returns
    (K+1, 4, 4) absolute poses, pose[0] = I, pose[i+1] = pose[i] @ rel[i].
    ``lax.associative_scan`` gives a log-depth parallel prefix on device.
    """
    # full-precision matmuls: an L-deep prefix chain amplifies a reduced-
    # precision (TF32/bf16) matmul pass into O(1e-3) pose drift
    prefix = lax.associative_scan(se3.compose, rel)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=rel.dtype), (1, 4, 4))
    return jnp.concatenate([eye, prefix], axis=0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry(scans: jnp.ndarray, cfg: ICPConfig = ICPConfig(),
             rel_init: Optional[jnp.ndarray] = None) -> OdometryResult:
    """Scan-to-scan odometry over a sequence.

    scans (S, n, 3|6): consecutive clouds in their own frames (pt2pl needs
    normal columns).  Registers scan i+1 (source) against scan i (target)
    for all i in one batched solve, then prefix-composes.
    """
    S = scans.shape[0]
    dtype = scans.dtype
    # symmetric ICP reads source normals — keep 6 columns for it
    # (code-review r3: the unconditional :3 slice made icp_type='symmetric'
    # unusable through every odometry entry point)
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    source = scans[1:, :, :src_cols]
    target = scans[:-1]
    if rel_init is None:
        rel_init = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (S - 1, 4, 4))
    with jax.default_matmul_precision("float32"):
        res = register(source, target, rel_init, None, cfg)
        poses = compose_chain(res.T)
    return OdometryResult(poses=poses, rel_transforms=res.T,
                          converged=res.converged, iterations=res.iterations)


def ate(poses_pred: jnp.ndarray, poses_true: jnp.ndarray,
        align: bool = True) -> jnp.ndarray:
    """Absolute trajectory error (RMSE over translations).

    With ``align=True`` the predicted trajectory is first rigidly aligned to
    the ground truth (closed-form Kabsch over the position sets), the
    standard ATE protocol.
    """
    p = poses_pred[:, :3, 3]
    q = poses_true[:, :3, 3]
    if align:
        from dicp_tpu.svd_icp import _kabsch

        with jax.default_matmul_precision("float32"):
            w = jnp.ones((1, p.shape[0]), dtype=p.dtype)
            C, r = _kabsch(p[None], q[None], w)
            p = jnp.matmul(p, C[0].T, precision=jax.lax.Precision.HIGHEST) + r[0]
    return jnp.sqrt(jnp.mean(jnp.sum((p - q) ** 2, axis=-1)))


class PoseGraph(NamedTuple):
    """Relative-pose graph: edge k constrains poses[i[k]], poses[j[k]] with
    measurement T_meas[k] ~ T_i^-1 T_j and scalar information weight."""
    edges_i: jnp.ndarray   # (E,) int32
    edges_j: jnp.ndarray   # (E,) int32
    t_meas: jnp.ndarray    # (E, 4, 4)
    info: jnp.ndarray      # (E,) weight per edge


def _edge_residual(t_i, t_j, t_meas):
    """se(3) residual log(T_meas^-1 · T_i^-1 · T_j): (6,)"""
    return se3.tran2vec(se3.tran_inv(t_meas) @ se3.tran_inv(t_i) @ t_j)


def edge_residual_and_jac(t_i, t_j, t_meas, dtype):
    """(residual (6,), J_i (6,6), J_j (6,6)) of one pose-graph edge w.r.t.
    right-multiplied se(3) perturbations of its endpoints.  Shared by the
    dense (:func:`pose_graph_optimize`) and partitioned
    (:mod:`dicp_tpu.parallel.pose_graph`) back-ends — their correctness
    contract is exact agreement, so the linearization must be one function.
    """
    def res_fn(xi_i, xi_j):
        return _edge_residual(t_i @ se3.vec2tran(xi_i),
                              t_j @ se3.vec2tran(xi_j), t_meas)

    zero = jnp.zeros((6,), dtype)
    r = res_fn(zero, zero)
    J_i, J_j = jax.jacfwd(res_fn, argnums=(0, 1))(zero, zero)
    return r, J_i, J_j


@functools.partial(jax.jit, static_argnames=("iterations",))
def pose_graph_optimize(poses: jnp.ndarray, graph: PoseGraph,
                        iterations: int = 10,
                        damping: float = 1e-6) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched Gauss-Newton pose-graph optimization.

    poses (V, 4, 4) initial guesses (pose 0 is gauge-fixed), graph edges with
    relative measurements.  Jacobians are taken numerically-exactly via
    jax.jacfwd of the residual w.r.t. right-multiplied se(3) perturbations —
    one vmapped 6x12 block per edge, assembled into dense normal equations
    (6V x 6V) and solved in one dense solve.  Returns (optimized poses, final cost).
    """
    V = poses.shape[0]
    dtype = poses.dtype
    E = graph.edges_i.shape[0]

    batched_rj = jax.vmap(
        lambda ti, tj, tm: edge_residual_and_jac(ti, tj, tm, dtype))

    def gn_step(poses, _):
        t_i = poses[graph.edges_i]
        t_j = poses[graph.edges_j]
        r, J_i, J_j = batched_rj(t_i, t_j, graph.t_meas)  # (E,6), (E,6,6) x2

        w = graph.info[:, None, None]
        H = jnp.zeros((V, 6, V, 6), dtype)
        b = jnp.zeros((V, 6), dtype)

        def scatter_h(H, rows, J_row, J_col, cols):
            blk = jnp.einsum("eab,eac->ebc", J_row * w, J_col)
            return H.at[rows, :, cols, :].add(blk)

        H = scatter_h(H, graph.edges_i, J_i, J_i, graph.edges_i)
        H = scatter_h(H, graph.edges_i, J_i, J_j, graph.edges_j)
        H = scatter_h(H, graph.edges_j, J_j, J_i, graph.edges_i)
        H = scatter_h(H, graph.edges_j, J_j, J_j, graph.edges_j)
        b = b.at[graph.edges_i].add(jnp.einsum("eab,ea->eb", J_i * w, r))
        b = b.at[graph.edges_j].add(jnp.einsum("eab,ea->eb", J_j * w, r))

        Hd = H.reshape(V * 6, V * 6) + damping * jnp.eye(V * 6, dtype=dtype)
        bd = b.reshape(V * 6)
        # gauge fix pose 0 exactly: replace its rows/cols with identity so
        # delta_0 = 0.  (A large-prior clamp would square the condition
        # number and break float32 — see tests/test_pose_graph_partitioned.)
        m = jnp.zeros((V * 6,), dtype).at[:6].set(1.0)
        Hd = Hd * (1.0 - m)[:, None] * (1.0 - m)[None, :] + jnp.diag(m)
        bd = bd * (1.0 - m)
        delta = -jnp.linalg.solve(Hd, bd).reshape(V, 6)
        poses = poses @ jax.vmap(se3.vec2tran)(delta)
        cost = jnp.sum(graph.info * jnp.sum(r * r, axis=-1))
        return poses, cost

    with jax.default_matmul_precision("float32"):
        poses, _ = lax.scan(gn_step, poses, None, length=iterations)
        # final cost evaluated AT the returned poses (the in-scan cost is
        # computed before each update, i.e. one iteration stale)
        r_fin, _, _ = batched_rj(poses[graph.edges_i], poses[graph.edges_j],
                                 graph.t_meas)
        cost = jnp.sum(graph.info * jnp.sum(r_fin * r_fin, axis=-1))
    return poses, cost


def odometry_pose_graph(scans: jnp.ndarray, cfg: ICPConfig = ICPConfig(),
                        loop_closures: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
                        pg_iterations: int = 10) -> OdometryResult:
    """Odometry + optional loop-closure pose-graph refinement.

    loop_closures: (idx_i (L,), idx_j (L,)) pairs of scan indices to register
    against each other as extra pose-graph edges.
    """
    odo = odometry(scans, cfg)
    S = scans.shape[0]
    i_odo = jnp.arange(S - 1, dtype=jnp.int32)
    edges_i, edges_j = i_odo, i_odo + 1
    t_meas = odo.rel_transforms
    info = jnp.ones((S - 1,), scans.dtype)

    if loop_closures is not None:
        li, lj = loop_closures
        # register_jit: the eager path re-traces the whole solve per call
        src_cols = 6 if cfg.icp_type == "symmetric" else 3
        res = register_jit(scans[lj][:, :, :src_cols], scans[li],
                           jnp.broadcast_to(jnp.eye(4, dtype=scans.dtype),
                                            (li.shape[0], 4, 4)), None, cfg=cfg)
        edges_i = jnp.concatenate([edges_i, li.astype(jnp.int32)])
        edges_j = jnp.concatenate([edges_j, lj.astype(jnp.int32)])
        t_meas = jnp.concatenate([t_meas, res.T])
        info = jnp.concatenate([info, jnp.ones((li.shape[0],), scans.dtype)])

    graph = PoseGraph(edges_i, edges_j, t_meas, info)
    poses, _ = pose_graph_optimize(odo.poses, graph, iterations=pg_iterations)
    return odo._replace(poses=poses)


def resumable_odometry(
    scans: jnp.ndarray,
    cfg: ICPConfig = ICPConfig(),
    checkpoint_path: Optional[str] = None,
    chunk: int = 64,
) -> OdometryResult:
    """Odometry over a long sequence with checkpoint/resume.

    Registers consecutive pairs in ``chunk``-sized batched solves (one jit
    cache entry per chunk shape, two for a ragged tail) and atomically
    checkpoints the accumulated relative transforms after each chunk.  If
    ``checkpoint_path`` exists, completed chunks are skipped — a killed run
    resumes where it left off and produces the identical trajectory (the
    reference has no checkpointing at all, SURVEY.md §5; this is the "real
    checkpoint/restart need" its multi-host odometry analysis calls out).
    """
    import os

    import numpy as np

    from dicp_tpu.utils.checkpoint import (load_odometry_state,
                                           save_odometry_state)

    S = scans.shape[0]
    n_pairs = S - 1
    done = 0
    rels = np.zeros((n_pairs, 4, 4), np.asarray(scans[:1]).dtype)
    conv = np.zeros((n_pairs,), bool)
    iters = np.zeros((n_pairs,), np.asarray(scans[:1]).dtype)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = load_odometry_state(checkpoint_path)
        done = int(state["step"])
        rels[:done] = state["rel_transforms"][:done]
        conv[:done] = state["converged"][:done]
        iters[:done] = state["iterations"][:done]

    while done < n_pairs:
        hi = min(done + chunk, n_pairs)
        # sources are scans[done+1 : hi+1], targets scans[done : hi]
        src_cols = 6 if cfg.icp_type == "symmetric" else 3
        res = register_jit(scans[done + 1:hi + 1, :, :src_cols], scans[done:hi],
                           jnp.broadcast_to(jnp.eye(4, dtype=scans.dtype),
                                            (hi - done, 4, 4)), None, cfg=cfg)
        rels[done:hi] = np.asarray(res.T)
        conv[done:hi] = np.asarray(res.converged)
        iters[done:hi] = np.asarray(res.iterations)
        done = hi
        if checkpoint_path is not None:
            save_odometry_state(checkpoint_path,
                                poses=compose_chain(jnp.asarray(rels[:done])),
                                rel_transforms=rels, step=done,
                                converged=conv, iterations=iters)

    poses = compose_chain(jnp.asarray(rels))
    return OdometryResult(poses=poses, rel_transforms=jnp.asarray(rels),
                          converged=jnp.asarray(conv),
                          iterations=jnp.asarray(iters))
