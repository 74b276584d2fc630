"""Multi-chip scaling: jax.sharding mesh utilities for batched and
large-cloud registration.

The reference is strictly single-device (SURVEY.md §2.3: no distributed
anything); these are the new first-class components that scale its two
parallelism concepts across the devices of a mesh:

* **batch parallelism** (the reference's leading batch dim, dICP/ICP.py:85)
  -> scan pairs sharded over the ``batch`` mesh axis.  The solver is purely
  batch-elementwise, so XLA partitions it with ZERO collectives — linear
  scaling by construction.
* **point-level parallelism** (dense (N, n, m) distance work inside single
  ATen ops) -> the source cloud of one huge registration sharded over the
  ``map`` mesh axis under ``shard_map``.  Each device finds correspondences
  for its point shard against the replicated target and accumulates its
  partial normal equations; the ONLY cross-device traffic per Gauss-Newton
  step is the psum of the (6, 6) J^T W J block and (6,) J^T W e vector —
  42 floats per step, over NVLink on one node.
"""

from __future__ import annotations

import functools

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dicp_tpu import knn, losses, se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import ICPResult, _damping, register


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("batch", "map"),
              devices=None) -> Mesh:
    """Build a 2-D device mesh.  Default: all devices on the batch axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def shard_batch(mesh: Mesh, *arrays, axis: str = "batch"):
    """Place arrays with their leading (batch) dim sharded over ``axis``."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def register_batch_sharded(
    mesh: Mesh,
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    key=None,
) -> ICPResult:
    """Batch-data-parallel registration: N scan pairs sharded over 'batch'.

    Inputs are placed with batch-dim sharding and the ordinary jitted solver
    runs SPMD; XLA keeps every array batch-sharded end-to-end (no
    collectives).  N must be divisible by the batch axis size.
    """
    n_batch = mesh.shape["batch"]
    if source.shape[0] % n_batch != 0:
        raise ValueError(f"batch {source.shape[0]} not divisible by mesh axis {n_batch}")
    sharding = NamedSharding(mesh, P("batch"))
    source, target, T_init = (jax.device_put(x, sharding) for x in (source, target, T_init))
    if weight is not None:
        weight = jax.device_put(weight, sharding)
    # every ICPResult leaf has a leading batch dim -> one sharding fits all
    fn = jax.jit(register, static_argnames=("cfg",), out_shardings=sharding)
    return fn(source, target, T_init, weight, cfg, key)


class MapShardedResult(NamedTuple):
    """Result of a map-sharded single-cloud registration."""
    T: jnp.ndarray           # (4, 4)
    converged: jnp.ndarray   # () bool
    iterations: jnp.ndarray  # () int32
    cost: jnp.ndarray        # () final weighted squared cost


def ring_nn(x: jnp.ndarray, y_shard: jnp.ndarray, axis: str) -> jnp.ndarray:
    """1-NN of local queries against a RING-SHARDED target.

    x (n_loc, 3) queries resident on this device; y_shard (m_loc, c) this
    device's shard of the target map.  The shards rotate around the mesh
    axis with ``lax.ppermute`` (K steps on a K-device ring); each step folds
    the visiting shard into a running (best-distance, best-row) accumulator.
    This is the point-cloud analogue of ring attention (SURVEY.md §5): the
    full map never needs to fit on one chip, and the per-step transfer
    (m_loc * c floats, neighbor-to-neighbor) rides the device ring while the
    (n_loc, m_loc) distance tile is computed.

    Ties across shards resolve by ring order (this device's own shard
    first), not by global index — immaterial for real data.
    """
    k_dev = lax.axis_size(axis)
    n_loc = x.shape[0]
    perm = [(i, (i + 1) % k_dev) for i in range(k_dev)]

    def step(carry, _):
        y_cur, best_d, best_row = carry
        d2 = knn.pairwise_sq_dist(x, y_cur[:, :3])
        idx = jnp.argmin(d2, axis=-1)
        dmin = jnp.take_along_axis(d2, idx[:, None], axis=-1)[:, 0]
        rows = jnp.take(y_cur, idx, axis=0)
        better = dmin < best_d
        best_d = jnp.where(better, dmin, best_d)
        best_row = jnp.where(better[:, None], rows, best_row)
        y_next = lax.ppermute(y_cur, axis, perm)
        return (y_next, best_d, best_row), None

    # pcast: the freshly-created accumulators are device-varying from the
    # first iteration (shard_map tracks varying manual axes through scan)
    init = (y_shard,
            lax.pcast(jnp.full((n_loc,), jnp.inf, x.dtype), (axis,), to="varying"),
            lax.pcast(jnp.zeros((n_loc, y_shard.shape[1]), y_shard.dtype),
                      (axis,), to="varying"))
    (_, _, best_row), _ = lax.scan(step, init, None, length=k_dev)
    return best_row


def _preshard(cfg: ICPConfig, source, target, weight):
    """Mirror registration._preprocess's input semantics for the sharded
    wrappers (code-review r3: the sharded solve skipped them and diverged
    from register() on dim=2 / zero-pad inputs): pt2pl normal requirement,
    pt2pt normal strip, dim-2 z zeroing (dICP/ICP.py:107-116), and the
    source_zeroes_are_pad weight rule (dICP/ICP.py:445-446)."""
    if cfg.icp_type == "pt2pl" and target.shape[-1] != 6:
        raise ValueError("pt2pl requires target normals: (m, 6)")
    if cfg.icp_type == "pt2pt":
        target = target[..., :3]
    if cfg.dim == 2:
        zmask = jnp.array([1.0, 1.0, 0.0], dtype=source.dtype)
        zmask6 = jnp.concatenate([zmask, zmask])
        source = source * (zmask6 if source.shape[-1] == 6 else zmask)
        target = target * (zmask6 if target.shape[-1] == 6 else zmask)
    if cfg.source_zeroes_are_pad:
        weight = weight * (jnp.linalg.norm(source[..., :3], axis=-1)
                           != 0.0).astype(source.dtype)
    return source, target, weight


def _map_sharded_body(cfg: ICPConfig, source_shard, weight_shard, target, T_init,
                      target_sharded: bool = False, axis: str = "map",
                      n_real: Optional[int] = None):
    """Per-device body under shard_map: source points sharded over 'map'.

    Runs the full Gauss-Newton iteration with the only cross-device traffic
    being psum of the normal-equation blocks (and cheap scalar psums for the
    cost/convergence bookkeeping).  With ``target_sharded`` the target map is
    sharded too and correspondences come from :func:`ring_nn` (adds the ring
    ppermute traffic, removes the replicated-map memory requirement).
    """
    dtype = source_shard.dtype
    C0 = T_init[:3, :3]
    r0 = T_init[:3, 3]

    src_pts = source_shard[:, :3]
    src_nrm = source_shard[:, 3:6] if cfg.icp_type == "symmetric" else None
    tgt_pts = target[:, :3]
    if target_sharded:
        method = "ring"
    else:
        method = cfg.resolved_nn_method(source_shard.shape[0], target.shape[0])
    if method == "cluster":
        # index over the replicated target, built ONCE per device outside
        # the GN loop (identical on every device — pure local compute, no
        # collectives); each device then queries only its source shard.
        # The query curve-order is also computed ONCE, at the T_init pose:
        # rigid motion preserves neighborhood structure exactly
        # (registration._make_corr_fn), so recomputing the argsort every GN
        # iteration would be pure waste.
        from dicp_tpu.ops.cluster_knn import (build_cluster_index, cluster_nn,
                                              query_order)

        cl_index = build_cluster_index(tgt_pts, cfg.cluster_group)
        ps0 = src_pts @ C0.T + r0
        qord = query_order(cl_index, lax.stop_gradient(ps0))

    def gn_iteration(C, r):
        cp = src_pts @ C.T
        ps_t = cp + r
        valid = None
        if method == "ring":
            nn6 = ring_nn(ps_t, target, axis)
        elif method == "cluster":
            idx, _, cert = cluster_nn(cl_index, ps_t,
                                      probes=cfg.cluster_probes,
                                      order=qord,
                                      fixup=cfg.shard_cluster_fixup(
                                          source_shard.shape[0],
                                          lax.axis_size(axis), n_real))
            nn6 = jnp.take(target, idx, axis=0)
            # raw per-point certificate; the 50% fallback guard
            # (registration._certified_gate) is applied GLOBALLY below by
            # riding the normal-equation psum — a separate scalar psum here
            # would double the per-iteration collective count
            valid = cert.astype(dtype)
        elif method == "pallas":
            # the XLA streaming form of the tiled brute force: no
            # pallas_call inside shard_map (the per-shard (n/K, m) problem
            # is K x smaller anyway)
            idx, _ = knn.nn_argmin_stream(ps_t, tgt_pts)
            nn6 = jnp.take(target, idx, axis=0)
        else:
            idx = knn.nn_indices(ps_t, tgt_pts)
            nn6 = jnp.take(target, idx, axis=0)
        nn_err = ps_t - nn6[:, :3]

        w = weight_shard
        if cfg.trim_dist is not None:  # negative k: dICP/loss.py:54,:58 semantics
            w = w * losses.trim_weight(nn_err, cfg.trim_dist,
                                       cfg.differentiable, cfg.tanh_steepness)
        if cfg.icp_type in ("pt2pl", "symmetric"):
            if cfg.icp_type == "symmetric":
                # residual along the sum of both normals (the source normal
                # rotated into the target frame), registration._gn_step
                cnp = src_nrm @ C.T
                nrm = nn6[:, 3:6] + cnp
            else:
                nrm = nn6[:, 3:6]
            res = jnp.sum(nn_err * nrm, axis=-1)          # (n_local,)
            if cfg.loss_name is not None:
                w = w * losses.robust_weight(cfg.loss_name, res[:, None],
                                             cfg.loss_metric, cfg.differentiable,
                                             cfg.tanh_steepness)
            J_C = jnp.cross(nrm, cp)
            if cfg.icp_type == "symmetric":
                J_C = J_C + jnp.cross(nn_err, cnp)
            J = jnp.concatenate([J_C, -nrm], axis=-1)     # (n_local, 6)
        else:
            if cfg.loss_name is not None:
                w = w * losses.robust_weight(cfg.loss_name, nn_err,
                                             cfg.loss_metric, cfg.differentiable,
                                             cfg.tanh_steepness)
            n_local = source_shard.shape[0]
            J = jnp.concatenate(
                [se3.skew(cp).reshape(3 * n_local, 3),
                 -jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n_local, 3, 3)).reshape(3 * n_local, 3)],
                axis=-1)
            res = nn_err.reshape(3 * n_local)
            w = jnp.repeat(w, 3, axis=-1)
            if valid is not None:
                valid = jnp.repeat(valid, 3, axis=-1)

        if cfg.dim == 2:
            J = J[:, 2:5]
        k = J.shape[-1]
        # Partial normal equations on this shard; the psum of these blocks is
        # the ONLY per-iteration cross-device traffic (<= 6x6 + 6 floats;
        # doubled plus one count when the certificate gate is active).

        def _ne(wv):
            return (J.T @ (wv[:, None] * J),     # (k, k)
                    J.T @ (wv * res),            # (k,)
                    jnp.sum(wv * res * res))

        if valid is None:
            A, b, cost = lax.psum(_ne(w), axis)
        else:
            # The 50% certification fallback (registration._certified_gate)
            # must fire on the GLOBAL fraction or shards diverge near the
            # threshold — but a separate scalar psum would add a second
            # per-iteration collective.  Instead both the gated and ungated
            # normal equations plus the certified count share the ONE fused
            # all-reduce (independent summands: XLA's combiner merges them),
            # and the guard selects after the psum.
            ne_g = _ne(w * valid)
            ne_f = _ne(w)
            if n_real is not None:
                # exclude the wrapper's synthetic zero-weight pads from the
                # fraction (numerator AND denominator): their certificates
                # are arbitrary and could flip the gate vs the unsharded
                # solve near the threshold (code-review r3).  Comparison
                # base is per-POINT even after the pt2pt x3 repeat.
                rep = valid.shape[0] // src_pts.shape[0]
                n_loc_pts = src_pts.shape[0]
                gidx = (lax.axis_index(axis) * n_loc_pts
                        + jnp.arange(n_loc_pts))
                real = (gidx < n_real).astype(valid.dtype)
                cnt_local = jnp.sum(valid[::rep] * real)
                denom = float(n_real)
            else:
                cnt_local = jnp.sum(valid) / (valid.shape[0]
                                              // src_pts.shape[0])
                denom = src_pts.shape[0] * lax.axis_size(axis)
            (A_g, b_g, c_g), (A_f, b_f, c_f), cnt = lax.psum(
                (ne_g, ne_f, cnt_local), axis)
            frac = cnt / denom
            use = frac >= 0.5
            A = jnp.where(use, A_g, A_f)
            b = jnp.where(use, b_g, b_f)
            cost = jnp.where(use, c_g, c_f)
        A = A + _damping(cfg, A) * jnp.eye(k, dtype=dtype)
        from dicp_tpu.ops.smallsolve import solve_spd
        delta_k = -solve_spd(A, b) if cfg.solve_method == "closed" \
            else -jnp.linalg.solve(A, b[:, None])[:, 0]

        if cfg.dim == 2:
            z = jnp.zeros((1,), dtype=dtype)
            delta6 = jnp.concatenate([z, z, delta_k, z])
        else:
            delta6 = delta_k
        del_C = se3.exp_so3(delta6[:3])
        C_new = del_C.T @ C
        r_new = r - delta6[3:]
        return C_new, r_new, jnp.linalg.norm(delta6), cost

    def cond(state):
        C, r, it, done, cost = state
        return (it < cfg.max_iterations) & jnp.logical_not(done)

    def body(state):
        C, r, it, done, _ = state
        C, r, step_norm, cost = gn_iteration(C, r)
        done = step_norm < cfg.tolerance
        return C, r, it + 1, done, cost

    # driver: scan (fixed trip count, reverse-differentiable) when
    # differentiable, while (true early exit) otherwise — overridable via
    # cfg.driver, which the sharded IFT uses (smooth weights + while
    # forward: custom_vjp never differentiates through the loop).
    if cfg.resolved_driver() == "scan":
        def scan_body(state, _):
            C, r, it, done, cost = state

            def run(s):
                C_, r_, it_, _, _ = s
                C2, r2, sn, c2 = gn_iteration(C_, r_)
                return C2, r2, it_ + 1, sn < cfg.tolerance, c2

            state = lax.cond(done, lambda s: s, run, state)
            return state, None

        init = (C0, r0, jnp.int32(0), jnp.bool_(False), jnp.zeros((), dtype))
        (C, r, it, done, cost), _ = lax.scan(scan_body, init, None,
                                             length=cfg.max_iterations)
    else:
        init = (C0, r0, jnp.int32(0), jnp.bool_(False), jnp.zeros((), dtype))
        C, r, it, done, cost = lax.while_loop(cond, body, init)

    # the in-loop cost is evaluated at each iteration's INPUT pose; report
    # the cost at the returned pose (one extra correspondence pass)
    _, _, _, cost = gn_iteration(C, r)
    T = jnp.eye(4, dtype=dtype).at[:3, :3].set(C).at[:3, 3].set(r)
    return T, done, it, cost


def register_map_sharded(
    mesh: Mesh,
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: Optional[jnp.ndarray] = None,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Register ONE large scan against a target map with the scan's points
    sharded across the ``map`` mesh axis.

    source (n, 3) with n divisible by the axis size (pad with zero-weight
    points otherwise), target (m, 3|6) replicated, T_init (4, 4).
    Per GN step the devices exchange only the psum-reduced 6x6/6 normal
    equations — the scaling design called for by SURVEY.md §2.3.
    """
    n = source.shape[0]
    n_dev = mesh.shape[axis]
    dtype = source.dtype
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    if cfg.icp_type == "symmetric" and source.shape[1] < 6:
        raise ValueError("symmetric ICP requires 6-column sources "
                         "(coordinates + normals)")
    if T_init is None:
        T_init = jnp.eye(4, dtype=dtype)
    if weight is None:
        weight = jnp.ones((n,), dtype=dtype)
    source, target, weight = _preshard(cfg, source, target, weight)
    pad = (-n) % n_dev
    if pad:
        source = jnp.concatenate(
            [source, jnp.zeros((pad, source.shape[1]), dtype=dtype)])
        weight = jnp.concatenate([weight, jnp.zeros((pad,), dtype=dtype)])

    fn = map_sharded_fn(mesh, cfg, axis=axis, target_sharded=False,
                        n_real=n if pad else None)
    T, done, it, cost = fn(source[:, :src_cols], weight, target, T_init)
    return MapShardedResult(T=T, converged=done, iterations=it, cost=cost)


@functools.lru_cache(maxsize=64)
def map_sharded_fn(mesh: Mesh, cfg: ICPConfig, axis: str = "map",
                   target_sharded: bool = False,
                   n_real: Optional[int] = None):
    """The jitted SPMD callable behind :func:`register_map_sharded` /
    :func:`register_ring_sharded` — exposed so tests can ``.lower()`` it and
    pin the compiled collective counts.

    lru_cached on the hashable key (mesh, cfg, axis, target_sharded,
    n_real): without it every call built a fresh closure and a fresh
    jax.jit wrapper, so JAX's executable cache (keyed on function identity)
    missed on every scan of an odometry loop — seconds of recompilation per
    call (code-review r3)."""
    def body(src_s, w_s, tgt, t_init):
        # pin f32 matmul precision: the per-shard distance/Jacobian matmuls
        # run outside register()'s pinned scope
        with jax.default_matmul_precision("float32"):
            return _map_sharded_body(cfg, src_s, w_s, tgt, t_init,
                                     target_sharded=target_sharded, axis=axis,
                                     n_real=n_real)

    tgt_spec = P(axis) if target_sharded else P()
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), tgt_spec, P()),
        out_specs=(P(), P(), P(), P()),
    ))


def register_ring_sharded(
    mesh: Mesh,
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: Optional[jnp.ndarray] = None,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Register one large scan against a map TOO LARGE TO REPLICATE.

    Both the source points and the target map are sharded over the ``axis``
    mesh axis; correspondences come from :func:`ring_nn` (ppermute ring over
    the target shards), the normal equations from the same psum reduction as
    :func:`register_map_sharded`.  Per-device memory is O(n/K + m/K) instead
    of O(n/K + m).

    Target padding uses a far-away sentinel row (coordinates 1e15) so padded
    rows can never win a distance comparison — the ring accumulator keeps
    them out without masks.

    Tie-break deviation: when a query is exactly equidistant to points in
    DIFFERENT target shards, the winner is the first shard visited in ring
    order (each device starts from its own shard), not the globally lowest
    index that the single-device solver would pick.  Immaterial for real
    scan data; exact-tie inputs may differ from ``register`` by the choice
    among equal-distance correspondences.
    """
    n, m = source.shape[0], target.shape[0]
    n_dev = mesh.shape[axis]
    dtype = source.dtype
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    if cfg.icp_type == "symmetric" and source.shape[1] < 6:
        raise ValueError("symmetric ICP requires 6-column sources "
                         "(coordinates + normals)")
    if T_init is None:
        T_init = jnp.eye(4, dtype=dtype)
    if weight is None:
        weight = jnp.ones((n,), dtype=dtype)
    source, target, weight = _preshard(cfg, source, target, weight)
    pad_n = (-n) % n_dev
    if pad_n:
        source = jnp.concatenate(
            [source, jnp.zeros((pad_n, source.shape[1]), dtype=dtype)])
        weight = jnp.concatenate([weight, jnp.zeros((pad_n,), dtype=dtype)])
    pad_m = (-m) % n_dev
    if pad_m:
        sentinel = jnp.full((pad_m, target.shape[1]), 0.0, dtype=dtype)
        sentinel = sentinel.at[:, :3].set(1e15)
        target = jnp.concatenate([target, sentinel])

    fn = map_sharded_fn(mesh, cfg, axis=axis, target_sharded=True)
    T, done, it, cost = fn(source[:, :src_cols], weight, target, T_init)
    return MapShardedResult(T=T, converged=done, iterations=it, cost=cost)
