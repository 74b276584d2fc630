"""Implicit-function-theorem gradients for the map-sharded solver.

The single-device IFT (dicp_tpu.ift) replaces the unrolled O(iterations)
backward with one k x k solve at the fixed point.  This module extends the
same stationarity argument to the SPMD map-sharded solver
(parallel.sharding.register_map_sharded): the stationarity condition is a
psum over shards,

    G(theta*) = sum_shards G_local(theta*) = J^T W e = 0

(the quantity the sharded GN step drives to zero via its psum'd normal
equations, sharding._map_sharded_body), so

    dG/d theta = psum(dG_local/d theta)     — k JVPs, one (k,k) psum each
    input cotangents = -lambda^T dG_local/dx  (local VJPs; the replicated
    target's cotangent is the psum of the per-shard scatter-adds).

The backward therefore adds a CONSTANT number of collectives (k (k,k)-psums
+ one (m,c) psum for the target cotangent) — never O(iterations) — which
tests/test_parallel_hlo.py pins on the compiled program;
the reference's backward is the unrolled torch graph
(/root/reference/dICP/ICP.py:132, SURVEY.md §3.3).

Weighting matches the sharded solver exactly: it applies prior*trim*loss
weights LINEARLY (sharding._map_sharded_body), not through the single-device
driver's sqrt(w+1e-10)-1e-5 row scaling, so the two solvers have (equal
fixed points but) slightly different G — each IFT must linearize its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dicp_tpu import knn, losses, se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import _damping
from dicp_tpu.parallel.sharding import MapShardedResult, map_sharded_fn


def _xi_embed(cfg: ICPConfig, xi):
    """(k,) update -> (6,) [omega, rho] (dim=2 optimizes slots 2:5)."""
    if cfg.dim == 2:
        z = jnp.zeros((1,), xi.dtype)
        return jnp.concatenate([z, z, xi, z])
    return xi


def _stationarity_local(cfg: ICPConfig, xi, C_star, r_star, src_s, tgt,
                        idx, w_prior):
    """Per-shard stationarity contribution G_local(xi) (k,).

    Mirrors sharding._map_sharded_body's gn_iteration arithmetic — linear
    weights, same residuals/Jacobians — with correspondences FIXED at
    theta* (hard-NN piecewise-constant semantics, dICP/nn.py argmin
    detach).  psum over shards of this quantity is the b-vector the sharded
    GN step drives to zero.
    """
    dtype = src_s.dtype
    xi6 = _xi_embed(cfg, xi)
    del_C = se3.exp_so3(xi6[:3][None])[0]
    C = del_C.T @ C_star
    r = r_star - xi6[3:]
    cp = src_s[:, :3] @ C.T
    ps_t = cp + r
    nn6 = jnp.take(tgt, idx, axis=0)
    nn_err = ps_t - nn6[:, :3]

    w = w_prior
    if cfg.trim_dist is not None:
        w = w * losses.trim_weight(nn_err, cfg.trim_dist, True,
                                   cfg.tanh_steepness)
    if cfg.icp_type in ("pt2pl", "symmetric"):
        if cfg.icp_type == "symmetric":
            cnp = src_s[:, 3:6] @ C.T
            nrm = nn6[:, 3:6] + cnp
        else:
            nrm = nn6[:, 3:6]
        res = jnp.sum(nn_err * nrm, axis=-1)
        if cfg.loss_name is not None:
            w = w * losses.robust_weight(cfg.loss_name, res[:, None],
                                         cfg.loss_metric, True,
                                         cfg.tanh_steepness)
        J_C = jnp.cross(nrm, cp)
        if cfg.icp_type == "symmetric":
            J_C = J_C + jnp.cross(nn_err, cnp)
        J = jnp.concatenate([J_C, -nrm], axis=-1)
        if cfg.dim == 2:
            J = J[:, 2:5]
        return J.T @ (w * res)
    else:
        if cfg.loss_name is not None:
            w = w * losses.robust_weight(cfg.loss_name, nn_err,
                                         cfg.loss_metric, True,
                                         cfg.tanh_steepness)
        n_loc = src_s.shape[0]
        J = jnp.concatenate(
            [se3.skew(cp).reshape(3 * n_loc, 3),
             -jnp.broadcast_to(jnp.eye(3, dtype=dtype),
                               (n_loc, 3, 3)).reshape(3 * n_loc, 3)],
            axis=-1)
        if cfg.dim == 2:
            J = J[:, 2:5]
        res = nn_err.reshape(3 * n_loc)
        w3 = jnp.repeat(w, 3)
        return J.T @ (w3 * res)


def _local_nn_idx(cfg: ICPConfig, ps_t, tgt, axis=None):
    """Correspondence indices at theta* plus the certificate gate (None for
    exact backends), same backend resolution as the sharded forward
    (sharding._map_sharded_body).  ``axis``: mesh axis name so the 50%
    certification guard fires on the GLOBAL fraction, matching the
    forward's gate."""
    method = cfg.resolved_nn_method(ps_t.shape[0], tgt.shape[0])
    tgt_pts = lax.stop_gradient(tgt[:, :3])
    q = lax.stop_gradient(ps_t)
    if method == "cluster":
        from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_nn
        from dicp_tpu.registration import _certified_gate

        cl_index = build_cluster_index(tgt_pts, cfg.cluster_group)
        shards = 1 if axis is None else lax.axis_size(axis)
        idx, _, cert = cluster_nn(cl_index, q, probes=cfg.cluster_probes,
                                  fixup=cfg.shard_cluster_fixup(q.shape[0],
                                                                shards))
        return idx, lax.stop_gradient(
            _certified_gate(cert, q.dtype, axis=axis))
    if method == "pallas":
        # same streaming brute force as the sharded forward
        return knn.nn_argmin_stream(q, tgt_pts)[0], None
    return knn.nn_indices(q, tgt_pts), None


def _pose_vjp_xi_bar(cfg: ICPConfig, T_star, T_bar):
    """Cotangent on xi (at xi=0) from the cotangent on T, through the
    retraction T(xi) = [exp(om)^T C* | r* - rho] (dicp_tpu.ift._pose_from_xi
    unbatched)."""
    k = 3 if cfg.dim == 2 else 6
    C_star, r_star = T_star[:3, :3], T_star[:3, 3]

    def pose(xi):
        xi6 = _xi_embed(cfg, xi)
        del_C = se3.exp_so3(xi6[:3][None])[0]
        C = del_C.T @ C_star
        r = r_star - xi6[3:]
        return (jnp.eye(4, dtype=T_star.dtype)
                .at[:3, :3].set(C).at[:3, 3].set(r))

    zero = jnp.zeros((k,), T_star.dtype)
    _, vjp = jax.vjp(pose, zero)
    return vjp(T_bar)[0]


def _make_core(mesh: Mesh, cfg: ICPConfig, axis: str):
    """custom_vjp'd (src, w, tgt, T_init) -> (T, done, it, cost) with IFT
    backward; closure-free statics via functools cache in the caller."""

    # smooth (differentiable) weight forms — the backward linearizes the
    # smooth stationarity, so the forward must converge to the smooth fixed
    # point — but the cheap early-exit while driver (custom_vjp never
    # differentiates through the loop, cf. ift._fixed_point_res)
    fwd_cfg = cfg.with_(differentiable=True, driver="while")
    fwd_fn = map_sharded_fn(mesh, fwd_cfg, axis=axis, target_sharded=False)

    @jax.custom_vjp
    def core(src, w, tgt, t_init):
        return fwd_fn(src, w, tgt, t_init)

    def core_fwd(src, w, tgt, t_init):
        out = fwd_fn(src, w, tgt, t_init)
        T = out[0]
        return out, (src, w, tgt, T)

    def core_bwd(saved, out_bar):
        src, w, tgt, T_star = saved
        # contract matches the single-device IFT: only T carries gradient
        # (stats/cost are diagnostics, dICP/ICP.py:220-237 detach semantics)
        T_bar = out_bar[0]
        k = 3 if cfg.dim == 2 else 6
        xi_bar = _pose_vjp_xi_bar(cfg, T_star, T_bar)
        C_star, r_star = T_star[:3, :3], T_star[:3, 3]

        def bwd_body(src_s, w_s, tgt_, xi_bar_, C_, r_):
            with jax.default_matmul_precision("float32"):
                ps_t = src_s[:, :3] @ C_.T + r_
                idx, gate = _local_nn_idx(cfg, ps_t, tgt_, axis=axis)
                zero = jnp.zeros((k,), src_s.dtype)

                def G_loc(xi, s_, t_, wp_):
                    # the forward gated weights by the cluster certificate;
                    # applying it INSIDE G keeps d/dwp_ consistent
                    wp_g = wp_ if gate is None else wp_ * gate
                    return _stationarity_local(cfg, xi, C_, r_, s_, t_,
                                               idx, wp_g)

                # A = psum(dG_local/dxi): k JVPs, each one (k,) psum
                basis = jnp.eye(k, dtype=src_s.dtype)
                cols = [jax.jvp(lambda x: G_loc(x, src_s, tgt_, w_s),
                                (zero,), (basis[j],))[1] for j in range(k)]
                A_loc = jnp.stack(cols, axis=-1)              # (k, k)
                A = lax.psum(A_loc, axis)
                A = A + _damping(cfg, A[None], use_abs=True)[0] \
                    * jnp.eye(k, dtype=src_s.dtype)
                lam = jnp.linalg.solve(A.T, xi_bar_[:, None])[:, 0]

                _, g_vjp = jax.vjp(
                    lambda s_, t_, wp_: G_loc(zero, s_, t_, wp_),
                    src_s, tgt_, w_s)
                # psum output is device-invariant; the VJP cotangent must
                # carry G_loc's varying-over-axis type (shard_map VMA rules)
                lam_v = lax.pcast(-lam, (axis,), to="varying")
                # the VJP w.r.t. the UNVARYING (replicated) target already
                # psums the per-shard scatter-adds (shard_map VMA autodiff
                # inserts the collective); an explicit psum would 8x it
                src_bar, tgt_bar, w_bar = g_vjp(lam_v)
                return src_bar, w_bar, tgt_bar

        bwd = jax.shard_map(
            bwd_body, mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P(), P(), P()),
            out_specs=(P(axis), P(axis), P()),
        )
        src_bar, w_bar, tgt_bar = bwd(src, w, tgt, xi_bar, C_star, r_star)
        t_init_bar = jnp.zeros_like(T_star)  # fixed point forgets the init
        return src_bar, w_bar, tgt_bar, t_init_bar

    core.defvjp(core_fwd, core_bwd)
    return core


@functools.lru_cache(maxsize=32)
def _cached_core(mesh: Mesh, cfg: ICPConfig, axis: str):
    return _make_core(mesh, cfg, axis)


def register_map_sharded_ift(
    mesh: Mesh,
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: Optional[jnp.ndarray] = None,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Map-sharded registration with implicit fixed-point gradients.

    Same forward as :func:`~dicp_tpu.parallel.sharding.register_map_sharded`
    (early-exit SPMD driver); ``jax.grad`` through the returned ``T`` costs
    one k x k solve + one stationarity VJP instead of unrolling the GN scan.
    Requires convergence for exactness (check ``.converged``).
    """
    if cfg.use_gumbel:
        raise ValueError("IFT gradients require hard (deterministic) NN")
    n = source.shape[0]
    n_dev = mesh.shape[axis]
    dtype = source.dtype
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    if cfg.icp_type == "symmetric" and source.shape[1] < 6:
        raise ValueError("symmetric ICP requires 6-column sources")
    if T_init is None:
        T_init = jnp.eye(4, dtype=dtype)
    if weight is None:
        weight = jnp.ones((n,), dtype=dtype)
    pad = (-n) % n_dev
    if pad:
        source = jnp.concatenate(
            [source, jnp.zeros((pad, source.shape[1]), dtype=dtype)])
        weight = jnp.concatenate([weight, jnp.zeros((pad,), dtype=dtype)])

    core = _cached_core(mesh, cfg, axis)
    T, done, it, cost = core(source[:, :src_cols], weight, target, T_init)
    return MapShardedResult(T=T, converged=done, iterations=it, cost=cost)
