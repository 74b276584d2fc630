"""Implicit-function-theorem gradients through the ICP fixed point.

The unrolled backward (reverse-mode through ``lax.scan``) differentiates
every Gauss-Newton iteration — O(iterations) memory and FLOPs.  At a
converged fixed point the solution satisfies the stationarity condition

    G(theta*, x) = J(theta*)^T W(theta*) e(theta*) = 0

(the weighted normal-equation gradient the solver drives to zero, cf. the
update at dICP/ICP.py:199-201), so by the implicit function theorem

    d theta* / dx = -(dG/d theta)^{-1} dG/dx.

The backward pass is then ONE k x k linear solve (k = 6, or 3 for dim=2)
plus one VJP of G — independent of iteration count, and the forward can use
the cheap early-exit ``while_loop`` driver because nothing needs to be
differentiated through it.  This is BASELINE.json's "vmapped
implicit-function-theorem gradients" component; the reference has no
counterpart (its backward replays the unrolled torch graph, SURVEY.md §3.3).

Semantics match the solver's differentiable mode: correspondences are the
hard-NN indices at the fixed point (piecewise constant -> treated fixed,
exactly the reference's detached-argmin semantics), robust/trim weights use
their smooth differentiable forms, and dG/d theta is the EXACT Jacobian of G
(via jacfwd), not the Gauss-Newton approximation — so gradients are exact at
exact fixed points.

Caveat: if an element did NOT converge, the stationarity condition does not
hold and the IFT gradient is an approximation (check ``result.converged``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import knn, losses, se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import ICPResult, _damping, register, register_jit


def _solver_weight(w):
    """The effective IRLS weight the solver applies: (sqrt(w+1e-10)-1e-5)^2
    (row scaling at dICP/ICP.py:194-196 squared into the normal equations)."""
    s = jnp.sqrt(w + 1.0e-10) - 1.0e-5
    return s * s


def _retract(cfg: ICPConfig, xi, C_star, r_star):
    """(C, r) at theta* [+] xi — the ONE xi->pose map the adjoint relies on
    (embeds the dim-2 3-vector into slots 2:5, then the solver's retraction
    del_C^T C / r - rho, registration._gn_step & dICP/ICP.py:204-217).
    Shared by the cotangent pose map and the stationarity so they cannot
    desynchronize."""
    dtype = C_star.dtype
    N = C_star.shape[0]
    if cfg.dim == 2:
        zeros = jnp.zeros((N, 1), dtype=dtype)
        xi6 = jnp.concatenate([zeros, zeros, xi, zeros], axis=-1)
    else:
        xi6 = xi
    del_C = se3.exp_so3(xi6[:, :3])
    C = jnp.swapaxes(del_C, -1, -2) @ C_star
    r = r_star - xi6[:, 3:]
    return C, r


def _pose_from_xi(cfg: ICPConfig, xi, C_star, r_star):
    """T(theta* [+] xi) as a (N, 4, 4) homogeneous matrix."""
    dtype = C_star.dtype
    N = C_star.shape[0]
    C, r = _retract(cfg, xi, C_star, r_star)
    T = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (N, 4, 4))
    return T.at[:, :3, :3].set(C).at[:, :3, 3].set(r)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _fixed_point_res(cfg: ICPConfig, source, target, weight, T_init):
    """Full ICPResult from ONE cheap early-exit forward solve.

    Only the ``T`` field's cotangent is consumed by the backward (histories
    and stats are detached by contract, dICP/ICP.py:220-237; ``pc`` is
    recomputed differentiably from T by the caller).

    NOTE: keep ``differentiable=True`` — the flag selects the smooth
    pseudo-Huber/tanh-trim weight forms (dICP/loss.py:30,:54), which have a
    DIFFERENT fixed point than the hard forms on noisy data; the backward
    linearizes the smooth stationarity, so the forward must converge to the
    smooth fixed point.  The while driver is safe here because custom_vjp
    never differentiates through it.  With ``const_iter`` the fixed-count
    scan driver is used instead — fully unrollable, no convergence
    branches, the highest-throughput serving shape.
    """
    driver = "scan" if cfg.const_iter else "while"
    return register_jit(source, target, T_init, weight,
                        cfg=cfg.with_(differentiable=True, driver=driver))


def _fp_fwd(cfg, source, target, weight, T_init):
    res = _fixed_point_res(cfg, source, target, weight, T_init)
    return res, (source, target, weight, T_init, res.T)


def _fp_bwd(cfg, saved, res_bar):
    # The f32 matmul pin must cover the BACKWARD trace too: register_ift's
    # with-block only wraps the primal, and custom_vjp bwd rules are traced
    # during the cotangent sweep — without the pin every einsum/@ here runs
    # at the backend's default reduced precision (TF32 on the GPU) and the
    # implicit gradients bias ~1e-3 off the unrolled reference.
    with jax.default_matmul_precision("float32"):
        return _fp_bwd_impl(cfg, saved, res_bar)


def _fp_bwd_impl(cfg, saved, res_bar):
    source, target, weight, T_init, T = saved
    T_bar = res_bar.T  # every other field is detached by contract
    dtype = source.dtype
    N = source.shape[0]
    k = 3 if cfg.dim == 2 else 6
    C_star = T[:, :3, :3]
    r_star = T[:, :3, 3]

    # Preprocessing shared with the solver (z zeroing for dim=2 etc.) via
    # registration._preprocess — the solver's pt2pt x3 weight expansion is
    # undone because the stationarity here applies per-point weights to
    # 3-vectors directly.
    from dicp_tpu.registration import _preprocess

    src, tgt, w_prior, C0, r0 = _preprocess(cfg, source, target, T_init, weight)
    if cfg.icp_type == "pt2pt":
        w_prior = w_prior[..., ::3]            # undo the x3 expansion

    # fixed correspondences at theta* — mirroring the forward's backend
    # EXACTLY (registration._make_corr_fn), so the stationarity linearized
    # here is the same G whose root the forward converged to: the
    # single-target path keeps the query curve-order (computed at the
    # T_init pose, like the forward); the batch path vmaps like the
    # forward.  A backend mismatch changes the certified set and silently
    # skews the implicit gradients.
    ps_t = jnp.einsum("nij,npj->npi", C_star, src[..., :3]) + r_star[:, None, :]
    n_, m_ = ps_t.shape[-2], tgt.shape[-2]
    method = cfg.resolved_nn_method(n_, m_)
    if method == "cluster":
        from dicp_tpu.ops.cluster_knn import (build_cluster_index, cluster_nn,
                                              query_order)
        from dicp_tpu.registration import _certified_gate

        if tgt.shape[0] == 1:
            index1 = build_cluster_index(
                lax.stop_gradient(tgt[0, ..., :3]), cfg.cluster_group)
            ps0 = jnp.einsum("ij,pj->pi", C0[0], src[0, :, :3]) + r0[0][None, :]
            qord = query_order(index1, lax.stop_gradient(ps0))
            idx1, _, cert1 = cluster_nn(
                index1, lax.stop_gradient(ps_t[0]),
                probes=cfg.cluster_probes, order=qord,
                fixup=cfg.resolved_cluster_fixup(n_))
            idx, cert = idx1[None], cert1[None]
        else:
            index = jax.vmap(
                lambda t: build_cluster_index(t, cfg.cluster_group))(
                lax.stop_gradient(tgt[..., :3]))
            idx, _, cert = jax.vmap(
                lambda ix, q: cluster_nn(ix, q, probes=cfg.cluster_probes,
                                         fixup=cfg.resolved_cluster_fixup(n_)))(
                index, lax.stop_gradient(ps_t))
        # replicate the forward's certificate gate in the stationarity: the
        # fixed point was computed with uncertified matches excluded
        w_prior = w_prior * lax.stop_gradient(_certified_gate(cert, dtype))
    elif method == "pallas":
        idx, _ = knn.nn_bruteforce(ps_t, tgt)
    else:
        idx = lax.stop_gradient(knn.nn_indices(ps_t, tgt))

    zero_xi = jnp.zeros((N, k), dtype=dtype)

    def G_full(xi, src_, tgt_, wp_):
        return _stationarity_weighted(cfg, xi, C_star, r_star, src_, tgt_, idx, wp_)

    # dG/dxi is block-diagonal over the batch (G is elementwise in N), so k
    # batched JVPs along the coordinate basis give every (k x k) block at once.
    def G_xi(xi):
        return G_full(xi, src, tgt, w_prior)

    basis = jnp.eye(k, dtype=dtype)
    A = jnp.stack(
        [jax.jvp(G_xi, (zero_xi,), (jnp.broadcast_to(basis[j], (N, k)),))[1]
         for j in range(k)],
        axis=-1)  # (N, k, k): A[., i, j] = dG_i/dxi_j
    # Damp like the solver (dICP/ICP.py:200): on gauge-degenerate problems
    # (e.g. planar data solved in 3-D) dG/dxi is singular; damping keeps the
    # adjoint solve finite (null-direction gradients are meaningless anyway).
    A = A + _damping(cfg, A, use_abs=True) * jnp.eye(k, dtype=dtype)

    # cotangent on xi from the cotangent on T via the retraction map
    _, pose_vjp = jax.vjp(lambda xi: _pose_from_xi(cfg, xi, C_star, r_star), zero_xi)
    xi_bar = pose_vjp(T_bar)[0]  # (N, k)

    # lambda solves A^T lambda = xi_bar ; input cotangents = -lambda^T dG/dx
    lam = jnp.linalg.solve(jnp.swapaxes(A, -1, -2), xi_bar[..., None])[..., 0]

    _, g_vjp = jax.vjp(lambda s, t, wp: G_full(zero_xi, s, t, wp), src, tgt, w_prior)
    src_bar, tgt_bar, wp_bar = g_vjp(-lam)

    # undo preprocessing on cotangents: src/tgt were sliced AND zmasked from
    # source/target (dim=2), w_prior masked by the zero-pad rule — each
    # linear map's transpose must be applied to the cotangents too.
    if cfg.dim == 2:
        zmask = jnp.array([1.0, 1.0, 0.0], dtype=dtype)
        zmask6 = jnp.concatenate([zmask, zmask])
        src_bar = src_bar * (zmask6 if src.shape[-1] == 6 else zmask)
        tgt_bar = tgt_bar * (zmask6 if tgt.shape[-1] == 6 else zmask)
    source_bar = jnp.zeros_like(source)
    source_bar = source_bar.at[..., :src.shape[-1]].set(src_bar)
    target_bar = jnp.zeros_like(target)
    target_bar = target_bar.at[..., :tgt.shape[-1]].set(tgt_bar)
    if weight is None:
        weight_bar = None
    else:
        weight_bar = wp_bar
        if cfg.source_zeroes_are_pad:
            weight_bar = weight_bar * (
                jnp.linalg.norm(src[..., :3], axis=-1) != 0.0).astype(dtype)
    T_init_bar = jnp.zeros_like(T)  # fixed point forgets its initialization
    return source_bar, target_bar, weight_bar, T_init_bar


def _stationarity_weighted(cfg, xi, C_star, r_star, source, target, idx, w_prior):
    """_stationarity with the prior weight folded in (w = w_prior*trim*loss,
    matching dICP/ICP.py:169).  ``source`` is (N, n, 3) — or (N, n, 6) for
    symmetric ICP, whose residual reads the source normals too."""
    dtype = source.dtype
    N, n = source.shape[0], source.shape[1]
    C, r = _retract(cfg, xi, C_star, r_star)
    cp = jnp.einsum("nij,npj->npi", C, source[..., :3])
    ps_t = cp + r[:, None, :]
    nn6 = knn.gather_rows(target, idx)
    nn_err = ps_t - nn6[..., :3]

    if cfg.trim_dist is not None:  # negative k follows dICP/loss.py:54 (~0 weights)
        trim_w = losses.trim_weight(nn_err, cfg.trim_dist, True, cfg.tanh_steepness)
    else:
        trim_w = jnp.ones((N, n), dtype=dtype)

    if cfg.icp_type in ("pt2pl", "symmetric"):
        if cfg.icp_type == "symmetric":
            # residual along the sum of both normals, the source normal
            # rotated into the target frame (registration._gn_step:153-159)
            cnp = jnp.einsum("nij,npj->npi", C, source[..., 3:6])
            nrm = nn6[..., 3:6] + cnp
        else:
            nrm = nn6[..., 3:6]
        res = jnp.sum(nn_err * nrm, axis=-1)
        if cfg.loss_name is not None:
            loss_w = losses.robust_weight(cfg.loss_name, res[..., None],
                                          cfg.loss_metric, True, cfg.tanh_steepness)
        else:
            loss_w = jnp.ones((N, n), dtype=dtype)
        w = _solver_weight(w_prior * trim_w * loss_w)
        J_C = jnp.cross(nrm, cp)
        if cfg.icp_type == "symmetric":
            J_C = J_C + jnp.cross(nn_err, cnp)
        J = jnp.concatenate([J_C, -nrm], axis=-1)
        if cfg.dim == 2:
            J = J[..., 2:5]
        return jnp.einsum("npk,np->nk", J, w * res)
    else:
        if cfg.loss_name is not None:
            loss_w = losses.robust_weight(cfg.loss_name, nn_err,
                                          cfg.loss_metric, True, cfg.tanh_steepness)
        else:
            loss_w = jnp.ones((N, n), dtype=dtype)
        w = _solver_weight(w_prior * trim_w * loss_w)
        J_C = se3.skew(cp)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (N, n, 3, 3))
        J = jnp.concatenate([J_C, -eye], axis=-1)
        if cfg.dim == 2:
            J = J[..., 2:5]
        return jnp.einsum("npak,npa->nk", J, w[..., None] * nn_err)


_fixed_point_res.defvjp(_fp_fwd, _fp_bwd)


def register_ift(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
) -> ICPResult:
    """ICP with implicit (fixed-point) gradients.

    Forward: cheap early-exit while_loop driver.  Backward: one k x k solve —
    O(1) in iteration count (vs the unrolled scan's O(iterations)).  Requires
    hard NN (no Gumbel) and convergence for exactness.  Histories/stats come
    from the forward run, detached (matching the reference contract).
    """
    if cfg.use_gumbel:
        raise ValueError("IFT gradients require hard (deterministic) NN")
    if cfg.batch_chunk is not None and source.shape[0] > cfg.batch_chunk:
        # sequential knee-sized chunks (see ICPConfig.batch_chunk); the
        # custom_vjp differentiates per chunk under lax.map's scan
        from dicp_tpu.registration import _chunked_over_batch

        sub = cfg.with_(batch_chunk=None)
        return _chunked_over_batch(
            lambda s, t, ti, w, k: register_ift(s, t, ti, w, sub),
            cfg.batch_chunk, source, target, T_init, weight, None)
    with jax.default_matmul_precision("float32"):
        # ONE forward solve: the custom_vjp returns the full ICPResult
        # (histories/stats detached by contract); pc is recomputed
        # differentiably from T and the (z-masked) source.
        res = _fixed_point_res(cfg, source, target, weight, T_init)
        src = source[..., :3]
        if cfg.dim == 2:
            src = src * jnp.array([1.0, 1.0, 0.0], dtype=source.dtype)
        pc = jnp.einsum("nij,npj->npi", res.T[:, :3, :3], src) \
            + res.T[:, None, :3, 3]
    return res._replace(pc=pc)


register_ift_jit = jax.jit(register_ift, static_argnames=("cfg",))
