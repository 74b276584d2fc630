"""Functional core: batched differentiable Gauss-Newton ICP.

This is the accelerator-native redesign of the reference's iteration loop
(dICP/ICP.py:46-303).  Key architectural differences from the reference:

* The whole solve is one jitted XLA program.  The reference's Python ``for``
  loop with a data-dependent ``break`` (dICP/ICP.py:132, :259-260) becomes a
  ``lax.scan`` whose body is wrapped in a ``lax.cond`` that skips compute once
  every batch element has converged (differentiable, fixed trip count), or a
  ``lax.while_loop`` with a true early exit (non-differentiable inference).
* Static shapes everywhere: histories are fixed-length (max_iterations) and
  the caller slices them to the executed length.  Skipped iterations emit
  exactly the values the reference's weight/cost carry-forward rule
  (dICP/ICP.py:224-234) would produce, so sliced histories match.
* Per-element convergence freezing — zeroing the weight of converged batch
  elements so batch results equal serial results (dICP/ICP.py:256-257) — is
  reproduced with pure `where` masking inside the carry.
* Rotation retraction uses closed-form Rodrigues (se3.exp_so3) instead of
  ``torch.matrix_exp`` (dICP/ICP.py:210); the linear system is solved with
  ``jnp.linalg.solve`` instead of forming an explicit inverse
  (dICP/ICP.py:201).
* Gradients: reverse-mode through the scan (optionally rematerialized), with
  the same stop-gradient boundaries as the reference — histories and stats
  are detached (dICP/ICP.py:220-237); only ``pc`` and ``T`` carry gradient.

Shapes (functional core; ragged/unbatched input handling lives in
:mod:`dicp_tpu.api`):
  source  (N, n, 3)   target (N, m, 3|6)   T_init (N, 4, 4)
  weight  (N, n) or None
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import knn, losses, se3
from dicp_tpu.config import ICPConfig


class ICPResult(NamedTuple):
    """Result pytree; fields mirror the reference's results dict
    (dICP/ICP.py:288-303).  Histories have fixed length ``max_iterations``;
    entries past the executed count repeat the last value (weights/costs) or
    are zero (deltas) — use :func:`executed_iterations` to slice.  With
    ``cfg.collect_histories=False`` they are length-1 placeholders holding
    the final values (weights/costs) or zeros (deltas)."""

    pc: jnp.ndarray            # (N, n, 3) transformed source
    T: jnp.ndarray             # (N, 4, 4)
    costs: jnp.ndarray         # (N, T, 1)
    deltas: jnp.ndarray        # (N, T, 6, 1)
    weights: jnp.ndarray       # (N, T, P, 1); P = n (pt2pl) or 3n (pt2pt)
    converged: jnp.ndarray     # (N,) bool
    iterations: jnp.ndarray    # (N,) float (reference keeps float dtype, dICP/ICP.py:92)
    matched_ratio: jnp.ndarray # (N,) float


def _damping(cfg: ICPConfig, A: jnp.ndarray, use_abs: bool = False) -> jnp.ndarray:
    """Per-element Tikhonov damping for the normal equations A (N, k, k).

    ``cfg.tikhonov`` set -> absolute, like the reference's 1e-12
    (dICP/ICP.py:200).  Auto (None) -> RELATIVE to the largest diagonal
    entry (Levenberg-Marquardt style): real scan pairs produce diagonals
    spanning 1e6 (rotation, ~radius^2 * n) down to <1 (weakly-observed
    translation), where any absolute lambda is simultaneously too small for
    f32 stability and too large for the small block.  Damping never moves
    the fixed point (the Gauss-Newton update is zero at a stationary point
    regardless of lambda), it only shortens steps in ill-observed
    directions, so reference-accuracy contracts are unaffected.
    """
    if cfg.tikhonov is not None:
        return jnp.asarray(cfg.tikhonov, A.dtype)
    rel = 1e-12 if A.dtype == jnp.float64 else 1e-6
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    if use_abs:
        diag = jnp.abs(diag)  # IFT adjoint: dG/dxi need not have positive diag
    dmax = jnp.max(diag, axis=-1)
    return (rel * jnp.maximum(dmax, 1.0))[..., None, None]


def _preprocess(cfg: ICPConfig, source, target, T_init, weight):
    """Input normalization done once before the loop (dICP/ICP.py:85-129)."""
    n = source.shape[-2]
    if cfg.icp_type == "symmetric":
        # symmetric point-to-plane (Rusinkiewicz 2019): residual along the
        # SUM of both clouds' normals -> normals required on both sides
        if source.shape[-1] < 6 or target.shape[-1] != 6:
            raise ValueError("symmetric ICP requires normals on BOTH clouds: "
                             "source (N, n, 6), target (N, m, 6)")
        source = source[..., :6]
    else:
        source = source[..., :3]
    if cfg.icp_type == "pt2pl":
        if target.shape[-1] != 6:
            raise ValueError("pt2pl requires target normals: (N, m, 6)")  # dICP/ICP.py:101-103
    elif cfg.icp_type == "pt2pt":
        target = target[..., :3]

    if cfg.dim == 2:
        # Zero z so it cannot influence NN or residuals (dICP/ICP.py:107-116);
        # pt2pl keeps the in-plane normal components, zeroes normal z.
        zmask = jnp.array([1.0, 1.0, 0.0], dtype=source.dtype)
        zmask6 = jnp.concatenate([zmask, zmask])
        source = source * (zmask6 if source.shape[-1] == 6 else zmask)
        target = target * (zmask6 if target.shape[-1] == 6 else zmask)

    if weight is None:
        weight = jnp.ones(source.shape[:-1], dtype=source.dtype)
    if cfg.source_zeroes_are_pad:
        # all-zero source rows are padding -> weight 0 (dICP/ICP.py:445-446)
        weight = weight * (jnp.linalg.norm(source[..., :3], axis=-1) != 0.0).astype(source.dtype)
    if cfg.icp_type == "pt2pt":
        # one weight per error component (dICP/ICP.py:508-509)
        weight = jnp.repeat(weight, 3, axis=-1)

    C = T_init[..., :3, :3]
    r = T_init[..., :3, 3]
    del n
    return source, target, weight, C, r


def _certified_gate(cert, dtype, axis=None):
    """Per-point validity weight from the cluster certificate.

    Uncertified correspondences (the found neighbor is not PROVABLY the
    global argmin) are excluded from the normal equations — they carry a
    small systematic bias toward the wrong fixed point (measured 2.8e-3
    transform error on a 100k surface scene vs 2e-7 masked; the neighbors
    are near-correct but not argmin-exact).  Guard: if certification ever
    collapses below 50% of points (pathological geometry), keep everything
    — a biased estimate beats a degenerate one.

    ``axis``: mesh axis name when called from a shard_map body — the
    fraction is then computed over the GLOBAL cloud (one scalar psum), so
    the gate fires identically on every shard and the sharded solve keeps
    the same fixed point as the single-device solve near the threshold."""
    w = cert.astype(dtype)
    if axis is None:
        frac = jnp.mean(w, axis=-1, keepdims=True)
    else:
        total = lax.psum(jnp.sum(w, axis=-1, keepdims=True), axis)
        frac = total / (w.shape[-1] * lax.axis_size(axis))
    return jnp.where(frac >= 0.5, w, jnp.ones_like(w))


def _make_corr_fn(cfg: ICPConfig, source, target, C0, r0):
    """Correspondence closure built ONCE per solve (outside the GN loop).

    Returns ``corr(ps_t) -> (nn6, valid)``: the gathered 6-col neighbor rows
    and a per-point validity weight (None for exact backends).  The cluster
    backend's ``valid`` is the exactness certificate — the solver then uses
    ONLY provably-exact (or brute-force-fixed-up) correspondences.

    The target is constant across iterations, so the cluster backend's
    Hilbert index (ops/cluster_knn) is built here and amortized over every
    iteration — the structural win a per-step knn call cannot express.
    The query curve-sort order is ALSO computed once (at the T_init pose):
    it is only a locality hint, and rigid motion preserves neighborhood
    structure exactly, so the initial order keeps blocks compact at every
    iterate.  Gradients keep hard-NN semantics: indices are ints (implicitly
    detached), values flow through the gather into ``target``."""
    n, m = source.shape[-2], target.shape[-2]
    dtype = source.dtype
    method = cfg.resolved_nn_method(n, m)
    if method == "cluster":
        from dicp_tpu.ops.cluster_knn import (build_cluster_index, cluster_nn,
                                              query_order)

        if target.shape[0] == 1:
            # single huge cloud (the common large-scale case): no vmap
            index = build_cluster_index(
                lax.stop_gradient(target[0, :, :3]), cfg.cluster_group)
            ps0 = jnp.einsum("ij,pj->pi", C0[0], source[0, :, :3]) + r0[0][None, :]
            qord = query_order(index, lax.stop_gradient(ps0))

            def corr(ps_t):
                idx, _, cert = cluster_nn(index, lax.stop_gradient(ps_t[0]),
                                          probes=cfg.cluster_probes, order=qord,
                                          fixup=cfg.resolved_cluster_fixup(n))
                return (knn.gather_rows(target, idx[None]),
                        _certified_gate(cert[None], dtype))

            return corr

        index = jax.vmap(
            lambda t: build_cluster_index(t, cfg.cluster_group))(
            lax.stop_gradient(target[..., :3]))

        def corr(ps_t):
            idx, _, cert = jax.vmap(
                lambda ix, q: cluster_nn(ix, q, probes=cfg.cluster_probes,
                                         fixup=cfg.resolved_cluster_fixup(n)))(
                index, lax.stop_gradient(ps_t))
            return (knn.gather_rows(target, idx),
                    _certified_gate(cert, dtype))

        return corr

    use_pallas = method == "pallas"

    def corr(ps_t):
        # find_nn_normalized, NOT find_nn: inputs here are already (N, n, 3)
        # and (N, m, 3|6); the public entry's transpose heuristic misreads
        # 3-point clouds as (3, n) layout and corrupts correspondences.
        return knn.find_nn_normalized(ps_t, target, use_pallas=use_pallas), None

    return corr


def _normal_equations(J_w, res_w, chunk: int = 4096):
    """A = J_w^T J_w (N, k, k) and b = J_w^T res_w (N, k) with TWO-LEVEL
    (chunked pairwise) f32 accumulation.

    A flat einsum accumulates P sequential partial sums; at P ~ 3e5 rows the
    f32 rounding noise in b reaches ~1e-4 in the Gauss-Newton step — the
    solve then oscillates at that floor instead of converging (at 100k
    points the pt2pt transform error plateaus at 1e-4 even with EXACT
    correspondences).  Summing within chunks and then across chunks
    bounds the error ~O(sqrt) instead of O(P)."""
    N, P, k = J_w.shape
    if P <= chunk:
        return (jnp.einsum("npi,npj->nij", J_w, J_w),
                jnp.einsum("npi,np->ni", J_w, res_w))
    nc = -(-P // chunk)
    pad = nc * chunk - P
    if pad:
        J_w = jnp.concatenate(
            [J_w, jnp.zeros((N, pad, k), J_w.dtype)], axis=1)
        res_w = jnp.concatenate(
            [res_w, jnp.zeros((N, pad), res_w.dtype)], axis=1)
    Jc = J_w.reshape(N, nc, chunk, k)
    rc = res_w.reshape(N, nc, chunk)
    A = jnp.sum(jnp.einsum("ncpi,ncpj->ncij", Jc, Jc), axis=1)
    b = jnp.sum(jnp.einsum("ncpi,ncp->nci", Jc, rc), axis=1)
    return A, b


def _gn_step(cfg: ICPConfig, source, target, w_init, C, r, key, corr_fn):
    """One Gauss-Newton iteration (body of the hot loop, dICP/ICP.py:132-217).

    Returns (C_new, r_new, delta6 (N,6), w (N,P), cost (N,)).
    """
    dtype = source.dtype
    N, n = source.shape[0], source.shape[1]
    src_pts = source[..., :3]

    # Transform into the current target-frame estimate.
    cp = jnp.einsum("nij,npj->npi", C, src_pts)         # C @ ps_s (rotated only)
    ps_t = cp + r[:, None, :]                            # dICP/ICP.py:137

    # Correspondences carry the full target rows (normals ride along).
    if cfg.differentiable and cfg.use_gumbel:
        # key is (N,)-batched (one stream per batch element, see register());
        # vmap keeps each element's draw independent of batch composition.
        nn6 = jax.vmap(lambda p, t, k: knn.gumbel_nn(
            p, t, k, tau=cfg.gumbel_tau, eps=cfg.gumbel_eps))(ps_t, target, key)
        valid = None
    else:
        nn6, valid = corr_fn(ps_t)

    nn_err = ps_t - nn6[..., :3]                         # (N, n, 3)

    if cfg.icp_type == "pt2pl":
        nn_norm = nn6[..., 3:6]
        err = jnp.sum(nn_err * nn_norm, axis=-1)         # (N, n)  dICP/ICP.py:146
        loss_err = err[..., None]                        # norm over last axis = |e|
    elif cfg.icp_type == "symmetric":
        # residual along the sum of both normals (source normal rotated into
        # the target frame): e = (p' - q) . (n_q + C n_p)
        cnp = jnp.einsum("nij,npj->npi", C, source[..., 3:6])
        nn_norm = nn6[..., 3:6] + cnp
        err = jnp.sum(nn_err * nn_norm, axis=-1)         # (N, n)
        loss_err = err[..., None]
    else:
        err = None
        loss_err = nn_err                                # 3-component error per point

    # Robust weights: trim gate always on the 3-D point error (dICP/ICP.py:155),
    # loss weight on the residual (dICP/ICP.py:160); fused elementwise by XLA.
    # Negative trim_dist follows the reference (dICP/loss.py:54,:58): the hard
    # gate ||e|| < k zeroes EVERY weight, the soft tanh gate makes them ~0 —
    # either way delta = 0 and the solve returns T_init (all-zero-weight path).
    if cfg.trim_dist is not None:
        trim_w = losses.trim_weight(nn_err, cfg.trim_dist, cfg.differentiable, cfg.tanh_steepness)
    else:
        trim_w = jnp.ones((N, n), dtype=dtype)
    if valid is not None:
        # cluster-certificate gate: only provably-exact correspondences
        # enter the normal equations (see _certified_gate)
        trim_w = trim_w * valid
    if cfg.loss_name is not None:
        loss_w = losses.robust_weight(cfg.loss_name, loss_err, cfg.loss_metric,
                                      cfg.differentiable, cfg.tanh_steepness)
    else:
        loss_w = jnp.ones((N, n), dtype=dtype)

    # Residual vector + Jacobian of err w.r.t. xi = [omega, rho] (dICP/ICP.py:171-183).
    if cfg.icp_type == "pt2pl":
        # d err / d omega = (skew(Cp)^T n) = n x (Cp); d err / d rho = -n
        J_C = jnp.cross(nn_norm, cp)
        J = jnp.concatenate([J_C, -nn_norm], axis=-1)    # (N, n, 6)
        res = err                                        # (N, n)
        w = w_init * trim_w * loss_w                     # (N, n)
    elif cfg.icp_type == "symmetric":
        # under the solver's retraction C <- exp(d)^T C:
        #   de/domega = (n_q + Cn_p) x Cp + (p' - q) x Cn_p,  de/drho = -(n_q + Cn_p)
        J_C = jnp.cross(nn_norm, cp) + jnp.cross(nn_err, cnp)
        J = jnp.concatenate([J_C, -nn_norm], axis=-1)    # (N, n, 6)
        res = err
        w = w_init * trim_w * loss_w
    else:
        J_C = se3.skew(cp).reshape(N, 3 * n, 3)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (N, n, 3, 3)).reshape(N, 3 * n, 3)
        J = jnp.concatenate([J_C, -eye], axis=-1)        # (N, 3n, 6)
        res = nn_err.reshape(N, 3 * n)                   # component-interleaved (dICP/ICP.py:166)
        w = w_init * jnp.repeat(trim_w, 3, axis=-1) * jnp.repeat(loss_w, 3, axis=-1)

    if cfg.dim == 2:
        # Optimize (omega_z, rho_x, rho_y) only (dICP/ICP.py:186-189).
        J = J[..., 2:5]

    k = J.shape[-1]
    # Row-scale instead of forming a diagonal weight matrix; the +-1e-5 trick
    # avoids sqrt(0) NaN gradients (dICP/ICP.py:193-196).
    w_sqrt = jnp.sqrt(w + 1.0e-10) - 1.0e-5
    res_w = w_sqrt * res                                 # (N, P)
    J_w = w_sqrt[..., None] * J                          # (N, P, k)

    A, b = _normal_equations(J_w, res_w)
    A = A + _damping(cfg, A) * jnp.eye(k, dtype=dtype)
    if cfg.solve_method == "closed":
        # A is SPD (J^T W J + lambda I): pivot-free closed-form solve fuses to
        # elementwise ops instead of XLA's sequential batched LU.
        from dicp_tpu.ops.smallsolve import solve_spd

        delta_k = -solve_spd(A, b)                        # (N, k)
    else:
        delta_k = -jnp.linalg.solve(A, b[..., None])[..., 0]  # (N, k)

    if cfg.dim == 2:
        # Embed (omega_z, rho_x, rho_y) into the 6-vector (dICP/ICP.py:204-207).
        zeros = jnp.zeros((N, 1), dtype=dtype)
        delta6 = jnp.concatenate([zeros, zeros, delta_k, zeros], axis=-1)
    else:
        delta6 = delta_k

    # Retraction (dICP/ICP.py:210-217): C <- exp(omega^)^T C, r <- r - rho.
    del_C = se3.exp_so3(delta6[:, :3])
    C_new = jnp.swapaxes(del_C, -1, -2) @ C
    r_new = r - delta6[:, 3:]

    cost = jnp.sum(res_w * res_w, axis=-1)               # e_w^T e_w (dICP/ICP.py:229)
    return C_new, r_new, delta6, w, cost


def _fold_iter(keys, it):
    """Fold the iteration counter into the per-batch-element key array
    ((N,)-batched; see :func:`register`).  None passes through."""
    if keys is None:
        return None
    return jax.vmap(lambda kk: jax.random.fold_in(kk, it))(keys)


class _Carry(NamedTuple):
    C: jnp.ndarray
    r: jnp.ndarray
    w_init: jnp.ndarray        # freezing state (zeroed on convergence)
    converged: jnp.ndarray     # (N,) bool
    num_iters: jnp.ndarray     # (N,) float, 0 = sentinel "not yet converged"
    match_ratio: jnp.ndarray   # (N,) float, 0 = sentinel
    prev_w_save: jnp.ndarray   # carry-forward weight history value
    prev_cost: jnp.ndarray     # carry-forward cost history value
    w_raw: jnp.ndarray         # raw w of the last *executed* iteration


def _apply_step(cfg: ICPConfig, source, target, carry: _Carry, it, key, corr_fn) -> tuple:
    """Run one iteration + bookkeeping; returns (carry', (delta, w_save, cost))."""
    dtype = source.dtype
    C, r, delta6, w, cost = _gn_step(cfg, source, target, carry.w_init, carry.C, carry.r, key, corr_fn)

    # Histories are detached in the reference (dICP/ICP.py:220-234).
    delta_out = lax.stop_gradient(delta6)
    w_save = lax.stop_gradient(w)
    # All-zero weights carry the previous iteration's values forward.
    all_zero = (jnp.sum(w_save, axis=-1) == 0.0)[:, None]
    w_save = jnp.where(all_zero, carry.prev_w_save, w_save)
    cost_out = lax.stop_gradient(cost)
    # Carry on zero cost (dICP/ICP.py:229-234) OR on the all-zero-weight
    # mask: the latter yields cost == 0 exactly only when sqrt(1e-10)-1e-5
    # cancels to 0.0, which an approximate sqrt lowering can miss by an ulp
    # (cost ~1e-24) and silently skip the carry (code-review r3).
    cost_out = jnp.where((cost_out == 0.0) | all_zero[:, 0],
                         carry.prev_cost, cost_out)

    delta_norm = jnp.linalg.norm(lax.stop_gradient(delta6), axis=-1)  # dICP/ICP.py:237
    below = delta_norm < cfg.tolerance
    converged = carry.converged | below

    w_init = carry.w_init
    num_iters = carry.num_iters
    match_ratio = carry.match_ratio
    if not cfg.const_iter:
        # First-crossing stats + freeze (dICP/ICP.py:240-257).  The reference
        # guards this block with `if any(below)`, but each update is a no-op
        # where ~below, so unconditional masking is equivalent.
        itf = (it + 1).astype(dtype)
        num_iters = jnp.where(below, num_iters + itf * (num_iters == 0), num_iters)
        num_curr = jnp.sum(w > cfg.match_ratio_thresh, axis=-1).astype(dtype)
        num_start = jnp.sum(w_init > cfg.match_ratio_thresh, axis=-1).astype(dtype)
        num_start = jnp.where(num_start == 0, jnp.ones_like(num_start), num_start)
        ratio = num_curr / num_start
        match_ratio = jnp.where(below, match_ratio + ratio * (match_ratio == 0), match_ratio)
        # Freeze converged elements so batch == serial (dICP/ICP.py:256-257).
        w_init = w_init * jnp.where(below, 0.0, 1.0).astype(dtype)[:, None]

    new_carry = _Carry(C, r, w_init, converged, num_iters, match_ratio,
                       w_save, cost_out, lax.stop_gradient(w))
    return new_carry, (delta_out, w_save, cost_out)


def _init_carry(cfg: ICPConfig, source, weight, C, r) -> _Carry:
    dtype = source.dtype
    N = source.shape[0]
    P = weight.shape[-1]
    zeros_np = jnp.zeros((N, P), dtype=dtype)
    zeros_n = jnp.zeros((N,), dtype=dtype)
    return _Carry(
        C=C, r=r, w_init=weight,
        converged=jnp.zeros((N,), dtype=bool),
        num_iters=zeros_n, match_ratio=zeros_n,
        prev_w_save=zeros_np, prev_cost=zeros_n, w_raw=zeros_np,
    )


def _run_scan(cfg: ICPConfig, source, target, weight, C, r, key, corr_fn):
    """Differentiable fixed-bound driver.

    ``lax.scan`` over max_iterations; once every element has converged the
    body switches (via ``lax.cond``) to a cheap identity branch that emits
    exactly the carry-forward history values — matching the reference's early
    ``break`` (dICP/ICP.py:259-260) after slicing, while keeping a fixed trip
    count for reverse-mode AD.
    """
    carry0 = _init_carry(cfg, source, weight, C, r)

    def skip(carry_it):
        carry, it = carry_it
        zeros6 = jnp.zeros(carry.C.shape[:1] + (6,), dtype=source.dtype)
        return carry, (zeros6, carry.prev_w_save, carry.prev_cost)

    def run(carry_it):
        carry, it = carry_it
        k = _fold_iter(key, it)
        return _apply_step(cfg, source, target, carry, it, k, corr_fn)

    step = run
    if cfg.remat:
        run = jax.checkpoint(run)
        step = run

    def body(carry, it):
        if cfg.const_iter:
            out = step((carry, it))
        else:
            out = lax.cond(jnp.all(carry.converged), skip, step, (carry, it))
        if not cfg.collect_histories:
            return out[0], ()          # no stacked ys -> no O(T*N*P) buffers
        return out

    carry, hist = lax.scan(
        body, carry0, jnp.arange(cfg.max_iterations), unroll=cfg.scan_unroll)
    if not cfg.collect_histories:
        deltas = jnp.zeros((1,) + carry.C.shape[:1] + (6,), source.dtype)
        weights = carry.prev_w_save[None]
        costs = carry.prev_cost[None]
    else:
        deltas, weights, costs = hist
    return carry, deltas, weights, costs


def _run_while(cfg: ICPConfig, source, target, weight, C, r, key, corr_fn):
    """Early-exit driver for inference (non-differentiable).

    True ``lax.while_loop``: stops as soon as all elements converge, exactly
    like the reference's ``break``.  History buffers are fixed-size and
    written in place at the iteration index.
    """
    T = cfg.max_iterations
    N = source.shape[0]
    P = weight.shape[-1]
    dtype = source.dtype
    carry0 = _init_carry(cfg, source, weight, C, r)
    if cfg.collect_histories:
        hist0 = (jnp.zeros((T, N, 6), dtype=dtype),
                 jnp.zeros((T, N, P), dtype=dtype),
                 jnp.zeros((T, N), dtype=dtype))
    else:
        hist0 = ()

    def cond(state):
        carry, it, _ = state
        not_done = jnp.logical_not(jnp.all(carry.converged)) if not cfg.const_iter else jnp.bool_(True)
        return (it < T) & not_done

    def body(state):
        carry, it, hist = state
        k = _fold_iter(key, it)
        carry, (delta, w_save, cost) = _apply_step(cfg, source, target, carry, it, k, corr_fn)
        if cfg.collect_histories:
            hd, hw, hc = hist
            hist = (hd.at[it].set(delta), hw.at[it].set(w_save), hc.at[it].set(cost))
        return carry, it + 1, hist

    carry, it_final, hist = lax.while_loop(
        cond, body, (carry0, jnp.int32(0), hist0))

    if not cfg.collect_histories:
        # length-1 placeholders holding the final carry-forward values
        deltas = jnp.zeros((1, N, 6), dtype=dtype)
        weights = carry.prev_w_save[None]
        costs = carry.prev_cost[None]
        return carry, deltas, weights, costs, it_final

    deltas, weights, costs = hist
    # Unexecuted slots carry the last executed values forward so slicing and
    # fixed-length consumers both see the reference's carry-forward semantics.
    idx = jnp.arange(T)
    executed = idx < it_final
    last = jnp.maximum(it_final - 1, 0)
    deltas = jnp.where(executed[:, None, None], deltas, 0.0)
    weights = jnp.where(executed[:, None, None], weights, weights[last][None])
    costs = jnp.where(executed[:, None], costs, costs[last][None])
    return carry, deltas, weights, costs, it_final


def _finalize(cfg: ICPConfig, source, carry: _Carry, deltas, weights, costs, it_final):
    """Post-loop stats fill + result assembly (dICP/ICP.py:262-303)."""
    dtype = source.dtype
    itf = it_final.astype(dtype) if hasattr(it_final, "astype") else jnp.asarray(it_final, dtype)
    num_iters = jnp.where(carry.num_iters == 0, itf, carry.num_iters)
    num_curr = jnp.sum(carry.w_raw > cfg.match_ratio_thresh, axis=-1).astype(dtype)
    num_start = jnp.sum(carry.w_init > cfg.match_ratio_thresh, axis=-1).astype(dtype)
    num_start = jnp.where(num_start == 0, jnp.ones_like(num_start), num_start)
    match_ratio = jnp.where(carry.match_ratio == 0, num_curr / num_start, carry.match_ratio)

    pc = jnp.einsum("nij,npj->npi", carry.C, source[..., :3]) + carry.r[:, None, :]  # dICP/ICP.py:274
    N = source.shape[0]
    T_ts = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (N, 4, 4))
    T_ts = T_ts.at[:, :3, :3].set(carry.C).at[:, :3, 3].set(carry.r)

    return ICPResult(
        pc=pc,
        T=T_ts,
        costs=jnp.swapaxes(costs, 0, 1)[..., None],
        deltas=jnp.swapaxes(deltas, 0, 1)[..., None],
        weights=jnp.swapaxes(weights, 0, 1)[..., None],
        converged=carry.converged,
        iterations=lax.stop_gradient(num_iters),
        matched_ratio=lax.stop_gradient(match_ratio),
    )


def register(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    key: Optional[jax.Array] = None,
) -> ICPResult:
    """Batched ICP registration (functional, jit-safe; cfg must be static).

    Equivalent of ICP.dICP (dICP/ICP.py:49-303) on pre-batched inputs.
    """
    if source.ndim != 3 or target.ndim != 3 or T_init.ndim != 3:
        raise ValueError("register() expects batched (N, n, 3), (N, m, 3|6), (N, 4, 4); "
                         "use dicp_tpu.api.ICP for ragged/unbatched inputs")
    if cfg.differentiable and cfg.use_gumbel and key is None:
        raise ValueError("Gumbel NN requires an explicit PRNG key")
    if not (cfg.differentiable and cfg.use_gumbel):
        key = None
    if key is not None:
        # One independent stream per batch element, derived from the GLOBAL
        # batch index: element i's noise is identical whether the batch is
        # solved whole or in ``batch_chunk`` pieces (chunked == unchunked),
        # and is invariant to the other elements in the batch.
        key = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(source.shape[0]))

    # f32 matmuls may run in TF32 (or bf16) by default, which biases the
    # distance matrices and the accumulated rotation chain by ~1e-3 — pin
    # full-precision matmuls for everything traced inside the solver.
    with jax.default_matmul_precision("float32"):
        if cfg.batch_chunk is not None and source.shape[0] > cfg.batch_chunk:
            return _chunked_over_batch(
                lambda s, t, ti, w, k: _register_impl(s, t, ti, w, cfg, k),
                cfg.batch_chunk, source, target, T_init, weight, key)
        return _register_impl(source, target, T_init, weight, cfg, key)


def _chunked_over_batch(call, chunk, source, target, T_init, weight, key):
    """Apply ``call`` over sequential batch chunks with ``lax.map``.

    Bitwise-identical to one big call: batch elements are independent, and
    (when a PRNG key is used) Gumbel noise streams are derived per GLOBAL
    batch element in :func:`register` before chunking, so element i draws
    the same noise either way.  Keeps every chunk at the solver's
    throughput knee (see ``ICPConfig.batch_chunk``).  The batch is
    edge-padded to a chunk multiple and results sliced back."""
    N = source.shape[0]
    nc = -(-N // chunk)
    pad = nc * chunk - N
    if weight is None:
        weight = jnp.ones(source.shape[:-1], dtype=source.dtype)

    def prep(a):
        if pad:
            a = jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)], axis=0)
        return a.reshape((nc, chunk) + a.shape[1:])

    operands = (prep(source), prep(target), prep(T_init), prep(weight))
    if key is not None:
        operands = operands + (prep(key),)
    else:
        operands = operands + (jnp.zeros((nc,), jnp.int32),)  # placeholder

    def body(args):
        s, t, ti, w, k = args
        return call(s, t, ti, w, k if key is not None else None)

    out = lax.map(body, operands)
    return jax.tree_util.tree_map(
        lambda o: o.reshape((nc * chunk,) + o.shape[2:])[:N], out)


def _register_impl(source, target, T_init, weight, cfg, key):
    if cfg.anderson_m > 0:
        # Anderson-accelerated fixed-point driver (dicp_tpu.anderson); does
        # its own preprocessing.  Reverse-mode AD cannot flow through it
        # (while_loop) — differentiable=True is still meaningful: it selects
        # the smooth weight forms whose fixed point the IFT backward
        # linearizes (see ift._fixed_point_res).
        from dicp_tpu.anderson import _anderson_impl

        return _anderson_impl(source, target, T_init, weight, cfg,
                              cfg.anderson_m, 1e-8, cfg.anderson_cap)

    source, target, weight, C, r = _preprocess(cfg, source, target, T_init, weight)

    # Gumbel soft-NN has its own dense path in _gn_step — building the hard
    # corr closure (incl. a cluster index + query sort) would be dead ops
    # traced into every program (code-review r3).
    corr_fn = None if (cfg.differentiable and cfg.use_gumbel) \
        else _make_corr_fn(cfg, source, target, C, r)

    driver = cfg.resolved_driver()
    if driver == "scan":
        carry, deltas, weights, costs = _run_scan(cfg, source, target, weight, C, r, key, corr_fn)
        if cfg.const_iter:
            it_final = jnp.asarray(cfg.max_iterations, source.dtype)
        else:
            # Reference it_final: max converged iteration if all converged,
            # else max_iterations (the break condition, dICP/ICP.py:259-267).
            it_final = jnp.where(jnp.all(carry.converged),
                                 jnp.max(carry.num_iters),
                                 jnp.asarray(float(cfg.max_iterations), source.dtype))
    else:
        carry, deltas, weights, costs, it_final = _run_while(
            cfg, source, target, weight, C, r, key, corr_fn)

    return _finalize(cfg, source, carry, deltas, weights, costs, it_final)


register_jit = jax.jit(register, static_argnames=("cfg",))


def executed_iterations(result: ICPResult) -> int:
    """Host-side count of executed iterations, for slicing fixed-length
    histories to the reference's dynamic length (requires a device sync)."""
    return int(jnp.max(result.iterations))


def slice_histories(result: ICPResult) -> ICPResult:
    """Trim histories to the executed length (host-side convenience).

    No-op under tracing (dynamic lengths are impossible inside jit/grad —
    fixed-length histories with carry-forward padding are returned instead).
    """
    if isinstance(result.iterations, jax.core.Tracer):
        return result
    k = executed_iterations(result)
    return result._replace(costs=result.costs[:, :k], deltas=result.deltas[:, :k],
                           weights=result.weights[:, :k])
