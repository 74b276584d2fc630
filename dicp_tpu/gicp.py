"""Generalized-ICP (plane-to-plane) — distribution-to-distribution alignment.

No reference counterpart (the reference offers pt2pt/pt2pl only,
dICP/ICP.py:49); GICP (Segal, Haehnel, Thrun, RSS 2009) is the remaining
classical ICP family member: every point carries a covariance describing
its local surface, and the residual is weighted by the inverse of the
combined covariance

    Sigma_i = C_target_i + R C_source_i R^T,   cost_i = r_i^T Sigma_i^{-1} r_i.

With the paper's (1, 1, eps) plane-to-plane regularization each covariance
is closed-form in the surface normal alone:

    C = U diag(1, 1, eps) U^T = I + (eps - 1) n n^T,

so no per-point eigendecomposition is stored or differentiated through —
the repo's normal estimation (ops/normals, power-iteration, no
jnp.linalg.eigh, which lowers to an iterative kernel) provides
everything, and Sigma_i is a rank-2 update of 2I inverted by the
closed-form 3x3 adjugate (ops/smallsolve.inv3).

Structure mirrors dicp_tpu.registration: one jitted program,
`lax.while_loop` early exit for inference / fixed-trip `lax.scan` with
convergence freezing for reverse-mode AD, f32 matmul precision pinned,
batch via vmap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import se3
from dicp_tpu.ops.normals import estimate_normals
from dicp_tpu.ops.smallsolve import inv3, solve_spd


class GICPResult(NamedTuple):
    T: jnp.ndarray            # (N, 4, 4) source -> target
    iterations: jnp.ndarray   # (N,) float
    converged: jnp.ndarray    # (N,) bool
    cost: jnp.ndarray         # (N,) final mean Mahalanobis cost


def _mahalanobis_ne(J, M, r, w, chunk: int = 4096):
    """H = sum_i w_i J_i^T M_i J_i (6,6), g = sum_i w_i J_i^T M_i r_i (6,)
    with two-level (chunked pairwise) f32 accumulation, plus Mr (n, 3).

    Same rounding scheme as registration._normal_equations: a flat einsum
    over n accumulates n sequential partial sums whose f32 noise reaches
    ~1e-4 in the GN step at ~3e5 rows; summing within
    chunks then across chunks bounds it ~O(sqrt)."""
    n = J.shape[0]
    MJ = jnp.einsum("nij,njk->nik", M, J)
    Mr = jnp.einsum("nij,nj->ni", M, r)
    if n <= chunk:
        H = jnp.einsum("nij,n,nik->jk", J, w, MJ)
        g = jnp.einsum("nij,n,ni->j", J, w, Mr)
        return H, g, Mr
    nc = -(-n // chunk)
    pad = nc * chunk - n
    if pad:
        J = jnp.concatenate([J, jnp.zeros((pad,) + J.shape[1:], J.dtype)], 0)
        MJ = jnp.concatenate(
            [MJ, jnp.zeros((pad,) + MJ.shape[1:], MJ.dtype)], 0)
        Mr_p = jnp.concatenate(
            [Mr, jnp.zeros((pad, 3), Mr.dtype)], 0)
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)], 0)
    else:
        Mr_p = Mr
    Jc = J.reshape(nc, chunk, 3, 6)
    MJc = MJ.reshape(nc, chunk, 3, 6)
    Mrc = Mr_p.reshape(nc, chunk, 3)
    wc = w.reshape(nc, chunk)
    H = jnp.sum(jnp.einsum("cnij,cn,cnik->cjk", Jc, wc, MJc), axis=0)
    g = jnp.sum(jnp.einsum("cnij,cn,cni->cj", Jc, wc, Mrc), axis=0)
    return H, g, Mr


def _gicp_step(T, src, src_n, tgt, tgt_n, weight, epsilon, trim2):
    """One GN step: correspondences -> Mahalanobis normal equations -> se(3)
    update.  Returns (T_new, step_norm, mean_cost)."""
    R, t = T[:3, :3], T[:3, 3]
    p = src @ R.T + t                                   # (n, 3)

    # hard NN (gradient flows into the gathered rows, matching the repo's
    # hard-diff semantics, knn.py:68)
    d2 = (jnp.sum(p * p, 1)[:, None] + jnp.sum(tgt * tgt, 1)[None, :]
          - 2.0 * p @ tgt.T)
    idx = jnp.argmin(d2, axis=1)
    q = tgt[idx]                                        # (n, 3)
    nt = tgt_n[idx]                                     # (n, 3)

    r = p - q                                           # (n, 3)
    ns_w = src_n @ R.T                                  # rotated source normals
    # Sigma = C_t + R C_s R^T = 2 I + (eps-1)(nt nt^T + m m^T)
    eye = jnp.eye(3, dtype=src.dtype)
    Sigma = (2.0 * eye + (epsilon - 1.0)
             * (nt[:, :, None] * nt[:, None, :]
                + ns_w[:, :, None] * ns_w[:, None, :]))
    M = inv3(Sigma)                                     # (n, 3, 3) SPD

    w = weight * (jnp.sum(r * r, 1) < trim2).astype(src.dtype)

    # J_i = [ I | -skew(p_i) ]  (n, 3, 6)
    J = jnp.concatenate(
        [jnp.broadcast_to(eye, (src.shape[0], 3, 3)), -se3.skew(p)], -1)
    H, g, Mr = _mahalanobis_ne(J, M, r, w)              # (6,6), (6,), (n,3)

    wsum = jnp.maximum(jnp.sum(w), 1e-10)
    # Levenberg jitter scaled to H's diagonal: keeps the solve defined when
    # every correspondence is trimmed or the scene is degenerate.  solve_spd
    # (not the raw Schur form) because the rotation/translation blocks scale
    # with r^2 vs 1 — the un-equilibrated f32 Schur complement cancels
    # catastrophically on realistic-radius scans (ops/smallsolve.solve_spd).
    lam = 1e-9 * jnp.trace(H) / 6.0 + 1e-30
    delta = solve_spd(H + lam * jnp.eye(6, dtype=src.dtype), -g)
    T_new = se3.vec2tran(delta) @ T
    cost = jnp.sum(w * jnp.sum(r * Mr, 1)) / wsum
    return T_new, jnp.linalg.norm(delta), cost


def _solve_one(src, tgt, tgt_n, src_n, T0, weight, *, epsilon, trim2,
               max_iterations, tolerance, differentiable):
    step = partial(_gicp_step, src=src, src_n=src_n, tgt=tgt, tgt_n=tgt_n,
                   weight=weight, epsilon=epsilon, trim2=trim2)

    if not differentiable:
        def cond(c):
            T, it, done, cost = c
            return jnp.logical_and(it < max_iterations,
                                   jnp.logical_not(done))

        def body(c):
            T, it, done, _ = c
            T_new, dn, cost = step(T)
            return T_new, it + 1.0, dn < tolerance, cost

        T, it, done, cost = lax.while_loop(
            cond, body,
            (T0, jnp.asarray(0.0, src.dtype),
             jnp.asarray(False), jnp.asarray(jnp.inf, src.dtype)))
        return T, it, done, cost

    def body(c, _):
        T, it, done, cost = c
        T_new, dn, cost_new = step(T)
        # convergence freezing: a converged element's pose is carried
        # forward bit-identically (registration.py batch==serial contract)
        T_out = jnp.where(done, T, T_new)
        cost_out = jnp.where(done, cost, cost_new)
        it_out = jnp.where(done, it, it + 1.0)
        done_out = jnp.logical_or(done, dn < tolerance)
        return (T_out, it_out, done_out, cost_out), ()

    (T, it, done, cost), _ = lax.scan(
        body,
        (T0, jnp.asarray(0.0, src.dtype), jnp.asarray(False),
         jnp.asarray(jnp.inf, src.dtype)),
        None, length=max_iterations)
    return T, it, done, cost


def register_gicp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    *,
    source_normals: Optional[jnp.ndarray] = None,
    epsilon: float = 1e-3,
    trim_dist: Optional[float] = None,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    differentiable: bool = False,
    k_normals: int = 16,
) -> GICPResult:
    """Batched plane-to-plane GICP: (N, n, 3), (N, m, 3|6), (N, 4, 4).

    ``target`` columns 3:6 are used as target normals when present,
    otherwise normals for BOTH clouds are estimated in-program
    (ops/normals, k=``k_normals``).  ``source_normals`` (N, n, 3) skips the
    source-side estimate.  ``epsilon`` is the plane-to-plane covariance
    regularizer (Segal et al. use 1e-3; ``epsilon=1`` degrades exactly to
    isotropic covariances, i.e. point-to-point GN).  ``differentiable``
    selects the fixed-trip scan driver (reverse-mode AD; hard-NN gradient
    semantics) instead of the early-exit while loop.

    Correspondences use the dense (n, m) distance matrix — GICP is for
    the mid-scale regime; pair it with :mod:`dicp_tpu.multiscale` /
    ops.voxel for large clouds.
    """
    if source.ndim != 3 or target.ndim != 3 or T_init.ndim != 3:
        raise ValueError("register_gicp expects batched (N, n, 3), "
                         "(N, m, 3|6), (N, 4, 4)")
    dt = source.dtype
    src = source[..., :3]
    tgt = target[..., :3]
    with jax.default_matmul_precision("float32"):
        if target.shape[-1] >= 6:
            tgt_n = target[..., 3:6]
        else:
            tgt_n = estimate_normals(tgt, k=k_normals)
        if source_normals is None:
            src_n = estimate_normals(src, k=k_normals)
        else:
            src_n = source_normals[..., :3]
        if weight is None:
            weight = jnp.ones(src.shape[:-1], dt)
        trim2 = (jnp.asarray(jnp.inf, dt) if trim_dist is None
                 else jnp.asarray(float(trim_dist) ** 2, dt))

        solve = partial(_solve_one, epsilon=float(epsilon), trim2=trim2,
                        max_iterations=max_iterations, tolerance=tolerance,
                        differentiable=differentiable)
        T, it, done, cost = jax.vmap(solve)(src, tgt, tgt_n, src_n,
                                            T_init.astype(dt), weight)
    return GICPResult(T=T, iterations=it, converged=done, cost=cost)


register_gicp_jit = jax.jit(
    register_gicp,
    static_argnames=("epsilon", "trim_dist", "max_iterations", "tolerance",
                     "differentiable", "k_normals"))


# ---------------------------------------------------------------------------
# Implicit-function-theorem gradients (mirrors dicp_tpu.ift for the main
# engine): the forward uses the cheap early-exit while driver; the backward
# linearizes the stationarity G(xi) = sum_i w_i J_i^T M_i r_i evaluated at
# the pose exp(xi) T* — the exact root condition of the solver's GN
# iteration map (delta = 0  <=>  g = 0 with M evaluated at T*).  The full
# xi-dependence of M (through the rotated source normals) is kept in the
# linearization; correspondences and the hard trim gate are piecewise
# constant and fixed at T* (hard-diff semantics, knn.py:68).
# ---------------------------------------------------------------------------


def _gicp_g_vec(xi, T_star, src, tgt, tgt_n, src_n, idx, w, epsilon):
    """Stationarity 6-vector at pose exp(xi) . T* with FIXED matches idx.

    The full xi-dependence is kept: p, r, AND M (through the rotated source
    normals m = R n_s) all vary — this is the exact root condition of the
    solver's iteration map, so its linearization is the right IFT system."""
    T = se3.vec2tran(xi) @ T_star
    R, t = T[:3, :3], T[:3, 3]
    p = src @ R.T + t
    r = p - tgt[idx]
    nt = tgt_n[idx]
    m = src_n @ R.T
    eye = jnp.eye(3, dtype=src.dtype)
    Sigma = (2.0 * eye + (epsilon - 1.0)
             * (nt[:, :, None] * nt[:, None, :]
                + m[:, :, None] * m[:, None, :]))
    M = inv3(Sigma)
    J = jnp.concatenate(
        [jnp.broadcast_to(eye, (src.shape[0], 3, 3)), -se3.skew(p)], -1)
    _, g, _ = _mahalanobis_ne(J, M, r, w)
    return g


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gicp_fixed_point(params, src, tgt, tgt_n, src_n, weight, T_init):
    epsilon, trim2, max_iterations, tolerance = params
    solve = partial(_solve_one, epsilon=epsilon,
                    trim2=jnp.asarray(trim2, src.dtype),
                    max_iterations=max_iterations, tolerance=tolerance,
                    differentiable=False)
    T, it, done, cost = jax.vmap(solve)(src, tgt, tgt_n, src_n, T_init,
                                        weight)
    return GICPResult(T=T, iterations=it, converged=done, cost=cost)


def _gicp_fp_fwd(params, src, tgt, tgt_n, src_n, weight, T_init):
    res = _gicp_fixed_point(params, src, tgt, tgt_n, src_n, weight, T_init)
    return res, (src, tgt, tgt_n, src_n, weight, res.T)


def _gicp_fp_bwd(params, saved, res_bar):
    # the f32 matmul pin must cover the backward trace too (custom_vjp bwd
    # rules are traced in the cotangent sweep, outside register_gicp_ift's
    # with-block — same trap ift._fp_bwd documents)
    with jax.default_matmul_precision("float32"):
        return _gicp_fp_bwd_impl(params, saved, res_bar)


def _gicp_fp_bwd_impl(params, saved, res_bar):
    epsilon, trim2, _, _ = params
    src, tgt, tgt_n, src_n, weight, T = saved
    T_bar = res_bar.T  # iterations/converged/cost are detached by contract
    dt = src.dtype
    N = src.shape[0]

    def one_bwd(src1, tgt1, tn1, sn1, w1, T1, Tb1):
        R, t = T1[:3, :3], T1[:3, 3]
        p = src1 @ R.T + t
        d2 = (jnp.sum(p * p, 1)[:, None] + jnp.sum(tgt1 * tgt1, 1)[None, :]
              - 2.0 * p @ tgt1.T)
        idx = lax.stop_gradient(jnp.argmin(d2, axis=1))
        r = p - tgt1[idx]
        gate = lax.stop_gradient(
            (jnp.sum(r * r, 1) < jnp.asarray(trim2, dt)).astype(dt))

        def G(xi, src_, tgt_, tn_, sn_, w_):
            return _gicp_g_vec(xi, T1, src_, tgt_, tn_, sn_, idx,
                               w_ * gate, epsilon)

        zero = jnp.zeros((6,), dt)
        basis = jnp.eye(6, dtype=dt)
        A = jnp.stack(
            [jax.jvp(lambda x: G(x, src1, tgt1, tn1, sn1, w1),
                     (zero,), (basis[j],))[1] for j in range(6)],
            axis=-1)  # A[i, j] = dG_i / dxi_j
        # jitter for gauge-degenerate scenes (planar data in 3-D): the
        # null-direction gradient is meaningless, keep the solve finite
        A = A + ((1e-9 * jnp.trace(jnp.abs(A)) / 6.0 + 1e-30)
                 * jnp.eye(6, dtype=dt))

        _, pose_vjp = jax.vjp(lambda xi: se3.vec2tran(xi) @ T1, zero)
        xi_bar = pose_vjp(Tb1)[0]
        lam = jnp.linalg.solve(A.T, xi_bar)

        _, g_vjp = jax.vjp(
            lambda s, tg, tn, sn, w: G(zero, s, tg, tn, sn, w),
            src1, tgt1, tn1, sn1, w1)
        return g_vjp(-lam)

    src_bar, tgt_bar, tn_bar, sn_bar, w_bar = jax.vmap(one_bwd)(
        src, tgt, tgt_n, src_n, weight, T, T_bar)
    return (src_bar, tgt_bar, tn_bar, sn_bar, w_bar,
            jnp.zeros((N, 4, 4), dt))


_gicp_fixed_point.defvjp(_gicp_fp_fwd, _gicp_fp_bwd)


def register_gicp_ift(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    *,
    source_normals: Optional[jnp.ndarray] = None,
    epsilon: float = 1e-3,
    trim_dist: Optional[float] = None,
    max_iterations: int = 50,
    tolerance: float = 1e-9,
    k_normals: int = 16,
) -> GICPResult:
    """GICP with implicit gradients: early-exit while forward, ONE 6x6
    adjoint solve + one VJP of the stationarity backward — O(1) in the
    iteration count (cf. dicp_tpu.ift for the main engine).

    Normals are computed OUTSIDE the fixed point, so reverse-mode AD
    composes through the normal estimate into the clouds as well.
    Gradients assume convergence (check ``result.converged``); use a tight
    ``tolerance`` — the default here is 1e-9, tighter than
    :func:`register_gicp`'s.
    """
    if source.ndim != 3 or target.ndim != 3 or T_init.ndim != 3:
        raise ValueError("register_gicp_ift expects batched (N, n, 3), "
                         "(N, m, 3|6), (N, 4, 4)")
    dt = source.dtype
    src = source[..., :3]
    tgt = target[..., :3]
    with jax.default_matmul_precision("float32"):
        if target.shape[-1] >= 6:
            tgt_n = target[..., 3:6]
        else:
            tgt_n = estimate_normals(tgt, k=k_normals)
        if source_normals is None:
            src_n = estimate_normals(src, k=k_normals)
        else:
            src_n = source_normals[..., :3]
        if weight is None:
            weight = jnp.ones(src.shape[:-1], dt)
        trim2 = float("inf") if trim_dist is None else float(trim_dist) ** 2
        params = (float(epsilon), trim2, int(max_iterations),
                  float(tolerance))
        return _gicp_fixed_point(params, src, tgt, tgt_n, src_n, weight,
                                 T_init.astype(dt))
