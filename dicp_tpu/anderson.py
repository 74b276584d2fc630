"""Anderson-accelerated ICP (opt-in inference driver).

Treats the Gauss-Newton ICP update as a fixed-point map on SE(3) and
applies Anderson mixing (type-II AA) over the last ``m`` iterates in
se(3)-log coordinates, with the energy safeguard of AA-ICP
[Pavlov et al., arXiv:1709.05479] / Fast-and-Robust-ICP
[Zhang et al., arXiv:2007.07627]: an accelerated iterate whose ICP energy
exceeds the last accepted one is discarded and replaced by the plain GN
step, so the worst case degrades to ordinary ICP (one wasted evaluation
per rejection) while well-behaved problems converge in substantially
fewer iterations.  That matters here because the per-iteration cost is
dispatch-bound on small pairs and correspondence-bound at 100k scale —
iterations saved are wall-clock saved.

Design notes:
- one ``lax.while_loop``; the mixing history lives in fixed (N, m, 6)
  buffers; every branch is a ``where`` mask, so batch elements accelerate,
  reject, and converge independently (batch == serial still holds).
- the m x m least-squares for the mixing weights is solved per element
  with a Tikhonov-regularized normal-equation solve (m is 3-5; the solve
  is negligible next to one correspondence pass).
- acceleration is for *inference* (the reference's differentiable path
  unrolls its own graph; use :mod:`dicp_tpu.ift` for gradients — the IFT
  backward only needs the fixed point, so its forward could use this
  driver; kept separate until profiled on the GPU).

No reference counterpart (the reference runs plain GN, dICP/ICP.py:132);
this is a capability addition from the retrieved technique papers.

When to use (measured, CPU f64, tolerance 1e-10):
- pt2pt — linear-rate fixed point, AA shines: reference test pair 25 -> 10
  iterations; 3-D synthetic 15 -> 12.
- pt2pl / symmetric — already near-quadratic; AA costs 1-3 extra
  evaluations (6 -> 7 on the test pair).  Prefer the plain ``while``
  driver there unless the initialization is poor.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import (ICPResult, _gn_step, _make_corr_fn,
                                   _preprocess)


def _encode(C, r):
    """(N,3,3),(N,3) -> (N,6) se(3)-log-style coordinates [log C | r]."""
    return jnp.concatenate([se3.log_so3(C), r], axis=-1)


def _decode(u):
    return se3.exp_so3(u[..., :3]), u[..., 3:]


def _aa_mix(dU, dF, f, valid, eps_rel, cap):
    """Type-II Anderson mixing coefficients and correction.

    dU, dF: (N, m, 6) histories of iterate / residual differences
    f:      (N, 6) current residual g(u) - u
    valid:  (N, m) 1.0 for filled history slots
    Returns the (N, 6) correction  sum_j gamma_j (dU_j + dF_j), trust-region
    capped at ``cap * |f|``: ICP's energy is only piecewise smooth
    (correspondences and robust weights switch between iterations), so raw
    AA extrapolations can overshoot by 50x+ and get rejected every few
    steps — the cap is what makes acceleration actually engage (measured on
    the reference pt2pt pair: uncapped 25 iterations = no better than
    plain, cap=5 -> 10).
    """
    dFm = dF * valid[..., None]
    A = jnp.einsum("nme,nke->nmk", dFm, dFm)             # (N, m, m)
    b = jnp.einsum("nme,ne->nm", dFm, f)                 # (N, m)
    # relative Tikhonov: keeps empty/ill-conditioned histories harmless
    # (their rows are zero -> gamma 0) without an absolute scale assumption
    m = A.shape[-1]
    diag_max = jnp.max(jnp.abs(jnp.diagonal(A, axis1=-2, axis2=-1)),
                       axis=-1, keepdims=True)
    lam = eps_rel * diag_max + jnp.finfo(A.dtype).tiny
    A = A + lam[..., None] * jnp.eye(m, dtype=A.dtype)
    gamma = jnp.linalg.solve(A, b[..., None])[..., 0]    # (N, m)
    gamma = gamma * valid
    corr = jnp.einsum("nm,nme->ne", gamma, dU + dF)
    cn = jnp.linalg.norm(corr, axis=-1, keepdims=True)
    fn = jnp.linalg.norm(f, axis=-1, keepdims=True)
    return corr * jnp.minimum(1.0, cap * fn / jnp.maximum(cn, jnp.finfo(corr.dtype).tiny))


def register_anderson(
    source: jnp.ndarray,
    target: jnp.ndarray,
    T_init: jnp.ndarray,
    weight: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
    m: int = 4,
    eps_rel: float = 1e-8,
    cap: float = 5.0,
) -> ICPResult:
    """Batched ICP with Anderson-accelerated fixed-point iteration.

    Same inputs/outputs as :func:`dicp_tpu.registration.register` with
    ``collect_histories=False`` semantics (no per-iteration history
    buffers); non-differentiable inference only.
    """
    if cfg.differentiable:
        raise ValueError("register_anderson is an inference driver; for "
                         "gradients use dicp_tpu.ift (IFT backward) or the "
                         "unrolled scan driver")
    if source.ndim != 3 or target.ndim != 3 or T_init.ndim != 3:
        raise ValueError("register_anderson expects batched (N, n, 3), "
                         "(N, m, 3|6), (N, 4, 4)")

    with jax.default_matmul_precision("float32"):
        return _anderson_impl(source, target, T_init, weight, cfg, int(m),
                              float(eps_rel), float(cap))


def _anderson_impl(source, target, T_init, weight, cfg, m, eps_rel, cap):
    source, target, weight, C0, r0 = _preprocess(cfg, source, target, T_init,
                                                 weight)
    corr_fn = _make_corr_fn(cfg, source, target, C0, r0)
    dtype = source.dtype
    N = source.shape[0]
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    u0 = _encode(C0, r0)
    state0 = dict(
        u=u0,
        g_safe=u0,                               # plain-GN fallback iterate
        u_acc=u0,                                # last ACCEPTED iterate
        f_acc=jnp.zeros((N, 6), dtype),          # residual at last accepted
        cost_acc=jnp.full((N,), big, dtype),     # energy at last accepted
        cost_last=jnp.full((N,), jnp.inf, dtype),  # last REAL evaluated energy
        dU=jnp.zeros((N, m, 6), dtype),
        dF=jnp.zeros((N, m, 6), dtype),
        hist_n=jnp.zeros((N,), jnp.int32),       # filled history slots
        converged=jnp.zeros((N,), bool),
        num_iters=jnp.zeros((N,), dtype),
        match_ratio=jnp.zeros((N,), dtype),
        w_last=jnp.zeros_like(weight),
        it=jnp.int32(0),
    )

    def cond(s):
        return (s["it"] < cfg.max_iterations) & ~jnp.all(s["converged"])

    def body(s):
        C, r = _decode(s["u"])
        # one plain GN evaluation at the current iterate: its cost is the
        # ICP energy AT u (weighted residuals before the update), its
        # output the fixed-point map image g(u)
        C1, r1, delta6, w, cost = _gn_step(cfg, source, target, weight,
                                           C, r, None, corr_fn)
        g = _encode(C1, r1)
        f = g - s["u"]

        # -- safeguard: u (an AA extrapolation) must not raise the energy
        accepted = cost <= s["cost_acc"]
        # convergence is judged on accepted plain-GN steps only
        below = accepted & (jnp.linalg.norm(delta6, axis=-1) < cfg.tolerance)
        converged = s["converged"] | below
        itf = (s["it"] + 1).astype(dtype)
        num_iters = jnp.where(below & (s["num_iters"] == 0), itf,
                              s["num_iters"])
        num_curr = jnp.sum(w > cfg.match_ratio_thresh, axis=-1).astype(dtype)
        num_start = jnp.sum(weight > cfg.match_ratio_thresh,
                            axis=-1).astype(dtype)
        num_start = jnp.where(num_start == 0, 1.0, num_start)
        match_ratio = jnp.where(below & (s["match_ratio"] == 0),
                                num_curr / num_start, s["match_ratio"])

        # -- history update (accepted elements only)
        du = s["u"] - s["u_acc"]
        df = f - s["f_acc"]
        first = s["hist_n"] == 0                  # no accepted point yet
        push = accepted & ~first
        dU = jnp.where(push[:, None, None],
                       jnp.concatenate([s["dU"][:, 1:], du[:, None]], axis=1),
                       s["dU"])
        dF = jnp.where(push[:, None, None],
                       jnp.concatenate([s["dF"][:, 1:], df[:, None]], axis=1),
                       s["dF"])
        hist_n = jnp.where(accepted, jnp.minimum(s["hist_n"] + 1, m + 1),
                           s["hist_n"])
        k = jnp.minimum(hist_n - 1, m)            # usable difference pairs
        valid = (jnp.arange(m)[None, :] >= (m - k[:, None])).astype(dtype)

        # -- next iterate: AA-mixed where accepted, plain fallback where not
        corr = _aa_mix(dU, dF, f, valid, eps_rel, cap)
        u_aa = g - corr
        u_next = jnp.where(accepted[:, None], u_aa, s["g_safe"])
        # NEWLY converged elements take the converging plain-GN step — the
        # plain while driver applies the sub-tolerance delta before freezing
        # (registration.py carry semantics), so freezing at the pre-update u
        # would lag it by one step at loose tolerances
        u_next = jnp.where(below[:, None], g, u_next)
        # previously converged elements stay frozen (batch == serial)
        u_next = jnp.where(s["converged"][:, None], s["u"], u_next)

        # rejected elements take the guaranteed plain step and accept it
        # unconditionally next time (cost_acc = +inf) — worst case is
        # ordinary ICP with one wasted evaluation per rejection
        cost_acc = jnp.where(accepted, cost, big)
        hist_n = jnp.where(accepted, hist_n, 0)

        return dict(
            u=u_next,
            g_safe=jnp.where(accepted[:, None], g, s["g_safe"]),
            u_acc=jnp.where(accepted[:, None], s["u"], s["u_acc"]),
            f_acc=jnp.where(accepted[:, None], f, s["f_acc"]),
            cost_acc=cost_acc,
            # the energy actually evaluated this iteration — never the
            # rejection sentinel; frozen once converged
            cost_last=jnp.where(s["converged"], s["cost_last"], cost),
            dU=dU, dF=dF, hist_n=hist_n,
            converged=converged, num_iters=num_iters,
            match_ratio=match_ratio,
            w_last=jnp.where(accepted[:, None], w, s["w_last"]),
            it=s["it"] + 1,
        )

    s = lax.while_loop(cond, body, state0)

    C, r = _decode(s["u"])
    itf = s["it"].astype(dtype)
    num_iters = jnp.where(s["num_iters"] == 0, itf, s["num_iters"])
    num_curr = jnp.sum(s["w_last"] > cfg.match_ratio_thresh,
                       axis=-1).astype(dtype)
    num_start = jnp.sum(weight > cfg.match_ratio_thresh, axis=-1).astype(dtype)
    num_start = jnp.where(num_start == 0, 1.0, num_start)
    match_ratio = jnp.where(s["match_ratio"] == 0, num_curr / num_start,
                            s["match_ratio"])

    pc = jnp.einsum("nij,npj->npi", C, source[..., :3]) + r[:, None, :]
    T_ts = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (N, 4, 4))
    T_ts = T_ts.at[:, :3, :3].set(C).at[:, :3, 3].set(r)
    P = weight.shape[-1]
    return ICPResult(
        pc=pc, T=T_ts,
        costs=s["cost_last"][:, None, None],
        deltas=jnp.zeros((N, 1, 6, 1), dtype),
        weights=s["w_last"].reshape(N, 1, P, 1),
        converged=s["converged"],
        iterations=num_iters,
        matched_ratio=match_ratio,
    )


register_anderson_jit = jax.jit(register_anderson,
                                static_argnames=("cfg", "m", "eps_rel", "cap"))
