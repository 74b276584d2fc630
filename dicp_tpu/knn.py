"""Nearest-neighbor correspondence search.

Replacement for the reference's brute-force NN class
(dICP/nn.py:4-125).  Three variants with identical semantics:

* hard NN (used for both "differentiable" and "non-differentiable" modes in
  the reference, dICP/nn.py:23-40 and :72-92): squared pairwise distances ->
  argmin -> gather of the full target rows (normals ride along).  Gradients
  flow into the *gathered* target rows only; the argmin index is an integer
  so the query gets no gradient through the selection — exactly the
  reference's stop-gradient-through-argmin semantics.
* Gumbel soft NN (dICP/nn.py:43-70): squared-distance logits + Gumbel noise,
  softmax at temperature tau, neighbor = probs @ targets.  Unlike the
  reference (which calls unseeded ``torch.rand``, dICP/nn.py:60) the noise is
  drawn from an explicit ``jax.random`` key.

The small-problem distance matrix is computed in the matmul form
|x|^2 + |y|^2 - 2 x.y^T instead of materializing an (n, m, 3) broadcast
difference (which the reference's Gumbel path does, dICP/nn.py:51-56 — its
memory hot spot).  Above ``backend.DENSE_MAX_PAIRS`` distance entries no
(n, m) matrix is built: :func:`nn_bruteforce` streams target tiles through
a running top-1, by the kernel :mod:`dicp_tpu.backend` picks for the
platform (the Triton kernel in :mod:`dicp_tpu.ops.pallas_knn`, or the XLA
:func:`nn_argmin_stream`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu import backend
from dicp_tpu.backend import DENSE_MAX_PAIRS

# Pad coordinate for streamed target rows: d2 ~ 3e30, finite in f32, never
# wins against a real point.
_SENTINEL = 1.0e15


def pairwise_sq_dist(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Squared Euclidean distances (..., n, 3) x (..., m, 3) -> (..., n, m).

    Matmul form; clipped at zero to guard tiny negatives.
    """
    x2 = jnp.sum(x * x, axis=-1, keepdims=True)  # (..., n, 1)
    y2 = jnp.sum(y * y, axis=-1, keepdims=True)  # (..., m, 1)
    # full f32 precision: a TF32 (or bf16) pass loses ~1e-3 relative on the
    # cross term, enough to flip argmins between close map points
    xy = jnp.einsum("...nd,...md->...nm", x, y,
                    precision=jax.lax.Precision.HIGHEST)
    d2 = x2 + jnp.swapaxes(y2, -1, -2) - 2.0 * xy
    return jnp.clip(d2, 0.0, None)


def nn_indices(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Argmin over brute-force distances: (..., n, 3), (..., m, >=3) -> (..., n) int32."""
    d2 = pairwise_sq_dist(x, y[..., :3])
    return jnp.argmin(d2, axis=-1).astype(jnp.int32)


def gather_rows(y: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather full target rows (..., m, c) at (..., n) -> (..., n, c).

    Differentiable in ``y`` (scatter-add in reverse), mirroring
    ``torch.gather`` at dICP/nn.py:38.
    """
    return jnp.take_along_axis(y, idx[..., None], axis=-2)


def hard_nn(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Hard 1-NN: (..., n, 3) queries, (..., m, 3/6) targets -> (..., n, 3/6)."""
    return gather_rows(y, nn_indices(x, y))


def gumbel_nn(
    x: jnp.ndarray,
    y: jnp.ndarray,
    key: jax.Array,
    tau: float = 0.1,
    eps: float = 1e-10,
    chunk: Optional[int] = None,
) -> jnp.ndarray:
    """Gumbel-softmax soft 1-NN (dICP/nn.py:43-70).

    neighbor = softmax((-d^2 + gumbel_noise) / tau) @ y — a convex
    combination, so gradients reach the query and ALL target rows.

    Above ``DENSE_MAX_PAIRS`` distance entries the softmax streams over
    target chunks with an online (flash-attention-style) max/denominator
    rescaling, so the (..., n, m) logits matrix is never materialized — the
    reference's Gumbel memory hot spot (dICP/nn.py:51-56) removed.  The
    streaming path folds the chunk index into ``key`` (a different — equally
    valid — noise stream than the dense path).  ``chunk`` forces a chunk
    size (None = auto).
    """
    n, m = x.shape[-2], y.shape[-2]
    if chunk is None and n * m <= DENSE_MAX_PAIRS:
        d2 = pairwise_sq_dist(x, y[..., :3])
        logits = -d2
        u = jax.random.uniform(key, shape=logits.shape, dtype=logits.dtype)
        noise = -jnp.log(-jnp.log(u + eps) + eps)
        probs = jax.nn.softmax((logits + noise) / tau, axis=-1)
        return jnp.einsum("...nm,...mc->...nc", probs, y)
    if chunk is None:
        chunk = max(128, min(m, DENSE_MAX_PAIRS // max(n, 1)))
    return _gumbel_nn_stream(x, y, key, tau, eps, chunk)


def _gumbel_nn_stream(x, y, key, tau, eps, chunk):
    """Online-softmax Gumbel NN over target chunks; O(n*chunk) live memory."""
    dtype = x.dtype
    m, c = y.shape[-2], y.shape[-1]
    nchunks = -(-m // chunk)
    pad = nchunks * chunk - m
    y_pad = jnp.concatenate(
        [y, jnp.zeros(y.shape[:-2] + (pad, c), dtype)], axis=-2) if pad else y
    qshape = x.shape[:-1]                     # (..., n)
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def step(carry, i):
        run_max, run_den, run_num = carry
        yc = lax.dynamic_slice_in_dim(y_pad, i * chunk, chunk, axis=-2)
        d2 = pairwise_sq_dist(x, yc[..., :3])              # (..., n, chunk)
        u = jax.random.uniform(jax.random.fold_in(key, i), shape=d2.shape,
                               dtype=dtype)
        s = (-d2 - jnp.log(-jnp.log(u + eps) + eps)) / tau
        col = jnp.arange(chunk) + i * chunk
        s = jnp.where(col < m, s, neg_inf)                 # mask padding
        new_max = jnp.maximum(run_max, jnp.max(s, axis=-1))
        # rescale previous accumulators into the new max's frame
        corr = jnp.exp(run_max - new_max)
        p = jnp.exp(s - new_max[..., None])
        run_den = run_den * corr + jnp.sum(p, axis=-1)
        run_num = run_num * corr[..., None] + jnp.einsum(
            "...nm,...mc->...nc", p, yc,
            precision=jax.lax.Precision.HIGHEST)
        return (new_max, run_den, run_num), None

    carry0 = (jnp.full(qshape, neg_inf, dtype),
              jnp.zeros(qshape, dtype),
              jnp.zeros(qshape + (c,), dtype))
    (_, den, num), _ = lax.scan(step, carry0, jnp.arange(nchunks))
    return num / den[..., None]


def _handle_dimensions(x: jnp.ndarray, y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Normalize inputs to (N, n, 3) queries and (N, m, 3/6) targets.

    Accepts (n, 3/6), (3/6, n), (N, n, 3/6), (N, 3/6, n) — the same transpose
    heuristics (including the documented 3x3 ambiguity) as dICP/nn.py:94-125.
    """
    x_use = x[None] if x.ndim == 2 else x
    if x_use.shape[-2] == 3 or (x_use.shape[-2] == 6 and x_use.shape[-2] < x_use.shape[-1]):
        x_use = jnp.swapaxes(x_use[:, :3, :], -1, -2)
    x_use = x_use[..., :3]
    if x_use.shape[-1] != 3:
        raise ValueError("x must have 3 coordinate columns")

    y_use = y[None] if y.ndim == 2 else y
    if y_use.shape[-2] == 3 or (y_use.shape[-2] == 6 and y_use.shape[-2] < y_use.shape[-1]):
        y_use = jnp.swapaxes(y_use, -1, -2)
    if y_use.shape[-1] not in (3, 6):
        raise ValueError("y must have 3 or 6 columns")
    return x_use, y_use


def min_and_lowest_id(d2: jnp.ndarray, ids: jnp.ndarray):
    """(min over the last axis, lowest id among its minima) in ONE reduction.

    ``d2`` (..., C), ``ids`` broadcastable to it.  A single variadic
    reduce: computing the min and then ``d2 == min`` in a second pass lets
    XLA recompute ``d2`` in two fusions with different rounding (FMA
    contraction differs between them on the GPU), after which no column
    equals the min and the id comes back as the int32 sentinel."""
    ids = jnp.broadcast_to(ids.astype(jnp.int32), d2.shape)

    def pick(a, b):
        (da, ia), (db, ib) = a, b
        take_b = (db < da) | ((db == da) & (ib < ia))
        return jnp.where(take_b, db, da), jnp.where(take_b, ib, ia)

    init = (jnp.asarray(jnp.inf, d2.dtype),
            jnp.asarray(jnp.iinfo(jnp.int32).max, jnp.int32))
    return lax.reduce((d2, ids), init, pick, (d2.ndim - 1,))


def nn_argmin_stream(xs: jnp.ndarray, pts: jnp.ndarray, chunk: int = 4096,
                     ids: Optional[jnp.ndarray] = None):
    """Exact brute-force argmin of ``xs`` (U, 3) against ``pts`` (M, 3).

    Streams target chunks through a running (d2, id) argmin in difference
    form, never materializing (U, M).  ``ids`` (M,) labels each target row
    (e.g. ORIGINAL-cloud rows when ``pts`` is Hilbert-sorted); exact-distance
    ties resolve to the LOWEST id — the global brute-force rule
    duplicate-point data depends on.  Returns (id (U,), d2 (U,))."""
    M = pts.shape[0]
    if ids is None:
        ids = jnp.arange(M, dtype=jnp.int32)
    nch = -(-M // chunk)
    pad = nch * chunk - M
    if pad:
        pts = jnp.concatenate(
            [pts, jnp.full((pad, 3), _SENTINEL, pts.dtype)], axis=0)
        ids = jnp.concatenate(
            [ids.astype(jnp.int32),
             jnp.full((pad,), jnp.iinfo(jnp.int32).max, jnp.int32)])
    ids = ids.astype(jnp.int32)

    def step(carry, i):
        best, bid = carry
        yc = lax.dynamic_slice_in_dim(pts, i * chunk, chunk, axis=0)
        idc = lax.dynamic_slice_in_dim(ids, i * chunk, chunk, axis=0)
        d2 = jnp.sum((xs[:, None, :] - yc[None, :, :].astype(xs.dtype)) ** 2,
                     axis=-1)                                  # (U, chunk)
        lmin, lid = min_and_lowest_id(d2, idc[None, :])
        better = (lmin < best) | ((lmin == best) & (lid < bid))
        return (jnp.where(better, lmin, best),
                jnp.where(better, lid, bid)), None

    # derive the init from xs so it inherits the varying-manual-axes type
    # under shard_map (cf. cluster_knn._candidate_argmin_scan)
    zero = 0.0 * xs[..., 0]
    init = (jnp.inf + zero,
            jnp.iinfo(jnp.int32).max + zero.astype(jnp.int32))
    (best, bid), _ = lax.scan(step, init, jnp.arange(nch))
    return bid, best


def nn_bruteforce(x: jnp.ndarray, y: jnp.ndarray):
    """Exact 1-NN without an (n, m) matrix: (..., n, 3), (..., m, >=3) ->
    (idx (..., n) int32, d2 (..., n)).

    The kernel is the platform's (:func:`dicp_tpu.backend.bruteforce_kernel`):
    the compiled Pallas-Triton kernel on the GPU, the XLA streaming argmin
    elsewhere.  Both use the difference form and the lowest-index tie rule.
    Indices carry no gradient (hard-NN semantics)."""
    x = lax.stop_gradient(x[..., :3])
    y = lax.stop_gradient(y[..., :3])
    if backend.bruteforce_kernel() == "triton":
        from dicp_tpu.ops.pallas_knn import nn_distances_pallas

        return nn_distances_pallas(x, y)
    fn = nn_argmin_stream
    for _ in x.shape[:-2]:
        fn = jax.vmap(fn)
    return fn(x, y)


def find_nn_normalized(
    x: jnp.ndarray,
    y: jnp.ndarray,
    use_pallas: Optional[bool] = None,
) -> jnp.ndarray:
    """Hard 1-NN on ALREADY-NORMALIZED (..., n, 3) / (..., m, 3|6) inputs.

    Solver-internal entry point: skips :func:`_handle_dimensions`, whose
    transpose heuristic misreads n==3 or m==3 clouds as (3, n) layout and
    silently corrupts correspondences.  ``use_pallas`` True forces the tiled
    brute force (:func:`nn_bruteforce`), False the dense matrix; None picks
    the tiled form above ``DENSE_MAX_PAIRS`` distance entries.
    """
    n, m = x.shape[-2], y.shape[-2]
    if use_pallas is None:
        use_pallas = n * m > DENSE_MAX_PAIRS
    if use_pallas:
        # the index is gradient-detached in hard-NN semantics; only the
        # gather carries tangents (into the target), like the dense hard_nn
        idx, _ = nn_bruteforce(x, y)
        return gather_rows(y, idx)
    return hard_nn(x, y)


def find_nn(
    x: jnp.ndarray,
    y: jnp.ndarray,
    differentiable: bool = True,
    use_gumbel: bool = False,
    key: Optional[jax.Array] = None,
    tau: float = 0.1,
    eps: float = 1e-10,
    use_pallas: Optional[bool] = None,
) -> jnp.ndarray:
    """Public NN entry point mirroring nn.find_nn (dICP/nn.py:11-21).

    Shape-normalizes inputs (including the reference's documented 3x3
    transpose ambiguity, dICP/nn.py:106-108), then dispatches: Gumbel soft NN
    when ``differentiable and use_gumbel`` (requires ``key``), hard NN
    otherwise.  ``use_pallas`` forces / forbids the tiled brute force
    (:func:`nn_bruteforce`); by default it is used for large clouds.
    """
    x_use, y_use = _handle_dimensions(x, y)
    if differentiable and use_gumbel:
        if key is None:
            raise ValueError("Gumbel NN needs an explicit PRNG key (the reference "
                             "uses unseeded torch.rand at dICP/nn.py:60; we don't).")
        return gumbel_nn(x_use, y_use, key, tau=tau, eps=eps)
    return find_nn_normalized(x_use, y_use, use_pallas)
