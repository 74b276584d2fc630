"""Surface-normal estimation from raw point clouds.

The reference assumes pt2pl targets arrive with precomputed normal columns
(dICP/ICP.py:101-103); a complete LiDAR front-end must produce them.  Classic
PCA normals: the normal at p is the smallest-eigenvalue eigenvector of the
covariance of its k nearest neighbors.

Design choices:

* three neighborhood backends: dense distance matrix + top_k (small),
  cluster-pruned exact k-NN (``ops/cluster_knn``), and — the scale path —
  :func:`estimate_normals_weighted`, which needs NO k-NN selection at all:
  an Epanechnikov-weighted covariance over cluster candidates whose moment
  sum is one fat-K matmul;
* the 3x3 symmetric eigenproblem solved in CLOSED FORM (trigonometric
  eigenvalues + eigenspace projector), not ``jnp.linalg.eigh`` — XLA lowers
  tiny eigh to a sequential Jacobi loop;
* everything vmap/jit-safe with static shapes; 2-D scans get a dedicated
  2x2 path (for planar data the 3-D smallest eigenvector is the out-of-plane
  axis, not the in-plane contour normal).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from dicp_tpu.knn import pairwise_sq_dist


def smallest_eigvec_sym3(a: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Trigonometric closed form (Smith's algorithm) for the eigenvalues
    lam1 >= lam2 >= lam3, then the lam3 eigenspace as the column space of
    (A - lam1 I)(A - lam2 I); the largest column is numerically the most
    stable representative.  Isotropic neighborhoods (p ~ 0) fall back to
    +z — the caller cannot recover a meaningful normal there anyway.
    """
    dtype = a.dtype
    # Normalize by the matrix scale FIRST: eigenvectors are scale-invariant
    # but the degeneracy guards below are not — vnorm is quartic in the
    # covariance scale while eps*(1+|q|) is ~constant, so without this a
    # perfectly valid small-extent neighborhood (cov ~ cm^2 in meters, f32)
    # tripped the guard and every normal collapsed to +z (code-review r3).
    scale = jnp.maximum(jnp.max(jnp.abs(a), axis=(-2, -1)),
                        jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    a = a / scale[..., None, None]
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0 = a[..., 0, 0] - q
    d1 = a[..., 1, 1] - q
    d2 = a[..., 2, 2] - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    # relative degeneracy scale: isotropic if spread << mean eigenvalue
    degenerate = p2 < (eps * (1.0 + jnp.abs(q))) ** 2
    p = jnp.sqrt(jnp.where(degenerate, jnp.ones_like(p2), p2) / 6.0)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), a.shape)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    det_b = (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
             - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
             + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0]))
    r = jnp.clip(det_b / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam1 = q + 2.0 * p * jnp.cos(phi)
    lam3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3

    # (A - lam1)(A - lam2) projects onto the lam3 eigenspace
    m = (a - lam1[..., None, None] * eye) @ (a - lam2[..., None, None] * eye)
    norms2 = jnp.sum(m * m, axis=-2)                       # (..., 3) column norms
    best = jnp.argmax(norms2, axis=-1)
    v = jnp.take_along_axis(m, best[..., None, None], axis=-1)[..., 0]
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    ez = jnp.zeros_like(v).at[..., 2].set(1.0)
    bad = degenerate[..., None] | (vnorm < eps * (1.0 + jnp.abs(q))[..., None])
    safe = jnp.where(bad, jnp.ones_like(vnorm), vnorm)
    return jnp.where(bad, ez, v / safe)


def _vmap_leading(fn, x, ndim_core=2):
    for _ in range(x.ndim - ndim_core):
        fn = jax.vmap(fn)
    return fn


def knn_indices(points: jnp.ndarray, k: int,
                query: Optional[jnp.ndarray] = None,
                method: str = "auto",
                cluster_group: int = 128,
                cluster_probes: int = 16) -> jnp.ndarray:
    """Indices of the k nearest points (incl. self) for each query (..., n, k).

    ``method='dense'`` materializes the (n, m) distance matrix + lax.top_k —
    fine to ~10k points, 40 GB at 100k.  ``'cluster'`` uses the Hilbert
    cluster-pruned exact search (ops/cluster_knn) with O(n * probes * group)
    cost and memory — the scale path.  ``'auto'`` switches on problem size.
    """
    q = points if query is None else query
    n, m = q.shape[-2], points.shape[-2]
    if method == "auto":
        method = "cluster" if n * m > 4096 * 4096 else "dense"
    if method == "cluster":
        from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_knn

        def one(pts, qq):
            index = build_cluster_index(pts, cluster_group)
            idx, _, _ = cluster_knn(index, qq, k=k, probes=cluster_probes)
            return idx

        fn = one
        for _ in range(q.ndim - 2):
            fn = jax.vmap(fn)
        return fn(points[..., :3], q[..., :3])
    d2 = pairwise_sq_dist(q, points)
    _, idx = jax.lax.top_k(-d2, k)
    return idx


def _normals_single(points: jnp.ndarray, neighbor_idx: jnp.ndarray,
                    viewpoint: jnp.ndarray, k: int) -> jnp.ndarray:
    """(n, 3) cloud + (n, k) neighbor indices -> (n, 3) oriented unit normals."""
    nbrs = points[neighbor_idx]                            # (n, k, 3)
    mu = jnp.mean(nbrs, axis=-2, keepdims=True)
    c = nbrs - mu
    cov = jnp.einsum("nka,nkb->nab", c, c) / k             # (n, 3, 3)
    n = smallest_eigvec_sym3(cov)
    flip = jnp.sum(n * (viewpoint[None, :] - points), axis=-1, keepdims=True) < 0.0
    return jnp.where(flip, -n, n)


def estimate_normals_weighted(
    points: jnp.ndarray,
    viewpoint: Optional[jnp.ndarray] = None,
    bandwidth_scale: float = 3.5,
    probes: int = 16,
    group_size: int = 128,
) -> jnp.ndarray:
    """Kernel-weighted PCA normals — the large-cloud fast path (n, 3) -> (n, 3).

    Instead of exact k-NN sets (whose top-k selection re-reads the
    candidate matrix k times), each point's
    covariance is an Epanechnikov-weighted moment sum over its cluster-index
    candidates: w = max(0, 1 - d2/h2).  The moment accumulation is ONE
    matmul with contraction over the candidates (fat K),
    and the bandwidth h = bandwidth_scale * max(own 1-NN distance,
    block-median 1-NN distance) adapts to local density without collapsing
    on close pairs.  Estimator quality matches kNN-PCA on smooth surfaces
    (tests/test_normals.py asserts angle accuracy on analytic scenes).
    """
    from dicp_tpu.ops.cluster_knn import (_SENTINEL, _block_select,
                                          _candidate_d2, _sorted_blocks,
                                          _unsort, build_cluster_index)

    pts = points[..., :3]
    if viewpoint is None:
        viewpoint = jnp.zeros((3,), pts.dtype)
    with jax.default_matmul_precision("float32"):
        index = build_cluster_index(pts, group_size)
        xb, inv, n = _sorted_blocks(index, pts)
        bsel, _ = _block_select(index, xb, probes)
        d2, _, cand = _candidate_d2(index, xb, bsel, return_cand=True)

        # adaptive bandwidth from the BLOCK-median 1-NN distance: a
        # per-query 1-NN bandwidth collapses for close pairs (h -> pair
        # distance -> 2-point rank-1 covariance -> garbage normal); the
        # block median tracks local density robustly (blocks are
        # curve-contiguous, hence spatially local)
        d2_pos = jnp.where(d2 <= 0.0, jnp.inf, d2)
        d2_nn = jnp.min(d2_pos, axis=-1)                  # (nb, Qb)
        d2_med = jnp.median(d2_nn, axis=-1, keepdims=True)[..., None]
        h2 = (bandwidth_scale ** 2) * jnp.maximum(d2_nn[..., None], d2_med)
        w = jnp.maximum(1.0 - d2 / h2, 0.0)               # Epanechnikov

        # center candidates at the block mean BEFORE the moment sum: the
        # raw-moment covariance S2/S0 - mu mu^T cancels catastrophically in
        # f32 at scene-scale coordinates (entries ~R^2=800 vs cov ~h^2=0.1
        # -> ~1e-3 relative noise, ~2 deg of normal tilt in f32);
        # after centering the moment scale is the block extent, not R.
        # Sentinel pads would poison the mean -> mask them out.
        real = cand[..., 0] < _SENTINEL * 0.5              # (nb, C)
        nreal = jnp.maximum(jnp.sum(real, axis=-1, keepdims=True), 1.0)
        o_b = (jnp.sum(jnp.where(real[..., None], cand, 0.0), axis=-2,
                       keepdims=True) / nreal[..., None])  # (nb, 1, 3)
        cand = cand - o_b

        # moments via ONE fat-K matmul: [S0 | S1 | S2(6)] = W @ M (C, 10)
        one = jnp.ones(cand.shape[:-1] + (1,), cand.dtype)
        c0, c1, c2 = cand[..., 0:1], cand[..., 1:2], cand[..., 2:3]
        M = jnp.concatenate([one, cand, c0 * c0, c0 * c1, c0 * c2,
                             c1 * c1, c1 * c2, c2 * c2], axis=-1)  # (nb, C, 10)
        S = jnp.einsum("bqc,bcm->bqm", w, M)              # (nb, Qb, 10)
        S0 = jnp.maximum(S[..., 0:1], jnp.finfo(pts.dtype).tiny)
        mu = S[..., 1:4] / S0
        m2 = S[..., 4:10] / S0[..., :]
        cov = jnp.stack([
            jnp.stack([m2[..., 0], m2[..., 1], m2[..., 2]], axis=-1),
            jnp.stack([m2[..., 1], m2[..., 3], m2[..., 4]], axis=-1),
            jnp.stack([m2[..., 2], m2[..., 4], m2[..., 5]], axis=-1),
        ], axis=-2) - mu[..., :, None] * mu[..., None, :]
        nrm = smallest_eigvec_sym3(cov)                   # (nb, Qb, 3)
        nrm = _unsort(nrm, inv, n)
    flip = jnp.sum(nrm * (viewpoint[None, :] - pts), axis=-1, keepdims=True) < 0.0
    return jnp.where(flip, -nrm, nrm)


def estimate_normals(
    points: jnp.ndarray,
    k: int = 16,
    viewpoint: Optional[jnp.ndarray] = None,
    neighbor_idx: Optional[jnp.ndarray] = None,
    method: str = "auto",
) -> jnp.ndarray:
    """PCA normals for a 3-D cloud (..., n, 3) -> unit normals (..., n, 3).

    ``viewpoint`` (3,) orients normals to face it (default: the origin — the
    LiDAR sensor frame convention).  ``neighbor_idx`` (..., n, k) skips the
    internal kNN (reuse the solver's correspondence machinery).  ``method``:
    'dense' / 'cluster' pick the exact-kNN backend (see :func:`knn_indices`);
    'weighted' uses :func:`estimate_normals_weighted` (fastest at scale);
    'auto' = dense small, weighted for 100k+ clouds — no (n, n) matrix is
    ever built.
    """
    pts = points[..., :3]
    if method == "auto" and neighbor_idx is None:
        n_m = pts.shape[-2] * pts.shape[-2]
        method = "weighted" if n_m > 4096 * 4096 else "dense"
    if method == "weighted" and neighbor_idx is None:
        fn = functools.partial(estimate_normals_weighted, viewpoint=viewpoint)
        for _ in range(pts.ndim - 2):
            fn = jax.vmap(fn)
        return fn(pts)
    if neighbor_idx is None:
        neighbor_idx = knn_indices(pts, k, method=method)
    if viewpoint is None:
        viewpoint = jnp.zeros((3,), pts.dtype)

    fn = functools.partial(_normals_single, k=neighbor_idx.shape[-1])
    wrapped = _vmap_leading(lambda p, i: fn(p, i, viewpoint), pts)
    with jax.default_matmul_precision("float32"):
        return wrapped(pts, neighbor_idx)


def _normals_2d_single(xy: jnp.ndarray, idx: jnp.ndarray,
                       viewpoint: jnp.ndarray) -> jnp.ndarray:
    nbrs = xy[idx]                                         # (n, k, 2)
    mu = jnp.mean(nbrs, axis=-2, keepdims=True)
    c = nbrs - mu
    cxx = jnp.sum(c[..., 0] * c[..., 0], axis=-1)
    cyy = jnp.sum(c[..., 1] * c[..., 1], axis=-1)
    cxy = jnp.sum(c[..., 0] * c[..., 1], axis=-1)
    # smallest eigenvalue of [[cxx, cxy], [cxy, cyy]] (closed form)
    tr = cxx + cyy
    gap = jnp.sqrt(jnp.clip((cxx - cyy) ** 2 + 4.0 * cxy * cxy, 0.0, None))
    lam_min = 0.5 * (tr - gap)
    # eigenvector: (cxy, lam - cxx) or (lam - cyy, cxy) — pick the better
    # conditioned of the two equivalent forms
    v1 = jnp.stack([cxy, lam_min - cxx], axis=-1)
    v2 = jnp.stack([lam_min - cyy, cxy], axis=-1)
    pick = (jnp.sum(v1 * v1, axis=-1, keepdims=True)
            >= jnp.sum(v2 * v2, axis=-1, keepdims=True))
    v = jnp.where(pick, v1, v2)
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    eps = jnp.asarray(jnp.finfo(xy.dtype).eps, xy.dtype) * (1.0 + tr[..., None])
    ex = jnp.zeros_like(v).at[..., 0].set(1.0)
    bad = vnorm < eps
    v = jnp.where(bad, ex, v / jnp.where(bad, jnp.ones_like(vnorm), vnorm))
    flip = jnp.sum(v * (viewpoint[None, :2] - xy), axis=-1, keepdims=True) < 0.0
    v = jnp.where(flip, -v, v)
    return jnp.concatenate([v, jnp.zeros_like(v[..., :1])], axis=-1)


def estimate_normals_2d(
    points: jnp.ndarray,
    k: int = 8,
    viewpoint: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """In-plane contour normals for a planar scan (..., n, 2|3) -> (..., n, 3).

    Uses the 2x2 covariance of the (x, y) neighborhood; output normals have
    z = 0 (the solver's dim=2 convention, dICP/ICP.py:113-116).
    """
    xy = points[..., :2]
    pts3 = jnp.concatenate([xy, jnp.zeros_like(xy[..., :1])], axis=-1)
    idx = knn_indices(pts3, k)
    if viewpoint is None:
        viewpoint = jnp.zeros((3,), xy.dtype)
    wrapped = _vmap_leading(lambda p, i: _normals_2d_single(p, i, viewpoint), xy)
    with jax.default_matmul_precision("float32"):
        return wrapped(xy, idx)
