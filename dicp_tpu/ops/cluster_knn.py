"""Exact cluster-pruned nearest-neighbor search for large clouds.

Brute force (``knn.nn_bruteforce``) costs O(n*m) distance evaluations —
1e10 at 100k x 100k.  This module replaces that with an
O(n * probes * group) EXACT search: the accelerator-friendly answer to the
kd-trees a CPU library would use (the reference has no index at all —
torch.cdist at dICP/nn.py:32-38).  Everything is plain XLA.

Design:

1. **Build** (once per target cloud — the target is constant across all GN
   iterations of a registration): Hilbert-sort the m points (one device
   radix sort; Hilbert, not Morton — octant jumps in the Morton curve
   produce ~2.5x looser covering radii), split the sorted order into G
   contiguous groups of ``g`` points, record per-group center + covering
   radius.  The jump-free curve makes every group compact.
2. **Block-scattered query**: sort the queries along the same curve (same
   quantization frame), form blocks of ~128 consecutive queries with a
   center+radius cover each, and select each BLOCK's top-P groups by the
   block-level lower bound ``max(0, |o-c| - r_blk - r_grp)^2`` — a
   (n/128, G) top_k instead of a per-query (n, G) one (per-query selection
   was the bottleneck of an earlier design; a contiguous-window search was
   fast but could not certify).  Every query in a
   block searches the block's P*g gathered candidates exactly.
3. **Certificate**: per query, exact iff its found distance <= the
   PER-QUERY lower bound minimized over all non-selected groups (the
   (n, G) LB matrix is cheap next to the candidate search).
   Sound by construction: a non-selected group's true points are at
   distance >= its LB.  All bounds carry a few-ulp conservative slack so
   f32 rounding can only loosen the certificate, never fake it; the
   certificate may under-claim, never lie (tested adversarially).

Static shapes throughout — the whole thing jits and vmaps.  Tie-breaking
follows candidate order (block probe order), not the reference's
global-lowest-index rule — ties are exact-equal distances, immaterial for
ICP.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dicp_tpu.knn import _SENTINEL, min_and_lowest_id, nn_argmin_stream
_QBLOCK = 128       # queries per selection block


class ClusterIndex(NamedTuple):
    """Hilbert-grouped search structure over one target cloud.

    points  (G, g, 3)  sorted/grouped coordinates (pads = 1e15 sentinel)
    centers (G, 3)     per-group mean of REAL points
    radius  (G,)       covering radius over real points (ulp-inflated)
    order   (G*g,)     sorted position -> original row (pads -> 0)
    frame   (2, 3)     f32 [bbox lo; bbox extent] — queries are curve-sorted
                       in this same quantization frame
    """

    points: jnp.ndarray
    centers: jnp.ndarray
    radius: jnp.ndarray
    order: jnp.ndarray
    frame: jnp.ndarray


def _part1by2(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of uint32 v so they occupy every 3rd bit."""
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def _bbox_frame(points: jnp.ndarray) -> jnp.ndarray:
    p = points[..., :3].astype(jnp.float32)
    lo = jnp.min(p, axis=-2)
    extent = jnp.maximum(jnp.max(p, axis=-2) - lo, jnp.float32(1e-30))
    return jnp.stack([lo, extent])


def _quantize(points: jnp.ndarray, frame: jnp.ndarray,
              bits: int = 10) -> jnp.ndarray:
    p = points[..., :3].astype(jnp.float32)
    n = float(1 << bits)
    q = (p - frame[0]) / frame[1] * n
    return jnp.clip(q, 0.0, n - 1.0).astype(jnp.uint32)


def morton_keys(points: jnp.ndarray) -> jnp.ndarray:
    """(m, 3) -> (m,) uint32 Morton codes on a 1024^3 grid over the bbox.

    Kept for comparison/tests; the index uses :func:`hilbert_keys` (compact
    groups).  Grid resolution only affects grouping quality, never
    correctness — the exactness certificate is geometric."""
    q = _quantize(points, _bbox_frame(points))
    return (_part1by2(q[..., 0])
            | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))


def hilbert_keys(points: jnp.ndarray, bits: int = 10,
                 frame: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(m, 3) -> (m,) int32 Hilbert-curve indices on a 1024^3 grid.

    Unlike Morton, the Hilbert curve has no octant discontinuities, so
    equal-count runs of the sorted order form COMPACT groups (about 2.5x
    smaller mean covering radius on uniform clouds) and consecutive
    sorted queries are spatial neighbors (the block-scattered query exploits
    this).  Skilling's transpose algorithm ("Programming the Hilbert
    curve", 2004) vectorized as pure uint32 ops over the whole cloud.  Keys
    are < 2^30, returned as int32.  ``frame`` fixes the quantization bbox
    (queries must reuse the index's frame).
    """
    if frame is None:
        frame = _bbox_frame(points)
    q = _quantize(points, frame, bits)
    X = [q[..., 0], q[..., 1], q[..., 2]]

    # inverse-undo excess work
    Q = 1 << (bits - 1)
    while Q > 1:
        Qj = jnp.uint32(Q)
        P = jnp.uint32(Q - 1)
        for i in range(3):
            hit = (X[i] & Qj) != 0
            # if bit set: invert low bits of X[0]; else swap low bits X[0]<->X[i]
            t = jnp.where(hit, jnp.uint32(0), (X[0] ^ X[i]) & P)
            X0_new = jnp.where(hit, X[0] ^ P, X[0] ^ t)
            X[i] = jnp.where(hit, X[i], X[i] ^ t)
            X[0] = X0_new
        Q >>= 1

    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = jnp.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        Qj = jnp.uint32(Q)
        t = jnp.where((X[2] & Qj) != 0, t ^ jnp.uint32(Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]

    # transpose -> single index: X[0] holds the most-significant bit of each
    # 3-bit level
    key = (_part1by2(X[0]) << 2) | (_part1by2(X[1]) << 1) | _part1by2(X[2])
    return key.astype(jnp.int32)  # < 2^30: sign-safe


def build_cluster_index(points: jnp.ndarray, group_size: int = 128) -> ClusterIndex:
    """Build the search structure for one (m, 3) cloud (jit/vmap-safe)."""
    pts = points[..., :3]
    m = pts.shape[0]
    g = int(group_size)
    G = -(-m // g)
    pad = G * g - m

    frame = _bbox_frame(pts)
    keys = hilbert_keys(pts, frame=frame)
    order = jnp.argsort(keys).astype(jnp.int32)
    sorted_pts = jnp.take(pts, order, axis=0)
    if pad:
        sorted_pts = jnp.concatenate(
            [sorted_pts, jnp.full((pad, 3), _SENTINEL, pts.dtype)], axis=0)
        order = jnp.concatenate([order, jnp.zeros((pad,), jnp.int32)], axis=0)
    grouped = sorted_pts.reshape(G, g, 3)

    valid = (jnp.arange(G * g).reshape(G, g) < m)                 # (G, g)
    nreal = jnp.sum(valid, axis=1).astype(pts.dtype)              # >= 1 always
    centers = jnp.sum(jnp.where(valid[..., None], grouped, 0.0), axis=1) / nreal[:, None]
    d = jnp.linalg.norm(grouped - centers[:, None, :], axis=-1)
    # ulp-inflate so f32 rounding can never shrink the covering ball
    eps8 = 8.0 * jnp.finfo(jnp.float32).eps
    radius = jnp.max(jnp.where(valid, d, 0.0), axis=1) * (1.0 + eps8)
    return ClusterIndex(points=grouped, centers=centers, radius=radius,
                        order=order, frame=frame)


def query_order(index: ClusterIndex, x: jnp.ndarray) -> jnp.ndarray:
    """Curve-sort permutation for a query cloud (int32 (n,)).

    The order is only a LOCALITY HINT (it controls how queries are grouped
    into selection blocks, never which answers are valid), so it can be
    computed once per registration and reused across Gauss-Newton
    iterations: rigid motion preserves neighborhood structure exactly, so
    the T_init-time order keeps blocks equally compact at every iterate."""
    return jnp.argsort(hilbert_keys(x, frame=index.frame)).astype(jnp.int32)


def _sorted_blocks(index: ClusterIndex, x: jnp.ndarray, order=None,
                   qblock: int = _QBLOCK):
    """Sort queries along the index's curve and cut into ``qblock`` blocks.

    Returns (xb (nb, Qb, 3), inv (n,) unsort permutation, n).  ``order``
    (optional) is a precomputed :func:`query_order` permutation."""
    n = x.shape[0]
    qord = query_order(index, x) if order is None else order
    xs = jnp.take(x, qord, axis=0)
    Qb = min(qblock, n)
    nb = -(-n // Qb)
    pad = nb * Qb - n
    if pad:
        xs = jnp.concatenate([xs, jnp.repeat(xs[-1:], pad, axis=0)])
    # invert the permutation by scatter (O(n)) — argsort would re-sort
    inv = jnp.zeros((n,), jnp.int32).at[qord].set(
        jnp.arange(n, dtype=jnp.int32))
    return xs.reshape(nb, Qb, 3), inv, n


def _block_select(index: ClusterIndex, xb: jnp.ndarray, probes: int):
    """Top-P groups per query BLOCK by the block-level lower bound.

    Sound covering: the block bound max(0, |o-c| - r_blk - r_grp)^2 lower-
    bounds every member query's own group bound, so ranking by it can only
    select a superset-quality probe set.  Returns bsel (nb, P) int32."""
    G = index.points.shape[0]
    P = min(int(probes), G)
    o = jnp.mean(xb, axis=1)                                   # (nb, 3)
    rb = jnp.max(jnp.linalg.norm(xb - o[:, None, :], axis=-1), axis=1)
    doc = jnp.linalg.norm(o[:, None, :] - index.centers[None].astype(o.dtype),
                          axis=-1)                             # (nb, G)
    # rank by the UNCLAMPED margin: when the block cover overlaps many group
    # balls (sparse queries -> large r_blk), the clamped bound ties at 0 and
    # top_k would pick arbitrary groups; the signed margin still orders
    # overlapping groups by depth of overlap
    lbb = doc - rb[:, None] - index.radius[None].astype(o.dtype)
    if P < G:
        _, bsel = lax.top_k(-lbb, P)                           # tiny: (nb, G)
    else:
        bsel = jnp.broadcast_to(jnp.arange(G, dtype=jnp.int32),
                                (xb.shape[0], G))
    return bsel.astype(jnp.int32), P


def _query_bounds(index: ClusterIndex, xb: jnp.ndarray, bsel: jnp.ndarray):
    """Per-query exactness bound: min group lower bound over NON-selected
    groups.  (nb, Qb, 3) x (nb, P) -> (nb, Qb).

    Conservative under f32 rounding: the diff-form |x-c| is computed to
    relative accuracy, deflated a few ulps; group radii are inflated at
    build time."""
    G = index.points.shape[0]
    dtype = xb.dtype
    c = index.centers.astype(dtype)
    dc = jnp.linalg.norm(xb[:, :, None, :] - c[None, None, :, :], axis=-1)
    eps8 = jnp.asarray(8.0 * jnp.finfo(jnp.float32).eps, dtype)
    lb = jnp.maximum(dc * (1.0 - eps8) - index.radius[None, None].astype(dtype),
                     0.0) ** 2                                  # (nb, Qb, G)
    mask = jnp.zeros((xb.shape[0], G), dtype).at[
        jnp.arange(xb.shape[0])[:, None], bsel].set(jnp.inf)
    return jnp.min(lb + mask[:, None, :], axis=-1)              # (nb, Qb)


def _candidate_d2(index: ClusterIndex, xb: jnp.ndarray, bsel: jnp.ndarray,
                  return_cand: bool = False):
    """Exact squared distances to the block's P*g candidates.

    Returns (d2 (nb, Qb, P*g), pos (nb, P*g) — sorted-cloud row of each
    candidate[, cand (nb, P*g, 3) when ``return_cand``])."""
    g = index.points.shape[1]
    nb, P = bsel.shape
    cand = index.points[bsel].astype(xb.dtype)                  # (nb, P, g, 3)
    cand = cand.reshape(nb, P * g, 3)
    d2 = jnp.sum((xb[:, :, None, :] - cand[:, None, :, :]) ** 2, axis=-1)
    pos = (bsel[:, :, None] * g
           + jnp.arange(g, dtype=jnp.int32)[None, None, :]).reshape(nb, P * g)
    if return_cand:
        return d2, pos, cand
    return d2, pos


def _candidate_argmin_scan(index: ClusterIndex, xb: jnp.ndarray,
                           bsel: jnp.ndarray):
    """Running (best d2, sorted-cloud row) over the P groups via lax.scan.

    Avoids materializing the (nb, Qb, P*g) candidate matrix (1.2 GB at
    100k): each scan step's diff->square->sum->min chain fuses into one
    streaming pass over a (nb, Qb, g) tile.  Same arithmetic and tie rule
    (strict '<' keeps the earlier group; argmin keeps the lowest offset)."""
    g = index.points.shape[1]
    nb, Qb, _ = xb.shape
    P = bsel.shape[1]
    offs = jnp.arange(g, dtype=jnp.int32)

    def step(carry, j):
        best, brow = carry
        grp = bsel[:, j]                                     # (nb,)
        cand = index.points[grp].astype(xb.dtype)            # (nb, g, 3)
        d2 = jnp.sum((xb[:, :, None, :] - cand[:, None, :, :]) ** 2, axis=-1)
        lmin, larg = min_and_lowest_id(d2, offs)             # (nb, Qb)
        row = grp[:, None] * g + larg
        better = lmin < best
        return (jnp.where(better, lmin, best),
                jnp.where(better, row, brow)), None

    # derive the init from xb so it inherits xb's varying-manual-axes type
    # under shard_map (a freshly created carry would mismatch the body's
    # device-varying outputs, cf. ring_nn's pcast)
    zero = (0.0 * xb[..., 0])
    init = (jnp.inf + zero, zero.astype(jnp.int32))
    (best, brow), _ = lax.scan(step, init, jnp.arange(P))
    return best, brow


def _unsort(arr, inv, n):
    flat = arr.reshape((-1,) + arr.shape[2:])[:n]
    return jnp.take(flat, inv, axis=0)


def _fixup_uncertified(index: ClusterIndex, x: jnp.ndarray, idx, d2, cert,
                       budget: int):
    """Brute-force up to ``budget`` uncertified queries against the full
    cloud, making them provably exact (the in-solver escalation the offline
    ``cluster_nn_verified`` loop cannot express under jit: fixed shapes).

    O(n) compaction (no sort): uncertified queries are scattered into a
    fixed-size slot vector by their running count.  If MORE than ``budget``
    queries are uncertified, the excess keeps ``certified=False`` — the
    certificate still never lies.  The uncertified share is typically well
    under 1% of queries, far under the default budget."""
    n = x.shape[0]
    U = min(int(budget), n)
    unc = jnp.logical_not(cert)
    slot = jnp.cumsum(unc.astype(jnp.int32)) - 1               # (n,)
    # certified queries (and overflow beyond U) are dropped by the scatter
    sel = jnp.zeros((U,), jnp.int32).at[
        jnp.where(unc, slot, U)].set(jnp.arange(n, dtype=jnp.int32),
                                     mode="drop")
    xs = jnp.take(x, sel, axis=0)
    # stream over the sorted cloud but tie-break by ORIGINAL row (ids =
    # index.order), matching the exact brute-force rule on duplicate points
    bf_idx, bf_d2 = nn_argmin_stream(xs, index.points.reshape(-1, 3),
                                     ids=index.order)
    take = jnp.take(unc, sel)           # unwritten slots point at query 0:
    new_idx = idx.at[sel].set(jnp.where(take, bf_idx, jnp.take(idx, sel)))
    new_d2 = d2.at[sel].set(jnp.where(take, bf_d2.astype(d2.dtype),
                                      jnp.take(d2, sel)))
    new_cert = cert.at[sel].set(True)   # brute force is exact by definition
    return new_idx, new_d2, new_cert


@functools.partial(jax.jit, static_argnames=("probes", "fixup"))
def cluster_nn(index: ClusterIndex, x: jnp.ndarray, probes: int = 16,
               order: Optional[jnp.ndarray] = None,
               fixup: int = 0,
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact-certified 1-NN: (n, 3) queries -> (idx (n,), d2 (n,), certified (n,)).

    ``idx`` indexes the ORIGINAL target rows.  ``certified[i]`` is True when
    the result is provably the global argmin (see module docstring).
    ``order``: precomputed :func:`query_order` permutation (a locality hint
    the solver reuses across GN iterations — rigid motion preserves it).
    ``fixup`` > 0: brute-force up to that many uncertified queries against
    the full cloud (in-solver exactness escalation; see
    :func:`_fixup_uncertified`) — with a budget covering the uncertified
    count, every returned neighbor is provably exact.
    """
    xb, inv, n = _sorted_blocks(index, x[..., :3], order)
    bsel, P = _block_select(index, xb, probes)
    # scan over groups with a running argmin: each step's distance+reduce
    # chain fuses into one streaming pass, with no (nb, Qb, P*g) matrix
    best, rows = _candidate_argmin_scan(index, xb, bsel)
    bound = _query_bounds(index, xb, bsel)
    idx = index.order[rows]
    idx, best, cert = (_unsort(idx, inv, n), _unsort(best, inv, n),
                       _unsort(best <= bound, inv, n))
    if fixup > 0:
        idx, best, cert = _fixup_uncertified(index, x[..., :3], idx, best,
                                             cert, fixup)
    return idx, best, cert


def _topk_small(d2: jnp.ndarray, k: int):
    """Ascending top-k by iterative argmin extraction.

    k unrolled (min, lowest index)/mask passes over the candidate matrix;
    faster than ``lax.top_k`` at k=16 on a (100k, 2048) matrix on the H100
    (benchmarks/bench_kernels.py, PERF.md).  Stable (lowest index on ties),
    exact."""
    vals, idxs = [], []
    cur = d2
    col = jnp.arange(d2.shape[-1], dtype=jnp.int32)
    big = jnp.asarray(jnp.inf, d2.dtype)
    for _ in range(k):
        m, j = min_and_lowest_id(cur, col)
        vals.append(m)
        idxs.append(j)
        cur = jnp.where(col == j[..., None], big, cur)
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "probes"))
def cluster_knn(index: ClusterIndex, x: jnp.ndarray, k: int, probes: int = 16,
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact-certified k-NN: -> (idx (n, k), d2 (n, k), certified (n,)).

    Neighbors are sorted by ascending distance.  ``certified`` requires the
    k-th distance to beat the best non-selected group's lower bound."""
    xb, inv, n = _sorted_blocks(index, x[..., :3])
    bsel, P = _block_select(index, xb, probes)
    d2, pos = _candidate_d2(index, xb, bsel)
    if k <= 32:
        d2k, j = _topk_small(d2, k)                             # (nb, Qb, k)
    else:
        neg, j = lax.top_k(-d2, k)
        d2k = -neg
    rows = jnp.take_along_axis(
        jnp.broadcast_to(pos[:, None, :], d2.shape), j, axis=-1)
    idx = index.order[rows]
    bound = _query_bounds(index, xb, bsel)
    return (_unsort(idx, inv, n), _unsort(d2k, inv, n),
            _unsort(d2k[..., -1] <= bound, inv, n))


def cluster_nn_verified(points_target: jnp.ndarray, x: jnp.ndarray,
                        group_size: int = 128, probes: int = 16,
                        max_probes: int = 256) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-driven fully exact 1-NN: doubles ``probes`` until every query is
    certified (each retry is a fresh jit specialization; intended for offline
    use and tests — the in-solver path uses fixed ``probes``)."""
    index = build_cluster_index(points_target, group_size)
    p = probes
    idx, d2, cert = cluster_nn(index, x, probes=p)
    while not bool(jnp.all(cert)) and p < max_probes:
        p *= 2
        idx, d2, cert = cluster_nn(index, x, probes=p)
    if not bool(jnp.all(cert)):
        raise RuntimeError(
            f"cluster_nn not certified at probes={p}; pathological geometry "
            "(use the brute-force kernel)")
    return idx, d2
