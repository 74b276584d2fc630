"""Tiled brute-force 1-NN kernel, Pallas through Triton (GPU).

The reference's hot spot is the brute-force O(n*m) distance/argmin
(torch.cdist + argmin at dICP/nn.py:32-38, SURVEY.md §3.2).  This kernel
never writes the (n, m) distance matrix: each program owns a block of
``bq`` queries and walks the target cloud tile by tile in a
``lax.fori_loop``, carrying a running (min d2, first argmin) per
(query, tile column) slot in registers; the slots are reduced once, after
the loop.

  grid      = (n_pad / bq,)                 one program per query block
  queries   = three (bq,) coordinate vectors, loaded once per program
  targets   = (3, m_pad) layout: each (bt,) tile is three coalesced loads
  d2 tile   = (bq, bt), exact difference form sum_c (x_c - y_c)^2 — no
              |x|^2 + |y|^2 - 2 x.y cancellation, and no matmul, so TF32
              never touches it

Padding: query rows are padded to ``bq`` (results sliced off); target rows
are padded with +1e30 so their d2 overflows to +inf and never wins —
replacing the reference's max(source)*1000 sentinel trick
(dICP/ICP.py:460).

Ties resolve to the lowest index, matching jnp.argmin/torch.argmin: each
slot's strict '<' keeps its earliest tile, and the final masked min over
slots picks the lowest index among the tied slots.

There is no automatic interpreter: ``interpret=True`` runs the kernel on
the CPU for tests and must be asked for.  Which platform runs this kernel
at all is decided in :mod:`dicp_tpu.backend`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Query block and target tile; both powers of two (Triton's block rule).
# Chosen by the H100 tile sweep in benchmarks/bench_kernels.py (PERF.md).
_BQ = 32
_BT = 128
_NUM_WARPS = 4
_NUM_STAGES = 2
_PAD_VAL = 1e30
_NO_COL = 2 ** 30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nn_kernel(x0_ref, x1_ref, x2_ref, y0_ref, y1_ref, y2_ref,
               idx_ref, d2_ref, *, bt: int, n_tiles: int):
    x0, x1, x2 = x0_ref[...], x1_ref[...], x2_ref[...]        # (bq,)
    col = jnp.arange(bt, dtype=jnp.int32)

    def body(t, carry):
        # elementwise running min per (query, column) slot: no cross-lane
        # reduction inside the loop; strict '<' keeps each slot's earliest
        # tile, i.e. its lowest target index
        best, bidx = carry                                    # (bq, bt)
        start = pl.multiple_of(t * bt, bt)
        sl = pl.ds(start, bt)
        d0 = x0[:, None] - y0_ref[sl][None, :]
        d1 = x1[:, None] - y1_ref[sl][None, :]
        d2_ = x2[:, None] - y2_ref[sl][None, :]
        d = d0 * d0 + d1 * d1 + d2_ * d2_
        better = d < best
        return (jnp.where(better, d, best),
                jnp.where(better, (col + start)[None, :], bidx))

    shape = (x0.shape[0], bt)
    best, bidx = lax.fori_loop(
        0, n_tiles, body,
        (jnp.full(shape, jnp.inf, jnp.float32), jnp.zeros(shape, jnp.int32)))
    # one reduction over the slots: the min, then the lowest index among
    # the slots that hold it (same registers, so the equality is exact)
    lmin = jnp.min(best, axis=1)
    idx_ref[...] = jnp.min(jnp.where(best == lmin[:, None], bidx,
                                     jnp.int32(_NO_COL)), axis=1)
    d2_ref[...] = lmin


@functools.partial(jax.jit, static_argnames=("bq", "bt", "num_warps",
                                             "num_stages", "interpret"))
def _nn_pallas_2d(x, y, bq: int, bt: int, num_warps: int, num_stages: int,
                  interpret: bool):
    """(n, 3) x (m, 3) -> (idx (n,), d2 (n,)) via the tiled kernel."""
    n, m = x.shape[0], y.shape[0]
    n_pad = _cdiv(n, bq) * bq
    m_pad = _cdiv(m, bt) * bt
    xt = jnp.pad(x.astype(jnp.float32), ((0, n_pad - n), (0, 0))).T
    yt = jnp.pad(y.astype(jnp.float32), ((0, m_pad - m), (0, 0)),
                 constant_values=_PAD_VAL).T                    # (3, m_pad)

    q_spec = pl.BlockSpec((bq,), lambda i: (i,))
    t_spec = pl.BlockSpec((m_pad,), lambda i: (0,))
    kernel = functools.partial(_nn_kernel, bt=bt, n_tiles=m_pad // bt)
    idx, d2 = pl.pallas_call(
        kernel,
        grid=(n_pad // bq,),
        in_specs=[q_spec] * 3 + [t_spec] * 3,
        out_specs=[q_spec, q_spec],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        cost_estimate=pl.CostEstimate(
            flops=8 * n_pad * m_pad,
            bytes_accessed=(3 * n_pad + 3 * m_pad * (n_pad // bq)
                            + 2 * n_pad) * 4,
            transcendentals=0),
        interpret=interpret,
        name="nn_bruteforce",
    )(xt[0], xt[1], xt[2], yt[0], yt[1], yt[2])
    return idx[:n], d2[:n]


def nn_distances_pallas(x: jnp.ndarray, y: jnp.ndarray,
                        bq: int = _BQ, bt: int = _BT,
                        num_warps: int = _NUM_WARPS,
                        num_stages: int = _NUM_STAGES,
                        interpret: bool = False):
    """(indices, squared distances) of the 1-NN of each query.

    x (..., n, 3) queries, y (..., m, 3) targets -> ((..., n) int32,
    (..., n) f32).  Batch dims are vmapped over the 2-D kernel (each batch
    element becomes one more grid axis).  ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests); it is never chosen
    automatically.
    """
    fn = functools.partial(_nn_pallas_2d, bq=bq, bt=bt, num_warps=num_warps,
                           num_stages=num_stages, interpret=interpret)
    for _ in x.shape[:-2]:
        fn = jax.vmap(fn)
    return fn(x[..., :3], y[..., :3])


def nn_indices_pallas(x: jnp.ndarray, y: jnp.ndarray, **kw) -> jnp.ndarray:
    """1-NN indices via :func:`nn_distances_pallas` (same keywords)."""
    return nn_distances_pallas(x, y, **kw)[0]
