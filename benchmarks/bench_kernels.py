"""Kernel-against-XLA timings on the GPU, the numbers behind PERF.md.

Times each hand-written kernel beside the plain XLA version it replaces,
at the sizes the ISSUE/PERF records name, with ``block_until_ready``
around every call (median of ``--reps`` calls after a warm-up call):

* brute-force 1-NN: the Pallas-Triton kernel (ops/pallas_knn) vs XLA's
  streaming difference-form argmin (knn.nn_argmin_stream) at
  n = m = 16,383, at 100k x 100k, and vmapped at B = 8 x 8k; a tile sweep
  of the kernel at 16,383 first;
* the same two inside a mid-size ``register`` (8k x 8k pt2pl), end to end,
  beside the cluster and dense routes;
* k-NN extraction for normals (cluster_knn, 100k, k=16): the unrolled
  ``_topk_small`` vs ``lax.top_k`` on the same candidate matrix.

Every kernel result is checked against the XLA one before it is timed.
Run on the card: ``python benchmarks/bench_kernels.py``.  Prints one JSON
line per row; the card's name and power limit go first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(**row):
    print(json.dumps(row), flush=True)


def _time(fn, reps):
    from dicp_tpu.utils.profiling import benchmark

    st = benchmark(fn, n=reps, warmup=1)
    return st["median_s"] * 1e3, st["compile_s"]


def _check_nn(idx, d2, ref_idx, ref_d2, x, y):
    """Indices equal except at exact ties; d2 to 1e-5 relative."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    d2, ref_d2 = np.asarray(d2, np.float64), np.asarray(ref_d2, np.float64)
    rel = float(np.max(np.abs(d2 - ref_d2) / np.maximum(ref_d2, 1e-30)))
    diff = np.flatnonzero(idx != ref_idx)
    ties_ok = True
    if diff.size:
        xd = np.asarray(x, np.float64)[diff]
        y64 = np.asarray(y, np.float64)
        da = np.sum((xd - y64[idx[diff]]) ** 2, -1)
        db = np.sum((xd - y64[ref_idx[diff]]) ** 2, -1)
        ties_ok = bool(np.all(np.abs(da - db) <= 1e-6 * np.maximum(db, 1e-30)))
    return {"max_rel_d2": rel, "idx_mismatch": int(diff.size),
            "mismatch_all_ties": ties_ok,
            "ok": bool(rel <= 1e-5 and ties_ok)}


def bench_bruteforce(reps):
    import jax
    import jax.numpy as jnp

    from dicp_tpu.knn import nn_argmin_stream
    from dicp_tpu.ops.pallas_knn import nn_distances_pallas

    rng = np.random.default_rng(0)

    def cloud(*shape):
        return jnp.asarray(rng.uniform(-50, 50, shape).astype(np.float32))

    xla = jax.jit(lambda a, b: nn_argmin_stream(a, b))
    n = 16_383
    x, y = cloud(n, 3), cloud(n, 3)
    ref = xla(x, y)
    best = None
    for bq, bt, warps, stages in ((32, 64, 4, 2), (64, 64, 4, 2),
                                  (64, 32, 4, 2), (32, 128, 4, 2),
                                  (64, 128, 4, 2), (128, 64, 8, 2),
                                  (64, 64, 2, 2), (64, 64, 4, 1),
                                  (16, 128, 4, 2), (32, 32, 2, 2)):
        f = jax.jit(lambda a, b, _k=(bq, bt, warps, stages): nn_distances_pallas(
            a, b, bq=_k[0], bt=_k[1], num_warps=_k[2], num_stages=_k[3]))
        idx, d2 = f(x, y)
        chk = _check_nn(idx, d2, ref[0], ref[1], x, y)
        ms, _ = _time(lambda: f(x, y), reps)
        _emit(row="triton_sweep", n=n, bq=bq, bt=bt, num_warps=warps,
              num_stages=stages, ms=ms, **chk)
        if chk["ok"] and (best is None or ms < best[0]):
            best = (ms, bq, bt, warps, stages)
    _, bq, bt, warps, stages = best
    tri = jax.jit(lambda a, b: nn_distances_pallas(
        a, b, bq=bq, bt=bt, num_warps=warps, num_stages=stages))

    for n, m in ((16_383, 16_383), (100_000, 100_000)):
        x, y = cloud(n, 3), cloud(m, 3)
        r = xla(x, y)
        k = tri(x, y)
        chk = _check_nn(k[0], k[1], r[0], r[1], x, y)
        ms_k, _ = _time(lambda: tri(x, y), reps)
        ms_x, _ = _time(lambda: xla(x, y), reps)
        for chunk in (1024, 16384):
            xc = jax.jit(lambda a, b, _c=chunk: nn_argmin_stream(a, b, chunk=_c))
            ms_c, _ = _time(lambda: xc(x, y), reps)
            _emit(row="xla_stream_chunk", n=n, m=m, chunk=chunk, ms=ms_c)
        _emit(row="bruteforce", n=n, m=m, triton_ms=ms_k, xla_stream_ms=ms_x,
              tile=[bq, bt, warps, stages], **chk)

    B, n = 8, 8192
    x, y = cloud(B, n, 3), cloud(B, n, 3)
    xla_b = jax.jit(jax.vmap(lambda a, b: nn_argmin_stream(a, b)))
    r = xla_b(x, y)
    k = tri(x, y)
    kd, rd = np.asarray(k[1], np.float64), np.asarray(r[1], np.float64)
    chk = {"idx_equal_frac": float(np.mean(np.asarray(k[0]) == np.asarray(r[0]))),
           "max_rel_d2": float(np.max(np.abs(kd - rd) / np.maximum(rd, 1e-30)))}
    ms_k, _ = _time(lambda: tri(x, y), reps)
    ms_x, _ = _time(lambda: xla_b(x, y), reps)
    _emit(row="bruteforce_vmap", B=B, n=n, m=n, triton_ms=ms_k,
          xla_stream_ms=ms_x, **chk)
    return best


def bench_register_mid(reps):
    """End to end: a mid-size pt2pl register through each route."""
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_suite import _make_scene
    from dicp_tpu import backend, se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register

    n = 8192
    target = _make_scene(n)
    xi = np.array([0.05, -0.04, 0.03, 0.01, -0.02, 0.02], np.float64)
    T = np.asarray(se3.vec2tran(jnp.asarray(xi.astype(np.float32))), np.float64)
    src = (target[:, :3].astype(np.float64) @ T[:3, :3].T + T[:3, 3])
    S = jnp.asarray(src.astype(np.float32))[None]
    Tg = jnp.asarray(target)[None]
    Ti = jnp.eye(4, dtype=jnp.float32)[None]
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                     tolerance=1e-6, dim=3, trim_dist=2.0, loss_name="huber",
                     loss_metric=1.0, collect_histories=False)
    T_true = np.linalg.inv(T)
    saved = backend._TRITON_PLATFORMS
    for tag, method, triton in (("triton", "pallas", True),
                                ("xla_stream", "pallas", False),
                                ("cluster", "cluster", True),
                                ("dense", "dense", True)):
        backend._TRITON_PLATFORMS = saved if triton else ()
        cfg = base.with_(nn_method=method)
        f = jax.jit(lambda s, t, ti, _c=cfg: register(s, t, ti, None, _c))
        res = f(S, Tg, Ti)
        err = float(np.linalg.norm(np.asarray(se3.tran2vec(jnp.asarray(
            (T_true @ np.linalg.inv(np.asarray(res.T[0], np.float64)))
            .astype(np.float32))))))
        ms, comp = _time(lambda: f(S, Tg, Ti), reps)
        _emit(row="register_mid", n=n, m=n, route=tag, ms=ms, compile_s=comp,
              iterations=float(res.iterations[0]), transform_err=err)
    backend._TRITON_PLATFORMS = saved


def bench_topk(reps):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from benchmarks.bench_suite import _make_scene
    from dicp_tpu.ops.cluster_knn import (_block_select, _candidate_d2,
                                          _sorted_blocks, _topk_small,
                                          build_cluster_index)

    pts = jnp.asarray(_make_scene(100_000)[:, :3])
    index = jax.jit(lambda p: build_cluster_index(p, 128))(pts)
    k, probes = 16, 16

    def make(kind):
        @jax.jit
        def f(ix, q):
            xb, _, _ = _sorted_blocks(ix, q)
            bsel, _ = _block_select(ix, xb, probes)
            d2, _ = _candidate_d2(ix, xb, bsel)
            if kind == "small":
                return _topk_small(d2, k)
            neg, j = lax.top_k(-d2, k)
            return -neg, j
        return f

    out = {}
    for kind in ("small", "lax_top_k"):
        f = make(kind)
        out[kind] = f(index, pts)
        ms, _ = _time(lambda: f(index, pts), reps)
        _emit(row="knn16_extract", n=100_000, k=k, probes=probes, impl=kind,
              ms=ms)
    same = bool(np.array_equal(np.asarray(out["small"][0]),
                               np.asarray(out["lax_top_k"][0])))
    _emit(row="knn16_extract_agree", d2_equal=same)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", default="bruteforce,register,topk")
    args = ap.parse_args()

    from dicp_tpu import backend
    from dicp_tpu.utils.device import (device_summary, enable_compile_cache,
                                       gpu_name_and_power)

    if backend.platform() != "gpu":
        raise SystemExit("bench_kernels.py measures the GPU; none found")
    enable_compile_cache()
    _emit(row="device", nvidia_smi=gpu_name_and_power(), **device_summary())
    parts = args.only.split(",")
    if "bruteforce" in parts:
        bench_bruteforce(args.reps)
    if "register" in parts:
        bench_register_mid(args.reps)
    if "topk" in parts:
        bench_topk(args.reps)


if __name__ == "__main__":
    main()
