"""Smoke test of dicp_tpu's main path on the GPU, at deployment sizes.

    python3 chip_smoke.py           # one GPU: phases 0-6
    python3 chip_smoke.py --four    # four GPUs: the sharded phases only

Each phase runs the public entry points, compares the card's answer with a
stated reference and tolerance, and prints one ``PHASE`` line; any failure
raises and the script exits non-zero.  Scenes come from fixed seeds
(benchmarks/bench_suite.py's scene and wavy sequence, an analytic wavy
world for SLAM); nothing is downloaded.  One process drives every card.

Phases (one card):
  0 environment: the card's ``name, power.limit``, JAX version, native loader
  1 training batch: B=256 pt2pl dim=2 huber/trim, value_and_grad through
    register_ift; transforms vs an f64 CPU solve, IFT-vs-unrolled cosine,
    the pair's pose vs truth
  2 100k x 100k full-resolution register (auto route: cluster); certified
    correspondences vs a plain chunked argmin on the card, pose error vs
    truth
  3 brute-force 1-NN (the platform's kernel: Pallas-Triton on the GPU) vs a
    plain query-chunked argmin at n = m = 16,383 and 100k
  4 estimate_normals at 100k (cluster k=16); certified k-NN sets vs dense
    top-k on a subsample
  5 streaming: stream_odometry (raw 60k scans, >= 3 windows),
    scan_to_map_odometry (60k scans, 65,536-voxel map), slam_odometry (60k
    scans, 65,536-voxel map, two laps, >= 1 closure, refinement no worse
    than the front end); each ATE bounded by the CPU run of the same seed
  6 the other solvers at their own exactness bars: symmetric pt2pl, the
    streaming Gumbel soft-NN vs hard NN, GICP and its IFT gradient vs
    unrolled, multiscale vs single-scale at 20k, SGD-ICP at 20k
Phases (``--four``), each against the same computation on one card:
  register_batch_sharded (B=256, mesh (4,1)); pose_graph_optimize_partitioned
  vs the dense back-end; register_map_sharded, register_ring_sharded and
  register_map_sharded_ift gradients on the 100k pair (mesh (1,4)), all
  with the default configuration.

The last line is ``{"ok": true, "device": {...}}`` with the device as JAX
reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Deployment sizes (see PERF.md, "Cells").
SIZES = dict(batch=256, big=100_000, bf=(16_383, 100_000), normals=100_000,
             normals_sample=2048, scan=60_000, stream_window=4,
             stream_windows=3, s2m_scans=10, map_capacity=65_536,
             solver_points=20_000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    return ap.parse_args(argv)


def final_line(device: dict) -> str:
    """The result line: ``{"ok": true, "device": {platform, kind, count}}``."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def check_nn(idx, d2, ref_idx, ref_d2, x, y, rtol=1e-5) -> dict:
    """Compare a 1-NN answer with a reference: indices equal except at
    exact ties (both picks equidistant in f64), d2 within ``rtol``."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    d2 = np.asarray(d2, np.float64)
    ref_d2 = np.asarray(ref_d2, np.float64)
    rel = float(np.max(np.abs(d2 - ref_d2) / np.maximum(ref_d2, 1e-30),
                       initial=0.0))
    diff = np.flatnonzero(idx != ref_idx)
    ties = True
    if diff.size:
        xd = np.asarray(x, np.float64)[diff]
        y64 = np.asarray(y, np.float64)
        da = np.sum((xd - y64[idx[diff]]) ** 2, -1)
        db = np.sum((xd - y64[ref_idx[diff]]) ** 2, -1)
        ties = bool(np.all(np.abs(da - db) <= 1e-6 * np.maximum(db, 1e-30)))
    return {"ok": bool(rel <= rtol and ties), "max_rel_d2": rel,
            "idx_mismatch": int(diff.size), "mismatches_are_ties": ties}


def _report(phase, name, ok, **vals):
    body = " ".join(f"{k}={v}" for k, v in vals.items())
    print(f"PHASE {phase} {name}: {body} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"phase {phase} {name} failed: {body}")


def _pose_err(T_true, T):
    """Norm of the se(3) log of T_true^-1 T (f64, host)."""
    import jax.numpy as jnp

    from dicp_tpu import se3

    E = np.linalg.inv(np.asarray(T_true, np.float64)) @ np.asarray(T, np.float64)
    return float(np.linalg.norm(np.asarray(se3.tran2vec(jnp.asarray(E)))))


def _exact_pair(cloud, xi):
    """Source = cloud moved by vec2tran(xi), built on the host in f64 (a
    card matmul at reduced precision would corrupt the ground truth);
    returns (source (n, 3) f32, T_true) with T_true aligning source to
    cloud."""
    import jax.numpy as jnp

    from dicp_tpu import se3

    T = np.asarray(se3.vec2tran(jnp.asarray(np.asarray(xi, np.float64))),
                   np.float64)
    src = np.asarray(cloud, np.float64)[:, :3] @ T[:3, :3].T + T[:3, 3]
    return src.astype(np.float32), np.linalg.inv(T)


def _scene_pair(n, xi):
    """(target (n, 6) f32 with exact normals, source (n, 3) f32, T_true)."""
    from benchmarks.bench_suite import _make_scene

    target = _make_scene(n)
    return (target,) + _exact_pair(target, xi)


def _plain_nn(x, y, chunk=2048):
    """Plain reference 1-NN: query chunks, full difference-form distance
    rows, jnp.argmin (lowest index on ties)."""
    import jax
    import jax.numpy as jnp

    n = x.shape[0]
    pad = (-n) % chunk
    xp = jnp.concatenate([x, jnp.zeros((pad, 3), x.dtype)]).reshape(-1, chunk, 3)

    @jax.jit
    def rows(q):
        d2 = jnp.sum((q[:, None, :] - y[None, :, :]) ** 2, axis=-1)
        return jnp.argmin(d2, axis=1).astype(jnp.int32), jnp.min(d2, axis=1)

    idx, d2 = jax.lax.map(rows, xp)
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]


# ---------------------------------------------------------------- phases


def phase_env():
    import jax

    from dicp_tpu.io import native
    from dicp_tpu.utils.device import gpu_name_and_power

    print(gpu_name_and_power(), flush=True)
    _report(0, "environment", True, jax=jax.__version__,
            native_loader="built" if native.native_available() else "numpy",
            compile_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(HERE, ".jax_cache"))


def _batch_inputs(B, dtype):
    base = os.path.join(HERE, "tests", "data")
    scan = np.load(os.path.join(base, "points_scan.npy")).astype(dtype)
    mp = np.load(os.path.join(base, "points_map.npy")).astype(dtype)
    return (np.repeat(scan[None, :, :3], B, 0), np.repeat(mp[None], B, 0),
            np.repeat(np.eye(4, dtype=dtype)[None], B, 0))


def phase_training(sizes, cpu):
    import jax
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.registration import register

    B = sizes["batch"]
    cfg = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber",
                    loss_metric=1.0)
    src, tgt, ti = (jnp.asarray(a) for a in _batch_inputs(B, np.float32))

    step = jax.jit(jax.value_and_grad(
        lambda s, t, i: jnp.sum(register_ift(s, t, i, None, cfg).T)))
    fwd = jax.jit(lambda s, t, i: register_ift(s, t, i, None, cfg).T)
    unrolled = jax.jit(jax.grad(
        lambda s, t, i: jnp.sum(register(s, t, i, None, cfg).T)))
    val, g_ift = step(src, tgt, ti)
    T = np.asarray(fwd(src, tgt, ti))
    g_unr = np.asarray(unrolled(src, tgt, ti))
    g_ift = np.asarray(g_ift)

    with jax.default_device(cpu):
        s64, t64, i64 = (jnp.asarray(a) for a in _batch_inputs(B, np.float64))
        T64 = np.asarray(jax.jit(
            lambda s, t, i: register_ift(s, t, i, None, cfg).T)(s64, t64, i64))
    err = float(np.max(np.abs(T - T64)))
    cos = float(np.sum(g_ift * g_unr)
                / (np.linalg.norm(g_ift) * np.linalg.norm(g_unr)))
    finite = bool(np.all(np.isfinite(g_ift)) and np.any(g_ift != 0))

    # the pair is an exact transform: the plain (non-smooth) solve must
    # land on it to f32 resolution and report convergence
    res = jax.jit(lambda s, t, i: register(
        s, t, i, None, cfg.with_(differentiable=False, driver="while")))(
        src[:1], tgt[:1], ti[:1])
    T_true = se3.tran_inv(se3.vec2tran(
        jnp.array([1., 1., 0, 0, 0, .1], jnp.float32)))
    err_true = _pose_err(T_true, res.T[0])
    conv = bool(res.converged[0])

    times = []
    for k in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(step(src + np.float32(1e-7 * (k + 1)), tgt, ti))
        times.append(time.perf_counter() - t0)
    _report(1, "training_batch", err <= 1e-4 and cos > 0.999 and finite
            and err_true < 1e-5 and conv,
            B=B, max_abs_T_vs_f64_cpu=err, tol_T=1e-4, grad_cosine=cos,
            tol_cos=0.999, grads_finite_nonzero=finite,
            pose_err_vs_truth=err_true, tol_truth=1e-5, converged=conv,
            ms_per_step_median=1e3 * float(np.median(times)))


def phase_big_register(sizes):
    import jax
    import jax.numpy as jnp

    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_nn
    from dicp_tpu.registration import register

    n = sizes["big"]
    target, src, T_true = _scene_pair(
        n, [0.2, -0.1, 0.05, 0.01, -0.02, 0.03])
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0, loss_name="huber",
                    loss_metric=1.0, collect_histories=False)
    route = cfg.resolved_nn_method(n, n)
    S, Tg = jnp.asarray(src), jnp.asarray(target)
    res = jax.jit(lambda s, t: register(
        s[None], t[None], jnp.eye(4, dtype=jnp.float32)[None], None, cfg))(S, Tg)
    err = _pose_err(T_true, res.T[0])

    # correspondences at T_init (identity): certified cluster answers must
    # be the answers of the plain query-chunked argmin, both on the card
    index = jax.jit(lambda t: build_cluster_index(t, cfg.cluster_group))(Tg[:, :3])
    idx, d2, cert = cluster_nn(index, S, probes=cfg.cluster_probes)
    bidx, bd2 = _plain_nn(S, Tg[:, :3])
    cert = np.asarray(cert)
    chk = check_nn(np.asarray(idx)[cert], np.asarray(d2)[cert],
                   np.asarray(bidx)[cert], np.asarray(bd2)[cert],
                   src[cert], target[:, :3])
    _report(2, "register_100k", route == "cluster" and err < 1e-3 and chk["ok"],
            n=n, route=route, pose_err=err, tol_pose=1e-3,
            iterations=float(res.iterations[0]),
            certified_frac=float(cert.mean()),
            certified_vs_plain_argmin=chk)


def phase_bruteforce(sizes):
    import jax
    import jax.numpy as jnp

    from dicp_tpu import backend, knn

    kernel = backend.bruteforce_kernel()
    rng = np.random.default_rng(0)
    for n in sizes["bf"]:
        x = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        y = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        X, Y = jnp.asarray(x), jnp.asarray(y)
        idx, d2 = jax.jit(knn.nn_bruteforce)(X, Y)
        ridx, rd2 = _plain_nn(X, Y)
        chk = check_nn(idx, d2, ridx, rd2, x, y, rtol=1e-5)
        ok = chk.pop("ok") and (kernel == "triton"
                                or backend.platform() != "gpu")
        _report(3, "bruteforce_1nn", ok, n=n, m=n, kernel=kernel,
                tol_rel_d2=1e-5, **chk)


def phase_normals(sizes):
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_suite import _make_scene
    from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_knn
    from dicp_tpu.ops.normals import estimate_normals

    n, k, probes = sizes["normals"], 16, 16
    scene = _make_scene(n)
    P = jnp.asarray(scene[:, :3])
    nrm = np.asarray(jax.jit(lambda p: estimate_normals(
        p, k=k, method="cluster"))(P))
    dots = np.abs(np.sum(nrm * scene[:, 3:6], axis=-1))
    index = jax.jit(lambda p: build_cluster_index(p, 128))(P)
    idx, d2, cert = cluster_knn(index, P, k=k, probes=probes)

    sel = np.random.default_rng(1).choice(n, sizes["normals_sample"],
                                          replace=False)
    Q = P[sel]
    # dense reference: the k+1 smallest, so a tie at the k-th is visible
    ref_d2, ref_idx = jax.jit(lambda q, p: jax.lax.top_k(
        -jnp.sum((q[:, None, :] - p[None, :, :]) ** 2, -1), k + 1))(Q, P)
    c = np.asarray(cert)[sel]
    ref_d2 = -np.asarray(ref_d2, np.float64)[c]
    ref_idx = np.asarray(ref_idx)[c]
    got_idx = np.asarray(idx)[sel][c]
    got_d2 = np.asarray(d2, np.float64)[sel][c]
    same_set = np.array([set(a) == set(b)
                         for a, b in zip(got_idx, ref_idx[:, :k])])
    # a differing set is allowed only where the k-th and (k+1)-th tie
    tie = np.isclose(ref_d2[:, k - 1], ref_d2[:, k], rtol=1e-6)
    sets_ok = bool(np.all(same_set | tie))
    d2_ok = bool(np.allclose(got_d2, ref_d2[:, :k], rtol=1e-5, atol=1e-7))
    _report(4, "normals_100k", sets_ok and d2_ok and c.mean() > 0.5
            and float(np.median(dots)) > 0.999,
            n=n, k=k, certified_frac_sample=float(c.mean()),
            sets_equal=int(same_set.sum()), checked=int(c.sum()),
            tol_rel_d2=1e-5, median_abs_dot_vs_truth=float(np.median(dots)))


def _slam_sequence(n, seed=5):
    """Two laps of a 5 m circle over an analytic wavy surface: each scan
    samples n fresh points within 6 m of its pose, with 3 cm noise, in its
    sensor frame (host f64).  Returns the scans and the true poses."""
    rng = np.random.default_rng(seed)
    R, per_lap, laps, reach = 5.0, 16, 2, 6.0
    scans, poses = [], []
    for k in range(laps * per_lap + 1):
        th = 2 * np.pi * k / per_lap
        t = np.array([R * np.cos(th), R * np.sin(th), 0.0])
        c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
        Rm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Rm, t
        rad = reach * np.sqrt(rng.uniform(0, 1, n))
        ang = rng.uniform(0, 2 * np.pi, n)
        w = np.empty((n, 3))
        w[:, 0] = t[0] + rad * np.cos(ang)
        w[:, 1] = t[1] + rad * np.sin(ang)
        w[:, 2] = np.sin(w[:, 0] * 0.6) * np.cos(w[:, 1] * 0.5) * 1.5
        scans.append(((w - t) @ Rm
                      + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32))
        poses.append(T)
    P = np.stack(poses)
    return scans, np.einsum("ij,kjl->kil", np.linalg.inv(P[0]), P)


def _ate_bound(gpu, cpu):
    """The card's ATE may exceed the CPU's by rounding, not by more."""
    return gpu <= 2.0 * cpu + 1e-6


def phase_streaming(sizes, cpu):
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_suite import _wavy_sequence
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.mapping import scan_to_map_odometry
    from dicp_tpu.odometry import ate
    from dicp_tpu.pipeline import stream_odometry

    W = sizes["stream_window"]
    S = 1 + W * sizes["stream_windows"]
    scans, poses, _ = _wavy_sequence(S, sizes["scan"],
                                     (0.04, 0.02, 0.01, 0.004, 0.002, 0.01))
    cfg = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=1.0, loss_name="huber",
                    loss_metric=0.5, collect_histories=False)

    def run_stream():
        res = stream_odometry(((s, None) for s in scans), cfg, window=W)
        return float(ate(res.poses, jnp.asarray(poses), align=False))

    a_gpu = run_stream()
    with jax.default_device(cpu):
        a_cpu = run_stream()
    _report(5, "stream_odometry", _ate_bound(a_gpu, a_cpu), scans=S,
            points=sizes["scan"], window=W, ate_gpu=a_gpu, ate_cpu=a_cpu,
            bound="ate_gpu <= 2*ate_cpu + 1e-6")

    S2 = sizes["s2m_scans"]
    scans2, poses2, _ = _wavy_sequence(
        S2, sizes["scan"], (0.06, 0.03, 0.01, 0.004, 0.002, 0.015))
    cfg2 = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                     tolerance=1e-6, dim=3, trim_dist=2.0, loss_name="huber",
                     loss_metric=0.5, collect_histories=False)

    def run_s2m():
        res = scan_to_map_odometry(((s, None) for s in scans2), cfg2,
                                   capacity=sizes["map_capacity"], voxel=0.25)
        return float(ate(res.poses, jnp.asarray(poses2), align=False))

    a_gpu = run_s2m()
    with jax.default_device(cpu):
        a_cpu = run_s2m()
    _report(5, "scan_to_map_odometry", _ate_bound(a_gpu, a_cpu), scans=S2,
            points=sizes["scan"], capacity=sizes["map_capacity"],
            ate_gpu=a_gpu, ate_cpu=a_cpu, bound="ate_gpu <= 2*ate_cpu + 1e-6")
    phase_slam(sizes, cpu)


def phase_slam(sizes, cpu):
    import jax
    import jax.numpy as jnp

    from dicp_tpu.config import ICPConfig
    from dicp_tpu.odometry import ate
    from dicp_tpu.slam import slam_odometry

    scans, poses = _slam_sequence(sizes["scan"])
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=40,
                    tolerance=1e-4, dim=3, trim_dist=2.0, loss_name="huber",
                    loss_metric=0.5, collect_histories=False)

    def run_slam():
        res = slam_odometry(((s, None) for s in scans), cfg,
                            capacity=sizes["map_capacity"], voxel=0.25,
                            anchor_every=4, closure_gap=12, detect_every=2,
                            detect_radius=5.0, accept_ratio=0.5,
                            max_closures=20, closure_info=30.0,
                            refine_iterations=10)
        # final-position error of the front end and of the refined graph
        ef = float(np.linalg.norm(np.asarray(res.poses_front[-1][:3, 3])
                                  - poses[-1][:3, 3]))
        er = float(np.linalg.norm(np.asarray(res.poses[-1][:3, 3])
                                  - poses[-1][:3, 3]))
        return (float(ate(res.poses, jnp.asarray(poses), align=False)),
                len(res.closures), ef, er)

    a_gpu, nc_gpu, ef, er = run_slam()
    with jax.default_device(cpu):
        a_cpu, nc_cpu, _, _ = run_slam()
    _report(5, "slam_odometry", _ate_bound(a_gpu, a_cpu) and nc_gpu >= 1
            and np.isfinite(er) and er <= ef + 1e-3,
            scans=len(scans), points=sizes["scan"],
            capacity=sizes["map_capacity"], closures_gpu=nc_gpu,
            closures_cpu=nc_cpu, ate_gpu=a_gpu, ate_cpu=a_cpu,
            end_err_front=ef, end_err_refined=er,
            bound="ate_gpu <= 2*ate_cpu + 1e-6, closures>=1, "
                  "end_err_refined <= end_err_front + 1e-3")


def phase_solvers(sizes):
    """The solvers off the main path, each at its own exactness bar."""
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_suite import _make_scene
    from dicp_tpu import knn
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.gicp import register_gicp, register_gicp_ift
    from dicp_tpu.multiscale import ScaleLevel, register_multiscale
    from dicp_tpu.registration import register, register_jit
    from dicp_tpu.sgd_icp import register_sgd

    eye = jnp.eye(4, dtype=jnp.float32)

    # symmetric pt2pl on three planes (source normals moved with the points)
    rng = np.random.default_rng(7)
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-5, 5, size=(200, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (200, 1)))
    cloud = np.hstack([np.vstack(pts), np.vstack(nrm)]).astype(np.float32)
    src, T_true = _exact_pair(cloud, [.05, -.04, .06, .02, -.01, .03])
    src = np.hstack([src, cloud[:, 3:6].astype(np.float64)
                     @ np.linalg.inv(T_true)[:3, :3].T]).astype(np.float32)
    cfg = ICPConfig(icp_type="symmetric", differentiable=True,
                    max_iterations=50, tolerance=1e-8, dim=3)
    res = register_jit(jnp.asarray(src[None]), jnp.asarray(cloud[None]),
                       eye[None], None, cfg=cfg)
    err = _pose_err(T_true, res.T[0])
    _report(6, "symmetric_pt2pl", err < 1e-4, n=cloud.shape[0],
            pose_err=err, tol_pose=1e-4)

    # streaming (online-softmax) Gumbel soft-NN at tiny tau equals hard NN
    # where the NN gaps dominate the Gumbel noise (the +-300 box)
    y = jnp.asarray(rng.uniform(-300, 300, (5000, 6)).astype(np.float32))
    x = jnp.asarray(rng.uniform(-300, 300, (512, 3)).astype(np.float32))
    out = jax.jit(lambda x, y: knn.gumbel_nn(x, y, jax.random.key(0),
                                             tau=1e-3, chunk=512))(x, y)
    hard = jax.jit(knn.hard_nn)(x, y)
    agree = float(jnp.mean((jnp.linalg.norm(
        out[..., :3] - hard[..., :3], axis=-1) < 1e-2).astype(jnp.float32)))
    _report(6, "gumbel_streaming", agree > 0.97, n=512, m=5000, tau=1e-3,
            chunk=512, agreement_with_hard_nn=agree, tol=0.97)

    # GICP on a curved patch; its IFT gradient against the unrolled one
    xy = np.random.default_rng(11).uniform(-3, 3, size=(400, 2))
    scene = np.column_stack(
        [xy, 0.09 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)]).astype(np.float32)
    src, T_true = _exact_pair(scene, [0.2, -0.15, 0.1, 0.06, -0.04, 0.08])
    S, Tg, Ti = (jnp.asarray(src[None]), jnp.asarray(scene[None]), eye[None])
    res = jax.jit(lambda s, t, ti: register_gicp(
        s, t, ti, max_iterations=40, tolerance=1e-6))(S, Tg, Ti)
    err = _pose_err(T_true, res.T[0])
    conv = bool(res.converged[0])
    _report(6, "gicp", err < 1e-4 and conv, n=400, pose_err=err,
            tol_pose=1e-4, converged=conv)
    g_i = np.asarray(jax.jit(jax.grad(lambda s, t, ti: jnp.sum(
        register_gicp_ift(s, t, ti, max_iterations=40,
                          tolerance=1e-6).T)))(S, Tg, Ti))
    g_u = np.asarray(jax.jit(jax.grad(lambda s, t, ti: jnp.sum(register_gicp(
        s, t, ti, max_iterations=15, tolerance=1e-6,
        differentiable=True).T)))(S, Tg, Ti))
    finite = bool(np.all(np.isfinite(g_i)) and np.abs(g_i).max() > 0)
    cos = float(np.sum(g_i * g_u)
                / (np.linalg.norm(g_i) * np.linalg.norm(g_u)))
    _report(6, "gicp_ift", finite and cos > 0.999, n=400,
            grad_cosine_vs_unrolled=cos, tol_cos=0.999,
            grads_finite_nonzero=finite)

    # voxel pyramid (dense coarse level, cluster final level) vs one level
    n = sizes["solver_points"]
    target = _make_scene(n)
    src, T_true = _exact_pair(target, [0.4, -0.25, 0.1, 0.03, -0.05, 0.08])
    Sj, Tj = jnp.asarray(src), jnp.asarray(target)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False,
                    max_iterations=30, tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster",
                    collect_histories=False)
    levels = (ScaleLevel(1.0, 2048, 2048, 15, 1e-3, trim_dist=8.0,
                         nn_method="dense"),
              ScaleLevel(0.0, 0, 0, 30, 1e-5))
    ms = jax.jit(lambda s, t, ti: register_multiscale(
        s[None], t[None], ti[None], None, cfg, levels))(Sj, Tj, eye)
    one = jax.jit(lambda s, t, ti: register(
        s[None], t[None], ti[None], None, cfg))(Sj, Tj, eye)
    e_ms, e_one = _pose_err(T_true, ms.result.T[0]), _pose_err(T_true, one.T[0])
    it_ms, it_one = float(ms.level_iterations[-1, 0]), float(one.iterations[0])
    _report(6, "multiscale", e_ms < 5e-4 and e_one < 5e-4 and it_ms <= it_one,
            n=n, pose_err_multiscale=e_ms, pose_err_single=e_one,
            tol_pose=5e-4, full_res_iterations_multiscale=it_ms,
            iterations_single=it_one)

    # stochastic mini-batch GN on the cluster route
    src, T_true = _exact_pair(target, [0.1, -0.08, 0.05, 0.04, -0.03, 0.05])
    res = jax.jit(lambda s, t, ti, k: register_sgd(
        s[None], t[None], ti[None], k, minibatch=1024, iterations=40,
        tolerance=1e-5, nn_method="cluster"))(jnp.asarray(src), Tj, eye,
                                              jax.random.key(0))
    err = _pose_err(T_true, res.T[0])
    conv = bool(res.converged[0])
    _report(6, "sgd_icp", err < 5e-4 and conv, n=n, minibatch=1024,
            route="cluster",
            pose_err=err, tol_pose=5e-4, converged=conv)


def phase_four(sizes):
    """Sharded paths on four cards, each against the single-device
    computation on one card (the plain solver, jitted once)."""
    import jax
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.odometry import PoseGraph, pose_graph_optimize
    from dicp_tpu.parallel import (make_mesh, pose_graph_optimize_partitioned,
                                   register_batch_sharded,
                                   register_map_sharded,
                                   register_map_sharded_ift,
                                   register_ring_sharded)
    from dicp_tpu.registration import register

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    m4 = make_mesh((1, 4))
    eye = jnp.eye(4, dtype=jnp.float32)

    B = sizes["batch"]
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber",
                    loss_metric=1.0, collect_histories=False)
    src, tgt, ti = (jnp.asarray(a) for a in _batch_inputs(B, np.float32))
    Tb4 = np.asarray(register_batch_sharded(make_mesh((4, 1)), src, tgt, ti,
                                            cfg=cfg).T)
    Tb1 = np.asarray(jax.jit(lambda s, t, i: register(s, t, i, None, cfg).T)(
        src, tgt, ti))
    d = float(np.max(np.abs(Tb4 - Tb1)))
    _report("4x", "register_batch_sharded", d <= 1e-6, B=B, mesh="(4,1)",
            max_abs_T_vs_1card=d, tol=1e-6)

    rng = np.random.default_rng(0)
    V = 64
    xi = rng.normal(scale=0.1, size=(V - 1, 6))
    true = [np.eye(4)]
    for k in range(V - 1):
        true.append(true[-1] @ np.asarray(se3.vec2tran(jnp.asarray(xi[k]))))
    true = np.stack(true)
    ei = list(range(V - 1)) + [2, 10, 30]
    ej = list(range(1, V)) + [60, 50, 45]
    meas = np.stack([np.linalg.inv(true[i]) @ true[j] for i, j in zip(ei, ej)])
    graph = PoseGraph(jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
                      jnp.asarray(meas, jnp.float32),
                      jnp.ones((len(ei),), jnp.float32))
    noise = rng.normal(scale=0.05, size=(V, 6))
    noise[0] = 0.0
    init = jnp.asarray(true, jnp.float32) @ jax.vmap(se3.vec2tran)(
        jnp.asarray(noise, jnp.float32))
    dense, _ = pose_graph_optimize(init, graph, iterations=8)
    part = pose_graph_optimize_partitioned(init, graph, m4, iterations=8)
    d = float(np.max(np.abs(np.asarray(part) - np.asarray(dense))))
    _report("4x", "pose_graph_optimize_partitioned", d <= 1e-4, poses=V,
            mesh="(1,4)", max_abs_vs_dense=d, tol=1e-4)

    # the 100k pair, default configuration throughout
    n = sizes["big"]
    target, srcb, T_true = _scene_pair(n, [0.2, -0.1, 0.05, 0.01, -0.02, 0.03])
    cfgb = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                     tolerance=1e-5, dim=3, trim_dist=2.0, loss_name="huber",
                     loss_metric=1.0, collect_histories=False)
    S, Tg = jnp.asarray(srcb), jnp.asarray(target)
    T1 = np.asarray(jax.jit(lambda s, t: register(
        s[None], t[None], eye[None], None, cfgb).T[0])(S, Tg))
    e1 = _pose_err(T_true, T1)
    for name, fn in (("register_map_sharded", register_map_sharded),
                     ("register_ring_sharded", register_ring_sharded)):
        r4 = fn(m4, S, Tg, cfg=cfgb)
        e4 = _pose_err(T_true, r4.T)
        d = float(np.max(np.abs(np.asarray(r4.T) - T1)))
        _report("4x", name, e4 < 1e-3 and d <= 1e-4, n=n, mesh="(1,4)",
                pose_err_4=e4, pose_err_1=e1, max_abs_T_vs_1card=d,
                tol_pose=1e-3, tol_T=1e-4, iterations=int(r4.iterations))

    # gradient w.r.t. the source points (the scene is an exact transform,
    # so weight gradients vanish at the zero-residual fixed point)
    cfgi = cfgb.with_(differentiable=True)
    g4 = np.asarray(jax.jit(jax.grad(lambda s, t: jnp.sum(
        register_map_sharded_ift(m4, s, t, cfg=cfgi).T)))(S, Tg))
    g1 = np.asarray(jax.jit(jax.grad(lambda s, t: jnp.sum(register_ift(
        s[None], t[None], eye[None], None, cfgi).T)))(S, Tg))
    cos = float(np.sum(g4 * g1) / (np.linalg.norm(g4) * np.linalg.norm(g1)))
    finite = bool(np.all(np.isfinite(g4)) and np.any(g4 != 0))
    _report("4x", "register_map_sharded_ift", cos > 0.999 and finite, n=n,
            mesh="(1,4)", grad_cosine_vs_1card=cos, tol_cos=0.999,
            grads_finite_nonzero=finite)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, HERE)
    import jax

    from dicp_tpu import backend
    from dicp_tpu.utils.device import (device_summary, enable_compile_cache,
                                       gpu_name_and_power)

    if backend.platform() != "gpu":
        print("chip_smoke.py: no GPU found (platform "
              f"{backend.platform()!r}); nothing was run", file=sys.stderr)
        return 2

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)   # for the f64 CPU references
    t0 = time.perf_counter()
    if args.four:
        print(gpu_name_and_power(), flush=True)
        phase_four(SIZES)
    else:
        cpu = jax.devices("cpu")[0]
        phase_env()
        phase_training(SIZES, cpu)
        phase_big_register(SIZES)
        phase_bruteforce(SIZES)
        phase_normals(SIZES)
        phase_streaming(SIZES, cpu)
        phase_solvers(SIZES)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(final_line(device_summary()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
