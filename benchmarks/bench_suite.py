"""Extended benchmark suite: the BASELINE.json configurations.

Each benchmark prints one JSON line {name, value, unit, detail}.  Run on the
default backend (the GPU; CPU with JAX_PLATFORMS=cpu).  The driver's
headline number stays in the repo-root bench.py (config #3).

Clock: K workload steps chained inside one jitted ``lax.scan`` (step k's
input depends on step k-1's outputs) ending in a host fetch, with two chain
lengths differenced to cancel the fixed dispatch and fetch cost
(``dicp_tpu.utils.timing.chained_rate``).

Usage: python benchmarks/bench_suite.py [name ...]
Names: svd_pair, pt2pl_pair, batch256, large_cloud, normals, odometry,
capacity, pipeline, scan_to_map, solvers
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.timing import chained_rate as _chained_rate


def _pair(dtype=np.float32):
    base = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "data")
    return (np.load(os.path.join(base, "points_scan.npy")).astype(dtype),
            np.load(os.path.join(base, "points_map.npy")).astype(dtype))


def _emit(name, value, unit, **detail):
    print(json.dumps({"name": name, "value": round(float(value), 3),
                      "unit": unit, **detail}))


def bench_svd_pair():
    """Config #1: point-to-point SVD ICP on the tests/data pair."""
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.svd_icp import pt2pt_svd_icp

    scan, mp = _pair()
    src = jnp.asarray(scan[:, :3])
    tgt = jnp.asarray(mp[:, :3])

    def step(s, tgt):
        res = pt2pt_svd_icp(s, tgt, max_iterations=60, tolerance=1e-9,
                            differentiable=False)
        return jnp.sum(res.T)

    dt = _chained_rate(step, src, tgt)
    res = pt2pt_svd_icp(src, tgt, max_iterations=60, tolerance=1e-9,
                        differentiable=False)
    T_true = se3.tran_inv(se3.vec2tran(jnp.array([1., 1., 0, 0, 0, .1], jnp.float32)))
    err = float(jnp.linalg.norm(se3.tran2vec(se3.compose(T_true, se3.tran_inv(res.T)))))
    _emit("svd_pair", dt * 1e3, "ms/pair", transform_err=err,
          iterations=int(res.iterations))


def bench_pt2pl_pair():
    """Config #2: point-to-plane IRLS ICP with Huber trust-region loss."""
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register, register_jit

    scan, mp = _pair()
    src = jnp.asarray(scan[None, :, :3])
    tgt = jnp.asarray(mp[None])
    ti = jnp.eye(4, dtype=jnp.float32)[None]
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)

    def step(s, tgt, ti):
        return jnp.sum(register(s, tgt, ti, None, cfg).T)

    # sub-millisecond steps: long chains lift the differenced quantity
    # well above the run-to-run noise
    dt = _chained_rate(step, src, tgt, ti, k_small=32, k_big=256)
    res = register_jit(src, tgt, ti, None, cfg=cfg)
    T_true = se3.tran_inv(se3.vec2tran(jnp.array([1., 1., 0, 0, 0, .1], jnp.float32)))
    err = float(jnp.linalg.norm(se3.tran2vec(se3.compose(T_true, se3.tran_inv(res.T[0])))))
    _emit("pt2pl_pair", dt * 1e3, "ms/pair", transform_err=err,
          iterations=float(res.iterations[0]))


def _batch_inputs(B):
    import jax.numpy as jnp

    scan, mp = _pair()
    src = jnp.asarray(np.broadcast_to(scan[None, :, :3], (B, scan.shape[0], 3)).copy())
    tgt = jnp.asarray(np.broadcast_to(mp[None], (B,) + mp.shape).copy())
    ti = jnp.asarray(np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy())
    return src, tgt, ti


def bench_batch256():
    """Config #3: B=256 batched diff ICP, fwd+bwd (the headline; see bench.py)."""
    import jax
    import jax.numpy as jnp

    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.registration import register

    B = 256
    src, tgt, ti = _batch_inputs(B)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)

    def unrolled_step(s, tgt, ti):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register(x, tgt, ti, None, cfg).T))(s)
        return val + jnp.sum(grad) * 1e-20

    dt = _chained_rate(unrolled_step, src, tgt, ti, k_small=2, k_big=8)
    _emit("batch256_fwdbwd", B / dt, "registrations/s",
          vs_cpu_baseline=round(B / dt / 1293.0, 2))

    def ift_step(s, tgt, ti):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register_ift(x, tgt, ti, None, cfg).T))(s)
        return val + jnp.sum(grad) * 1e-20

    dt_ift = _chained_rate(ift_step, src, tgt, ti)
    _emit("batch256_fwdbwd_ift", B / dt_ift, "registrations/s",
          vs_cpu_baseline=round(B / dt_ift / 1293.0, 2))


def bench_capacity():
    """Chip-capacity probe: the headline config at B=4096."""
    import jax
    import jax.numpy as jnp

    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift

    B = 4096
    src, tgt, ti = _batch_inputs(B)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)

    def step(s, tgt, ti):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register_ift(x, tgt, ti, None, cfg).T))(s)
        return val + jnp.sum(grad) * 1e-20

    dt = _chained_rate(step, src, tgt, ti, k_small=2, k_big=8)
    _emit("batch4096_fwdbwd_ift", B / dt, "registrations/s",
          vs_cpu_baseline=round(B / dt / 1293.0, 2))

    # the fix for the B=4096 collapse: knee-sized sequential chunks
    # (bitwise-identical results; see ICPConfig.batch_chunk)
    cfg_c = cfg.with_(batch_chunk=1024)

    def step_chunked(s, tgt, ti):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register_ift(x, tgt, ti, None, cfg_c).T))(s)
        return val + jnp.sum(grad) * 1e-20

    dt_c = _chained_rate(step_chunked, src, tgt, ti, k_small=2, k_big=8)
    _emit("batch4096_fwdbwd_ift_chunked", B / dt_c, "registrations/s",
          vs_cpu_baseline=round(B / dt_c / 1293.0, 2), batch_chunk=1024)


def _make_scene(n=100_000):
    rng = np.random.default_rng(0)
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-20, 20, size=(n // 3 + 1, 2)).astype(np.float32)
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (n // 3 + 1, 1)))
    return np.hstack([np.vstack(pts)[:n], np.vstack(nrm)[:n]]).astype(np.float32)


def bench_large_cloud():
    """Config #4: 100k-point registration — cluster-pruned exact kNN
    (build once, query per GN iteration), plus the brute-force 1-NN
    kernel and the normals front-end as standalone metrics."""
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.knn import nn_bruteforce
    from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_nn
    from dicp_tpu.ops.voxel import voxel_downsample
    from dicp_tpu.registration import register, register_jit

    n = 100_000
    target = jnp.asarray(_make_scene(n))
    xi = jnp.asarray(np.array([0.2, -0.1, 0.05, 0.01, -0.02, 0.03], np.float32))
    T_st = se3.vec2tran(xi)
    # generate the source on HOST in f64: a device matmul here would run at
    # the backend's default reduced precision and corrupt the ground truth
    T_np = np.asarray(T_st).astype(np.float64)
    source = jnp.asarray((np.asarray(target[:, :3], np.float64) @ T_np[:3, :3].T
                          + T_np[:3, 3]).astype(np.float32))

    # brute-force kernel alone (the exact O(n*m) floor)
    def knn_step(s, tgt3):
        return jnp.sum(nn_bruteforce(s, tgt3)[0].astype(jnp.float32)) * 1e-9

    dt_knn = _chained_rate(knn_step, source, target[:, :3], k_small=2, k_big=6)
    _emit("bruteforce_knn_100k", dt_knn * 1e3, "ms", pairs=n * n)

    # cluster-pruned search: build and query timed in separate chains
    import jax

    from dicp_tpu.ops.cluster_knn import ClusterIndex

    build = jax.jit(lambda t: build_cluster_index(t, 128))

    def build_step(tgt3):
        ix = build_cluster_index(tgt3, 128)
        return jnp.sum(ix.centers) + jnp.sum(ix.order.astype(jnp.float32)) * 1e-9

    dt_build = _chained_rate(jax.jit(build_step), target[:, :3],
                             k_small=2, k_big=8)
    index = build(target[:, :3])

    def query_step(s, pts, c, r, o, fr):
        ix = ClusterIndex(pts, c, r, o, fr)
        idx, d2, cert = cluster_nn(ix, s, probes=32)
        return (jnp.sum(idx.astype(jnp.float32)) * 1e-9
                + jnp.sum(cert) * 1e-9 + jnp.sum(d2) * 1e-20)

    dt_q = _chained_rate(jax.jit(query_step), source, index.points,
                         index.centers, index.radius, index.order,
                         index.frame, k_small=2, k_big=8)
    idx, _, cert = cluster_nn(index, source, probes=32)
    idx_ref = nn_bruteforce(source, target[:, :3])[0]
    agree = float(jnp.mean((idx == idx_ref).astype(jnp.float32)))
    _emit("cluster_knn_100k", (dt_build + dt_q) * 1e3, "ms",
          build_ms=round(dt_build * 1e3, 3), query_ms=round(dt_q * 1e3, 3),
          certified_pct=round(100 * float(jnp.mean(cert.astype(jnp.float32))), 3),
          agreement_vs_bruteforce_pct=round(100 * agree, 4),
          note="solver amortizes the one-time build over all GN iterations")

    # exact k-NN (k=16) through the same index
    from dicp_tpu.ops.cluster_knn import cluster_knn

    def knn16_step(s, pts, c, r, o, fr):
        ix = ClusterIndex(pts, c, r, o, fr)
        idx16, d2k, cert = cluster_knn(ix, s, k=16, probes=32)
        return (jnp.sum(idx16.astype(jnp.float32)) * 1e-9
                + jnp.sum(cert) * 1e-9 + jnp.sum(d2k) * 1e-20)

    dt16 = _chained_rate(jax.jit(knn16_step), source, index.points,
                         index.centers, index.radius, index.order,
                         index.frame, k_small=2, k_big=6)
    idx16, d2k16, cert16 = cluster_knn(index, source, k=16, probes=32)
    _emit("cluster_knn16_100k", dt16 * 1e3, "ms", k=16, certified_pct=round(
        100 * float(jnp.mean(cert16.astype(jnp.float32))), 3))

    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster")

    def reg_step(s, tgt):
        v = voxel_downsample(s, 0.5)
        res = register(v.points[None], tgt[None],
                       jnp.eye(4, dtype=jnp.float32)[None], v.weight[None], cfg)
        return jnp.sum(res.T)

    dt = _chained_rate(reg_step, source, target, k_small=1, k_big=4)
    v = voxel_downsample(source, 0.5)
    res = register_jit(v.points[None], target[None],
                       jnp.eye(4, dtype=jnp.float32)[None], v.weight[None], cfg=cfg)
    T_true = se3.tran_inv(T_st)
    err = float(jnp.linalg.norm(se3.tran2vec(se3.compose(T_true, se3.tran_inv(res.T[0])))))
    _emit("large_cloud_100k", dt * 1e3, "ms/registration", transform_err=err,
          iterations=float(res.iterations[0]))

    # full-resolution registration, NO voxel downsample: 100k source points
    # against the 100k map every GN iteration through the cluster index
    def reg_full_step(s, tgt):
        res = register(s[None], tgt[None], jnp.eye(4, dtype=jnp.float32)[None],
                       None, cfg)
        return jnp.sum(res.T)

    dt_full = _chained_rate(reg_full_step, source, target, k_small=1, k_big=4)
    res_f = register_jit(source[None], target[None],
                         jnp.eye(4, dtype=jnp.float32)[None], None, cfg=cfg)
    err_f = float(jnp.linalg.norm(se3.tran2vec(
        se3.compose(T_true, se3.tran_inv(res_f.T[0])))))
    _emit("large_cloud_100k_fullres", dt_full * 1e3, "ms/registration",
          transform_err=err_f, iterations=float(res_f.iterations[0]))


def bench_normals():
    """Normals front-end at scale: estimate_normals on the 100k cloud via
    the cluster kNN (no (n, n) matrix), then an e2e pt2pl registration that
    COMPUTES its own target normals."""
    import jax
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ops.normals import estimate_normals
    from dicp_tpu.registration import register, register_jit

    n = 100_000
    scene = _make_scene(n)
    target3 = jnp.asarray(scene[:, :3])
    true_n = scene[:, 3:6]

    est = jax.jit(lambda p: estimate_normals(p, method="weighted"))

    def step(p):
        return jnp.sum(est(p)) * 1e-9

    dt = _chained_rate(step, target3, k_small=2, k_big=6)
    nrm = np.asarray(est(target3))
    # orientation-agnostic accuracy vs the scene's exact normals
    dots = np.abs(np.sum(nrm * true_n, axis=-1))
    _emit("normals_100k", dt * 1e3, "ms", method="weighted",
          mean_abs_dot_vs_truth=round(float(dots.mean()), 6),
          pct_within_5deg=round(100 * float((dots > np.cos(np.radians(5))).mean()), 3))

    # e2e: registration computing its own normals
    xi = jnp.asarray(np.array([0.2, -0.1, 0.05, 0.01, -0.02, 0.03], np.float32))
    T_st = se3.vec2tran(xi)
    T_np = np.asarray(T_st).astype(np.float64)  # host f64 ground truth
    source = jnp.asarray((np.asarray(target3, np.float64) @ T_np[:3, :3].T
                          + T_np[:3, 3]).astype(np.float32))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster")

    def e2e_step(s, tgt3):
        tgt6 = jnp.concatenate([tgt3, est(tgt3)], axis=-1)
        res = register(s[None], tgt6[None], jnp.eye(4, dtype=jnp.float32)[None],
                       None, cfg)
        return jnp.sum(res.T)

    dt_e2e = _chained_rate(e2e_step, source, target3, k_small=1, k_big=4)
    tgt6 = jnp.concatenate([target3, est(target3)], axis=-1)
    res = register_jit(source[None], tgt6[None],
                       jnp.eye(4, dtype=jnp.float32)[None], None, cfg=cfg)
    T_true = se3.tran_inv(T_st)
    err = float(jnp.linalg.norm(se3.tran2vec(
        se3.compose(T_true, se3.tran_inv(res.T[0])))))
    _emit("large_cloud_100k_selfnormals", dt_e2e * 1e3, "ms/registration",
          transform_err=err, iterations=float(res.iterations[0]))


def bench_odometry():
    """Config #5: chained odometry over a synthetic sequence + ATE."""
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.odometry import ate, odometry

    scan, mp = _pair(np.float32)
    S = 64
    step_xi = np.array([0.05, 0.08, 0, 0, 0, 0.02], np.float32)
    step_T = np.asarray(se3.vec2tran(jnp.asarray(step_xi)))
    T = np.eye(4, dtype=np.float32)
    scans, poses = [], []
    for _ in range(S):
        Ti = np.linalg.inv(T)
        scans.append(np.hstack([mp[:, :3] @ Ti[:3, :3].T + Ti[:3, 3],
                                mp[:, 3:6] @ Ti[:3, :3].T]).astype(np.float32))
        poses.append(T.copy())
        T = T @ step_T
    scans_j = jnp.asarray(np.stack(scans))
    poses_true = jnp.asarray(np.stack(poses))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)

    # One 63-pair batched solve is sub-millisecond; each chained step runs
    # R dependent solves, lifting the differenced quantity well above the
    # run-to-run noise.
    R = 8

    def step(s):
        from jax import lax

        def inner(carry, j):
            r = odometry(s + (carry * 1e-12 + j.astype(jnp.float32) * 1e-7),
                         cfg).poses
            return jnp.sum(r) * 1e-6, ()

        c, _ = lax.scan(inner, jnp.float32(0.0), jnp.arange(R))
        return c

    dt = _chained_rate(step, scans_j, k_small=2, k_big=6)
    res = odometry(scans_j, cfg)
    err = float(ate(res.poses, poses_true, align=False))
    _emit("odometry_64scans", R * (S - 1) / dt, "pairs/s", ate=err,
          solves_per_step=R,
          all_converged=bool(jnp.all(res.converged)))


def bench_solvers():
    """Solver-zoo rows — which solver when.  GICP / SGD-vs-full / multiscale rows
    delegate to the focused exp_ modules (same row format); the AA rows
    and the AA-forward + IFT-backward composition profile (the TODO at
    anderson.py:23-26) are measured here."""
    import jax
    import jax.numpy as jnp

    from benchmarks import exp_gicp, exp_multiscale, exp_sgd
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.registration import register

    # DICP_SOLVERS_AA_ONLY skips the delegated exp_ rows (each compiles
    # several programs; they are rerunnable standalone)
    if not os.environ.get("DICP_SOLVERS_AA_ONLY"):
        exp_gicp.main()
        exp_sgd.main()
        exp_multiscale.main()

    # --- Anderson acceleration on the linear-rate pt2pt fixed point ---
    scan, mp = _pair()
    src1 = jnp.asarray(scan[None, :, :3])
    tgt1 = jnp.asarray(mp[None])
    ti1 = jnp.asarray(np.eye(4, dtype=np.float32)[None])
    base = ICPConfig(icp_type="pt2pt", differentiable=False,
                     max_iterations=100, tolerance=1e-6, dim=2,
                     trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     collect_histories=False)
    # two tolerances: at 1e-6 the plain driver stops early anyway (AA's
    # mixing overhead loses); at 1e-10 the linear-rate tail is long and AA
    # cuts it (test_anderson.py pins <= 0.6x iterations there)
    for m, tol, tag in ((0, 1e-6, "aa_off"), (3, 1e-6, "aa_m3"),
                        (0, 1e-10, "aa_off_tol10"), (3, 1e-10, "aa_m3_tol10")):
        cfg = base.with_(anderson_m=m, tolerance=tol)

        def step(s, tgt, ti, _c=cfg):
            res = register(s, tgt, ti, None, _c)
            return jnp.sum(res.T) + res.iterations[0] * 1e-9

        res = jax.jit(lambda s, t, ti, _c=cfg: register(s, t, ti, None, _c))(
            src1, tgt1, ti1)
        dt = _chained_rate(step, src1, tgt1, ti1, k_small=4, k_big=16)
        _emit(f"pt2pt_pair_{tag}", dt * 1e3, "ms/pair",
              iterations=float(res.iterations[0]),
              converged=bool(res.converged[0]))

    # --- AA forward + IFT backward (anderson.py's deferred composition):
    # headline B=256 pt2pl fwd+bwd with the AA driver as the fixed-point
    # forward.  Gradients must match the plain-while forward's (same fixed
    # point => same implicit linearization).
    B = 256
    srcB, tgtB, tiB = _batch_inputs(B)
    # driver='while' + collect_histories=False: what register_ift resolves
    # to internally, and the only combination anderson_m > 0 validates with
    cfgd = ICPConfig(icp_type="pt2pl", differentiable=True, driver="while",
                     max_iterations=100, tolerance=1e-6, dim=2,
                     trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     collect_histories=False)
    grads = {}
    for m, tag in ((0, "off"), (3, "m3")):
        cfg = cfgd.with_(anderson_m=m)

        def step(s, tgt, ti, _c=cfg):
            val, grad = jax.value_and_grad(
                lambda x: jnp.sum(register_ift(x, tgt, ti, None, _c).T))(s)
            return val + jnp.sum(grad) * 1e-20

        g = jax.jit(jax.grad(lambda x, _c=cfg: jnp.sum(
            register_ift(x, tgtB, tiB, None, _c).T)))(srcB)
        grads[tag] = np.asarray(g)
        dt = _chained_rate(step, srcB, tgtB, tiB, k_small=4, k_big=12)
        _emit(f"batch256_ift_aa_{tag}", B / dt, "registrations/s")
    gdiff = float(np.max(np.abs(grads["m3"] - grads["off"]))
                  / max(1e-12, float(np.max(np.abs(grads["off"])))))
    _emit("aa_ift_grad_reldiff", gdiff, "max_rel",
          note="AA fwd + IFT bwd vs while fwd + IFT bwd, same fixed point")


def bench_pipeline():
    """End-to-end streaming odometry: disk -> native host preprocess (range
    filter + voxel hash-grid) -> prefetched host->device transfer -> device
    registration, one scan pair at a time (the online-SLAM serving path).
    Host-pipeline-bound; every result is fetched to host inside the timed
    region, so device work cannot be skipped."""
    import tempfile

    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.io import ScanDataset, save_bin
    from dicp_tpu.registration import register_jit

    scene = _make_scene(60_000)[:, :3]
    S = 16
    step_xi = jnp.asarray(np.array([0.04, 0.02, 0.01, 0.004, 0.002, 0.01], np.float32))
    T_step = np.asarray(se3.vec2tran(step_xi))
    tmpdir = tempfile.mkdtemp(prefix="dicp_bench_")
    T = np.eye(4, dtype=np.float32)
    for i in range(S):
        Ti = np.linalg.inv(T).astype(np.float32)
        scan = scene @ Ti[:3, :3].T + Ti[:3, 3]
        save_bin(os.path.join(tmpdir, f"{i:04d}.bin"),
                 np.hstack([scan, np.zeros((scan.shape[0], 1), np.float32)]))
        T = T @ T_step

    def run_pipeline(shift, voxel, max_pts, cfg):
        ds = ScanDataset.from_dir(tmpdir, max_points=max_pts, voxel=voxel,
                                  workers=4, prefetch=4)
        prev = None
        rels = []
        for pts_np, w_np in ds:
            cur = jnp.asarray(pts_np[:, :3] + shift)
            w = jnp.asarray(w_np)
            if prev is not None:
                res = register_jit(cur[None], prev[0][None],
                                   jnp.eye(4, dtype=jnp.float32)[None],
                                   w[None], cfg=cfg)
                rels.append(res.T[0])
            prev = (cur, w)
        # host fetch of every transform forces all solves to really run
        return np.asarray(jnp.stack(rels))

    step_inv = np.asarray(se3.tran_inv(jnp.asarray(T_step)))

    # Accuracy-vs-voxel sweep: coarse voxels quantize the
    # clouds DIFFERENTLY per pose, so corresponding points cease to exist and
    # the fixed point shifts.  The cluster-kNN solver makes fine/raw
    # resolutions affordable, so the default is chosen to meet rel_err<=1e-3.
    sweep = [
        (0.4, 4096, "pallas"),        # coarse voxels, tiled brute force
        (0.2, 16384, "cluster"),
        (0.1, 65536, "cluster"),
        (None, 61440, "cluster"),     # raw full-resolution scans
    ]
    results = {}
    if os.environ.get("DICP_BENCH_STREAM_Q_ONLY"):
        sweep = []
    for voxel, max_pts, nn in sweep:
        cfg = ICPConfig(icp_type="pt2pt", differentiable=False,
                        max_iterations=30, tolerance=1e-5, dim=3,
                        trim_dist=1.0, loss_name="huber", loss_metric=0.5,
                        nn_method=nn)
        run_pipeline(np.float32(0), voxel, max_pts, cfg)  # compile + warm
        t0 = time.time()
        rels = run_pipeline(np.float32(1e-7), voxel, max_pts, cfg)
        dt = time.time() - t0
        err = float(np.max([np.linalg.norm(np.asarray(se3.tran2vec(
            jnp.asarray(r @ step_inv)))) for r in rels]))
        tag = "raw" if voxel is None else str(voxel)
        results[tag] = (S / dt, err)
        _emit(f"pipeline_sweep_voxel_{tag}", S / dt, "frames/s", rel_err=err,
              scans=S, raw_pts=60_000, max_pts=max_pts, nn_method=nn)

    # Windowed streaming serving loop (dicp_tpu.pipeline):
    # one h2d transfer per scan, one dispatch per W pairs, device futures
    # kept in flight while the host preprocesses.  Measured on a longer
    # 64-scan sequence (sustained rate; the per-pair loop above is
    # dispatch-bound so short sequences flatter it).
    from dicp_tpu.pipeline import stream_odometry

    S2 = 64
    tmpdir2 = tempfile.mkdtemp(prefix="dicp_bench_stream_")
    T = np.eye(4, dtype=np.float32)
    for i in range(S2):
        Ti = np.linalg.inv(T).astype(np.float32)
        scan = scene @ Ti[:3, :3].T + Ti[:3, 3]
        save_bin(os.path.join(tmpdir2, f"{i:04d}.bin"),
                 np.hstack([scan, np.zeros((scan.shape[0], 1), np.float32)]))
        T = T @ T_step

    raw_cfg = ICPConfig(icp_type="pt2pt", differentiable=False,
                        max_iterations=30, tolerance=1e-5, dim=3,
                        trim_dist=1.0, loss_name="huber", loss_metric=0.5,
                        nn_method="cluster")

    def run_streamed(shift, W, warm, quant=False):
        ds = ScanDataset.from_dir(tmpdir2, max_points=61440, voxel=None,
                                  workers=4, prefetch=4)

        def gen():
            for pts, w in ds:
                p = pts[:, :3] + shift
                if quant:
                    # weightless transfer needs the zero-row pads replaced
                    # by REAL rows (api.py's repeat-pad convention): pads
                    # at the origin bias the solve ~1e-3 (measured — the
                    # reference's sentinel-at-origin bug resurfacing).
                    pad = w == 0
                    n_pad = int(pad.sum())
                    if n_pad:
                        p[pad] = p[~pad][:n_pad]
                    yield p, None
                else:
                    yield p, w

        res = stream_odometry(gen(), raw_cfg, window=W, warm_start=warm,
                              quantize=quant)
        return np.asarray(res.rel_transforms)   # host fetch: forces all work

    shift_n = 0
    # W=1 + warm start (constant-velocity prior) is the production serving
    # mode; the windowed rows quantify that batching LOSES on raw 60k scans
    # (the loop is device-compute-bound and dispatches are already async, so
    # a window only adds the max-iteration sync across its pairs).
    combos = ((1, True, False), (4, True, False),
              (8, True, False), (8, False, False),
              (1, True, True), (4, True, True))
    if os.environ.get("DICP_BENCH_STREAM_Q_ONLY"):
        combos = ((1, True, True), (4, True, True))
    for W, warm, quant in combos:
        run_streamed(np.float32(0), W, warm, quant)    # compile + warm
        best, err = float("inf"), None
        for _ in range(2):
            shift_n += 1
            t0 = time.time()
            rels = run_streamed(np.float32(shift_n * 1e-7), W, warm, quant)
            dt = time.time() - t0
            best = min(best, dt)
        err = float(np.max([np.linalg.norm(np.asarray(se3.tran2vec(
            jnp.asarray(r @ step_inv)))) for r in rels]))
        tag = (f"streamW{W}" + ("" if warm else "_cold")
               + ("_q" if quant else ""))
        results[tag] = (S2 / best, err)
        _emit(f"pipeline_stream_window{W}" + ("" if warm else "_cold")
              + ("_q16" if quant else ""),
              S2 / best, "frames/s", rel_err=err, scans=S2, raw_pts=60_000,
              window=W, warm_start=warm, quantized=quant)

    # headline = fastest setting that meets the 1e-3 accuracy bound
    ok = [(tag, f, e) for tag, (f, e) in results.items() if e <= 1e-3]
    tag, fps, err = max(ok, key=lambda t: t[1]) if ok else \
        min(((t, f, e) for t, (f, e) in results.items()), key=lambda t: t[2])
    _emit("pipeline_stream", fps, "frames/s", rel_err=err,
          chosen=tag)


def _wavy_sequence(S, n, step_xi, seed=0, noise=0.0):
    """S scans of a wavy 60k-pt surface along a constant-step trajectory,
    generated host-side in f64 (device matmuls at reduced default precision
    would corrupt the ground truth)."""
    from dicp_tpu import se3
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    base = rng.uniform(-20, 20, (n, 3))
    base[:, 2] = (np.sin(base[:, 0] * 0.35) * np.cos(base[:, 1] * 0.3) * 2.0)
    if noise:
        base = base + rng.normal(scale=noise, size=base.shape)
    step_T = np.asarray(se3.vec2tran(jnp.asarray(
        np.array(step_xi, np.float32)))).astype(np.float64)
    scans, poses = [], []
    T = np.eye(4)
    for _ in range(S):
        Ti = np.linalg.inv(T)
        scans.append((base @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
        poses.append(T.astype(np.float32).copy())
        T = T @ step_T
    return scans, np.stack(poses), step_T.astype(np.float32)


def bench_scan_to_map():
    """Scan-to-map odometry at serving scale: 60k-pt raw
    scans against a 65k-cap fused voxel map.

    Rows:
      scan_to_map_60k        — host-loop fps (the real serving shape: one
                               map_step dispatch per scan, poses fetched at
                               the end so no device work can be skipped)
                               + final-pose error vs ground truth
      scan_to_map_60k_step   — device cost per scan (chained lax.scan with
                               the map as carry — genuinely dependent), with
                               phase attribution: merge cost from an
                               insert=False chain, per-GN-iteration cost
                               from const_iter differencing (10 vs 20)
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.mapping import empty_map, map_merge, map_step
    from dicp_tpu.odometry import ate
    from dicp_tpu.mapping import scan_to_map_odometry

    S, n, cap, voxel = 12, 60_000, 65_536, 0.25
    scans, poses_true, step_T = _wavy_sequence(
        S, n, (0.06, 0.03, 0.01, 0.004, 0.002, 0.015))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=0.5, nn_method="cluster",
                    collect_histories=False)

    # --- device step cost, chained (map carried through the scan) ---
    import sys
    scans_j = jnp.asarray(np.stack(scans))          # (S, n, 3)
    step_j = jnp.asarray(step_T)

    def chain(insert, cfg_c, solver="gn", **skw):
        @jax.jit
        def f(scans, off):
            m0 = map_merge(empty_map(cap), scans[0] + off * 1e-7, voxel,
                           with_normals=True, mode="mean")
            key0 = jax.random.key(0)

            def body(carry, xs):
                m, pose = carry
                scan, i = xs
                t_pred = se3.compose(pose, step_j)
                p2, cv, it, m2 = map_step(m, scan, t_pred, None, cfg_c,
                                          voxel, insert=insert,
                                          merge_mode="mean", solver=solver,
                                          key=(jax.random.fold_in(key0, i)
                                               if solver == "sgd" else None),
                                          **skw)
                return (m2, p2), it

            idx = jnp.arange(scans.shape[0] - 1, dtype=jnp.int32)
            (m, pose), its = lax.scan(body, (m0, jnp.eye(4, dtype=jnp.float32)),
                                      (scans[1:], idx))
            return (jnp.sum(pose) + jnp.sum(m.pos) * 1e-9
                    + jnp.sum(its.astype(jnp.float32)) * 1e-6)
        return f

    def timed(insert, cfg_c, k_small=3, k_big=S, solver="gn", **skw):
        out = {}
        for K in (k_small, k_big):
            f = chain(insert, cfg_c, solver=solver, **skw)
            sl = scans_j[:K]
            t0 = time.perf_counter()
            float(f(sl, jnp.float32(0.0)))  # compile
            print(f"# step compile insert={insert} K={K}: "
                  f"{time.perf_counter()-t0:.0f}s", file=sys.stderr, flush=True)
            best = float("inf")
            for rep in range(2):
                t0 = time.perf_counter()
                float(f(sl, jnp.float32(rep + 1)))
                best = min(best, time.perf_counter() - t0)
            out[K] = best
        return (out[k_big] - out[k_small]) / (k_big - k_small)

    if os.environ.get("DICP_S2M_LOOP_ONLY"):
        _scan_to_map_host_loop(scans, poses_true, cfg, S, n, cap, voxel)
        return

    cfg10 = cfg.with_(const_iter=True, max_iterations=10)
    cfg20 = cfg.with_(const_iter=True, max_iterations=20)
    dt_full = timed(True, cfg10)     # solve(10 it) + merge
    dt_solve = timed(False, cfg10)   # solve(10 it) only
    merge_ms = (dt_full - dt_solve) * 1e3
    _emit("scan_to_map_60k_step", dt_full * 1e3, "ms/scan",
          merge_ms=round(merge_ms, 3),
          solve10_ms=round(dt_solve * 1e3, 3),
          note="const_iter=10 chained; merge = full - insert_off")
    dt_solve20 = timed(False, cfg20)
    per_iter = max(0.0, (dt_solve20 - dt_solve) / 10.0)
    _emit("scan_to_map_gn_iter", per_iter * 1e3, "ms/iteration",
          note="const_iter 20-vs-10 differencing, 60k scan vs 65k-cap map")

    # stochastic front-end, same chained clock (the host-loop fps rows
    # also carry host and transfer time):
    # solve over a 2048-pt mini-batch instead of all 60k points/iteration
    dt_sgd = timed(True, cfg, solver="sgd", sgd_minibatch=2048,
                   sgd_iterations=30)
    _emit("scan_to_map_60k_step_sgd", dt_sgd * 1e3, "ms/scan",
          sgd_minibatch=2048, sgd_iterations=30,
          vs_gn_step=round(dt_full / dt_sgd, 2),
          note="chained; merge cost identical, solve is the delta")

    # + subsampled merge (scan normal estimation, linear in merged rows,
    # is a large share of the merge) — the serving-throughput stack
    dt_sgd_sub = timed(True, cfg, solver="sgd", sgd_minibatch=2048,
                       sgd_iterations=30, merge_subsample=20_000)
    _emit("scan_to_map_60k_step_sgd_sub", dt_sgd_sub * 1e3, "ms/scan",
          sgd_minibatch=2048, sgd_iterations=30, merge_subsample=20_000,
          vs_gn_step=round(dt_full / dt_sgd_sub, 2))

    if os.environ.get("DICP_S2M_STEP_ONLY"):
        return
    _scan_to_map_host_loop(scans, poses_true, cfg, S, n, cap, voxel)


def _scan_to_map_host_loop(scans, poses_true, cfg, S, n, cap, voxel):
    """Host-loop serving fps (wall clock; poses fetched at the end).

    Includes host and transfer time; compare the gn/sgd/sub *ratios*
    within one run."""
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.mapping import scan_to_map_odometry
    from dicp_tpu.odometry import ate

    def run(shift, **kw):
        res = scan_to_map_odometry(
            ((s + shift, None) for s in scans), cfg,
            capacity=cap, voxel=voxel, **kw)
        return np.asarray(res.poses), np.asarray(res.converged)

    variants = [("scan_to_map_60k", {}),
                # stochastic front-end: the solve's correspondence pass over
                # 2048 sampled points instead of all 60k (map_step solver=sgd)
                ("scan_to_map_60k_sgd",
                 dict(solver="sgd", sgd_minibatch=2048, sgd_iterations=30)),
                ("scan_to_map_60k_sgd_sub",
                 dict(solver="sgd", sgd_minibatch=2048, sgd_iterations=30,
                      merge_subsample=20_000))]
    for tag, kw in variants:
        run(np.float32(0.0), **kw)  # compile + warm
        best = float("inf")
        for rep in range(2):
            t0 = time.time()
            poses, conv = run(np.float32((rep + 1) * 1e-7), **kw)
            best = min(best, time.time() - t0)
        err = float(np.linalg.norm(np.asarray(se3.tran2vec(jnp.asarray(
            np.linalg.inv(poses_true[-1].astype(np.float64))
            @ poses[-1].astype(np.float64))))))
        traj = float(ate(jnp.asarray(poses), jnp.asarray(poses_true),
                         align=False))
        _emit(tag, S / best, "frames/s", final_pose_err=err,
              ate=traj, scans=S, raw_pts=n, map_cap=cap, voxel=voxel,
              all_converged=bool(conv.all()), **{k: v for k, v in kw.items()
                                                 if k != "solver"})


ALL = {
    "svd_pair": bench_svd_pair,
    "pt2pl_pair": bench_pt2pl_pair,
    "batch256": bench_batch256,
    "large_cloud": bench_large_cloud,
    "normals": bench_normals,
    "odometry": bench_odometry,
    "capacity": bench_capacity,
    "pipeline": bench_pipeline,
    "scan_to_map": bench_scan_to_map,
    "solvers": bench_solvers,
}


if __name__ == "__main__":
    from dicp_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    names = sys.argv[1:] or list(ALL)
    for name in names:
        ALL[name]()
