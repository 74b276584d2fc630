"""Multi-device sharding tests on the 8-device virtual CPU mesh
(conftest sets xla_force_host_platform_device_count=8).

These are the new multi-device components with no reference counterpart
(SURVEY.md §2.3): batch sharding must be bit-equivalent to single-device,
and the map-sharded psum Gauss-Newton must match the dense solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu import se3
from dicp_tpu.config import ICPConfig
from dicp_tpu.parallel import (
    make_mesh,
    register_batch_sharded,
    register_map_sharded,
)
from dicp_tpu.registration import register_jit


CFG = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=25,
                tolerance=1e-8, dim=2, trim_dist=5.0,
                loss_name="huber", loss_metric=1.0)


def _t_true():
    xi = jnp.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=jnp.float64)
    return np.asarray(se3.tran_inv(se3.vec2tran(xi)))


def _err(T_a, T_b):
    return float(jnp.linalg.norm(se3.tran2vec(
        jnp.asarray(T_a) @ jnp.linalg.inv(jnp.asarray(T_b)))))


def test_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_batch_sharded_equals_single_device(source_np, target_np):
    mesh = make_mesh((8, 1))
    src = jnp.asarray(np.stack([source_np[:, :3]] * 8))
    tgt = jnp.asarray(np.stack([target_np] * 8))
    ti = jnp.asarray(np.stack([np.eye(4)] * 8))

    res_sharded = register_batch_sharded(mesh, src, tgt, ti, cfg=CFG)
    res_single = register_jit(src, tgt, ti, None, cfg=CFG)
    np.testing.assert_allclose(np.asarray(res_sharded.T), np.asarray(res_single.T),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(res_sharded.matched_ratio),
                               np.asarray(res_single.matched_ratio), atol=1e-12)


def test_batch_sharded_heterogeneous(source_np, target_np):
    """Different per-element inputs stay independent across shards."""
    mesh = make_mesh((8, 1))
    rng = np.random.default_rng(0)
    srcs, tis = [], []
    for i in range(8):
        xi = np.zeros(6)
        xi[5] = 0.02 * i  # different z-rotations
        T = np.asarray(se3.vec2tran(jnp.asarray(xi)))
        pts = target_np[:, :3] @ T[:3, :3].T + T[:3, 3]
        srcs.append(pts)
        tis.append(np.eye(4))
    src = jnp.asarray(np.stack(srcs))
    tgt = jnp.asarray(np.stack([target_np] * 8))
    res = register_batch_sharded(mesh, src, tgt, jnp.asarray(np.stack(tis)), cfg=CFG)
    # each element should converge to its own inverse transform
    for i in range(8):
        xi = np.zeros(6)
        xi[5] = 0.02 * i
        T_true = np.asarray(se3.tran_inv(se3.vec2tran(jnp.asarray(xi))))
        assert _err(T_true, np.asarray(res.T[i])) < 1e-6, i


def test_map_sharded_matches_dense(source_np, target_np):
    """Psum-reduced normal equations == dense single-device solve."""
    mesh = make_mesh((1, 8))
    res = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                               jnp.asarray(target_np), cfg=CFG)
    dense = register_jit(jnp.asarray(source_np[None, :, :3]),
                         jnp.asarray(target_np[None]),
                         jnp.eye(4, dtype=jnp.float64)[None], None, cfg=CFG)
    assert _err(np.asarray(dense.T[0]), np.asarray(res.T)) < 1e-10
    assert bool(res.converged)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-7


def test_map_sharded_nondiff_early_exit(source_np, target_np):
    mesh = make_mesh((1, 8))
    cfg = CFG.with_(differentiable=False)
    res = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                               jnp.asarray(target_np), cfg=cfg)
    assert bool(res.converged)
    assert int(res.iterations) < 25
    assert _err(_t_true(), np.asarray(res.T)) < 1e-7


def test_map_sharded_gradient(source_np, target_np):
    """Gradients flow through the psum-reduced solve (training path)."""
    mesh = make_mesh((1, 8))
    tgt = jnp.asarray(target_np)
    cfg = CFG.with_(max_iterations=10)

    def f(src):
        return jnp.sum(register_map_sharded(mesh, src, tgt, cfg=cfg).T)

    g = jax.grad(f)(jnp.asarray(source_np[:, :3]))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0)


def test_map_sharded_pt2pt(source_np, target_np):
    mesh = make_mesh((1, 8))
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=40)
    res = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                               jnp.asarray(target_np[:, :3]), cfg=cfg)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-6


def test_mesh_2d_both_axes(source_np, target_np):
    """4x2 mesh: batch work on one axis, map sharding on the other."""
    mesh = make_mesh((4, 2))
    res = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                               jnp.asarray(target_np), cfg=CFG)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-7


def test_ring_nn_matches_replicated(source_np, target_np):
    """ring_nn over sharded targets == hard NN over the replicated target."""
    from dicp_tpu import knn
    from dicp_tpu.parallel import ring_nn
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((1, 8))
    x = jnp.asarray(source_np[:64, :3])       # 64 queries over 8 devices
    y = jnp.asarray(target_np[:64])           # 64 target rows over 8 devices

    fn = jax.jit(jax.shard_map(
        lambda xs, ys: ring_nn(xs, ys, "map"),
        mesh=mesh, in_specs=(P("map"), P("map")), out_specs=P("map")))
    got = fn(x, y)
    want = knn.hard_nn(x, y)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=0)


def test_ring_sharded_registration(source_np, target_np):
    """Fully sharded (source AND target) registration recovers the truth and
    matches the replicated-target map-sharded result."""
    from dicp_tpu.parallel import register_ring_sharded

    mesh = make_mesh((1, 8))
    res = register_ring_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                jnp.asarray(target_np), cfg=CFG)
    assert bool(res.converged)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-7

    dense = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np), cfg=CFG)
    assert _err(np.asarray(dense.T), np.asarray(res.T)) < 1e-10


def test_ring_sharded_pt2pt_and_padding(source_np, target_np):
    """Uneven point counts exercise source zero-padding and target sentinel
    rows (65 % 8 != 0)."""
    from dicp_tpu.parallel import register_ring_sharded

    mesh = make_mesh((2, 4))
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=40)
    res = register_ring_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                jnp.asarray(target_np[:, :3]), cfg=cfg)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-6


def test_map_sharded_nondefault_axis(source_np, target_np):
    """Regression: the psum/ring axis was hardcoded to 'map' — sharding over
    a different axis silently solved with un-reduced partial normal
    equations."""
    from dicp_tpu.parallel import register_ring_sharded

    mesh = make_mesh((8, 1))  # all devices on 'batch'
    res = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                               jnp.asarray(target_np), cfg=CFG, axis="batch")
    assert _err(_t_true(), np.asarray(res.T)) < 1e-7

    res2 = register_ring_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np), cfg=CFG, axis="batch")
    assert _err(_t_true(), np.asarray(res2.T)) < 1e-7


def test_map_sharded_symmetric(planes_scene):
    """Map-sharded symmetric ICP (round-1 gate removed): psum-reduced normal
    equations must match the dense single-device symmetric solve."""
    mesh = make_mesh((1, 8))
    cfg = ICPConfig(icp_type="symmetric", differentiable=False,
                    max_iterations=60, tolerance=1e-12, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0)
    xi = jnp.array([0.2, -0.1, 0.15, 0.03, -0.02, 0.04], dtype=jnp.float64)
    T_st = np.asarray(se3.vec2tran(xi))
    src6 = jnp.asarray(np.hstack(
        [planes_scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3],
         planes_scene[:, 3:6] @ T_st[:3, :3].T]))

    res = register_map_sharded(mesh, src6, jnp.asarray(planes_scene), cfg=cfg)
    dense = register_jit(src6[None], jnp.asarray(planes_scene)[None],
                         jnp.eye(4, dtype=jnp.float64)[None], None, cfg=cfg)
    assert _err(np.asarray(dense.T[0]), np.asarray(res.T)) < 1e-10
    T_true = np.asarray(se3.tran_inv(se3.vec2tran(xi)))
    assert _err(T_true, np.asarray(res.T)) < 1e-8
    assert bool(res.converged)

    # 3-column source is a clear error
    with pytest.raises(ValueError, match="6-column"):
        register_map_sharded(mesh, src6[:, :3], jnp.asarray(planes_scene),
                             cfg=cfg)


def test_map_sharded_cluster_matches_dense(source_np, target_np):
    """Map-sharded solve with the cluster correspondence backend (index
    built per device over the replicated target, queries shard-local) must
    match the dense-backend map-sharded solve exactly."""
    mesh = make_mesh((1, 8))
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50,
                     tolerance=1e-10, dim=2, trim_dist=5.0,
                     loss_name="huber", loss_metric=1.0)
    res_d = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np),
                                 cfg=base.with_(nn_method="dense"))
    res_c = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np),
                                 cfg=base.with_(nn_method="cluster",
                                                cluster_group=16,
                                                cluster_probes=8))
    np.testing.assert_allclose(np.asarray(res_c.T), np.asarray(res_d.T),
                               atol=1e-12)
    assert _err(_t_true(), np.asarray(res_c.T)) < 1e-7


def test_map_sharded_fused_parity(source_np, target_np):
    """The XLA cluster search INSIDE the shard_map body with the in-solver
    fixup off (cluster_fixup=0, so only certified matches enter) must
    reproduce the brute-force (dense) sharded solve — pose, convergence,
    and iteration count."""
    mesh = make_mesh((1, 8))
    base = ICPConfig(icp_type="pt2pl", differentiable=False,
                     max_iterations=50, tolerance=1e-10, dim=2,
                     trim_dist=5.0, loss_name="huber", loss_metric=1.0)
    res_x = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np),
                                 cfg=base.with_(nn_method="dense"))
    res_f = register_map_sharded(mesh, jnp.asarray(source_np[:, :3]),
                                 jnp.asarray(target_np),
                                 cfg=base.with_(nn_method="cluster",
                                                cluster_group=16,
                                                cluster_probes=8,
                                                cluster_fixup=0))
    np.testing.assert_allclose(np.asarray(res_f.T), np.asarray(res_x.T),
                               atol=1e-12)
    assert float(res_f.iterations) == float(res_x.iterations)
    assert bool(res_f.converged) == bool(res_x.converged)


@pytest.mark.parametrize("n_local,shards,n_real,fixup,want", [
    (25_000, 4, None, None, 1562),     # 100k over four: not 25_000 // 64
    (12_500, 8, None, None, 1562),
    (25_000, 4, 99_998, None, 1562),   # padded: the real count decides
    (1_000, 4, None, None, 256),
    (200, 8, None, None, 200),         # never more than the shard holds
    (25_000, 4, None, 300, 300),       # an explicit budget is kept
])
def test_shard_fixup_budget_is_the_whole_problems(n_local, shards, n_real,
                                                  fixup, want):
    """Each shard gets the single-device budget of the whole query set, so
    the sharded certified set does not shrink as the shard count grows."""
    cfg = ICPConfig(cluster_fixup=fixup)
    assert cfg.shard_cluster_fixup(n_local, shards, n_real) == want
    n = n_real if n_real is not None else n_local * shards
    assert want == min(cfg.resolved_cluster_fixup(n), n_local)


def test_map_sharded_ift_default_fixup_is_shard_invariant():
    """Three planes, 32k points over 8 shards, default cluster fixup: every
    shard covers its uncertified queries as the one-device solve does, so
    the sharded IFT gradient is the one-device gradient (a per-shard
    n_local // 64 budget gave cosine 0.997 here)."""
    from dicp_tpu.ift import register_ift
    from dicp_tpu.parallel import register_map_sharded_ift

    n = 32_768
    rng = np.random.default_rng(0)
    normals = np.eye(3)[[2, 0, 1]]
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-20, 20, size=(n // 3 + 1, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (n // 3 + 1, 1)))
    target = np.hstack([np.vstack(pts)[:n], np.vstack(nrm)[:n]])
    T = np.asarray(se3.vec2tran(jnp.asarray([0.2, -0.1, 0.05, 0.01, -0.02,
                                             0.03])))
    src = jnp.asarray((target[:, :3] @ T[:3, :3].T + T[:3, 3])
                      .astype(np.float32))
    tgt = jnp.asarray(target.astype(np.float32))
    cfg = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0, loss_name="huber",
                    loss_metric=1.0, collect_histories=False)
    assert cfg.resolved_nn_method(n, n) == "cluster"
    mesh = make_mesh((1, 8))
    eye = jnp.eye(4, dtype=jnp.float32)
    g8 = np.asarray(jax.jit(jax.grad(lambda s, t: jnp.sum(
        register_map_sharded_ift(mesh, s, t, cfg=cfg).T)))(src, tgt),
        np.float64)
    g1 = np.asarray(jax.jit(jax.grad(lambda s, t: jnp.sum(register_ift(
        s[None], t[None], eye[None], None, cfg).T)))(src, tgt), np.float64)
    assert np.all(np.isfinite(g8)) and np.any(g8 != 0)
    cos = np.sum(g8 * g1) / (np.linalg.norm(g8) * np.linalg.norm(g1))
    assert cos > 0.99999, cos


def test_map_sharded_ift_gradients_match_unrolled(source_np, target_np):
    """IFT backward for the map-sharded solver (VERDICT r2 #2): gradients
    from the one-solve fixed-point adjoint must match unrolling reverse-mode
    through the sharded GN scan to <= 1e-5, for source, target AND weight."""
    from dicp_tpu.parallel import register_map_sharded_ift

    mesh = make_mesh((1, 8))
    # IFT gradient error scales with the residual distance to the true
    # fixed point — drive the forward to f64 resolution.  Perturb the source
    # so the fixed point has NONZERO residuals: on the exact-fit pair the
    # weight gradient is identically zero (G is residual-weighted) and the
    # comparison would measure rounding noise.
    cfg = CFG.with_(max_iterations=80, tolerance=1e-14)
    rng = np.random.default_rng(11)
    src = jnp.asarray(source_np[:, :3]
                      + rng.normal(scale=2e-2, size=(65, 3)) * [1, 1, 0])
    tgt = jnp.asarray(target_np)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (src.shape[0],)))
    probe = jnp.asarray(np.linspace(0.5, 1.5, 16).reshape(4, 4))

    def loss_ift(s, t, w_):
        return jnp.sum(register_map_sharded_ift(
            mesh, s, t, weight=w_, cfg=cfg).T * probe)

    def loss_unrolled(s, t, w_):
        return jnp.sum(register_map_sharded(
            mesh, s, t, weight=w_, cfg=cfg).T * probe)

    # forward agreement first (same solver, same driver semantics)
    T_i = register_map_sharded_ift(mesh, src, tgt, weight=w, cfg=cfg)
    T_u = register_map_sharded(mesh, src, tgt, weight=w, cfg=cfg)
    assert bool(T_i.converged)
    assert _err(np.asarray(T_i.T), np.asarray(T_u.T)) < 1e-9

    g_i = jax.grad(loss_ift, argnums=(0, 1, 2))(src, tgt, w)
    g_u = jax.grad(loss_unrolled, argnums=(0, 1, 2))(src, tgt, w)
    for a, b, name in zip(g_i, g_u, ("source", "target", "weight")):
        a, b = np.asarray(a), np.asarray(b)
        denom = max(np.abs(b).max(), 1e-12)
        rel = np.abs(a - b).max() / denom
        assert rel < 1e-5, f"{name} grad rel err {rel}"


def test_map_sharded_ift_pt2pt(source_np, target_np):
    """Same contract for the pt2pt residual (3-vector errors)."""
    from dicp_tpu.parallel import register_map_sharded_ift

    mesh = make_mesh((1, 8))
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=60, tolerance=1e-12)
    src = jnp.asarray(source_np[:, :3])
    tgt = jnp.asarray(target_np[:, :3])

    def loss_ift(s):
        return jnp.sum(register_map_sharded_ift(mesh, s, tgt, cfg=cfg).T)

    def loss_unrolled(s):
        return jnp.sum(register_map_sharded(mesh, s, tgt, cfg=cfg).T)

    res = register_map_sharded_ift(mesh, src, tgt, cfg=cfg)
    assert bool(res.converged)
    assert _err(_t_true(), np.asarray(res.T)) < 1e-6
    g_i = np.asarray(jax.grad(loss_ift)(src))
    g_u = np.asarray(jax.grad(loss_unrolled)(src))
    rel = np.abs(g_i - g_u).max() / max(np.abs(g_u).max(), 1e-12)
    assert rel < 1e-5, rel


def test_multihost_single_process_fallbacks():
    """Multi-host readiness (VERDICT r2 #5), single-process fallback: the
    pod recipe (initialize -> make_pod_mesh -> host_local_batch ->
    batch-sharded solve) must run unchanged on one process and produce the
    same result as the plain batch-sharded path."""
    from dicp_tpu.parallel.multihost import (host_local_batch,
                                             initialize_distributed,
                                             make_pod_mesh,
                                             process_local_slice)

    assert initialize_distributed() is False  # one process -> no-op

    mesh = make_pod_mesh(map_per_host=2)      # hybrid (4, 2) on 8 devices
    assert mesh.shape["batch"] == 4 and mesh.shape["map"] == 2

    src_np = np.load("tests/data/points_scan.npy")[:, :3]
    tgt_np = np.load("tests/data/points_map.npy")
    B = 8
    sl = process_local_slice(B)
    assert sl == slice(0, B)                  # one process owns everything
    src = np.stack([src_np] * B)
    tgt = np.stack([tgt_np] * B)
    ti = np.stack([np.eye(4)] * B)
    srcg, tgtg, tig = host_local_batch(mesh, src[sl], tgt[sl], ti[sl])
    assert srcg.shape == (B,) + src_np.shape

    res = register_batch_sharded(mesh, srcg, tgtg, tig, cfg=CFG)
    for i in range(B):
        assert _err(_t_true(), np.asarray(res.T[i])) < 1e-6

    with pytest.raises(ValueError, match="divide"):
        make_pod_mesh(map_per_host=3)


def test_map_sharded_dim2_matches_dense(source_np, target_np):
    """dim=2 z-zeroing must apply in the sharded wrapper too (code-review
    r3: _map_sharded_body skipped registration._preprocess's input
    semantics, so noisy-z planar scans solved to a different pose than
    register())."""
    from dicp_tpu.parallel import make_mesh, register_map_sharded
    from dicp_tpu.registration import register_jit

    rng = np.random.default_rng(2)
    src = np.asarray(source_np[:, :3]).copy()
    src[:, 2] = rng.normal(scale=0.05, size=src.shape[0])   # z noise
    tgt = np.asarray(target_np).copy()
    tgt[:, 2] = rng.normal(scale=0.05, size=tgt.shape[0])
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, driver="while",
                    max_iterations=50, tolerance=1e-12, dim=2,
                    trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                    nn_method="dense")
    mesh = make_mesh((1, 8))
    res = register_map_sharded(mesh, jnp.asarray(src), jnp.asarray(tgt),
                               cfg=cfg)
    ref = register_jit(jnp.asarray(src)[None], jnp.asarray(tgt)[None],
                       jnp.eye(4)[None], None, cfg=cfg)
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(ref.T[0]),
                               atol=1e-9)
