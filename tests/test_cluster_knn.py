"""Cluster-pruned exact kNN (ops/cluster_knn) vs dense brute force."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu.ops.cluster_knn import (ClusterIndex, build_cluster_index,
                                      cluster_knn, cluster_nn,
                                      cluster_nn_verified, morton_keys)


def _dense_nn(x, y):
    d2 = np.sum((np.asarray(x)[:, None, :] - np.asarray(y)[None, :, :]) ** 2,
                axis=-1)
    return np.argmin(d2, axis=1), np.min(d2, axis=1)


def test_cluster_nn_exact_random():
    """Random uniform cloud with SPARSE off-distribution queries (the
    certificate's hardest case): every certified answer must match the dense
    argmin exactly, agreement must be high even uncertified, and the
    verified (probe-doubling) path must reach full exactness."""
    rng = np.random.default_rng(0)
    y = rng.uniform(-50, 50, size=(20_000, 3))
    x = rng.uniform(-50, 50, size=(3_000, 3))
    ref_idx, ref_d2 = _dense_nn(x, y)

    index = build_cluster_index(jnp.asarray(y), group_size=256)
    idx, d2, cert = cluster_nn(index, jnp.asarray(x), probes=16)
    cert = np.asarray(cert)
    assert cert.mean() > 0.7, cert.mean()
    # certified => exactly the dense answer (up to exact-tie twins)
    np.testing.assert_allclose(np.asarray(d2)[cert], ref_d2[cert], rtol=1e-12)
    # overall agreement stays high even where uncertified
    agree = np.isclose(np.asarray(d2), ref_d2, rtol=1e-9).mean()
    assert agree > 0.97, agree

    # doubling path: fully exact
    idx_v, d2_v = cluster_nn_verified(jnp.asarray(y), jnp.asarray(x),
                                      group_size=256, probes=16)
    np.testing.assert_allclose(np.asarray(d2_v), ref_d2, rtol=1e-12)


def test_cluster_nn_structured_scene():
    """Plane+wall scene (realistic scan geometry), queries offset off-cloud."""
    rng = np.random.default_rng(1)
    ground = np.column_stack([rng.uniform(-30, 30, (8000,)),
                              rng.uniform(-30, 30, (8000,)),
                              rng.normal(0, 0.02, (8000,))])
    wall = np.column_stack([rng.uniform(-30, 30, (4000,)),
                            np.full((4000,), 5.0) + rng.normal(0, 0.02, (4000,)),
                            rng.uniform(0, 3, (4000,))])
    y = np.vstack([ground, wall])
    x = y[rng.choice(len(y), 2000, replace=False)] + rng.normal(0, 0.3, (2000, 3))
    idx, d2 = cluster_nn_verified(jnp.asarray(y), jnp.asarray(x),
                                  group_size=256, probes=8)
    ref_idx, ref_d2 = _dense_nn(x, y)
    np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-12)


def test_cluster_knn_matches_topk():
    """k-NN distances must equal dense top-k distances (indices up to ties);
    with probes >= G the search is exhaustive and everything certifies, and
    at partial probes certified rows must still match exactly."""
    rng = np.random.default_rng(2)
    y = rng.uniform(-10, 10, size=(5_000, 3))
    x = rng.uniform(-10, 10, size=(700, 3))
    index = build_cluster_index(jnp.asarray(y), group_size=128)
    k = 16
    d2 = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    ref = np.sort(d2, axis=1)[:, :k]

    idx, d2k, cert = cluster_knn(index, jnp.asarray(x), k=k, probes=48)
    assert bool(jnp.all(cert))  # probes >= G: exhaustive
    np.testing.assert_allclose(np.sort(np.asarray(d2k), axis=1), ref, rtol=1e-12)
    # ascending order contract
    assert np.all(np.diff(np.asarray(d2k), axis=1) >= -1e-12)

    idx, d2k, cert = cluster_knn(index, jnp.asarray(x), k=k, probes=16)
    cert = np.asarray(cert)
    assert 0.5 < cert.mean()
    np.testing.assert_allclose(np.asarray(d2k)[cert], ref[cert], rtol=1e-12)


def test_certificate_is_sound():
    """With probes too small for an adversarial layout, wrong answers MUST
    be flagged uncertified (the certificate may under-claim, never lie)."""
    rng = np.random.default_rng(3)
    # many tight distant clusters: correct group is easy to miss with P=1
    centers = rng.uniform(-100, 100, size=(64, 3))
    y = (centers[:, None, :] + rng.normal(0, 0.1, (64, 32, 3))).reshape(-1, 3)
    x = rng.uniform(-100, 100, size=(500, 3))
    index = build_cluster_index(jnp.asarray(y), group_size=32)
    idx, d2, cert = cluster_nn(index, jnp.asarray(x), probes=1)
    ref_idx, ref_d2 = _dense_nn(x, y)
    wrong = np.asarray(d2) > ref_d2 * (1 + 1e-9)
    assert not np.any(wrong & np.asarray(cert)), \
        "certificate claimed exactness for a wrong answer"


def test_non_divisible_padding():
    """m not divisible by group_size: sentinel pads must never be returned."""
    rng = np.random.default_rng(4)
    y = rng.uniform(-5, 5, size=(777, 3))
    x = rng.uniform(-5, 5, size=(123, 3))
    index = build_cluster_index(jnp.asarray(y), group_size=128)
    idx, d2, cert = cluster_nn(index, jnp.asarray(x), probes=7)
    assert bool(jnp.all(cert))
    ref_idx, ref_d2 = _dense_nn(x, y)
    np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-12)
    assert np.asarray(idx).max() < 777


def test_vmap_batched():
    """build + query compose with vmap over a batch of clouds."""
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.uniform(-5, 5, size=(3, 800, 3)))
    x = jnp.asarray(rng.uniform(-5, 5, size=(3, 200, 3)))
    build = jax.vmap(lambda p: build_cluster_index(p, 128))
    index = build(y)
    idx, d2, cert = jax.vmap(lambda ix, q: cluster_nn(ix, q, probes=7))(index, x)
    assert idx.shape == (3, 200) and bool(jnp.all(cert))
    for b in range(3):
        _, ref_d2 = _dense_nn(np.asarray(x[b]), np.asarray(y[b]))
        np.testing.assert_allclose(np.asarray(d2[b]), ref_d2, rtol=1e-12)


def test_morton_keys_locality():
    """Morton keys must sort lattice neighbors near each other (sanity: the
    average index distance of spatial neighbors is far below random)."""
    rng = np.random.default_rng(6)
    y = rng.uniform(0, 1, size=(4096, 3)).astype(np.float32)
    keys = np.asarray(morton_keys(jnp.asarray(y)))
    order = np.argsort(keys)
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    # nearest spatial neighbor of 200 probes
    probe = rng.choice(4096, 200, replace=False)
    d2 = np.sum((y[probe][:, None] - y[None]) ** 2, axis=-1)
    d2[np.arange(200), probe] = np.inf
    nn = np.argmin(d2, axis=1)
    mean_gap = np.abs(pos[probe] - pos[nn]).mean()
    assert mean_gap < 4096 * 0.15, mean_gap  # random would be ~1365


def test_small_cloud_probes_exceed_groups():
    """probes >= G degenerates to certified dense search."""
    rng = np.random.default_rng(7)
    y = rng.uniform(-1, 1, size=(100, 3))
    x = rng.uniform(-1, 1, size=(40, 3))
    index = build_cluster_index(jnp.asarray(y), group_size=64)  # G = 2
    idx, d2, cert = cluster_nn(index, jnp.asarray(x), probes=8)
    assert bool(jnp.all(cert))
    ref_idx, ref_d2 = _dense_nn(x, y)
    np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-12)


def test_solver_cluster_matches_dense(planes_scene):
    """register() with nn_method='cluster' must match nn_method='dense'
    exactly (same correspondences -> identical iterates)."""
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register_jit

    xi = jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.01, 0.03])
    T_st = np.asarray(se3.vec2tran(xi))
    src = jnp.asarray(planes_scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    tgt = jnp.asarray(planes_scene)[None]
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50,
                     tolerance=1e-12, dim=3, trim_dist=2.0,
                     loss_name="huber", loss_metric=1.0)
    r_dense = register_jit(src, tgt, ti, None, cfg=base.with_(nn_method="dense"))
    r_clust = register_jit(src, tgt, ti, None,
                           cfg=base.with_(nn_method="cluster",
                                          cluster_group=64, cluster_probes=16))
    np.testing.assert_allclose(np.asarray(r_clust.T), np.asarray(r_dense.T),
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(r_clust.iterations),
                                  np.asarray(r_dense.iterations))


def test_solver_cluster_gradients(planes_scene):
    """Unrolled gradients through the cluster correspondence path: finite,
    nonzero, and equal to the dense path's (same gathered rows)."""
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register

    xi = jnp.asarray([0.05, -0.02, 0.04, 0.01, -0.01, 0.02])
    T_st = np.asarray(se3.vec2tran(xi))
    rng = np.random.default_rng(9)
    scene = planes_scene.copy()
    scene[:, :3] += rng.normal(scale=0.01, size=(scene.shape[0], 3))
    src = jnp.asarray(scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    tgt = jnp.asarray(scene)[None]
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    base = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=40,
                     tolerance=1e-12, dim=3)

    def loss(s, cfg):
        return jnp.sum(register(s, tgt, ti, None, cfg).T)

    g_dense = jax.grad(lambda s: loss(s, base.with_(nn_method="dense")))(src)
    g_clust = jax.grad(lambda s: loss(s, base.with_(nn_method="cluster",
                                                    cluster_group=64)))(src)
    assert np.all(np.isfinite(np.asarray(g_clust)))
    np.testing.assert_allclose(np.asarray(g_clust), np.asarray(g_dense),
                               atol=1e-10)


def test_batch_chunking_identical(source_np, target_np):
    """batch_chunk processes big batches in knee-sized lax.map chunks —
    results must be IDENTICAL to the unchunked solve (both drivers + IFT)."""
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.registration import register_jit

    B = 7  # deliberately not a multiple of the chunk
    src = jnp.asarray(np.stack([source_np[:, :3]] * B))
    # make elements distinct so chunking bugs can't hide
    src = src + jnp.arange(B, dtype=src.dtype)[:, None, None] * 1e-3
    tgt = jnp.asarray(np.stack([target_np] * B))
    ti = jnp.asarray(np.stack([np.eye(4)] * B))
    base = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=40,
                     tolerance=1e-10, dim=2, trim_dist=5.0,
                     loss_name="huber", loss_metric=1.0, driver="while")

    full = register_jit(src, tgt, ti, None, cfg=base)
    chunked = register_jit(src, tgt, ti, None, cfg=base.with_(batch_chunk=3))
    np.testing.assert_allclose(np.asarray(chunked.T), np.asarray(full.T), atol=0)
    np.testing.assert_array_equal(np.asarray(chunked.iterations),
                                  np.asarray(full.iterations))

    # IFT values + gradients chunk-invariant
    cfg_ift = base.with_(differentiable=True, driver="auto")
    g_full = jax.grad(lambda s: jnp.sum(
        register_ift(s, tgt, ti, None, cfg_ift).T))(src)
    g_chunk = jax.grad(lambda s: jnp.sum(
        register_ift(s, tgt, ti, None, cfg_ift.with_(batch_chunk=3)).T))(src)
    np.testing.assert_allclose(np.asarray(g_chunk), np.asarray(g_full),
                               atol=1e-12)


def test_normals_cluster_matches_dense():
    """estimate_normals via the cluster kNN equals the dense kNN normals."""
    from dicp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(12)
    # smooth surface: z = sin(x)cos(y) grid + jitter
    gx, gy = np.meshgrid(np.linspace(-3, 3, 45), np.linspace(-3, 3, 45))
    pts = np.column_stack([gx.ravel(), gy.ravel(),
                           np.sin(gx.ravel()) * np.cos(gy.ravel())])
    pts += rng.normal(scale=1e-3, size=pts.shape)
    p = jnp.asarray(pts)
    n_dense = estimate_normals(p, k=12, method="dense")
    n_clust = estimate_normals(p, k=12, method="cluster")
    # same neighborhoods -> same normals (up to eigensolver determinism)
    dots = np.abs(np.sum(np.asarray(n_dense) * np.asarray(n_clust), axis=-1))
    assert dots.min() > 1 - 1e-9, dots.min()


def test_pallas_block_search_parity():
    """The streaming candidate scan (the XLA block search) must reproduce
    the flat candidate-matrix argmin bit-for-bit (same diff-form
    arithmetic, lowest-offset tie rule), and the public entry agrees."""
    from dicp_tpu.ops.cluster_knn import (_block_select, _candidate_argmin_scan,
                                          _candidate_d2, _sorted_blocks)

    rng = np.random.default_rng(21)
    y = jnp.asarray(rng.uniform(-10, 10, size=(4000, 3)).astype(np.float32))
    x = jnp.asarray(rng.uniform(-10, 10, size=(2000, 3)).astype(np.float32))
    ix = build_cluster_index(y, 128)
    xb, inv, n = _sorted_blocks(ix, x)
    bsel, P = _block_select(ix, xb, 8)
    best_s, row_s = _candidate_argmin_scan(ix, xb, bsel)
    d2, pos = _candidate_d2(ix, xb, bsel)
    j = jnp.argmin(d2, axis=-1)
    best_x = jnp.take_along_axis(d2, j[..., None], -1)[..., 0]
    row_x = jnp.take_along_axis(pos, j, -1)
    np.testing.assert_allclose(np.asarray(best_s), np.asarray(best_x),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(row_s), np.asarray(row_x))

    # and through the public entry: certified answers are the dense ones
    idx_p, d2_p, cert_p = cluster_nn(ix, x, probes=8)
    assert idx_p.shape == (2000,)
    ref_idx, _ = _dense_nn(x, y)
    c = np.asarray(cert_p)
    np.testing.assert_array_equal(np.asarray(idx_p)[c], ref_idx[c])


def test_degenerate_clouds():
    """Index build + query on degenerate geometry: all-identical points
    (zero extent), collinear points, and duplicate-heavy clouds must not
    NaN/crash and must return valid certified answers."""
    # all points identical: extent guard -> all keys equal -> radius 0
    y = jnp.asarray(np.ones((300, 3)) * 5.0)
    x = jnp.asarray(np.array([[5.0, 5.0, 5.0], [6.0, 5.0, 5.0]]))
    index = build_cluster_index(y, group_size=64)
    idx, d2, cert = cluster_nn(index, x, probes=8)
    assert bool(jnp.all(cert))
    np.testing.assert_allclose(np.asarray(d2), [0.0, 1.0], atol=1e-12)
    assert np.all(np.asarray(idx) < 300)

    # collinear cloud (1-D extent; two axes degenerate)
    rng = np.random.default_rng(8)
    t = rng.uniform(-10, 10, 2000)
    y = jnp.asarray(np.column_stack([t, np.zeros_like(t), np.zeros_like(t)]))
    x = jnp.asarray(np.column_stack([t[:50] + 0.01, np.ones(50), np.zeros(50)]))
    idx, d2, cert = cluster_nn(build_cluster_index(y, 128), x, probes=8)
    ref_idx, ref_d2 = _dense_nn(np.asarray(x), np.asarray(y))
    cert = np.asarray(cert)
    np.testing.assert_allclose(np.asarray(d2)[cert], ref_d2[cert], rtol=1e-9)

    # duplicate-heavy cloud (ties everywhere): d2 must still be the true min
    base = rng.uniform(-1, 1, size=(100, 3))
    y = jnp.asarray(np.repeat(base, 20, axis=0))            # 2000 pts, 20x dup
    x = jnp.asarray(base + 1e-3)
    index = build_cluster_index(y, 128)
    idx, d2, cert = cluster_nn(index, x, probes=8)
    ref_idx, ref_d2 = _dense_nn(np.asarray(x), np.asarray(y))
    cert = np.asarray(cert)
    np.testing.assert_allclose(np.asarray(d2)[cert], ref_d2[cert], rtol=1e-9)
    # exhaustive probes: everything certified and exact despite the ties
    idx, d2, cert = cluster_nn(index, x, probes=16)       # = G
    assert bool(jnp.all(cert))
    np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-9)


def test_fixup_uncertified_exactness():
    """In-solver exactness escalation (``fixup``): with a budget covering
    the uncertified count every answer matches dense brute force exactly;
    with a smaller budget, certified entries still never lie (ADVICE r2:
    default-config correspondences must not silently deviate from the
    reference's exact NN, dICP/nn.py:32-38)."""
    rng = np.random.default_rng(3)
    m, n = 5000, 3000
    y = jnp.asarray(rng.uniform(-10, 10, (m, 3)))
    x = jnp.asarray(rng.uniform(-10, 10, (n, 3)))
    ref_idx, ref_d2 = _dense_nn(x, y)
    index = build_cluster_index(y, 64)

    # pathologically low probes: ~half the answers wrong without fixup
    idx0, _, c0 = cluster_nn(index, x, probes=2)
    n_unc = int((~np.asarray(c0)).sum())
    assert n_unc > 100  # the setup really does stress the certificate

    idx1, d1, c1 = cluster_nn(index, x, probes=2, fixup=n)
    assert bool(jnp.all(c1))
    d_true = jnp.sum((x - y[jnp.asarray(ref_idx)]) ** 2, axis=-1)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d_true), rtol=1e-12)
    # idx may differ from ref argmin only at exact-tie distances
    assert int((np.asarray(idx1) != ref_idx).sum()) == 0

    # partial budget: excess stays uncertified, certified entries exact
    idx2, d2, c2 = cluster_nn(index, x, probes=2, fixup=max(1, n_unc // 3))
    cert2 = np.asarray(c2)
    assert cert2.sum() < n  # over-budget queries correctly left unflagged
    np.testing.assert_array_equal(np.asarray(idx2)[cert2], ref_idx[cert2])

    # no uncertified queries: fixup is a no-op
    idx3, _, c3 = cluster_nn(index, x, probes=64, fixup=256)
    if bool(jnp.all(c3)):
        np.testing.assert_array_equal(np.asarray(idx3), ref_idx)


def test_fused_search_parity():
    """The XLA search pieces at a realistic block layout: the streaming
    candidate scan and the per-query bound must agree with brute force —
    every query whose found distance is within its bound is the dense
    answer, and fixup closes the rest."""
    from dicp_tpu.ops.cluster_knn import (_block_select,
                                          _candidate_argmin_scan,
                                          _query_bounds, _sorted_blocks,
                                          _unsort)

    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.uniform(-30, 30, (20000, 3)).astype(np.float32))
    x = jnp.asarray(rng.uniform(-30, 30, (4096, 3)).astype(np.float32))
    index = build_cluster_index(y, 128)
    ref_idx, ref_d2 = _dense_nn(x, y)

    xb, inv, n = _sorted_blocks(index, x)
    bsel, P = _block_select(index, xb, 16)
    best, rows = _candidate_argmin_scan(index, xb, bsel)
    bound = _query_bounds(index, xb, bsel)
    idx_s = np.asarray(_unsort(index.order[rows], inv, n))
    cert_s = np.asarray(_unsort(best <= bound, inv, n))
    assert cert_s.mean() > 0.5
    np.testing.assert_array_equal(idx_s[cert_s], ref_idx[cert_s])
    np.testing.assert_allclose(np.asarray(_unsort(best, inv, n))[cert_s],
                               ref_d2[cert_s], rtol=1e-5)

    # certificate soundness through the public path: certified answers
    # match dense brute force; fixup closes the rest
    idx_f, _, c_f = cluster_nn(index, x, probes=16)
    cf = np.asarray(c_f)
    np.testing.assert_array_equal(np.asarray(idx_f)[cf], ref_idx[cf])
    idx_all, _, c_all = cluster_nn(index, x, probes=16, fixup=x.shape[0])
    assert bool(jnp.all(c_all))
    np.testing.assert_array_equal(np.asarray(idx_all), ref_idx)

    # vmapped path (the batched-solver usage)
    idx_v, _, _ = jax.vmap(lambda q: cluster_nn(index, q, probes=16))(
        x.reshape(4, 1024, 3))
    assert idx_v.shape == (4, 1024)


def test_fused_topk_parity():
    """Cluster k-NN (the XLA _topk_small extraction) against dense
    brute-force k-NN: certified rows carry exactly the k smallest
    distances, in ascending order, for several (k, probes)."""
    from dicp_tpu.ops.cluster_knn import cluster_knn as _cknn

    rng = np.random.default_rng(21)
    y = jnp.asarray(rng.uniform(-30, 30, (20_000, 3)).astype(np.float32))
    x = jnp.asarray(rng.uniform(-30, 30, (2_048, 3)).astype(np.float32))
    index = build_cluster_index(y, 128)
    d2 = np.sum((np.asarray(x)[:, None, :] - np.asarray(y)[None, :, :]) ** 2,
                axis=-1)
    order = np.argsort(d2, axis=1, kind="stable")
    for k, probes in ((16, 16), (4, 32), (1, 16), (8, 32)):
        idx_c, d2_c, c_c = _cknn(index, x, k=k, probes=probes)
        cf = np.asarray(c_c)
        assert cf.any()
        if (k, probes) == (8, 32):
            assert cf.mean() > 0.5
        ref = np.take_along_axis(d2, order[:, :k], axis=1)
        np.testing.assert_allclose(np.asarray(d2_c)[cf], ref[cf], rtol=1e-5)
        assert np.all(np.diff(np.asarray(d2_c), axis=1) >= 0)
        np.testing.assert_array_equal(np.asarray(idx_c)[cf],
                                      order[:, :k][cf])


def test_fixup_tie_rule_duplicate_points():
    """Duplicate target points (voxel-snapped / repeated static returns):
    the brute-force fixup must resolve exact-distance ties to the lowest
    ORIGINAL row — the Hilbert-sorted stream order is not the original
    order (code-review r3)."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-10, 10, (1000, 3))
    y = jnp.asarray(np.concatenate([base, base]))   # every point duplicated
    x = jnp.asarray(base + rng.normal(scale=1e-3, size=base.shape))
    ref_idx, _ = _dense_nn(x, y)
    assert int(np.asarray(ref_idx).max()) < 1000    # ref picks the low copy
    index = build_cluster_index(y, 64)
    # force every query through the brute-force fixup path
    idx, _, cert = cluster_nn(index, x, probes=1, fixup=x.shape[0])
    fixed = np.asarray(cert)
    assert fixed.sum() > 0
    np.testing.assert_array_equal(np.asarray(idx)[fixed],
                                  np.asarray(ref_idx)[fixed])
