"""End-to-end ICP tests: port of the reference suite (tests/test_ICP.py) with
our se3 module replacing pylgmath for ground truth, plus JAX-native gradient
checks (jax.grad instead of .backward())."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu import se3
from dicp_tpu.api import ICP
from dicp_tpu.svd_icp import pt2pt_svd_icp

MAX_ITER = 100
TOL = 1e-10


def _truth():
    """Ground-truth transform of the reference tests (tests/test_ICP.py:45-47):
    xi = [1, 1, 0, 0, 0, 0.1], T_ts_true = inv(vec2tran(xi))."""
    xi = jnp.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=jnp.float64)
    return np.asarray(se3.tran_inv(se3.vec2tran(xi)))


def _err_norm(T_true, T_pred):
    e = se3.tran2vec(jnp.asarray(T_true) @ jnp.linalg.inv(jnp.asarray(T_pred)))
    return float(jnp.linalg.norm(e))


def test_pt2pt_dicp(source_np, target_np):
    """Differentiable pt2pt (port of tests/test_ICP.py:35-78)."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np[:, :3])
    T_true = _truth()
    T_init = jnp.eye(4, dtype=source.dtype)
    loss_fn = {"name": "huber", "metric": 1.0}

    solver = ICP(icp_type="pt2pt", differentiable=True,
                 max_iterations=MAX_ITER, tolerance=TOL)
    res = solver.icp(source, target, T_init, trim_dist=5.0, loss_fn=loss_fn, dim=2)
    T_pred = np.asarray(res["T"][0])

    assert _err_norm(T_true, T_pred) < TOL
    np.testing.assert_allclose(np.asarray(res["pc"][0]), np.asarray(target), atol=1e-5)

    # Gradients of sum(T) w.r.t. both clouds exist and are finite.
    def f(src, tgt):
        r = solver.icp(src, tgt, T_init, trim_dist=5.0, loss_fn=loss_fn, dim=2)
        return jnp.sum(r["T"])

    gs, gt = jax.grad(f, argnums=(0, 1))(source, target)
    assert np.all(np.isfinite(np.asarray(gs)))
    assert np.all(np.isfinite(np.asarray(gt)))
    assert np.any(np.asarray(gs) != 0)


def test_pt2pl_dicp(source_np, target_np):
    """Differentiable pt2pl (port of tests/test_ICP.py:80-117)."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np)
    T_true = _truth()
    T_init = jnp.eye(4, dtype=source.dtype)
    loss_fn = {"name": "huber", "metric": 10.0}

    solver = ICP(icp_type="pt2pl", differentiable=True,
                 max_iterations=MAX_ITER, tolerance=TOL)
    res = solver.icp(source, target, T_init, trim_dist=5.0, loss_fn=loss_fn, dim=2)
    T_pred = np.asarray(res["T"][0])

    assert _err_norm(T_true, T_pred) < TOL
    np.testing.assert_allclose(np.asarray(res["pc"][0]), np.asarray(target[:, :3]), atol=1e-5)

    def f(src, tgt):
        r = solver.icp(src, tgt, T_init, trim_dist=5.0, loss_fn=loss_fn, dim=2)
        return jnp.sum(r["T"])

    gs, gt = jax.grad(f, argnums=(0, 1))(source, target)
    assert np.all(np.isfinite(np.asarray(gs)))
    assert np.all(np.isfinite(np.asarray(gt)))
    assert np.any(np.asarray(gs) != 0) and np.any(np.asarray(gt) != 0)


def test_grads_finite_at_exact_fixed_point(source_np, target_np):
    """Regression: the test clouds are exact transforms of each other, so at
    convergence many residuals are exactly 0.0.  torch's norm has a zero
    subgradient there; a naive jnp.linalg.norm gives NaN and poisons the
    whole backward pass.  Config chosen to converge well inside the budget."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np)
    solver = ICP(icp_type="pt2pl", differentiable=True,
                 max_iterations=25, tolerance=1e-8)

    def f(src):
        r = solver.icp(src, target, jnp.eye(4, dtype=src.dtype), trim_dist=5.0,
                       loss_fn={"name": "huber", "metric": 1.0}, dim=2)
        return jnp.sum(r["T"])

    g = jax.grad(f)(source)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0)


def test_pt2pt_icp_nondiff(source_np, target_np):
    """Non-differentiable pt2pt (port of tests/test_ICP.py:119-149)."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np[:, :3])
    T_true = _truth()
    T_init = jnp.eye(4, dtype=source.dtype)
    loss_fn = {"name": "huber", "metric": 10.0}

    solver = ICP(icp_type="pt2pt", differentiable=False,
                 max_iterations=MAX_ITER, tolerance=TOL)
    res = solver.icp(source, target, T_init, trim_dist=5.0, loss_fn=loss_fn, dim=2)
    T_pred = np.asarray(res["T"][0])

    assert _err_norm(T_true, T_pred) < TOL
    np.testing.assert_allclose(np.asarray(res["pc"][0]), np.asarray(target), atol=1e-5)


def test_results_dict_contract(source_np, target_np):
    """Results dict keys/shapes match the reference (dICP/ICP.py:288-303)."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np)
    solver = ICP(icp_type="pt2pl", differentiable=True,
                 max_iterations=25, tolerance=1e-8)
    res = solver.icp(source, target, jnp.eye(4, dtype=source.dtype),
                     trim_dist=5.0, loss_fn={"name": "huber", "metric": 1.0}, dim=2)
    assert set(res) == {"pc", "T", "costs", "deltas", "weights", "stats"}
    assert set(res["stats"]) == {"converged", "iterations", "matched_ratio"}
    N, n = 1, source.shape[0]
    it = res["deltas"].shape[1]
    assert res["pc"].shape == (N, n, 3)
    assert res["T"].shape == (N, 4, 4)
    assert res["deltas"].shape == (N, it, 6, 1)
    assert res["weights"].shape == (N, it, n, 1)
    assert res["costs"].shape == (N, it, 1)
    assert bool(res["stats"]["converged"][0])
    assert 1 <= float(res["stats"]["iterations"][0]) <= 25
    assert 0.0 < float(res["stats"]["matched_ratio"][0]) <= 1.0
    # costs non-increasing-ish after first iterations (sanity, not exact)
    costs = np.asarray(res["costs"][0, :, 0])
    assert costs[-1] <= costs[0]


def test_pt2pt_svd(source_np, target_np):
    """Batched SVD ICP recovers the same transform (BASELINE config #1;
    reference orphan at dICP/ICP.py:534-591)."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np[:, :3])
    T_true = _truth()

    res = pt2pt_svd_icp(source, target, max_iterations=200, tolerance=1e-18,
                        differentiable=False)
    # SVD pt2pt without trimming on this exact-overlap pair: tight match.
    assert _err_norm(T_true, np.asarray(res.T)) < 1e-5
    np.testing.assert_allclose(np.asarray(res.pc), np.asarray(target), atol=1e-4)


def test_pt2pt_svd_batched_and_diff(source_np, target_np):
    source = jnp.asarray(np.stack([source_np[:, :3]] * 3))
    target = jnp.asarray(np.stack([target_np[:, :3]] * 3))
    res = pt2pt_svd_icp(source, target, max_iterations=100, tolerance=1e-16,
                        differentiable=True)
    T_true = _truth()
    for i in range(3):
        assert _err_norm(T_true, np.asarray(res.T[i])) < 1e-4

    def f(src):
        return jnp.sum(pt2pt_svd_icp(src, target, max_iterations=10,
                                     tolerance=1e-16, differentiable=True).T)

    g = jax.grad(f)(source)
    assert np.all(np.isfinite(np.asarray(g)))


def test_gumbel_icp_converges(source_np, target_np):
    """Gumbel-softmax NN inside the full solve (config functionality block,
    config/dICP_config.yaml:12-14) with explicit PRNG key."""
    source = jnp.asarray(source_np[:, :3])
    target = jnp.asarray(target_np)
    solver = ICP(icp_type="pt2pl", differentiable=True,
                 max_iterations=50, tolerance=1e-8)
    solver.use_gumbel = True
    res = solver.icp(source, target, jnp.eye(4, dtype=source.dtype),
                     trim_dist=5.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=2, key=jax.random.key(0))
    # Soft correspondences + Gumbel noise bias the fixed point (the reference
    # never exercises Gumbel inside ICP); require a nearby, finite solution.
    assert _err_norm(_truth(), np.asarray(res["T"][0])) < 0.5
    assert np.all(np.isfinite(np.asarray(res["T"])))


def test_svd_degenerate_inputs_no_nan(source_np):
    """All-trimmed / coincident clouds must return finite identity-ish
    transforms, not NaN (power-iteration underflow regression)."""
    from dicp_tpu.svd_icp import pt2pt_svd_icp

    src = jnp.asarray(source_np[:, :3])
    # target far away + tiny trim -> every point trimmed every iteration
    res = pt2pt_svd_icp(src, src + 5.0, trim_dist=0.1, differentiable=False,
                        max_iterations=10)
    assert np.all(np.isfinite(np.asarray(res.T)))
    # negative trim is ignored (parity with the GN path)
    res2 = pt2pt_svd_icp(src, src, trim_dist=-1.0, differentiable=False,
                         max_iterations=5)
    assert np.all(np.isfinite(np.asarray(res2.T)))
    np.testing.assert_allclose(np.asarray(res2.T), np.eye(4), atol=1e-6)


def test_svd_180_degree_alignment():
    """Kabsch must recover a 180-degree rotation (the identity-quaternion
    power-iteration seed is exactly orthogonal to that eigenvector)."""
    from dicp_tpu.svd_icp import _kabsch

    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.normal(size=(1, 200, 3)))
    Rz = jnp.asarray(np.diag([-1.0, -1.0, 1.0]))  # 180 deg about z
    q = p @ Rz.T
    C, r = _kabsch(p, q, jnp.ones((1, 200)))
    np.testing.assert_allclose(np.asarray(C[0]), np.asarray(Rz), atol=1e-6)
    np.testing.assert_allclose(np.asarray(r[0]), 0.0, atol=1e-8)


def test_svd_180_degree_blind_axes():
    """180-degree rotations about axes with ux+uy+uz=0 — orthogonal to BOTH
    of the original two power-iteration seeds ([1,0,0,0] and [0,1,1,1]); the
    complementary vector-part seeds must recover them to full precision."""
    from dicp_tpu.svd_icp import _kabsch

    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.normal(size=(1, 200, 3)))
    for u in ([1.0, -1.0, 0.0], [1.0, 0.0, -1.0], [0.0, 1.0, -1.0],
              [1.0, 1.0, -2.0]):
        u = np.asarray(u) / np.linalg.norm(u)
        R = jnp.asarray(2.0 * np.outer(u, u) - np.eye(3))  # 180 deg about u
        q = p @ R.T
        C, r = _kabsch(p, q, jnp.ones((1, 200)))
        np.testing.assert_allclose(np.asarray(C[0]), np.asarray(R), atol=1e-6,
                                   err_msg=f"axis {u}")
        np.testing.assert_allclose(np.asarray(r[0]), 0.0, atol=1e-8)


def test_find_nn_pallas_grad(source_np, target_np):
    """jax.grad through find_nn's Pallas dispatch path (pallas_call has no
    AD rule; the index must be computed under stop_gradient)."""
    from dicp_tpu import knn

    x = jnp.asarray(source_np[:, :3])
    y = jnp.asarray(target_np)

    def loss(y_):
        out = knn.find_nn(x, y_, differentiable=True, use_pallas=True)
        return jnp.sum(out ** 2)

    g = jax.grad(loss)(y)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0)


def test_three_point_clouds_not_transposed(target_np):
    """Regression: the public NN shape heuristic misreads n==3 clouds as
    (3, n) layout; the solver must bypass it for its internal normalized
    arrays."""
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register_jit

    # 3 source points drawn from the map; truth = identity
    src = jnp.asarray(target_np[:3, :3][None])
    tgt = jnp.asarray(target_np[None])
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=20,
                    tolerance=1e-10, dim=2)
    res = register_jit(src, tgt, jnp.eye(4, dtype=jnp.float64)[None], None, cfg=cfg)
    np.testing.assert_allclose(np.asarray(res.T[0]), np.eye(4), atol=1e-8)


def _planes_scene(rng, n=600):
    """Three orthogonal noisy planes with exact normals, both columns."""
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-5, 5, size=(n // 3, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (n // 3, 1)))
    return np.hstack([np.vstack(pts), np.vstack(nrm)])


def test_symmetric_icp_recovers_transform():
    """Symmetric point-to-plane (Rusinkiewicz 2019): residual along the sum
    of both clouds' normals; must recover the truth on a 3-D scene."""
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register_jit

    rng = np.random.default_rng(0)
    scene = _planes_scene(rng)
    xi = jnp.asarray([0.3, -0.2, 0.1, 0.04, -0.02, 0.05])
    T_st = se3.vec2tran(xi)
    src_pts = scene[:, :3] @ np.asarray(T_st)[:3, :3].T + np.asarray(T_st)[:3, 3]
    src_nrm = scene[:, 3:6] @ np.asarray(T_st)[:3, :3].T
    source = jnp.asarray(np.hstack([src_pts, src_nrm]))[None]
    target = jnp.asarray(scene)[None]

    cfg = ICPConfig(icp_type="symmetric", differentiable=False,
                    max_iterations=60, tolerance=1e-12, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0)
    res = register_jit(source, target, jnp.eye(4, dtype=jnp.float64)[None],
                       None, cfg=cfg)
    T_true = se3.tran_inv(T_st)
    err = float(jnp.linalg.norm(se3.tran2vec(
        se3.compose(T_true, se3.tran_inv(res.T[0])))))
    assert bool(res.converged[0])
    assert err < 1e-9, f"symmetric err {err}"

    # symmetric converges at least as fast as plain pt2pl on the same data
    cfg_pl = cfg.with_(icp_type="pt2pl")
    res_pl = register_jit(source, target, jnp.eye(4, dtype=jnp.float64)[None],
                          None, cfg=cfg_pl)
    assert float(res.iterations[0]) <= float(res_pl.iterations[0]) + 1


def test_symmetric_icp_differentiable():
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register

    rng = np.random.default_rng(1)
    scene = _planes_scene(rng, n=300)
    source = jnp.asarray(scene)[None]
    target = jnp.asarray(scene)[None]
    cfg = ICPConfig(icp_type="symmetric", differentiable=True,
                    max_iterations=10, tolerance=1e-10, dim=3)

    g = jax.grad(lambda s: jnp.sum(register(s, target,
                                            jnp.eye(4, dtype=jnp.float64)[None],
                                            None, cfg).T))(source)
    assert np.all(np.isfinite(np.asarray(g)))


def test_symmetric_requires_normals():
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register

    cfg = ICPConfig(icp_type="symmetric", dim=3)
    with pytest.raises(ValueError, match="normals on BOTH"):
        register(jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 6)),
                 jnp.eye(4)[None], None, cfg)


def test_register_vmappable(source_np, target_np):
    """The functional core composes with jax.vmap (nested batching: an outer
    vmap over parameter sets on top of the solver's own batch dim)."""
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register

    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=20,
                    tolerance=1e-8, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)
    src = jnp.asarray(np.stack([source_np[:, :3]] * 2))[None].repeat(3, axis=0)
    tgt = jnp.asarray(np.stack([target_np] * 2))[None].repeat(3, axis=0)
    ti = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float64), (3, 2, 4, 4))

    out = jax.vmap(lambda s, t, i: register(s, t, i, None, cfg).T)(src, tgt, ti)
    assert out.shape == (3, 2, 4, 4)
    assert np.all(np.isfinite(np.asarray(out)))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(out[2]), atol=1e-12)


def test_symmetric_api_class(planes_scene):
    """Symmetric ICP through the drop-in ICP class (round-1 gate removed):
    the normalizer must keep 6-column sources, dense and ragged-list."""
    from dicp_tpu import se3
    from dicp_tpu.api import ICP

    xi = jnp.asarray([0.2, -0.1, 0.15, 0.03, -0.02, 0.04])
    T_st = np.asarray(se3.vec2tran(xi))
    src6 = np.hstack([planes_scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3],
                      planes_scene[:, 3:6] @ T_st[:3, :3].T])
    T_true = np.asarray(se3.tran_inv(jnp.asarray(T_st)))

    solver = ICP(icp_type="symmetric", differentiable=False,
                 max_iterations=60, tolerance=1e-12)
    res = solver.icp(jnp.asarray(src6), jnp.asarray(planes_scene), jnp.eye(4),
                     trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=3)
    err = float(jnp.linalg.norm(se3.tran2vec(
        jnp.asarray(T_true) @ jnp.linalg.inv(res["T"][0]))))
    assert err < 1e-9, err

    # ragged list batch: a 150-point subset and the full cloud
    res2 = solver.icp([jnp.asarray(src6[:150]), jnp.asarray(src6)],
                      [jnp.asarray(planes_scene)] * 2, jnp.eye(4),
                      trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                      dim=3)
    err2 = float(jnp.linalg.norm(se3.tran2vec(
        jnp.asarray(T_true) @ jnp.linalg.inv(res2["T"][1]))))
    assert err2 < 1e-9, err2

    # 3-column sources are a clear error, not silent corruption
    with pytest.raises(ValueError, match="6-column"):
        solver.icp(jnp.asarray(src6[:, :3]), jnp.asarray(planes_scene),
                   jnp.eye(4), dim=3)


def test_symmetric_zero_source_normals_equals_pt2pl(source_np, target_np):
    """With all-zero source normals the symmetric residual reduces exactly
    to pt2pl — the class path must reproduce the pt2pl solution on the
    reference pair (whose scan has zero normal columns)."""
    from dicp_tpu.api import ICP

    kw = dict(trim_dist=5.0, loss_fn={"name": "huber", "metric": 1.0}, dim=2)
    sym = ICP(icp_type="symmetric", differentiable=False,
              max_iterations=50, tolerance=1e-10)
    pl = ICP(icp_type="pt2pl", differentiable=False,
             max_iterations=50, tolerance=1e-10)
    res_s = sym.icp(jnp.asarray(source_np), jnp.asarray(target_np),
                    jnp.eye(4), **kw)
    res_p = pl.icp(jnp.asarray(source_np), jnp.asarray(target_np),
                   jnp.eye(4), **kw)
    np.testing.assert_allclose(np.asarray(res_s["T"]), np.asarray(res_p["T"]),
                               atol=1e-12)


@pytest.mark.parametrize("driver", ["scan", "while"])
def test_collect_histories_off(source_np, target_np, driver):
    """collect_histories=False: identical T/stats, length-1 history
    placeholders carrying the final weights/costs, both drivers."""
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register_jit

    base = ICPConfig(icp_type="pt2pl", differentiable=(driver == "scan"),
                     driver=driver, max_iterations=50, tolerance=1e-10,
                     dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
    src = jnp.asarray(source_np[None, :, :3])
    tgt = jnp.asarray(target_np[None])
    ti = jnp.eye(4, dtype=jnp.float64)[None]

    full = register_jit(src, tgt, ti, None, cfg=base)
    slim = register_jit(src, tgt, ti, None, cfg=base.with_(collect_histories=False))
    np.testing.assert_allclose(np.asarray(slim.T), np.asarray(full.T), atol=0)
    np.testing.assert_allclose(np.asarray(slim.iterations),
                               np.asarray(full.iterations), atol=0)
    np.testing.assert_allclose(np.asarray(slim.matched_ratio),
                               np.asarray(full.matched_ratio), atol=0)
    assert slim.weights.shape[1] == 1 and slim.costs.shape[1] == 1
    # placeholder holds the final carry-forward values
    k = int(full.iterations.max()) - 1
    np.testing.assert_allclose(np.asarray(slim.weights[:, 0]),
                               np.asarray(full.weights[:, k]), atol=0)
    np.testing.assert_allclose(np.asarray(slim.costs[:, 0]),
                               np.asarray(full.costs[:, k]), atol=0)


def test_icp_class_tpu_kwargs(planes_scene):
    """Solver config knobs pass through the drop-in ICP constructor."""
    from dicp_tpu import se3
    from dicp_tpu.api import ICP

    xi = jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.01, 0.03])
    T_st = np.asarray(se3.vec2tran(xi))
    src = jnp.asarray(planes_scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=50,
                 tolerance=1e-12, nn_method="cluster", cluster_group=64,
                 collect_histories=False)
    assert solver._base_cfg.nn_method == "cluster"
    res = solver.icp(src, jnp.asarray(planes_scene), jnp.eye(4),
                     trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=3)
    T_true = np.asarray(se3.tran_inv(jnp.asarray(T_st)))
    err = float(jnp.linalg.norm(se3.tran2vec(
        jnp.asarray(T_true) @ jnp.linalg.inv(res["T"][0]))))
    assert err < 1e-9, err
    assert res["weights"].shape[1] == 1  # collect_histories=False placeholder
