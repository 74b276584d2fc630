"""Implicit-function-theorem gradient tests: IFT backward must match the
unrolled-scan backward at a converged fixed point (BASELINE.json tolerance
1e-4; achieved ~1e-15 in f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu.config import ICPConfig
from dicp_tpu.ift import register_ift
from dicp_tpu.registration import register


def _cfg(**kw):
    base = dict(icp_type="pt2pl", differentiable=True, max_iterations=60,
                tolerance=1e-12, dim=2, trim_dist=5.0,
                loss_name="huber", loss_metric=1.0)
    base.update(kw)
    return ICPConfig(**base)


@pytest.mark.parametrize("icp_type,loss_name,loss_metric", [
    ("pt2pl", "huber", 1.0),
    ("pt2pl", "cauchy", 0.5),
    ("pt2pt", "huber", 1.0),
    ("pt2pl", None, 1.0),
    # redescending kernels: dw/de changes sign, exercising the exact
    # (non-Gauss-Newton) linearization in _stationarity_weighted
    ("pt2pl", "welsch", 10.0),
    ("pt2pl", "gm", 10.0),
])
def test_ift_matches_unrolled(source_np, target_np, icp_type, loss_name, loss_metric):
    cfg = _cfg(icp_type=icp_type, loss_name=loss_name, loss_metric=loss_metric)
    src = jnp.asarray(source_np[None, :, :3])
    tgt = jnp.asarray(target_np[None] if icp_type == "pt2pl" else target_np[None, :, :3])
    ti = jnp.eye(4, dtype=jnp.float64)[None]

    T_u = register(src, tgt, ti, None, cfg).T
    T_i = register_ift(src, tgt, ti, None, cfg).T
    np.testing.assert_allclose(np.asarray(T_u), np.asarray(T_i), atol=1e-12)

    g_u = jax.grad(lambda a: jnp.sum(register(a, tgt, ti, None, cfg).T))(src)
    g_i = jax.grad(lambda a: jnp.sum(register_ift(a, tgt, ti, None, cfg).T))(src)
    scale = np.abs(np.asarray(g_u)).max()
    np.testing.assert_allclose(np.asarray(g_i), np.asarray(g_u), atol=1e-6 * max(scale, 1))

    tg_u = jax.grad(lambda b: jnp.sum(register(src, b, ti, None, cfg).T))(tgt)
    tg_i = jax.grad(lambda b: jnp.sum(register_ift(src, b, ti, None, cfg).T))(tgt)
    scale = np.abs(np.asarray(tg_u)).max()
    np.testing.assert_allclose(np.asarray(tg_i), np.asarray(tg_u), atol=1e-6 * max(scale, 1))


def test_ift_3d():
    """Full 6-DOF problem on genuinely 3-D data (the planar test pair is
    gauge-degenerate in 3-D: out-of-plane motion is unobservable, both
    unrolled and implicit gradients blow up along the null directions)."""
    from dicp_tpu import se3

    rng = np.random.default_rng(0)
    # points on three planes with distinct normals -> well-conditioned pt2pl
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrms = [], []
    for k in range(3):
        uv = rng.uniform(-2, 2, size=(30, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (0.5 + k))
        nrms.append(np.tile(normals[k], (30, 1)))
    target = jnp.asarray(np.hstack([np.vstack(pts), np.vstack(nrms)]))
    xi = jnp.asarray(np.array([0.05, -0.04, 0.03, 0.02, -0.01, 0.03]))
    T_ts = se3.tran_inv(se3.vec2tran(xi))
    T_st = se3.vec2tran(xi)
    source = (target[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    tgt = target[None]
    ti = jnp.eye(4, dtype=jnp.float64)[None]

    cfg = _cfg(dim=3, max_iterations=80, trim_dist=None)
    T_u = register(source, tgt, ti, None, cfg).T
    err = np.abs(np.asarray(T_u[0]) - np.asarray(T_ts)).max()
    assert err < 1e-6, err

    g_u = jax.grad(lambda a: jnp.sum(register(a, tgt, ti, None, cfg).T))(source)
    g_i = jax.grad(lambda a: jnp.sum(register_ift(a, tgt, ti, None, cfg).T))(source)
    scale = max(np.abs(np.asarray(g_u)).max(), 1)
    np.testing.assert_allclose(np.asarray(g_i), np.asarray(g_u), atol=1e-5 * scale)


def test_ift_weight_gradients(source_np, target_np):
    """d T*/d weight: the clean test pair converges to zero residuals where
    this gradient vanishes identically — perturb the target so the fixed
    point balances nonzero residuals and the weight gradient is informative."""
    rng = np.random.default_rng(3)
    tgt_np = target_np.copy()
    tgt_np[:, :3] += rng.normal(scale=0.05, size=(tgt_np.shape[0], 3))
    tgt_np[:, 2] = 0.0  # keep planar (dim=2 zeroes z anyway)

    cfg = _cfg()
    src = jnp.asarray(source_np[None, :, :3])
    tgt = jnp.asarray(tgt_np[None])
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    w = jnp.ones(src.shape[:2], dtype=jnp.float64)

    g_u = jax.grad(lambda w_: jnp.sum(register(src, tgt, ti, w_, cfg).T))(w)
    g_i = jax.grad(lambda w_: jnp.sum(register_ift(src, tgt, ti, w_, cfg).T))(w)
    scale = np.abs(np.asarray(g_u)).max()
    assert scale > 1e-8, "weight gradient should be nontrivial on noisy data"
    np.testing.assert_allclose(np.asarray(g_i), np.asarray(g_u), atol=1e-6 * scale)


def test_ift_batched(source_np, target_np):
    cfg = _cfg()
    src = jnp.asarray(np.stack([source_np[:, :3]] * 3))
    tgt = jnp.asarray(np.stack([target_np] * 3))
    ti = jnp.asarray(np.stack([np.eye(4)] * 3))
    res = register_ift(src, tgt, ti, None, cfg)
    assert res.T.shape == (3, 4, 4)
    g = jax.grad(lambda a: jnp.sum(register_ift(a, tgt, ti, None, cfg).T))(src)
    assert np.all(np.isfinite(np.asarray(g)))


def test_ift_rejects_gumbel(source_np, target_np):
    cfg = _cfg(use_gumbel=True)
    with pytest.raises(ValueError):
        register_ift(jnp.asarray(source_np[None, :, :3]),
                     jnp.asarray(target_np[None]),
                     jnp.eye(4, dtype=jnp.float64)[None], None, cfg)


def test_ift_symmetric(planes_scene):
    """IFT gradients for symmetric ICP (round-1 gate removed) must match the
    unrolled backward; sources carry normals, so the (N, n, 6) source
    cotangent includes normal columns."""
    from dicp_tpu import se3

    xi = jnp.asarray(np.array([0.05, -0.04, 0.03, 0.02, -0.01, 0.03]))
    T_st = se3.vec2tran(xi)
    src6 = jnp.asarray(np.hstack(
        [planes_scene[:, :3] @ np.asarray(T_st)[:3, :3].T + np.asarray(T_st)[:3, 3],
         planes_scene[:, 3:6] @ np.asarray(T_st)[:3, :3].T]))[None]
    # perturb the target so the fixed point balances NONZERO residuals —
    # normal-column gradients are residual-scaled and vanish at an exact fit
    rng = np.random.default_rng(5)
    scene = planes_scene.copy()
    scene[:, :3] += rng.normal(scale=0.01, size=(scene.shape[0], 3))
    tgt = jnp.asarray(scene)[None]
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    cfg = _cfg(icp_type="symmetric", dim=3, max_iterations=80, trim_dist=None)

    T_u = register(src6, tgt, ti, None, cfg).T
    T_i = register_ift(src6, tgt, ti, None, cfg).T
    np.testing.assert_allclose(np.asarray(T_u), np.asarray(T_i), atol=1e-12)

    g_u = jax.grad(lambda a: jnp.sum(register(a, tgt, ti, None, cfg).T))(src6)
    g_i = jax.grad(lambda a: jnp.sum(register_ift(a, tgt, ti, None, cfg).T))(src6)
    scale = max(np.abs(np.asarray(g_u)).max(), 1)
    np.testing.assert_allclose(np.asarray(g_i), np.asarray(g_u), atol=1e-5 * scale)
    # normal-column gradients are genuinely nonzero for symmetric
    assert np.abs(np.asarray(g_u)[..., 3:6]).max() > 1e-8

    tg_u = jax.grad(lambda b: jnp.sum(register(src6, b, ti, None, cfg).T))(tgt)
    tg_i = jax.grad(lambda b: jnp.sum(register_ift(src6, b, ti, None, cfg).T))(tgt)
    scale = max(np.abs(np.asarray(tg_u)).max(), 1)
    np.testing.assert_allclose(np.asarray(tg_i), np.asarray(tg_u), atol=1e-5 * scale)


def test_ift_matches_finite_differences(source_np, target_np):
    """Ground-truth check AGAINST THE SOLVER ITSELF: central differences of
    the converged T* w.r.t. source, target, and weight entries.  Unlike the
    IFT-vs-unrolled comparison this cannot be fooled by an assumption shared
    by both autodiff paths (e.g. a wrong fixed-correspondence treatment)."""
    rng = np.random.default_rng(11)
    tgt_np = target_np.copy()
    tgt_np[:, :3] += rng.normal(scale=0.05, size=(tgt_np.shape[0], 3))
    tgt_np[:, 2] = 0.0
    cfg = _cfg(max_iterations=80, tolerance=1e-13)

    src0 = np.asarray(source_np[None, :, :3])
    tgt0 = np.asarray(tgt_np[None])
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    w0 = np.ones(src0.shape[:2])
    cot = rng.normal(size=(1, 4, 4))  # fixed random cotangent on T

    def f(s, t, w):
        T = register_ift(jnp.asarray(s), jnp.asarray(t), ti,
                         jnp.asarray(w), cfg).T
        return float(jnp.sum(T * jnp.asarray(cot)))

    g_s, g_t, g_w = jax.grad(
        lambda s, t, w: jnp.sum(register_ift(s, t, ti, w, cfg).T
                                * jnp.asarray(cot)),
        argnums=(0, 1, 2))(jnp.asarray(src0), jnp.asarray(tgt0),
                           jnp.asarray(w0))
    g_s, g_t, g_w = np.asarray(g_s), np.asarray(g_t), np.asarray(g_w)

    eps = 1e-6
    checked = 0
    for arr, grad in ((src0, g_s), (tgt0, g_t), (w0, g_w)):
        flat_idx = rng.choice(arr.size, size=6, replace=False)
        for fi in flat_idx:
            idx = np.unravel_index(fi, arr.shape)
            if arr is tgt0 and idx[-1] == 2:
                continue  # z column is zmasked in dim=2: gradient 0 vs FD 0
            plus, minus = arr.copy(), arr.copy()
            plus[idx] += eps
            minus[idx] -= eps
            args = [src0, tgt0, w0]
            pos = 0 if arr is src0 else (1 if arr is tgt0 else 2)
            args_p = list(args); args_p[pos] = plus
            args_m = list(args); args_m[pos] = minus
            fd = (f(*args_p) - f(*args_m)) / (2 * eps)
            ad = grad[idx]
            denom = max(abs(fd), abs(ad), 1e-6)
            assert abs(fd - ad) / denom < 1e-4, \
                f"idx {idx} (input {pos}): FD {fd} vs AD {ad}"
            checked += 1
    assert checked >= 12


def test_ift_const_iter_scan_forward(source_np, target_np):
    """const_iter: the IFT forward runs the fixed-count scan driver
    (serving shape, no convergence branches); T and gradients must match
    the while-driver IFT path once both are converged."""
    cfg_w = _cfg(max_iterations=60, tolerance=1e-12)
    cfg_f = cfg_w.with_(const_iter=True, max_iterations=20, driver="scan",
                        scan_unroll=4)
    src = jnp.asarray(source_np[None, :, :3])
    tgt = jnp.asarray(target_np[None])
    ti = jnp.eye(4, dtype=jnp.float64)[None]

    T_w = register_ift(src, tgt, ti, None, cfg_w).T
    T_f = register_ift(src, tgt, ti, None, cfg_f).T
    np.testing.assert_allclose(np.asarray(T_f), np.asarray(T_w), atol=1e-10)

    g_w = jax.grad(lambda s: jnp.sum(register_ift(s, tgt, ti, None, cfg_w).T))(src)
    g_f = jax.grad(lambda s: jnp.sum(register_ift(s, tgt, ti, None, cfg_f).T))(src)
    np.testing.assert_allclose(np.asarray(g_f), np.asarray(g_w), atol=1e-8)


def test_ift_cluster_backend(planes_scene):
    """IFT gradients with nn_method='cluster': the fixed-point backward's
    correspondence resolution must match the dense backend's gradients."""
    from dicp_tpu import se3

    xi = jnp.asarray(np.array([0.05, -0.04, 0.03, 0.02, -0.01, 0.03]))
    T_st = np.asarray(se3.vec2tran(xi))
    rng = np.random.default_rng(6)
    scene = planes_scene.copy()
    scene[:, :3] += rng.normal(scale=0.01, size=(scene.shape[0], 3))
    src = jnp.asarray(scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    tgt = jnp.asarray(scene)[None]
    ti = jnp.eye(4, dtype=jnp.float64)[None]
    base = _cfg(icp_type="pt2pl", dim=3, max_iterations=60, trim_dist=None)

    g_d = jax.grad(lambda s: jnp.sum(register_ift(
        s, tgt, ti, None, base.with_(nn_method="dense")).T))(src)
    g_c = jax.grad(lambda s: jnp.sum(register_ift(
        s, tgt, ti, None, base.with_(nn_method="cluster",
                                     cluster_group=64)).T))(src)
    np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_d), atol=1e-10)


def test_ift_with_fused_forward(test_pair):
    """IFT gradients of the histories-off f32 serving forward (early-exit
    while driver): value and gradient must match the f64 solve of the same
    problem closely (the fixed points agree to ~f32 resolution, and the
    backward's matmul precision is pinned)."""
    source_np, target_np = test_pair
    base = ICPConfig(icp_type="pt2pl", differentiable=True,
                     max_iterations=80, tolerance=1e-6, dim=2,
                     trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     collect_histories=False, nn_method="dense")

    outs = {}
    for dt in (jnp.float32, jnp.float64):
        src = jnp.asarray(source_np[:, :3], dt)[None]
        tgt = jnp.asarray(target_np, dt)[None]
        ti = jnp.eye(4, dtype=dt)[None]
        val, g = jax.value_and_grad(
            lambda s: jnp.sum(register_ift(s, tgt, ti, None, base).T))(src)
        assert g.dtype == dt
        outs[dt] = (float(val), np.asarray(g, np.float64))
    v0, g0 = outs[jnp.float64]
    v1, g1 = outs[jnp.float32]
    assert abs(v0 - v1) < 1e-4 * max(1.0, abs(v0))
    cos = float(np.sum(g0 * g1) /
                (np.linalg.norm(g0) * np.linalg.norm(g1)))
    assert cos > 0.9999, cos
