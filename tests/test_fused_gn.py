"""Parity tests for the histories-off f32 early-exit solve.

The inference path that small-pair serving uses is the XLA ``while``
driver (registration._run_while, mirroring dICP/ICP.py:132-303) in f32
with histories off.  Each test solves one batch that way and compares
every ICPResult field with an f64 solve of the SAME inputs through the
fixed-trip ``scan`` driver — a different driver and twice the precision.
Scenes have unique exact matches, so both converge decisively at the same
iteration; the 1e-5 comparison tolerance sits far above f32 resolution.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dicp_tpu.config import ICPConfig
from dicp_tpu.registration import register


def _make_batch(B, n, m, dim, normals, seed=0):
    """Host-f64 random scene: target = permuted exact transform of source.

    Every query has a UNIQUE exact match (m >= n; extra target rows are far
    outliers that never win NN), so convergence is decisively quadratic —
    sampled-with-replacement targets leave queries with no exact match and
    can produce neighbor-flip limit cycles where delta_norm never crosses
    the tolerance (observed: period-3 cycle at 3e-3)."""
    assert m >= n
    rng = np.random.RandomState(seed)
    src = rng.uniform(-2.0, 2.0, (B, n, 3))
    if dim == 2:
        src[..., 2] = 0.0
    th = rng.uniform(-0.15, 0.15, B)
    Ts = []
    for b in range(B):
        c, s = np.cos(th[b]), np.sin(th[b])
        C = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([0.1 * rng.randn(), 0.1 * rng.randn(), 0.0])
        Ts.append((C, t))
    tgt_pts = np.stack(
        [np.concatenate([src[b][rng.permutation(n)],
                         rng.uniform(50.0, 60.0, (m - n, 3))])
         @ Ts[b][0].T + Ts[b][1] for b in range(B)])
    if normals:
        nrm = rng.randn(B, m, 3)
        if dim == 2:
            nrm[..., 2] = 0.0
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        tgt = np.concatenate([tgt_pts, nrm], axis=-1)
    else:
        tgt = tgt_pts
    T_init = np.broadcast_to(np.eye(4), (B, 4, 4)).copy()
    return (jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32),
            jnp.asarray(T_init, jnp.float32))


def _compare(cfg_base, src, tgt, weight=None, tol=1e-5):
    """f32 while driver (histories off) vs an f64 scan-driver reference."""
    cfg_f = cfg_base.with_(driver="while", collect_histories=False)
    cfg_r = cfg_base.with_(driver="scan", collect_histories=False)
    f64 = (lambda a: None if a is None else jnp.asarray(a, jnp.float64))
    T_init = jnp.broadcast_to(jnp.eye(4, dtype=src.dtype),
                              (src.shape[0], 4, 4))
    rf = register(src, tgt, T_init, weight, cfg_f)
    rx = register(f64(src), f64(tgt), f64(T_init), f64(weight), cfg_r)
    assert rf.T.dtype == jnp.float32 and rx.T.dtype == jnp.float64
    np.testing.assert_allclose(rf.T, rx.T, atol=tol, rtol=0)
    np.testing.assert_allclose(rf.pc, rx.pc, atol=10 * tol, rtol=0)
    np.testing.assert_array_equal(np.asarray(rf.converged),
                                  np.asarray(rx.converged))
    np.testing.assert_allclose(rf.iterations, rx.iterations, atol=0)
    np.testing.assert_allclose(rf.matched_ratio, rx.matched_ratio, atol=1e-6)
    np.testing.assert_allclose(rf.weights, rx.weights, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(rf.costs, rx.costs, atol=1e-5, rtol=1e-3)
    assert rf.deltas.shape == rx.deltas.shape
    return rf, rx


# tolerance 1e-5: decisively above the f32 fixed-point noise floor (~1e-7)
# so the convergence-crossing iteration is identical in f32 and f64 (random
# normals give a nonzero-residual fixed point where delta_norm can hover).
BASE = ICPConfig(differentiable=False, driver="while", collect_histories=False,
                 max_iterations=40, tolerance=1e-5, nn_method="dense")


def test_pt2pl_dim2_huber_trim():
    src, tgt, _ = _make_batch(9, 65, 65, dim=2, normals=True, seed=1)
    cfg = BASE.with_(icp_type="pt2pl", dim=2, loss_name="huber",
                     loss_metric=1.0, trim_dist=5.0)
    rf, _ = _compare(cfg, src, tgt)
    assert bool(jnp.all(rf.converged))


def test_pt2pt_dim3_cauchy():
    src, tgt, _ = _make_batch(8, 40, 48, dim=3, normals=False, seed=2)
    cfg = BASE.with_(icp_type="pt2pt", dim=3, loss_name="cauchy",
                     loss_metric=2.0)
    _compare(cfg, src, tgt)


def test_pt2pl_dim3_no_loss():
    src, tgt, _ = _make_batch(4, 33, 57, dim=3, normals=True, seed=3)
    cfg = BASE.with_(icp_type="pt2pl", dim=3)
    _compare(cfg, src, tgt)


def test_pt2pt_dim2_trim_nondiff_gate():
    # hard indicator trim (differentiable=False) + prior weights with zeros
    src, tgt, _ = _make_batch(5, 40, 40, dim=2, normals=False, seed=4)
    w = jnp.asarray(np.random.RandomState(5).rand(5, 40) > 0.2,
                    jnp.float32)
    cfg = BASE.with_(icp_type="pt2pt", dim=2, trim_dist=3.0)
    _compare(cfg, src, tgt, weight=w)


def test_soft_weights_forced_while():
    # differentiable=True weight formulas under the while driver
    src, tgt, _ = _make_batch(6, 50, 50, dim=2, normals=True, seed=6)
    cfg = BASE.with_(icp_type="pt2pl", dim=2, differentiable=True,
                     loss_name="huber", loss_metric=1.0, trim_dist=5.0)
    _compare(cfg, src, tgt)


def test_reference_pair_accuracy():
    """The f32 solve recovers the reference test-pair transform."""
    import os.path as osp
    d = osp.join(osp.dirname(__file__), "data")
    src = np.load(osp.join(d, "points_scan.npy"))[None, :, :3]
    tgt = np.load(osp.join(d, "points_map.npy"))[None]
    # tolerance 1e-4: f32 rounding in the first large steps leaves the 5th
    # step at ~3e-5 in f32 against ~3e-6 in f64; 1e-4 makes the crossing
    # decisive in both (the quadratic tail is then below 1e-6)
    cfg = BASE.with_(icp_type="pt2pl", dim=2, loss_name="huber",
                     loss_metric=1.0, trim_dist=5.0, max_iterations=60,
                     tolerance=1e-4)
    src8 = jnp.asarray(np.repeat(src, 8, axis=0), jnp.float32)
    tgt8 = jnp.asarray(np.repeat(tgt, 8, axis=0), jnp.float32)
    rf, rx = _compare(cfg, src8, tgt8, tol=3e-5)
    # both must land on the reference fixed point (f32 floor ~1e-6)
    from dicp_tpu import se3
    err = se3.tran2vec(rf.T[0] @ jnp.linalg.inv(rx.T[0]))
    assert float(jnp.linalg.norm(err)) < 1e-5


def test_batch_padding():
    # odd batch size with one early-converging element per batch
    src, tgt, _ = _make_batch(5, 30, 30, dim=2, normals=True, seed=7)
    cfg = BASE.with_(icp_type="pt2pl", dim=2, loss_name="huber")
    _compare(cfg, src, tgt)


def test_trim_loss_custom_steepness():
    # loss_name='trim' with a NON-default tanh_steepness: the solve must
    # thread cfg.tanh_steepness into the soft trim LOSS weight, not just the
    # trim_dist gate
    src, tgt, _ = _make_batch(4, 40, 40, dim=2, normals=False, seed=9)
    cfg = BASE.with_(icp_type="pt2pt", dim=2, differentiable=True,
                     loss_name="trim", loss_metric=2.0, trim_dist=None,
                     tanh_steepness=2.0)
    _compare(cfg, src, tgt)


@pytest.mark.parametrize("loss", ["huber", "cauchy", "welsch", "gm", "trim",
                                  None])
@pytest.mark.parametrize("icp_type,dim", [("pt2pl", 3), ("pt2pt", 2)])
def test_loss_zoo_parity(loss, icp_type, dim):
    # every IRLS loss, smooth variants (the serving config), f32 while
    # driver vs the f64 scan driver
    src, tgt, _ = _make_batch(3, 48, 64, dim=dim,
                              normals=(icp_type == "pt2pl"), seed=17)
    cfg = BASE.with_(icp_type=icp_type, dim=dim, differentiable=True,
                     loss_name=loss,
                     loss_metric=2.0 if loss else 1.0,
                     trim_dist=4.0)
    _compare(cfg, src, tgt)
