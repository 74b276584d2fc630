"""Utils: profiling helper + checkpoint/resume round trip."""

import os

import jax.numpy as jnp
import numpy as np

from dicp_tpu.utils import benchmark, load_odometry_state, save_odometry_state


def test_benchmark_helper():
    stats = benchmark(lambda: jnp.sum(jnp.ones((64, 64))), n=3)
    assert stats["n"] == 3
    assert stats["mean_s"] > 0 and stats["min_s"] > 0
    assert stats["min_s"] <= stats["median_s"] <= max(stats["mean_s"] * 3, 1)


def test_benchmark_needs_warmup():
    import pytest

    with pytest.raises(ValueError, match="warmup"):
        benchmark(lambda: jnp.ones(3), n=1, warmup=0)


def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "odo.npz")
    poses = np.tile(np.eye(4), (5, 1, 1))
    rel = np.tile(np.eye(4), (4, 1, 1))
    save_odometry_state(path, poses, rel_transforms=rel,
                        edges_i=np.arange(4), edges_j=np.arange(1, 5),
                        t_meas=rel, info=np.ones(4), step=7)
    state = load_odometry_state(path)
    np.testing.assert_array_equal(state["poses"], poses)
    np.testing.assert_array_equal(state["rel_transforms"], rel)
    assert int(state["step"]) == 7
    # overwrite is atomic and idempotent
    save_odometry_state(path, poses[:2])
    state2 = load_odometry_state(path)
    assert state2["poses"].shape == (2, 4, 4)
    assert "step" not in state2


def test_visualization_saves(tmp_path, source_np, target_np):
    from dicp_tpu.visualization import plot_map, plot_overlay

    p1 = os.path.join(tmp_path, "overlay.png")
    plot_overlay(jnp.asarray(source_np[:, :3]), jnp.asarray(target_np[:, :3]),
                 file_name=p1)
    assert os.path.getsize(p1) > 0

    p2 = os.path.join(tmp_path, "map.png")
    plot_map(source_np[:, :3], file_name=p2)
    assert os.path.getsize(p2) > 0


def test_voxel_large_extent_no_overflow():
    """Regression: linearized int32 cell keys overflow for large grids and
    silently merge unrelated voxels; the lexsort keying must not."""
    from dicp_tpu.ops.voxel import voxel_downsample

    rng = np.random.default_rng(0)
    # two tight clusters separated by 4 km at 5 cm voxels: extents ~8e4 per
    # axis -> a linearized key needs ~2^50
    a = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    b = a + np.array([4000.0, 4000.0, 2000.0], np.float32)
    pts = jnp.asarray(np.vstack([a, b]))
    out = voxel_downsample(pts, 0.05)
    n_cells = int(out.count)
    # clusters must not merge: every centroid belongs clearly to one cluster
    cents = np.asarray(out.points)[:n_cells]
    d_a = np.linalg.norm(cents - np.mean(a, 0), axis=1)
    d_b = np.linalg.norm(cents - np.mean(b, 0), axis=1)
    assert np.all((d_a < 10) | (d_b < 10)), "voxel key overflow merged clusters"


def test_chained_rate_cpu_sane():
    """chained_rate on CPU: positive seconds-per-step for a tiny workload."""
    from dicp_tpu.utils.timing import chained_rate

    def step(s):
        return jnp.sum(s * s)

    dt = chained_rate(step, jnp.ones((64, 64), jnp.float32),
                      k_small=2, k_big=6, reps=2)
    assert dt > 0
