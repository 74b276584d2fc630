"""Online serving demo: the streaming registration pipeline in ~60 lines.

The serving shape of the framework (no reference counterpart — the
reference is a single-pair offline solver, SURVEY.md §1): scans arrive as
a stream, and `dicp_tpu.pipeline.stream_odometry` keeps the device busy by

  * shipping each preprocessed scan host->device exactly once,
  * dispatching ONE jitted program per window of K consecutive pairs,
  * returning device futures so several windows stay in flight while the
    host preprocesses the next ones,
  * seeding every dispatch with the constant-velocity prior (warm start —
    default on), and
  * optionally shipping scans as packed (n, 4) uint16 (8 bytes/point,
    dequantized on device) for when the h2d transfer, not the solve,
    bounds the raw-scan serving rate.

Run:  python examples/serving_demo.py  (uses whatever jax.devices() offers)
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from dicp_tpu import ICPConfig, se3
from dicp_tpu.io import ScanDataset, save_bin
from dicp_tpu.odometry import ate
from dicp_tpu.pipeline import stream_odometry


def main():
    rng = np.random.default_rng(0)
    n, S = 20_000, 24
    scene = rng.uniform(-15.0, 15.0, size=(n, 3)).astype(np.float32)

    # ground-truth trajectory: constant twist per frame
    xi = np.array([0.04, 0.02, 0.01, 0.004, 0.002, 0.01], np.float32)
    T_step = np.asarray(se3.vec2tran(jnp.asarray(xi)))
    tmpdir = tempfile.mkdtemp(prefix="dicp_serving_")
    T, poses_true = np.eye(4, dtype=np.float32), []
    for i in range(S):
        Ti = np.linalg.inv(T).astype(np.float32)
        scan = scene @ Ti[:3, :3].T + Ti[:3, 3]
        save_bin(os.path.join(tmpdir, f"{i:04d}.bin"),
                 np.hstack([scan, np.zeros((n, 1), np.float32)]))
        poses_true.append(T.copy())
        T = T @ T_step

    cfg = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=3, trim_dist=1.0,
                    loss_name="huber", loss_metric=0.5, nn_method="auto")

    # disk -> native C++ preprocess -> device, windowed dispatch with the
    # constant-velocity warm start (default)
    ds = ScanDataset.from_dir(tmpdir, max_points=n, voxel=None,
                              workers=2, prefetch=4)
    t0 = time.time()
    res = stream_odometry(((pts[:, :3], w) for pts, w in ds), cfg, window=4)
    dt = time.time() - t0

    err = float(ate(res.poses, jnp.asarray(np.stack(poses_true)), align=False))
    print(f"f32 stream : {S} scans in {dt:.2f}s wall ({S / dt:.1f} fps incl. "
          f"compile), ATE {err:.2e}, all converged: "
          f"{bool(jnp.all(res.converged))}")
    assert err < 1e-2, "trajectory drifted"

    # quantized transfers: 8 B/point over the wire instead of 12, weights
    # elided (quantize requires weightless scans with no zero-row padding)
    ds = ScanDataset.from_dir(tmpdir, max_points=n, voxel=None,
                              workers=2, prefetch=4)
    t0 = time.time()
    res_q = stream_odometry(((pts[:, :3], None) for pts, _ in ds), cfg,
                            window=4, quantize=True)
    dt_q = time.time() - t0
    err_q = float(ate(res_q.poses, jnp.asarray(np.stack(poses_true)),
                      align=False))
    print(f"quantized  : {S} scans in {dt_q:.2f}s wall ({S / dt_q:.1f} fps "
          f"incl. compile), ATE {err_q:.2e}")
    assert err_q < 1e-2, "quantized trajectory drifted"


if __name__ == "__main__":
    from dicp_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
