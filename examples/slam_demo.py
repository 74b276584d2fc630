"""Closed-loop SLAM demo: scan-to-map odometry + loop closures + pose graph.

The full `dicp_tpu.slam` stack on a synthetic multi-lap circuit — the
scenario loop closure exists for: a capacity-bounded sliding map forgets
old geometry (LRU eviction), so odometry noise accumulates into drift, and
revisiting the start only helps if the revisit is *detected* and fed back
through the pose graph.  (The reference, `/root/reference/dICP/ICP.py:46`,
is a single-pair solver; this composes the repo's front-end, closure
detector, and Schur-partitioned back-end into the full loop.)

Pipeline per scan:
  predict pose (EMA constant-velocity)
    -> register scan against the fused voxel map (pt2pl, cluster kNN)
    -> merge the posed scan into the map (running means, LRU eviction)
    -> every few scans: freeze a keyframe anchor / check for a revisit
       -> on revisit: two-stage registration against the anchor snapshot
          -> accepted closures become RELATIVE pose-graph edges
finally:
  robust (Huber-IRLS) pose-graph refinement -> drift-corrected trajectory
    -> optional map rebuild at the refined poses.

Run:  python examples/slam_demo.py          (any backend; minutes on CPU)
      SLAM_DEMO_LAPS=6 python examples/slam_demo.py   for the full circuit

Expected (6 laps, CPU f64): ~60 closures accepted, refined ATE ~0.11-0.13
(3-8x below the drifting front-end — the front-end drift REALIZATION
depends on last-ulp XLA rounding, see tests/test_slam.py; the refined
error is the stable quantity), rebuilt-map median surface distance ~0.1.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# honor JAX_PLATFORMS (e.g. cpu) before any backend initializes
if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax.numpy as jnp
import numpy as np

from dicp_tpu import ICPConfig, backend, se3
from dicp_tpu.odometry import ate
from dicp_tpu.slam import rebuild_map, slam_odometry


def make_world(n=40_000, R=5.0, seed=0):
    """Wavy ground surface around a circular circuit."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, 3))
    pts[:, 0] = rng.uniform(-R - 8, R + 8, n)
    pts[:, 1] = rng.uniform(-R - 8, R + 8, n)
    pts[:, 2] = np.sin(pts[:, 0] * 0.6) * np.cos(pts[:, 1] * 0.5) * 1.5
    return pts


def make_scans(laps, per_lap=32, n=1200, r=6.0, noise=0.04, R=5.0, seed=3):
    """Local-frame range scans along the circuit + ground-truth poses."""
    rng = np.random.default_rng(seed)
    world = make_world(R=R)
    scans, poses = [], []
    for k in range(int(laps * per_lap) + 1):
        th = 2 * np.pi * k / per_lap
        t = np.array([R * np.cos(th), R * np.sin(th), 0.0])
        yaw = th + np.pi / 2 + 0.05 * np.sin(k * 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        Rm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3] = Rm
        T[:3, 3] = t
        d = np.linalg.norm(world[:, :2] - t[None, :2], axis=1)
        idx = np.flatnonzero(d < r)
        sel = rng.choice(idx, n, replace=len(idx) < n)
        # f64 under JAX_ENABLE_X64 on CPU (matches tests/test_slam.py);
        # always f32 on accelerators — the serving path is f32
        dtype = (np.float64 if (jnp.zeros(()).dtype == jnp.float64
                                and backend.platform() == "cpu")
                 else np.float32)
        scans.append(((world[sel] - t) @ Rm
                      + rng.normal(scale=noise, size=(n, 3))).astype(dtype))
        poses.append(T)
    P = np.stack(poses)
    # SLAM gauge: pose 0 = identity (trajectory in the scan-0 frame);
    # P[0] maps that frame back to the world the analytic surface lives in
    return scans, np.einsum("ij,kjl->kil", np.linalg.inv(P[0]), P), P[0]


def main():
    laps = int(os.environ.get("SLAM_DEMO_LAPS", "3"))
    scans, poses_true, T0 = make_scans(laps)
    print(f"{len(scans)} scans, {laps} laps of a 5 m circuit, "
          f"sigma=0.04 noise, 2048-voxel sliding map")

    cfg = ICPConfig(icp_type="pt2pl", differentiable=False,
                    max_iterations=50, tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=0.5,
                    collect_histories=False)
    res = slam_odometry(((s, None) for s in scans), cfg,
                        capacity=2048, voxel=0.25,
                        anchor_every=4, closure_gap=24, detect_every=2,
                        detect_radius=5.0, accept_ratio=0.5,
                        max_closures=100, closure_info=30.0,
                        refine_iterations=25)

    truth = jnp.asarray(poses_true.astype(np.float32))
    a_front = float(ate(res.poses_front, truth, align=False))
    a_ref = float(ate(res.poses, truth, align=False))
    print(f"closures accepted: {len(res.closures)}")
    for c in res.closures[:5]:
        print(f"  anchor {c.anchor_idx:3d} -> scan {c.scan_idx:3d}  "
              f"matched_ratio {c.matched_ratio:.3f}")
    if len(res.closures) > 5:
        print(f"  ... and {len(res.closures) - 5} more")
    print(f"front-end ATE (drifting): {a_front:.4f}")
    print(f"refined   ATE          : {a_ref:.4f}  "
          f"({a_front / max(a_ref, 1e-12):.1f}x lower)")

    # drift-corrected map: re-merge all scans at the refined poses.  The
    # map lives in the scan-0 gauge frame — map it back to world (T0)
    # before comparing against the analytic surface.
    m = rebuild_map(scans, res.poses, capacity=16384, voxel=0.25)
    valid = np.asarray(m.count) > 0
    pts = np.asarray(m.pos)[valid] @ np.asarray(T0)[:3, :3].T + T0[:3, 3]
    zerr = np.abs(pts[:, 2] - np.sin(pts[:, 0] * 0.6)
                  * np.cos(pts[:, 1] * 0.5) * 1.5)
    print(f"rebuilt map: {valid.sum()} voxels, median |z - surface| "
          f"= {np.median(zerr):.3f} (voxel 0.25)")
    # transform final poses back for a quick visual sanity check
    final_err = float(np.linalg.norm(np.asarray(se3.tran2vec(jnp.asarray(
        np.linalg.inv(poses_true[-1]) @ np.asarray(res.poses[-1],
                                                   np.float64))))))
    print(f"final-pose error after refinement: {final_err:.4f}")


if __name__ == "__main__":
    from dicp_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
