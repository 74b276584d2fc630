"""Full-resolution large-cloud registration with self-computed normals.

Demonstrates the 100k-point serving workflow (transform error ~1e-7):

1. estimate surface normals for the map with the kernel-weighted PCA path
   (no (n, n) matrix, no top-k — one fat-K matmul over cluster-index
   candidates);
2. register a 100k-point scan against the 100k-point map at FULL resolution
   (no voxel downsampling) — the Hilbert cluster index is built once per
   solve and amortized over the Gauss-Newton iterations;
3. check the exactness certificate of the final correspondences.

Run:  python examples/large_cloud_demo.py        (GPU or CPU)
"""

import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from dicp_tpu import ICPConfig, register_jit, se3
from dicp_tpu.ops.cluster_knn import build_cluster_index, cluster_nn
from dicp_tpu.ops.normals import estimate_normals


def make_scene(n=100_000, seed=0):
    """Three orthogonal planes, n points, f64 ground truth on host."""
    rng = np.random.default_rng(seed)
    axes = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts = []
    for k in range(3):
        uv = rng.uniform(-20, 20, size=(n // 3 + 1, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(axes[k])]]
        pts.append(uv @ basis + axes[k] * (2.0 + k))
    return np.vstack(pts)[:n]


def main():
    print(f"device: {jax.devices()[0]}")
    map_pts = make_scene()

    # ground-truth offset, applied in host f64 (a device matmul at reduced
    # default precision would corrupt the data)
    xi = np.array([0.2, -0.1, 0.05, 0.01, -0.02, 0.03])
    T_st = np.asarray(se3.vec2tran(jnp.asarray(xi)), np.float64)
    scan = (map_pts @ T_st[:3, :3].T + T_st[:3, 3]).astype(np.float32)

    target3 = jnp.asarray(map_pts.astype(np.float32))
    source = jnp.asarray(scan)

    # 1. normals for the map (computed, not assumed — the reference requires
    #    them precomputed)
    normals = jax.jit(lambda p: estimate_normals(p, method="weighted"))(target3)
    target6 = jnp.concatenate([target3, normals], axis=-1)

    # 2. full-resolution registration through the cluster index
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster")
    res = register_jit(source[None], target6[None],
                       jnp.eye(4, dtype=jnp.float32)[None], None, cfg=cfg)
    T_pred = np.asarray(res.T[0], np.float64)
    err = np.linalg.norm(np.asarray(se3.tran2vec(
        jnp.asarray(np.linalg.inv(T_st) @ np.linalg.inv(T_pred)))))
    print(f"registered 100k vs 100k: {float(res.iterations[0]):.0f} GN "
          f"iterations, transform error {err:.2e}, "
          f"converged={bool(res.converged[0])}")

    # 3. exactness accounting on the final correspondences (transform
    #    applied on HOST — a bare device matmul at reduced precision would
    #    add centimetres of noise to the residuals)
    index = jax.jit(lambda t: build_cluster_index(t, 128))(target3)
    aligned = jnp.asarray(
        (scan.astype(np.float64) @ T_pred[:3, :3].T + T_pred[:3, 3])
        .astype(np.float32))
    idx, d2, cert = cluster_nn(index, aligned, probes=32)
    print(f"final correspondences: {100 * float(jnp.mean(cert)):.2f}% "
          f"certified-exact, median residual "
          f"{float(jnp.median(jnp.sqrt(d2))):.2e} m")


if __name__ == "__main__":
    from dicp_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
