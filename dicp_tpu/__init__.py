"""dicp_tpu — differentiable point-cloud registration & LiDAR odometry in JAX.

A from-scratch JAX/XLA/Pallas framework with the full capability surface of
utiasASRL/dICP (see SURVEY.md), redesigned for accelerators:

* :mod:`dicp_tpu.registration` — jitted batched Gauss-Newton ICP
  (lax.scan / lax.while_loop drivers, pt2pt & pt2pl, 2-D & 3-D, robust
  losses, trimming, prior weights, per-element convergence freezing,
  end-to-end gradients).
* :mod:`dicp_tpu.svd_icp` — batched closed-form (Kabsch/SVD) pt2pt ICP.
* :mod:`dicp_tpu.sgd_icp` — stochastic mini-batch ICP (SGD-ICP,
  arXiv:1907.09133): O(k·m) per iteration with stochastic-GN/SGD/Adam
  updates, explicit PRNG keys.
* :mod:`dicp_tpu.knn` / :mod:`dicp_tpu.ops.pallas_knn` /
  :mod:`dicp_tpu.ops.cluster_knn` — brute-force, tiled-Pallas, and
  Hilbert cluster-pruned certified-exact nearest-neighbor search.
* :mod:`dicp_tpu.ops.normals` — PCA / kernel-weighted surface normals.
* :mod:`dicp_tpu.losses` — Huber / Cauchy / trim IRLS weights.
* :mod:`dicp_tpu.se3` — Lie-group math (replaces pylgmath + torch.matrix_exp).
* :mod:`dicp_tpu.parallel` — jax.sharding mesh utilities: batch-sharded
  registration and map-sharded normal-equation psum reduction.
* :mod:`dicp_tpu.odometry` — chained scan-to-scan odometry / pose graph.
* :mod:`dicp_tpu.pipeline` — streaming serving loop (windowed dispatch,
  one transfer per scan, async depth over the host/device boundary).
* :mod:`dicp_tpu.api` — drop-in ``ICP`` class with the reference's exact
  call surface and ragged-input handling.
"""

from dicp_tpu.anderson import register_anderson, register_anderson_jit
from dicp_tpu.api import ICP, batch_size_handling
from dicp_tpu.config import ICPConfig, config_from_yaml
from dicp_tpu.gicp import (GICPResult, register_gicp, register_gicp_ift,
                           register_gicp_jit)
from dicp_tpu.ift import register_ift, register_ift_jit
from dicp_tpu.mapping import (LocalMap, empty_map, map_merge, map_step,
                              map_target, scan_to_map_odometry)
from dicp_tpu.multiscale import (MultiscaleResult, ScaleLevel,
                                 register_multiscale)
from dicp_tpu.ops.cluster_knn import (build_cluster_index, cluster_knn,
                                      cluster_nn, cluster_nn_verified)
from dicp_tpu.ops.normals import estimate_normals, estimate_normals_weighted
from dicp_tpu.pipeline import stream_odometry, stream_registrations
from dicp_tpu.registration import ICPResult, register, register_jit
from dicp_tpu.sgd_icp import SGDICPResult, register_sgd, register_sgd_jit
from dicp_tpu.slam import (Closure, SlamResult, build_pose_graph,
                           rebuild_map, refine_robust, slam_odometry)
from dicp_tpu.svd_icp import pt2pt_svd_icp

__version__ = "0.1.0"

__all__ = [
    "ICP",
    "ICPConfig",
    "ICPResult",
    "batch_size_handling",
    "build_cluster_index",
    "cluster_knn",
    "cluster_nn",
    "cluster_nn_verified",
    "config_from_yaml",
    "estimate_normals",
    "estimate_normals_weighted",
    "pt2pt_svd_icp",
    "GICPResult",
    "register_gicp",
    "register_gicp_ift",
    "register_gicp_jit",
    "LocalMap",
    "empty_map",
    "map_merge",
    "map_step",
    "map_target",
    "scan_to_map_odometry",
    "MultiscaleResult",
    "ScaleLevel",
    "register",
    "register_multiscale",
    "register_anderson",
    "register_anderson_jit",
    "register_ift",
    "register_ift_jit",
    "register_jit",
    "SGDICPResult",
    "register_sgd",
    "register_sgd_jit",
    "Closure",
    "SlamResult",
    "build_pose_graph",
    "rebuild_map",
    "refine_robust",
    "slam_odometry",
    "stream_odometry",
    "stream_registrations",
    "__version__",
]
