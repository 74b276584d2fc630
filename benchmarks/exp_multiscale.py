"""A/B: multiscale pyramid vs single-scale full-res at 100k points.

The pyramid's claim (dicp_tpu/multiscale.py): from a FAR initialization the
full-resolution solver spends many costly GN iterations walking to the
basin; a coarse voxel level walks the same distance in cheap iterations, so the
final full-res level only polishes.  Both paths must land on the same pose
(f32 solver floor); the metric is ms/registration at equal accuracy.

Run: python benchmarks/exp_multiscale.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmarks.timing import chained_rate


def _emit(name, value, unit, **detail):
    print(json.dumps({"name": name, "value": round(float(value), 3),
                      "unit": unit, **detail}))


def main():
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_suite import _make_scene
    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.multiscale import ScaleLevel, register_multiscale
    from dicp_tpu.registration import register

    print(f"dev={jax.devices()[0]}",
          file=sys.stderr, flush=True)

    n = 100_000
    target = jnp.asarray(_make_scene(n))
    # FAR init (~4x the suite's large_cloud offset): the regime multiscale
    # is for.  Source generated host-side in f64 (a device matmul at
    # reduced default precision would corrupt the ground truth).
    xi = np.array([0.8, -0.5, 0.2, 0.05, -0.08, 0.12], np.float64)
    T_np = np.asarray(se3.vec2tran(jnp.asarray(xi))).astype(np.float64)
    source = jnp.asarray((np.asarray(target[:, :3], np.float64) @ T_np[:3, :3].T
                          + T_np[:3, 3]).astype(np.float32))
    T_true = se3.tran_inv(jnp.asarray(T_np.astype(np.float32)))

    cfg = ICPConfig(icp_type="pt2pl", differentiable=False,
                    max_iterations=40, tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster",
                    collect_histories=False)
    levels = (ScaleLevel(1.0, 4096, 4096, 15, 1e-3, trim_dist=8.0,
                         nn_method="dense"),
              ScaleLevel(0.0, 0, 0, 40, 1e-5))

    def err_of(T):
        return float(jnp.linalg.norm(se3.tran2vec(
            se3.compose(T_true, se3.tran_inv(T)))))

    # --- single-scale full-res from the far init
    def single_step(s, tgt):
        res = register(s[None], tgt[None],
                       jnp.eye(4, dtype=jnp.float32)[None], None, cfg)
        return jnp.sum(res.T)

    res_s = jax.jit(lambda s, t: register(
        s[None], t[None], jnp.eye(4, dtype=jnp.float32)[None], None, cfg)
    )(source, target)
    dt_s = chained_rate(single_step, source, target, k_small=1, k_big=3)
    _emit("singlescale_100k_farinit", dt_s * 1e3, "ms/registration",
          transform_err=err_of(res_s.T[0]),
          iterations=float(res_s.iterations[0]))

    # --- pyramid from the same init
    def pyr_step(s, tgt):
        ms = register_multiscale(s[None], tgt[None],
                                 jnp.eye(4, dtype=jnp.float32)[None],
                                 None, cfg, levels)
        return jnp.sum(ms.result.T)

    ms = jax.jit(lambda s, t: register_multiscale(
        s[None], t[None], jnp.eye(4, dtype=jnp.float32)[None], None, cfg,
        levels))(source, target)
    dt_p = chained_rate(pyr_step, source, target, k_small=1, k_big=3)
    _emit("multiscale_100k_farinit", dt_p * 1e3, "ms/registration",
          transform_err=err_of(ms.result.T[0]),
          level_iterations=[float(x) for x in
                            np.asarray(ms.level_iterations)[:, 0]],
          speedup_vs_singlescale=round(dt_s / dt_p, 3))


if __name__ == "__main__":
    main()
