"""GICP throughput: batched plane-to-plane solves on a curved scene.

GICP's per-iteration cost over pt2pl is the (n, 3, 3) covariance algebra
(inv3 + two einsums) — elementwise work that should fuse around the same
(n, m) distance matmul, so the expected cost ratio vs pt2pl is modest.
Metric: registrations/s at B=64, n=m=600, plus the cost ratio vs an
identically-shaped pt2pt solve.

Run: python benchmarks/exp_gicp.py
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

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.gicp import register_gicp
    from dicp_tpu.registration import register

    print(f"dev={jax.devices()[0]}",
          file=sys.stderr, flush=True)

    B, n = 64, 600
    rng = np.random.default_rng(11)
    xy = rng.uniform(-3, 3, size=(n, 2))
    scene = np.column_stack([xy, 0.09 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)])
    xi = np.array([0.2, -0.15, 0.1, 0.06, -0.04, 0.08], np.float64)
    T_np = np.asarray(se3.vec2tran(
        jnp.asarray(xi.astype(np.float32)))).astype(np.float64)
    src = (scene @ T_np[:3, :3].T + T_np[:3, 3]).astype(np.float32)

    S = jnp.asarray(np.stack([src] * B))
    Tg = jnp.asarray(np.stack([scene.astype(np.float32)] * B))
    Ti = jnp.asarray(np.stack([np.eye(4, dtype=np.float32)] * B))

    def gicp_step(s, tgt, ti):
        res = register_gicp(s, tgt, ti, max_iterations=30, tolerance=1e-6)
        return jnp.sum(res.T)

    dt_g = chained_rate(gicp_step, S, Tg, Ti, k_small=2, k_big=8)
    res = jax.jit(lambda s, t, ti: register_gicp(
        s, t, ti, max_iterations=30, tolerance=1e-6))(S, Tg, Ti)
    T_true = se3.tran_inv(jnp.asarray(T_np.astype(np.float32)))
    err = float(jnp.linalg.norm(se3.tran2vec(
        se3.compose(T_true, se3.tran_inv(res.T[0])))))
    _emit("gicp_b64", dt_g * 1e3, "ms/batch", registrations_per_s=B / dt_g,
          transform_err=err, iterations=float(res.iterations[0]))

    # IFT fwd+bwd (the differentiable-serving combination)
    from dicp_tpu.gicp import register_gicp_ift

    def ift_step(s, tgt, ti):
        g = jax.grad(lambda a: jnp.sum(register_gicp_ift(
            a, tgt, ti, max_iterations=30, tolerance=1e-6).T))(s)
        return jnp.sum(g)

    dt_i = chained_rate(ift_step, S, Tg, Ti, k_small=2, k_big=6)
    _emit("gicp_ift_fwdbwd_b64", dt_i * 1e3, "ms/batch",
          registrations_per_s=B / dt_i)

    # identically-shaped pt2pt for the cost-ratio context
    cfg = ICPConfig(icp_type="pt2pt", differentiable=False, driver="while",
                    max_iterations=30, tolerance=1e-6, dim=3,
                    trim_dist=100.0, loss_name="huber", loss_metric=1e9,
                    collect_histories=False)

    def pt_step(s, tgt, ti):
        return jnp.sum(register(s, tgt, ti, None, cfg).T)

    dt_p = chained_rate(pt_step, S, Tg, Ti, k_small=2, k_big=8)
    _emit("pt2pt_b64_same_shape", dt_p * 1e3, "ms/batch",
          registrations_per_s=B / dt_p,
          gicp_cost_ratio=round(dt_g / dt_p, 3))


if __name__ == "__main__":
    main()
