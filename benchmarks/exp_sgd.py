"""SGD-ICP: mini-batch stochastic registration vs the full solver.

SGD-ICP's pitch (arXiv:1907.09133) is O(k·m) per iteration instead of
O(n·m) — it pays off when the correspondence pass dominates, i.e. at
large n.  Two comparisons, both to the same accuracy target:

* mid scale (n = m = 20k): stochastic-GN @ k=1024 vs the full register()
  (auto backend) — wall-clock per converged registration + transform err.
* large scale (n = m = 100k): stochastic-GN @ k=2048 vs the full solver's
  cluster path.

Run: python benchmarks/exp_sgd.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmarks.timing import chained_rate


def _emit(name, value, unit, **detail):
    print(json.dumps({"name": name, "value": round(float(value), 4),
                      "unit": unit, **detail}))


def _scene(n, seed=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, size=(n, 2))
    z = (0.01 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)
         + 0.5 * np.sin(0.4 * xy[:, 0]))
    return np.column_stack([xy, z])


def main():
    import jax
    import jax.numpy as jnp

    from dicp_tpu import se3
    from dicp_tpu.config import ICPConfig
    from dicp_tpu.registration import register
    from dicp_tpu.sgd_icp import register_sgd

    print(f"dev={jax.devices()[0]}",
          file=sys.stderr, flush=True)

    xi = np.array([0.1, -0.08, 0.05, 0.04, -0.03, 0.05], np.float64)
    T_np = np.asarray(se3.vec2tran(jnp.asarray(xi)))

    sizes = [("20k", 20_000, 1024, 40), ("100k", 100_000, 2048, 40)]
    if os.environ.get("DICP_SGD_SMOKE"):  # CPU wiring check
        sizes = [("2k", 2_000, 256, 30)]
    for label, n, k, iters in sizes:
        scene = _scene(n)
        src = ((scene @ T_np[:3, :3].T + T_np[:3, 3])
               .astype(np.float32))
        S = jnp.asarray(src[None])
        tgt3 = jnp.asarray(scene.astype(np.float32)[None])
        # both solvers get the same precomputed 6-col target (normals are a
        # per-map front-end cost, amortized across registrations)
        from dicp_tpu.ops.normals import estimate_normals

        tgt_n = jax.jit(lambda p: estimate_normals(p, method="weighted"))(
            tgt3)
        Tg = jnp.concatenate([tgt3, tgt_n], axis=-1)
        Ti = jnp.asarray(np.eye(4, dtype=np.float32)[None])
        key = jax.random.key(0)

        def sgd_step(s, tgt, ti):
            res = register_sgd(s, tgt, ti, key, minibatch=k,
                               iterations=iters, tolerance=1e-6)
            return jnp.sum(res.T)

        dt_s = chained_rate(sgd_step, S, Tg, Ti, k_small=2, k_big=8)
        res = jax.jit(lambda s, t, ti: register_sgd(
            s, t, ti, key, minibatch=k, iterations=iters,
            tolerance=1e-6))(S, Tg, Ti)
        err_s = float(jnp.linalg.norm(se3.tran2vec(
            jnp.asarray(np.asarray(res.T[0], np.float64) @ T_np))))
        _emit(f"sgd_gn_{label}_k{k}", dt_s * 1e3, "ms/registration",
              transform_err=err_s, iterations=float(res.iterations[0]),
              converged=bool(res.converged[0]))

        cfg = ICPConfig(icp_type="pt2pl", differentiable=False,
                        driver="while", max_iterations=40, tolerance=1e-6,
                        dim=3, trim_dist=5.0, loss_name="huber",
                        loss_metric=1.0, collect_histories=False)

        def full_step(s, tgt, ti):
            return jnp.sum(register(s, tgt, ti, None, cfg).T)

        dt_f = chained_rate(full_step, S, Tg, Ti, k_small=2, k_big=6)
        resf = jax.jit(lambda s, t, ti: register(s, t, ti, None, cfg))(
            S, Tg, Ti)
        err_f = float(jnp.linalg.norm(se3.tran2vec(
            jnp.asarray(np.asarray(resf.T[0], np.float64) @ T_np))))
        _emit(f"full_pt2pl_{label}", dt_f * 1e3, "ms/registration",
              transform_err=err_f, sgd_speedup=round(dt_f / dt_s, 3))


if __name__ == "__main__":
    main()
