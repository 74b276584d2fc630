"""Benchmark: batched differentiable pt2pl ICP, forward+backward, B=256.

Reproduces the reference's headline configuration (BASELINE.md): the 65-point
test pair replicated to a 256-pair batch, dim=2, trim_dist=5.0, huber(1.0),
forward + gradient of sum(T) w.r.t. the source clouds.  Reference measured
~1293 registrations/s on 1 CPU core (torch 2.13, f64, tol=1e-10).

Headline path: implicit-function-theorem gradients (dicp_tpu.ift) — the
framework's designed fast gradient path (early-exit while_loop forward, one
6x6 adjoint solve backward, validated against unrolled-scan gradients in
tests/test_ift.py).

Clock: K solver steps chained inside one jitted ``lax.scan`` (step k's
input depends on step k-1's outputs) ending in a host fetch, two chain
lengths differenced to cancel the fixed dispatch and fetch cost
(``dicp_tpu.utils.timing.chained_rate``).

Prints ONE JSON line; detail, and the card's name and power limit, go to
stderr.  Set BENCH_FULL=1 to also measure the unrolled-scan and
forward-only paths (extra chain compiles).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from benchmarks.timing import chained_rate as _chained_rate

BASELINE_REG_PER_S = 1293.0  # BASELINE.md: pt2pl diff B=256 fwd+bwd, 1 CPU core


def main():
    import jax
    import jax.numpy as jnp

    from dicp_tpu.config import ICPConfig
    from dicp_tpu.ift import register_ift
    from dicp_tpu.registration import register
    from dicp_tpu.utils.device import enable_compile_cache, gpu_name_and_power

    from dicp_tpu import backend

    enable_compile_cache()
    if backend.platform() == "gpu":
        print(gpu_name_and_power(), file=sys.stderr)

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
    scan = np.load(os.path.join(base, "points_scan.npy")).astype(np.float32)
    mp = np.load(os.path.join(base, "points_map.npy")).astype(np.float32)

    B = 256
    source = jnp.asarray(np.stack([scan[:, :3]] * B))
    target = jnp.asarray(np.stack([mp]) * jnp.ones((B, 1, 1), jnp.float32))
    t_init = jnp.asarray(np.stack([np.eye(4, dtype=np.float32)] * B))

    cfg = ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=100,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)

    def ift_step(s, target, t_init):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register_ift(x, target, t_init, None, cfg).T))(s)
        return val + jnp.sum(grad) * 1e-20   # consume both outputs

    def unrolled_step(s, target, t_init):
        val, grad = jax.value_and_grad(
            lambda x: jnp.sum(register(x, target, t_init, None,
                                       cfg.with_(scan_unroll=4)).T))(s)
        return val + jnp.sum(grad) * 1e-20

    def fwd_step(s, target, t_init):
        T = register(s, target, t_init, None,
                     cfg.with_(differentiable=False, driver="while")).T
        return jnp.sum(T)

    t0 = time.time()
    dt = _chained_rate(ift_step, source, target, t_init)
    reg_per_s = B / dt
    print(f"first measurement (incl. compile): {time.time()-t0:.1f}s on "
          f"{jax.devices()[0]}", file=sys.stderr)
    print(f"IFT fwd+bwd B={B}: {dt*1e3:.2f} ms -> {reg_per_s:.0f} reg/s", file=sys.stderr)

    if os.environ.get("BENCH_FULL"):
        # secondary paths (each costs an extra pair of chain compiles)
        dt_u = _chained_rate(unrolled_step, source, target, t_init)
        print(f"unrolled fwd+bwd B={B}: {dt_u*1e3:.2f} ms -> {B/dt_u:.0f} reg/s",
              file=sys.stderr)
        dt_f = _chained_rate(fwd_step, source, target, t_init)
        print(f"forward-only (while) B={B}: {dt_f*1e3:.2f} ms -> {B/dt_f:.0f} reg/s",
              file=sys.stderr)
    else:
        del unrolled_step, fwd_step  # measured via BENCH_FULL=1

    # sanity: transforms finite + accurate, grads finite, IFT agrees with unrolled
    res_T = jax.jit(lambda s: register(s, target, t_init, None, cfg).T)(source)
    assert np.all(np.isfinite(np.asarray(res_T))), "non-finite transforms"
    g_ift = jax.jit(jax.grad(
        lambda s: jnp.sum(register_ift(s, target, t_init, None, cfg).T)))(source)
    g_unr = jax.jit(jax.grad(
        lambda s: jnp.sum(register(s, target, t_init, None, cfg).T)))(source)
    g_ift, g_unr = np.asarray(g_ift), np.asarray(g_unr)
    assert np.all(np.isfinite(g_ift)) and np.all(np.isfinite(g_unr)), "non-finite grads"
    cos = float(np.sum(g_ift * g_unr) /
                (np.linalg.norm(g_ift) * np.linalg.norm(g_unr)))
    print(f"IFT vs unrolled grad cosine: {cos:.6f}", file=sys.stderr)
    assert cos > 0.99, f"IFT/unrolled gradient mismatch (cos={cos})"

    print(json.dumps({
        "metric": "pt2pl_diff_B256_fwdbwd_registrations_per_s",
        "value": round(reg_per_s, 1),
        "unit": "registrations/s/chip",
        "vs_baseline": round(reg_per_s / BASELINE_REG_PER_S, 2),
    }))


if __name__ == "__main__":
    main()
