"""Chained step timing for the benchmark scripts.

:func:`chained_rate` runs K workload steps chained inside one jitted
``lax.scan`` (step k's input depends on step k-1's outputs, so nothing can
be skipped or reordered), ends in a host fetch of the dependent scalar, and
differences two chain lengths to cancel the fixed dispatch and fetch cost.
It is kept as a plain helper for the bench scripts;
:func:`dicp_tpu.utils.profiling.benchmark` (``block_until_ready`` around
each call) is the general clock.
"""

from __future__ import annotations

import sys
import time


def chained_rate(make_step, src, *consts, k_small=4, k_big=16, reps=3):
    """Seconds per step of ``make_step``, overhead-differenced.

    ``make_step(src_shifted, *consts)`` must return a scalar that depends on
    ALL of the step's outputs (so nothing is dead-code-eliminated).
    ``consts`` are jit ARGUMENTS: closure-captured concrete arrays would be
    baked into the program as constants.  Every outer invocation gets a
    distinct src offset, so no two calls compute the same thing.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    def chain(K):
        @jax.jit
        def f(src, off, *consts):
            def body(carry, k):
                s = src + (carry * 1e-12 + (off + k.astype(jnp.float32)) * 1e-7)
                # cast keeps the carry dtype stable under jax_enable_x64
                return make_step(s, *consts).astype(jnp.float32), ()
            c, _ = lax.scan(body, jnp.float32(0.0), jnp.arange(K))
            return c
        return f

    times = {}
    call = 0
    for K in (k_small, k_big):
        f = chain(K)
        float(f(src, np.float32(1000 * call), *consts))  # compile + throwaway
        call += 1
        best = float("inf")
        for _ in range(reps):
            off = np.float32(1000 * call)  # distinct input per call
            call += 1
            t0 = time.perf_counter()
            float(f(src, off, *consts))    # host fetch forces completion
            best = min(best, time.perf_counter() - t0)
        times[K] = best

    dt = (times[k_big] - times[k_small]) / (k_big - k_small)
    if dt <= 0:
        # run-to-run noise swallowed the difference; fall back to the
        # conservative bound (fixed overhead charged to the steps)
        print(f"warning: chain differencing non-positive "
              f"({times[k_small]:.4f}s @K={k_small}, {times[k_big]:.4f}s "
              f"@K={k_big}); using K={k_big} mean", file=sys.stderr)
        dt = times[k_big] / k_big
    return dt
