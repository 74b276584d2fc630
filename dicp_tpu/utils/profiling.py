"""Profiling / observability helpers.

The reference's only timing artifact is a wall-clock print inside one test
(tests/test_ICP_inputs.py:79-103, SURVEY.md §5).  Here: a context manager
around ``jax.profiler`` for per-kernel device traces (viewable in TensorBoard /
xprof) and a steady-state benchmark helper that handles compile warmup and
device synchronization correctly.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: ``with trace('/tmp/tb'): fn()``.

    Produces an xplane trace under ``log_dir`` with per-kernel timing
    (Pallas kernels show up under their pallas_call name).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _block(out):
    return jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out)


def benchmark(fn: Callable, n: int = 10, warmup: int = 1) -> dict:
    """Steady-state timing of ``fn()`` (compile excluded).

    Every call ends in ``block_until_ready`` on all outputs, so the host
    clock spans the device work, not just the enqueue.  Returns
    {mean_s, min_s, median_s, compile_s, n}.
    """
    if warmup < 1:
        # warmup=0 would fold XLA compilation into the first timed
        # iteration while reporting compile_s ~ 0 — silently wrong in a
        # module whose purpose is truthful timing (code-review r3)
        raise ValueError("benchmark() needs warmup >= 1: the first call "
                         "pays compilation and must not be timed")
    t0 = time.perf_counter()
    for _ in range(warmup):
        _block(fn())
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        _block(fn())
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(times) / n,
        "min_s": min(times),
        "median_s": sorted(times)[n // 2],
        "compile_s": compile_s,
        "n": n,
    }
