"""Run-time setup shared by the scripts: compile cache and device naming.

Nothing here runs at import: the scripts (``chip_smoke.py``, ``bench.py``,
``benchmarks/``, ``examples/``) call these helpers from their entry points.
"""

from __future__ import annotations

import os
import shutil
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache is ``<checkout>/.jax_cache``:
    a fixed path, because the path is part of the cache key and a moving
    directory never hits.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
