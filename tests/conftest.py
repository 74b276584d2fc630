"""Test harness configuration.

Tests run on CPU with float64 enabled (the reference test data and tolerance
contract are float64, tests/test_ICP.py:66 asserts 1e-10) and an 8-device
virtual mesh so multi-device sharding paths execute without accelerators.
Environment must be set before JAX initializes.

The ``gpu``-marked tests need the card; they skip here and run there with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` (the platform list
is honoured when it is set).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: opt-in ONLY (export
# JAX_COMPILATION_CACHE_DIR to enable).  It cut cached re-runs ~2.7x on
# this compile-bound suite, but concurrent pytest runs sharing one cache
# dir produced a corrupted entry whose READ segfaulted the whole process
# (jax compilation_cache.get_executable_and_time via zstd) — and the bad
# entry persists, making later runs crash deterministically.  A later
# SINGLE-writer run also segfaulted in put_executable_and_time (round 3),
# so the cache is unreliable here even without concurrency.  Not worth a
# segfaulting suite by default.
_cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
if _cache:
    try:
        jax.config.update("jax_compilation_cache_dir", _cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:
        pass  # older jax without the persistent-cache options

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The full suite compiles hundreds of distinct XLA programs in one
    process; with everything retained, later compilations started
    segfaulting inside backend_compile_and_load at state-dependent points
    (observed at ~110-150 tests in, at different tests per run — classic
    accumulated-state corruption, NOT memory pressure: 128 GB free).
    Dropping executables between modules keeps within-module reuse (the
    expensive fixtures) while bounding accumulated compiler state.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import, so every xdist worker collects the same tests)."""
    from dicp_tpu import backend

    if backend.platform() != "gpu":
        pytest.skip("needs a GPU: run JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m gpu on the card")


@pytest.fixture
def source_np():
    """65-point planar scan, float64, zero normal columns (tests/data)."""
    return np.load(os.path.join(DATA_DIR, "points_scan.npy"))


@pytest.fixture
def target_np():
    """65-point map with unit normals in columns 3:6 (tests/data)."""
    return np.load(os.path.join(DATA_DIR, "points_map.npy"))


@pytest.fixture
def test_pair(source_np, target_np):
    """(scan, map) tuple — the reference's test pair."""
    return source_np, target_np


@pytest.fixture
def planes_scene():
    """Three orthogonal noisy planes with exact unit normals, (600, 6) f64 —
    a well-conditioned full-6-DOF scene for pt2pl/symmetric solvers."""
    rng = np.random.default_rng(7)
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-5, 5, size=(200, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (200, 1)))
    return np.hstack([np.vstack(pts), np.vstack(nrm)])
