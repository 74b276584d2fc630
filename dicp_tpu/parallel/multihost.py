"""Multi-process execution: initialization, process-aware meshes, and
process-local data placement.

The reference is single-process (SURVEY.md §2.3).  The design rule: put the
**batch** axis across processes — the batch-parallel solver needs ZERO data
collectives (HLO-pinned in tests/test_parallel_hlo), so the slower link
between processes is irrelevant — and the **map** axis within a process's
devices, where the per-GN-step psum of the 6x6 normal equations and the
ring ppermutes ride the fast local interconnect (NVLink on a four-card
node).

Launch recipe (documented in docs/multihost.md): run the SAME program in
every process with `initialize_distributed()` first, giving it an explicit
coordinator address, process count and process id; JAX's runtime wires the
processes into one logical device mesh.

Everything here works unchanged on one process (initialize becomes a no-op
and the hybrid mesh degrades to the local mesh), so single-host tests and
the driver's virtual-device dry run exercise the same code path.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Initialize JAX's multi-process runtime; returns True if distributed.

    Pass all three of coordinator address, process count and process id,
    or set ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``.

    No-op (returns False) with no coordinator or with one process —
    so the same program runs unchanged on a single host or in tests.
    Idempotent: a second call is ignored.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    already = getattr(jax.distributed, "is_initialized", None)
    if already is not None and jax.distributed.is_initialized():
        return jax.process_count() > 1

    # CRITICAL: decide WITHOUT touching the XLA backend.  Anything that
    # initializes it (asking for the platform, jax.devices(), ...) before
    # jax.distributed.initialize() makes the latter raise — found by
    # actually launching two processes (tests/test_multiprocess.py).
    if coordinator_address is None:
        return False  # single process: nothing to initialize
    if num_processes == 1:
        return False  # EXPLICIT single-process launch only.  A coordinator
        # address with num_processes unset still initializes (jax cluster
        # auto-detection fills the rest) — silently skipping here would
        # run N independent single-process jobs with wrong results.

    # CPU hosts need a cross-process collectives backend (the GPU brings
    # NCCL); gloo is what XLA:CPU ships.  Decided from the requested
    # platform string — still without initializing the backend.
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS", ""))
    if "cpu" in str(platforms).lower():
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # option renamed/absent: let jax pick its default
            pass

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count() > 1


def make_pod_mesh(
    map_per_host: Optional[int] = None,
    axis_names: Tuple[str, str] = ("batch", "map"),
) -> Mesh:
    """Process-aware 2-D mesh: ``batch`` across processes, ``map`` within a
    process's devices.

    ``map_per_host``: devices per process assigned to the map axis
    (default: all local devices — each process works on one large cloud,
    batch parallelism across processes).  Must divide the local device count; the remainder
    multiplies into the batch axis.

    Single-process fallback: the familiar local mesh with all devices on
    ``batch`` (map_per_host=None) or the requested split — so tests and the
    virtual-device dry run exercise this exact function.
    """
    n_local = jax.local_device_count()
    n_hosts = jax.process_count()
    if map_per_host is None:
        map_per_host = n_local if n_hosts > 1 else 1
    if n_local % map_per_host != 0:
        raise ValueError(f"map_per_host={map_per_host} does not divide the "
                         f"local device count {n_local}")
    batch = n_hosts * (n_local // map_per_host)

    if n_hosts > 1:
        from jax.experimental import mesh_utils

        # Hybrid mesh: outer axis = processes, inner = local split.
        # Granule = PROCESS, not slice: every device can report slice_index
        # 0, so the slice-granule default raises — found by an actual
        # 2-process launch (tests/test_multiprocess.py).
        try:
            devices = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=(n_local // map_per_host, map_per_host),
                dcn_mesh_shape=(n_hosts, 1),
                process_is_granule=True,
            )
        except ValueError:
            # deterministic fallback: host boundary on the outer axis
            devs = sorted(jax.devices(),
                          key=lambda d: (d.process_index, d.id))
            devices = np.array(devs).reshape(
                n_hosts * (n_local // map_per_host), map_per_host)
        return Mesh(np.asarray(devices).reshape(batch, map_per_host),
                    axis_names)
    devices = np.asarray(jax.devices()).reshape(batch, map_per_host)
    return Mesh(devices, axis_names)


def host_local_batch(mesh: Mesh, *arrays, axis: str = "batch"):
    """Assemble global batch-sharded arrays from PER-HOST local shards.

    Each process passes ITS slice of the global batch (e.g. the scans its
    local dataloader produced); the returned jax.Arrays are globally
    batch-sharded without any host ever materializing the full batch —
    the multi-host analogue of :func:`~dicp_tpu.parallel.shard_batch`.

    The global batch size is ``local_batch * process_count``; local shards
    must have equal shapes on every host (pad the last batch).
    """
    sharding = NamedSharding(mesh, P(axis))
    out = []
    for a in arrays:
        a = np.asarray(a)
        global_shape = (a.shape[0] * jax.process_count(),) + a.shape[1:]
        out.append(jax.make_array_from_process_local_data(
            sharding, a, global_shape))
    return tuple(out)


def process_local_slice(n_global: int) -> slice:
    """The [start, stop) slice of a global batch this process should load
    (equal contiguous blocks by process index)."""
    per = n_global // jax.process_count()
    if per * jax.process_count() != n_global:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{jax.process_count()} processes")
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
