"""Static-shape voxel-grid downsampling.

No reference counterpart (the reference registers raw clouds); required by
the large-cloud configuration in BASELINE.json ("tiled Pallas kNN + voxel
downsample").  Accelerator-friendly design: fixed output shape (n, 3) with a validity
mask instead of a dynamic compaction — one centroid per occupied voxel in the
leading slots, zeros elsewhere.  Zero rows + zero weights compose with the
solver's padding convention (weight 0 rows are exact no-ops).

Implementation is a sort + segment-mean: O(n log n) on device, fully
jittable and vmappable, no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class VoxelResult(NamedTuple):
    points: jnp.ndarray  # (n, 3) voxel centroids in leading slots, zeros after
    weight: jnp.ndarray  # (n,) points-per-voxel count (0 for padding slots)
    count: jnp.ndarray   # () int32 number of occupied voxels


def voxel_downsample(points: jnp.ndarray, voxel_size: float,
                     origin: float = 0.0) -> VoxelResult:
    """Average all points falling in each (voxel_size)^3 cell.

    points (n, >=3): extra columns (e.g. normals) are averaged too.
    Returns fixed-shape output; use ``weight > 0`` as the validity mask or
    feed ``points``/``weight`` straight into the solver.
    """
    n = points.shape[0]
    dtype = points.dtype
    coords = points[:, :3]

    cell = jnp.floor((coords - origin) / voxel_size).astype(jnp.int32)
    # lexicographic sort on the 3 cell coordinates: a single linearized key
    # overflows int32 for realistic grids (200m at 5cm voxels is ~1.6e10
    # cells; astype(int64) silently truncates to int32 when x64 is off)
    order = jnp.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    cell_s = cell[order]
    pts_s = points[order]

    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), jnp.any(cell_s[1:] != cell_s[:-1], axis=1)])
    seg_idx = jnp.cumsum(new_seg) - 1          # (n,) segment id per point
    num_seg = seg_idx[-1] + 1

    # one pass for sums AND counts (ones column), with the sorted-segment
    # guarantee communicated to XLA — seg_idx is a cumsum over lexsorted
    # cells, so the general scatter-add lowering is pure waste
    aug = jnp.concatenate([pts_s, jnp.ones((n, 1), dtype)], axis=1)
    agg = jax.ops.segment_sum(aug, seg_idx, num_segments=n,
                              indices_are_sorted=True)
    sums, counts = agg[:, :-1], agg[:, -1]
    centroids = sums / jnp.where(counts[:, None] == 0, 1.0, counts[:, None])

    valid = jnp.arange(n) < num_seg
    return VoxelResult(
        points=jnp.where(valid[:, None], centroids, 0.0),
        weight=jnp.where(valid, counts, 0.0),
        count=num_seg.astype(jnp.int32),
    )
