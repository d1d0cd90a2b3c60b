"""Voxel-grid downsampling as sort + segment-sum (static shapes).

The reference uses a host hash map keyed on int-floored voxel coords
(src/registration.cpp:15-60). Hash maps don't fit static shapes; the
equivalent is:

  1. quantize:   c = floor(p / voxel)  (int32, matches registration.cpp:34-38)
  2. lexsort points by (cx, cy, cz)    (one fused XLA multi-operand sort)
  3. segment ids from adjacent-key changes (cumsum)
  4. centroids via ``segment_sum`` of points (and colors) / counts

Output order is ascending voxel key; the reference's output is hash-map
order, i.e. both are "unordered" — fidelity is gated on the *set* of
centroids (SURVEY.md §7 hard-parts note).

Static shapes: output capacity equals input capacity; valid centroids occupy
a prefix (sorted padding keys are +max, so padding lands in the final
segments) with ``mask`` marking real rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu3d.types import PointCloud

_PAD_COORD = jnp.int32(2**30)


@functools.partial(jax.jit, static_argnames=())
def voxel_downsample(cloud: PointCloud, voxel_size: jnp.ndarray) -> PointCloud:
    """Average points (and colors) per voxel. Drops normals, like the
    reference (registration.cpp:29-60 never fills ``result.normals``)."""
    n = cloud.capacity
    inv = 1.0 / jnp.asarray(voxel_size, jnp.float32)
    coords = jnp.floor(cloud.points * inv).astype(jnp.int32)  # (N, 3)
    coords = jnp.where(cloud.mask[:, None], coords, _PAD_COORD)

    # Primary key cx, then cy, then cz — jnp.lexsort sorts by the LAST key
    # first, so pass (cz, cy, cx).
    order = jnp.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    c_sorted = coords[order]
    p_sorted = cloud.points[order]
    m_sorted = cloud.mask[order]

    prev = jnp.roll(c_sorted, 1, axis=0)
    new_seg = jnp.any(c_sorted != prev, axis=1)
    new_seg = new_seg.at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1  # (N,) in [0, N)

    w = m_sorted.astype(jnp.float32)
    counts = jax.ops.segment_sum(w, seg_id, num_segments=n)
    sums = jax.ops.segment_sum(p_sorted * w[:, None], seg_id, num_segments=n)
    denom = jnp.maximum(counts, 1.0)[:, None]
    out_points = sums / denom
    out_mask = counts > 0

    out_colors = None
    if cloud.colors is not None:
        c = jax.ops.segment_sum(
            cloud.colors[order] * w[:, None], seg_id, num_segments=n
        )
        out_colors = c / denom

    return PointCloud(points=out_points, mask=out_mask, colors=out_colors)


def voxel_count(cloud: PointCloud, voxel_size) -> jnp.ndarray:
    """Number of occupied voxels (traced scalar) — handy for picking a
    compaction capacity without running the full downsample."""
    down = voxel_downsample(cloud, voxel_size)
    return down.count()


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact(cloud: PointCloud, capacity: int) -> PointCloud:
    """Re-pack valid rows into a (smaller) fixed-capacity buffer.

    Stage-boundary helper: after masking/downsampling, far fewer rows are
    valid than the static capacity; compacting keeps the O(N·M) registration
    ops sized to the data. Stable: valid rows keep their relative order.
    Rows beyond ``capacity`` are dropped (callers size buckets from the host
    count).
    """
    order = jnp.argsort(~cloud.mask, stable=True)
    sel = order[:capacity]

    def take(a):
        return None if a is None else a[sel]

    return PointCloud(
        points=cloud.points[sel],
        mask=cloud.mask[sel],
        normals=take(cloud.normals),
        colors=take(cloud.colors),
    )
