"""Sharded surface-feature prepare: normals + FPFH distributed over a mesh.

At 1M+ points the prepare stage (the fused normals+FPFH sweeps,
ops/fused_features.py) dominates the registration cost, and BASELINE.json
configs[4]'s spirit is "the scene doesn't fit one chip" — so the sweeps
themselves must distribute, not just the descriptor table they produce.
The reference's prepare is a single-threaded O(N²) loop
(/root/reference/src/registration.cpp:105-201); this is its multi-chip
multi-device answer.

Design (x-range partition + halo exchange):

  1. **x-range partitioning** (:func:`x_partition`): one global sort by x
     assigns each shard an equal-count, x-contiguous slice of the rows
     (invalid rows sort to the top end and land in the last shard,
     masked). Every surface-feature neighborhood is a radius ball, so
     x-contiguity bounds each shard's out-of-slice dependencies to two
     boundary strips.
  2. **Halo exchange**: each shard ships its first/last ``halo`` rows to
     its x-neighbors with two ``ppermute``s (device-to-device, 16 B/row).
     The FPFH→SPFH→normals→points dependency chain reaches 3·radius past
     a shard boundary (FPFH needs SPFH within r, SPFH needs normals
     within 2r, normals need points within 3r), so a halo strip spanning
     ≥ 3·radius in x makes every OWN row's descriptor radius-exact.
  3. **Local fused prepare**: each shard runs the single-chip fused
     walk (the engine table's choice) on [left halo | own |
     right halo] — its own local slab2 build, no cross-shard traffic
     inside the sweeps — and emits the own-row slice.

Exactness is *checked, not assumed*: the returned ``ok`` flag is False
whenever any shard's halo strip fails to span 3·radius beyond its
boundary (e.g. a degenerate-x cloud, where x-partitioning cannot localize
neighborhoods and the halo would silently truncate). The check is
conservative: it can flag a technically-exact extreme (a whole first
shard narrower than 3r sitting entirely inside the halo) but never passes
a truncating one.

Tolerance vs the single-device path: values are the same mathematics on
the same rows; only the engine's query-block composition changes (each
shard buckets its local layout independently), which moves the per-block
f32 centering origin — bin-boundary-flip class deltas, the same envelope
as changing ``block`` on one chip (see fused_prepare_sparse's docstring).
tests/test_prepare_sharded.py gates normals alignment and per-row FPFH L1
against the single-device result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu3d.ops.fused_features import fused_prepare_features
from tpu3d.types import FPFHFeatures, PointCloud


def x_partition(
    points: jnp.ndarray, mask: jnp.ndarray, n_shards: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reorder rows ascending in x (invalid rows last) and pad to a
    multiple of ``n_shards``; returns (points, mask, orig_rows) ready to
    ``device_put`` with ``P('shard')``. orig_rows maps each output row to
    its input row (-1 on padding) so callers can scatter results back."""
    n = points.shape[0]
    pts32 = points.astype(jnp.float32)
    key = jnp.where(mask, pts32[:, 0], jnp.float32(3e4))
    # Payload rides the sort network (stable, like argsort) — cheaper than
    # the [order] row gathers at 1M-row scale (see ops/slab2.py).
    _, sx, sy, sz, sm, order = jax.lax.sort(
        (
            key,
            pts32[:, 0], pts32[:, 1], pts32[:, 2],
            mask.astype(jnp.float32),
            jnp.arange(n, dtype=jnp.int32),
        ),
        num_keys=1,
    )
    pad = (-n) % n_shards
    pts = jnp.pad(
        jnp.stack([sx, sy, sz], axis=1),
        ((0, pad), (0, 0)),
        constant_values=3e4,
    )
    msk = jnp.pad(sm > 0.5, (0, pad))
    orig = jnp.pad(order, (0, pad), constant_values=-1)
    return pts, msk, orig


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "halo", "block", "sub", "interpret"),
)
def fused_prepare_sharded(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    halo: int | None = None,
    block: int | None = None,
    sub: int | None = None,
    interpret: bool = False,
) -> tuple[PointCloud, FPFHFeatures, jnp.ndarray]:
    """Radius-exact normals + FPFH with rows sharded over ``axis``.

    ``points``/``mask`` must be x-range partitioned (``x_partition``) and
    placed with ``P(axis)`` row sharding; row count must divide the axis
    size. Returns (cloud-with-normals, features, ok) — the first two in
    the INPUT row order/sharding, ``ok`` a replicated bool that is False
    when some shard's halo strip did not span 3·radius past its boundary
    (descriptors near that boundary may then miss neighbors; callers
    should fall back to the single-device path or raise).

    ``halo``: boundary-strip row count shipped to each x-neighbor
    (default: an eighth of the shard, floor 1024, capped at the shard).
    """
    r = jnp.asarray(radius, jnp.float32)
    n_shards = mesh.shape[axis]
    m = points.shape[0]
    if m % n_shards:
        raise ValueError(f"rows {m} % {n_shards} shards != 0")
    shard_rows = m // n_shards
    if halo is None:
        halo = min(shard_rows, max(1024, shard_rows // 8))
    halo = min(halo, shard_rows)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards - 1)]
    bwd = [((i + 1) % n_shards, i) for i in range(n_shards - 1)]

    def local(pts, msk):
        # pts (shard_rows, 3) ascending-x; msk (shard_rows,)
        sid = jax.lax.axis_index(axis)
        # Halo exchange: my LAST rows go forward (become the next shard's
        # left halo); my FIRST rows go backward. Endpoints receive zeros
        # from the non-cyclic permutation — their mask rows arrive False.
        tail_p = jax.lax.dynamic_slice(
            pts, (shard_rows - halo, 0), (halo, 3)
        )
        tail_m = jax.lax.dynamic_slice(msk, (shard_rows - halo,), (halo,))
        head_p = pts[:halo]
        head_m = msk[:halo]
        left_p = jax.lax.ppermute(tail_p, axis, fwd)
        left_m = jax.lax.ppermute(tail_m, axis, fwd)
        right_p = jax.lax.ppermute(head_p, axis, bwd)
        right_m = jax.lax.ppermute(head_m, axis, bwd)
        # ppermute zero-fill gives endpoint halos points at the origin with
        # mask False — fused_prepare ignores masked rows entirely, but
        # guard the coordinates with a sentinel anyway so an upstream
        # change to mask handling can't silently corrupt boundary shards.
        left_p = jnp.where(left_m[:, None], left_p, 3e4)
        right_p = jnp.where(right_m[:, None], right_p, 3e4)

        loc = PointCloud(
            points=jnp.concatenate([left_p, pts, right_p], axis=0),
            mask=jnp.concatenate([left_m, msk, right_m], axis=0),
        )
        cloud_l, feat_l = fused_prepare_features(
            loc, r, block=block, sub=sub, interpret=interpret
        )
        normals = jax.lax.dynamic_slice(
            cloud_l.normals, (halo, 0), (shard_rows, 3)
        )
        desc = jax.lax.dynamic_slice(
            feat_l.descriptors, (halo, 0), (shard_rows, 33)
        )

        # --- exactness check (see module docstring) ----------------------
        big = jnp.float32(3e4)
        own_min = jnp.min(jnp.where(msk, pts[:, 0], big))
        own_max = jnp.max(jnp.where(msk, pts[:, 0], -big))
        has_own = jnp.any(msk)
        l_min = jnp.min(jnp.where(left_m, left_p[:, 0], big))
        r_max = jnp.max(jnp.where(right_m, right_p[:, 0], -big))
        ok_l = (sid == 0) | (l_min <= own_min - 3.0 * r)
        # Right side: exact also when the received halo strip contains an
        # INVALID row — invalid rows sort to the global tail (x_partition
        # keys them 3e4), so an invalid row inside the halo proves the
        # whole valid sequence ends within it: no valid point exists
        # beyond the halo to truncate. (This is the common shape at the
        # top x-extreme: a mostly-padding last shard whose few valid rows
        # sit entirely inside its left neighbor's halo.)
        ok_r = (
            (sid == n_shards - 1)
            | (r_max >= own_max + 3.0 * r)
            | jnp.logical_not(jnp.all(right_m))
        )
        # A shard with no valid rows (global padding tail) is trivially ok.
        ok_shard = (~has_own) | (ok_l & ok_r)
        ok = jnp.min(
            jax.lax.all_gather(ok_shard.astype(jnp.int32), axis)
        ) > 0
        return normals, desc, ok

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,  # ok is replicated by construction (all_gather)
    )
    normals, desc, ok = fn(points, mask)
    cloud = PointCloud(points=points, mask=mask, normals=normals)
    return cloud, FPFHFeatures(descriptors=desc, mask=mask), ok
