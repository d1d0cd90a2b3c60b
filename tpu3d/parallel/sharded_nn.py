"""Multi-device nearest-neighbor search: target cloud sharded over a mesh.

The scaling axis of this workload is point-cloud size (SURVEY.md §5
long-context note): a 1M-point target cloud is split row-wise across the
mesh, every device runs the local top-1 scan against its shard, and the
global winner is a tiny (n_dev, Q) argmin after an ``all_gather`` of
per-shard (distance, index) pairs — bandwidth ∝ queries, not targets.

Determinism: per-shard results are combined in shard order with a strict
``<`` via argmin-on-stacked-rows, so ties resolve to the lowest global
target index, identical to the single-chip kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu3d.ops.nn_pallas import nearest_neighbor
from tpu3d.ops.slab import SlabIndex, build_slab, slab_top1


def nearest_neighbor_sharded(
    queries: jnp.ndarray,
    targets: jnp.ndarray,
    target_mask: jnp.ndarray,
    mesh: Mesh,
    axis: str = "shard",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-1 NN with the target rows sharded across ``axis``.

    queries are replicated; targets/target_mask must have row count divisible
    by the axis size (pad with masked rows). Returns (idx i32[Q], d2 f32[Q])
    with GLOBAL target indices.
    """
    n_shards = mesh.shape[axis]
    m = targets.shape[0]
    if m % n_shards:
        raise ValueError(f"target rows {m} not divisible by {n_shards} shards")
    shard_rows = m // n_shards

    def local(q, t, tm):
        # q: (Q, 3) replicated; t: (shard_rows, 3); tm: (shard_rows,)
        idx, d2 = nearest_neighbor(q, t, tm)
        offset = jax.lax.axis_index(axis) * shard_rows
        # Masked-out shards (all-invalid) return garbage idx at huge d2 —
        # the global argmin ignores them.
        gath_d = jax.lax.all_gather(d2, axis)  # (n_shards, Q)
        gath_i = jax.lax.all_gather(idx + offset, axis)
        win = jnp.argmin(gath_d, axis=0)  # ties → lowest shard → lowest index
        q_ids = jnp.arange(d2.shape[0])
        return gath_i[win, q_ids], gath_d[win, q_ids]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        # Outputs ARE replicated (every shard computes the identical global
        # argmin from the all_gather) — VMA inference can't prove it.
        check_vma=False,
    )
    return fn(queries, targets, target_mask)


class ShardedSlab(NamedTuple):
    """Per-shard slab indices over a row-sharded target cloud: each shard's
    rows are x-sorted LOCALLY (build once; the target never moves during
    ICP), so the per-iteration correspondence search within every shard is
    O(Q·L_occ) slab slices instead of the O(Q·M/n_shards) brute scan."""

    sorted_points: jnp.ndarray  # f32[M, 3], rows sharded; x-sorted per shard
    sorted_points_t: jnp.ndarray  # f32[3, M], columns sharded
    sorted_orig: jnp.ndarray  # i32[M] LOCAL original row per shard
    sorted_x: jnp.ndarray  # f32[M] ascending per shard
    valid_sorted: jnp.ndarray  # bool[M]


def build_slab_sharded(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    mesh: Mesh,
    axis: str = "shard",
) -> ShardedSlab:
    """Build per-shard slab indices (one local x-sort per shard, no
    cross-shard traffic)."""

    def local(p, m_):
        s = build_slab(p, m_)
        return ShardedSlab(
            s.sorted_points, s.sorted_points_t, s.sorted_orig, s.sorted_x,
            s.valid_sorted,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=ShardedSlab(
            P(axis), P(None, axis), P(axis), P(axis), P(axis)
        ),
    )
    return fn(points, mask)


def slab_top1_sharded(
    sslab: ShardedSlab,
    queries: jnp.ndarray,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    slice_cap: int = 4096,
    return_overflow: bool = False,
):
    """Nearest target within ``radius`` per query, target sharded with a
    local slab per shard. Queries replicated (pre-sort them by x for block
    coherence). Returns (idx i32[Q] GLOBAL rows, d2 f32[Q], >=1e30 when no
    match)[, overflow].

    LEGACY 1-D slab path: a shard whose x-interval occupancy exceeds
    ``slice_cap`` truncates its scan; ``return_overflow=True`` surfaces
    the OR-reduced per-shard truncation flag so callers can detect it.
    Prefer :func:`slab2_top1_sharded` — radius-exact for any occupancy,
    no cap, no flag."""

    def local(q, sp, spt, so, sx, vs):
        slab = SlabIndex(sp, spt, so, sx, vs)
        idx_l, d2_l, overflow_l = slab_top1(slab, q, radius,
                                            slice_cap=slice_cap)
        offset = jax.lax.axis_index(axis) * sp.shape[0]
        gath_d = jax.lax.all_gather(d2_l, axis)  # (n_shards, Q)
        gath_i = jax.lax.all_gather(idx_l + offset, axis)
        win = jnp.argmin(gath_d, axis=0)  # ties → lowest shard/global row
        q_ids = jnp.arange(d2_l.shape[0])
        # Any shard truncating taints the global answer — OR across shards.
        overflow = jnp.max(
            jax.lax.all_gather(overflow_l.astype(jnp.int32), axis)
        ) > 0
        return gath_i[win, q_ids], gath_d[win, q_ids], overflow

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(None, axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,  # replicated by construction (see above)
    )
    idx, d2, overflow = fn(queries, *sslab)
    if return_overflow:
        return idx, d2, overflow
    return idx, d2


# ---------------------------------------------------------------------------
# slab2 + window walk on shards: radius-exact for ANY occupancy — no
# slice_cap, no silent truncation. Each shard sorts its target rows once
# (build) and every query pass runs the walk locally; the global winner is
# the usual (n_shards, Q) argmin over an all_gather.
# ---------------------------------------------------------------------------

from tpu3d.ops.nn_walk import (  # noqa: E402  (grouped with their users)
    WalkTarget,
    build_walk_target,
    slab2_top1_indexed,
)


class ShardedWalk(NamedTuple):
    """Per-shard WalkTargets over a row-sharded target cloud. Array fields
    are sharded on the mesh axis; the per-shard scalars ride as (n_shards,)
    vectors (each shard reads its own element as a (1,) slice)."""

    packed: jnp.ndarray  # f32[4, M] columns sharded
    sorted_key: jnp.ndarray  # i32[M] sharded
    x0: jnp.ndarray  # f32[n_shards]
    inv_w: jnp.ndarray  # f32[n_shards]
    y0: jnp.ndarray  # f32[n_shards]
    y_scale: jnp.ndarray  # f32[n_shards]


def build_walk_sharded(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    radius,
    mesh: Mesh,
    axis: str = "shard",
) -> ShardedWalk:
    """Per-shard slab2 build (one local composite-key sort per shard, no
    cross-shard traffic)."""

    def local(p, m_):
        wt = build_walk_target(p, m_, radius)
        return ShardedWalk(
            wt.packed, wt.sorted_key, wt.x0, wt.inv_w, wt.y0, wt.y_scale
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=ShardedWalk(
            P(None, axis), P(axis), P(axis), P(axis), P(axis), P(axis)
        ),
    )
    return fn(points, mask)


def slab2_top1_sharded(
    sw: ShardedWalk,
    queries: jnp.ndarray,
    qmask: jnp.ndarray,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    block: int = 64,
    sub: int = 64,
    k_windows: int = 10,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Radius-exact sharded top-1: per-shard slab2+walk, global argmin.

    Queries/qmask replicated. Returns (idx i32[Q] GLOBAL original target
    rows, d2 f32[Q], >=1e30 when no in-radius match). Ties resolve to the
    lowest shard, then the shard's lowest sorted row — deterministic, and
    identical to single-device whenever the minimum is unique. The walk
    engine comes from the table (``interpret=True``: the Triton kernel in
    the interpreter, for tests)."""
    n_shards = mesh.shape[axis]
    m = sw.packed.shape[1]
    shard_rows = m // n_shards

    def local(q, qm, packed, skey, x0, iw, y0, ys):
        wt = WalkTarget(packed, skey, x0, iw, y0, ys)
        idx_l, d2_l = slab2_top1_indexed(
            wt, q, qm, radius,
            block=block, sub=sub, k_windows=k_windows, interpret=interpret,
        )
        offset = jax.lax.axis_index(axis) * shard_rows
        gath_d = jax.lax.all_gather(d2_l, axis)  # (n_shards, Q)
        gath_i = jax.lax.all_gather(idx_l + offset, axis)
        win = jnp.argmin(gath_d, axis=0)  # ties → lowest shard
        q_ids = jnp.arange(d2_l.shape[0])
        return gath_i[win, q_ids], gath_d[win, q_ids]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(), P(), P(None, axis), P(axis), P(axis), P(axis), P(axis),
            P(axis),
        ),
        out_specs=(P(), P()),
        check_vma=False,  # outputs replicated by construction
    )
    return fn(queries, qmask, *sw)
