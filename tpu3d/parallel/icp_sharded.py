"""ICP with the target cloud sharded across a device mesh.

Completes BASELINE.json configs[4]: at 1M+ points the target cloud no longer
fits one chip's working set comfortably — shard its rows over a mesh axis
and run the per-iteration correspondence search distributed. Round 2
unified this with the single-chip loop: this module is now ONLY the
correspondence plug (per-shard slab top-1 + global argmin over an
all_gather that moves (n_shards × queries) scalars between devices); the
Gauss-Newton/Kabsch iteration, convergence and result semantics come from
``tpu3d.ops.icp.icp_loop`` + ``gathered_stats_fn`` — one loop body, no
drift between the single-chip and sharded paths.

Each shard x-sorts its rows ONCE (build_slab_sharded) so the per-iteration
search inside a shard is O(Q·L_occ) contiguous slab slices, not the
O(Q·M/n_shards) brute scan round 1 shipped.

Gathers of matched target points/normals (rows live on other shards) are
done on the replicated copies of ``points``/``normals`` that XLA keeps
addressable through the sharded arrays — at these scales the per-iteration
gather of (N, 3) rows is cheap relative to the distance scan it avoids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpu3d.ops.icp import gathered_stats_fn, icp_loop
from tpu3d.ops.transforms import transform_points
from tpu3d.parallel.sharded_nn import (
    build_slab_sharded,
    build_walk_sharded,
    nearest_neighbor_sharded,
    slab2_top1_sharded,
    slab_top1_sharded,
)
from tpu3d.types import PointCloud, RegistrationResult


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iterations", "point_to_plane", "mesh", "axis", "nn_mode",
        "slice_cap",
    ),
)
def icp_refine_sharded(
    source: PointCloud,
    target: PointCloud,
    initial_transform: jnp.ndarray,
    distance_threshold,
    mesh: Mesh,
    axis: str = "shard",
    max_iterations: int = 200,
    point_to_plane: bool = True,
    nn_mode: str = "slab2",
    slice_cap: int = 4096,
) -> RegistrationResult:
    """Same semantics as ops.icp.icp_refine; target rows sharded over
    ``axis`` (row count must divide the axis size — pad with masked rows).

    ``nn_mode``:
      'slab2' — per-shard slab2 + window walk (radius-exact for ANY
                occupancy, no static cap — the single-chip round-2
                exactness contract, distributed); the default.
      'slab'  — legacy per-shard 1-D x-sorted slices with a static
                ``slice_cap`` (can truncate on degenerate shards).
      'brute' — per-shard full scan."""
    thr = jnp.asarray(distance_threshold, jnp.float32)
    use_p2l = point_to_plane and target.normals is not None
    n_valid = jnp.maximum(jnp.sum(source.mask.astype(jnp.float32)), 1.0)
    src_pts = source.points.astype(jnp.float32)
    smask = source.mask

    if nn_mode == "slab2":
        # Per-shard slab2 walk targets built ONCE; every iteration's query
        # pass handles its own query-side coherence sort internally.
        sw = build_walk_sharded(target.points, target.mask, thr, mesh, axis)

        def corr_fn(P):
            return slab2_top1_sharded(
                sw, P, smask, thr, mesh, axis=axis
            )

    elif nn_mode == "slab":
        # Build per-shard slabs ONCE (the target never moves) and keep the
        # source x-sorted so slab query blocks stay coherent; all loop
        # reductions are permutation-invariant, so no un-sorting is needed.
        sslab = build_slab_sharded(target.points, target.mask, mesh, axis)
        x0 = transform_points(
            initial_transform.astype(jnp.float32), src_pts
        )[:, 0]
        # Payload rides the sort network (stable, like argsort) — cheaper
        # than the two [order] row gathers it replaces (see ops/slab2.py).
        _, ssx, ssy, ssz, ssm = jax.lax.sort(
            (
                jnp.where(smask, x0, jnp.float32(3e4)),
                src_pts[:, 0], src_pts[:, 1], src_pts[:, 2],
                smask.astype(jnp.float32),
            ),
            num_keys=1,
        )
        src_pts = jnp.stack([ssx, ssy, ssz], axis=1)
        smask = ssm > 0.5

        def corr_fn(P):
            return slab_top1_sharded(
                sslab, P, thr, mesh, axis=axis, slice_cap=slice_cap
            )

    else:

        def corr_fn(P):
            return nearest_neighbor_sharded(
                P, target.points, target.mask, mesh, axis=axis
            )

    stats = gathered_stats_fn(
        corr_fn, src_pts, smask, target.points,
        target.normals if use_p2l else None, thr, use_p2l,
    )
    return icp_loop(stats, n_valid, initial_transform, max_iterations,
                    use_p2l)
