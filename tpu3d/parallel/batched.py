"""Batched multi-instance registration (the bin-picking fan-out, on device).

The reference fans instances out over a host thread pool
(pipeline.cpp:321-339, thread_pool.hpp:50-70). On the device the idiomatic
equivalent is a leading vmap axis: all instances' RANSAC hypothesis batches
and ICP iterations run as one fused program, and sharding that batch axis
over a mesh ('inst') makes it data-parallel across chips — XLA inserts the
collectives.

Note the reference seeds mt19937(42) PER INSTANCE (each processInstance call
constructs its own rng, registration.cpp:235), so using one seed for every
instance in the batch is parity, not a shortcut.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu3d.ops.icp import icp_refine
from tpu3d.ops.ransac import ransac_registration
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult


def stack_clouds(clouds: list[PointCloud]) -> PointCloud:
    """Stack same-capacity clouds along a new leading instance axis."""
    caps = {c.capacity for c in clouds}
    if len(caps) != 1:
        raise ValueError(f"clouds must share a capacity bucket, got {caps}")

    def stk(field):
        vals = [getattr(c, field) for c in clouds]
        if any(v is None for v in vals):
            return None
        return jnp.stack(vals)

    return PointCloud(
        points=stk("points"),
        mask=stk("mask"),
        normals=stk("normals"),
        colors=stk("colors"),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "ransac_max_iterations",
        "icp_max_iterations",
        "point_to_plane",
        "ransac_chunk",
        "corr_mode",
        "src_mode",
        "two_stage",
    ),
)
def register_batch(
    sources: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size,
    ransac_max_iterations: int = 10000,
    ransac_confidence: float = 0.999,
    icp_distance_factor: float = 0.4,
    icp_max_iterations: int = 200,
    point_to_plane: bool = True,
    seed: int = 42,
    ransac_chunk: int = 512,
    corr_mode: str = "auto",
    src_mode: str = "auto",
    two_stage: str | bool = "auto",
    ransac_sources: PointCloud | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP for a batch of source instances against one target.

    sources/source_features carry a leading instance axis; target is shared.
    Returns (refined, coarse), each with leading instance axis.
    ``corr_mode``/``src_mode``/``two_stage`` are the same exactness knobs as
    the scalar path (ops/ransac.py, ops/icp.py) — 'exact' requests
    reference-exact fitness/rmse.

    ``ransac_sources``: optional batch of RANSAC-only subset views (the
    sparse-prepare output, ops/fused_features.fused_prepare_sparse — same
    subset capacity across instances by construction). When given, RANSAC
    consumes these views with their ``source_features`` while ICP refines
    the FULL ``sources`` clouds — the batched analog of the scalar sparse
    path (pipeline ``prepare_mode``), so 64-instance vmap fan-out and
    sparse prepare compose instead of excluding each other. The views are
    already the correspondence subset, so corr_mode is forced 'exact'."""

    def one(
        src: PointCloud, feat: FPFHFeatures, rsrc: PointCloud | None
    ):
        coarse = ransac_registration(
            src if rsrc is None else rsrc,
            target,
            feat,
            target_features,
            voxel_size,
            max_iterations=ransac_max_iterations,
            confidence=ransac_confidence,
            seed=seed,
            chunk=ransac_chunk,
            corr_mode="exact" if rsrc is not None else corr_mode,
            two_stage=two_stage,
        )
        refined = icp_refine(
            src,
            target,
            coarse.transformation,
            jnp.asarray(voxel_size, jnp.float32) * icp_distance_factor,
            max_iterations=icp_max_iterations,
            point_to_plane=point_to_plane,
            src_mode=src_mode,
        )
        return refined, coarse

    if ransac_sources is None:
        return jax.vmap(lambda s, f: one(s, f, None))(
            sources, source_features
        )
    return jax.vmap(one)(sources, source_features, ransac_sources)


def shard_instances(
    sources: PointCloud,
    source_features: FPFHFeatures,
    mesh: Mesh,
    axis: str = "inst",
) -> tuple[PointCloud, FPFHFeatures]:
    """Place the instance batch axis across a mesh axis (data parallel)."""
    sh = NamedSharding(mesh, P(axis))

    def put(a):
        return None if a is None else jax.device_put(a, sh)

    return (
        PointCloud(
            points=put(sources.points),
            mask=put(sources.mask),
            normals=put(sources.normals),
            colors=put(sources.colors),
        ),
        FPFHFeatures(
            descriptors=put(source_features.descriptors),
            mask=put(source_features.mask),
        ),
    )
