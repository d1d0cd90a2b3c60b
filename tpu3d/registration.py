"""High-level registration API: the reference's public surface.

``register_pair(source, target, config) -> (refined, coarse)`` is the
C-style entry the reference exposes through ``Registration``'s static
methods composed in ``Pipeline::processInstance`` (pipeline.cpp:92-129):
voxel downsample → normals → FPFH → RANSAC → ICP.

Static-shape strategy: stage boundaries re-bucket cloud capacity (powers of
two) so the O(N·M) registration ops compile once per bucket instead of once
per frame, and padding never exceeds 2x the live data.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from tpu3d.config import RegistrationConfig
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.fused_features import fused_prepare_features
from tpu3d.ops.grid import build_grid, grid_knn
from tpu3d.ops.slab import build_slab, slab_knn
from tpu3d.ops.icp import icp_refine
from tpu3d.ops.neighbors import knn
from tpu3d.ops.normals import estimate_normals
from tpu3d.ops.ransac import ransac_registration
from tpu3d.ops.voxel import compact, voxel_downsample
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult


def bucket_capacity(count: int, minimum: int = 256) -> int:
    """Next power-of-two bucket ≥ count (≥ minimum)."""
    cap = minimum
    while cap < count:
        cap *= 2
    return cap


# Capacity at which the fused radius-exact feature path takes over from the
# gather (reference-parity) path when neighbor_mode='auto'. Pair-level
# callers (register_pair, the pipeline) must resolve the mode ONCE from both
# clouds — mixing descriptor variants across a pair corrupts feature
# correspondences (the variants bin neighborhoods differently).
FUSED_CAPACITY_THRESHOLD = 16384


def two_stage_opt(v):
    """Config 'auto'|'on'|'off' → ransac_registration's two_stage arg."""
    return {"on": True, "off": False}.get(v, "auto")


def resolve_neighbor_mode(*capacities: int) -> str:
    """Pick one descriptor path for every cloud of a registration pair:
    'fused' when any participant is at scale, else 'auto' (gather — exact
    reference parity, and both sub-variants 'slab'/'brute' produce identical
    descriptors)."""
    return (
        "fused"
        if max(capacities) >= FUSED_CAPACITY_THRESHOLD
        else "auto"
    )


def downsample_bucketed(
    cloud: PointCloud,
    config: RegistrationConfig,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Voxel downsample + compact to a power-of-two capacity bucket.

    With an explicit ``capacity`` (the config's max_points), a cloud whose
    voxel count exceeds it is TRUNCATED — loudly, because a silently
    cropped reference model degrades every registration against it."""
    down = voxel_downsample(cloud, config.voxel_size)
    count = int(down.count())  # host sync at the stage boundary
    if capacity is None:
        capacity = bucket_capacity(max(count, 1))
    elif count > capacity:
        print(
            f"tpu3d: cloud has {count} voxels but max_points={capacity} — "
            "truncating; raise registration.max_points to keep full coverage"
        )
    return compact(down, capacity)


def surface_neighbors(
    cloud: PointCloud, radius, k: int = 100, mode: str = "auto"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One self-kNN (idx, d2) shared by normals (first 30 columns) and FPFH
    (all k, radius-gated).

    mode 'slab' sorts the cloud by x once and scans one contiguous slice per
    query block (ops/slab.py) — exact for the FPFH radius cap, and exact for
    the k=30 normals neighborhood whenever ≥ 30 points fall within the
    radius (the dense common case; sparse outliers get their in-radius
    subset). 'grid' is the 27-cell bucket variant (same semantics,
    gather-heavy). 'brute' is the full O(N²) scan matching the reference's
    findKNN (registration.cpp:63). 'auto': slab at scale, brute below
    (where brute is both exact and fast).
    """
    if mode == "auto":
        mode = "slab" if cloud.capacity >= 16384 else "brute"
    if mode == "slab":
        slab = build_slab(cloud.points, cloud.mask)
        # Query with the slab's OWN sorted points: query blocks are then
        # maximally x-coherent regardless of the caller's row order, and the
        # per-row results are un-sorted back at the end (returned idx values
        # are already original rows via sorted_orig).
        idx, d2, _overflow = slab_knn(slab, slab.sorted_points, radius, k=k)
        # Invert the permutation with one unique-index scatter (an argsort
        # re-pays the full O(n log n) sort network for what is a write).
        n_rows = slab.sorted_orig.shape[0]
        inv = (
            jnp.zeros((n_rows,), jnp.int32)
            .at[slab.sorted_orig]
            .set(jnp.arange(n_rows, dtype=jnp.int32), unique_indices=True)
        )
        return idx[inv], d2[inv]
    if mode == "grid":
        grid = build_grid(cloud.points, cloud.mask, radius)
        return grid_knn(grid, cloud.points, k=k)
    # 'brute' is the reference-parity path — exact top-k.
    return knn(cloud.points, cloud.points, cloud.mask, k=k)


def prepare_cloud(
    cloud: PointCloud,
    config: RegistrationConfig,
    capacity: Optional[int] = None,
    neighbor_mode: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Downsample + normals + FPFH — the per-cloud preprocessing the
    reference runs for both the scene instance (pipeline.cpp:92-95) and the
    reference model (pipeline.cpp:291-294): k=30 normals, FPFH radius =
    5 × voxel_size.

    At scale (capacity ≥ FUSED_CAPACITY_THRESHOLD, or
    neighbor_mode='fused') the fused slab-sweep path computes radius-exact
    normals+FPFH with no per-row top-k (ops/fused_features.py) — ~10x
    faster AND more discriminative than the reference's 100-capped
    neighborhoods; below that the gather path keeps exact reference parity.

    NOTE: when registering a PAIR, resolve the mode once for both clouds
    (``resolve_neighbor_mode``) — ``register_pair`` and the pipeline do."""
    down = downsample_bucketed(cloud, config, capacity)
    return prepare_features(down, config, neighbor_mode)


def prepare_features(
    down: PointCloud,
    config: RegistrationConfig,
    neighbor_mode: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH on an already-downsampled, compacted cloud."""
    capacity = down.capacity
    radius = jnp.float32(config.voxel_size * 5.0)
    use_fused = neighbor_mode == "fused" or (
        neighbor_mode == "auto" and capacity >= FUSED_CAPACITY_THRESHOLD
    )
    if use_fused:
        # The dynamic sub-tile sweeps are radius-exact for any occupancy —
        # no slice_cap/overflow handling exists anymore (fused_features v2).
        return fused_prepare_features(down, radius)
    nbrs = surface_neighbors(down, radius, k=100, mode=neighbor_mode)
    down = estimate_normals(down, k=30, neighbors=nbrs)
    features = compute_fpfh(down, radius, neighbors=nbrs)
    return down, features


def prepare_icp_target(
    cloud: PointCloud,
    config: RegistrationConfig,
    with_normals: bool = True,
) -> PointCloud:
    """Downsample + normals ONLY — the prep an ICP-only consumer needs.

    ICP reads the target's points and (for point-to-plane) its normals,
    never FPFH descriptors (registration.cpp:343-372), so the multiscale
    per-level target prep must not pay the full 33-bin FPFH sweep that
    ``prepare_cloud`` runs. ``with_normals=False`` (point-to-point) skips
    even the normal estimation."""
    down = downsample_bucketed(cloud, config)
    if not with_normals:
        return down
    radius = jnp.float32(config.voxel_size * 5.0)
    mode = "slab" if down.capacity >= FUSED_CAPACITY_THRESHOLD else "brute"
    nbrs = surface_neighbors(down, radius, k=30, mode=mode)
    return estimate_normals(down, k=30, neighbors=nbrs)


def register_prepared(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    config: RegistrationConfig,
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP on preprocessed clouds. Returns (refined, coarse).

    The config's exactness knobs (``corr_mode``/``src_mode``/``two_stage``,
    PARITY.md "Exact vs statistical metrics") flow through — 'exact'
    reproduces the reference's exact fitness/rmse."""
    two_stage = two_stage_opt(config.two_stage)
    coarse = ransac_registration(
        source,
        target,
        source_features,
        target_features,
        config.voxel_size,
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
        corr_mode=config.corr_mode,
        two_stage=two_stage,
    )
    refined = icp_refine(
        source,
        target,
        coarse.transformation,
        config.voxel_size * config.icp_distance_factor,
        max_iterations=config.icp_max_iterations,
        point_to_plane=config.use_point_to_plane,
        src_mode=config.src_mode,
    )
    return refined, coarse


def sparse_prepare_active(
    config: RegistrationConfig, neighbor_mode: str, src_capacity: int
) -> bool:
    """Should the SOURCE use the sparse query-subset prepare?

    'sparse' forces it; 'auto' enables it only where it cannot change the
    metric class: a kernel engine for the prepare walk (the GPU), fused
    descriptor path, corr_mode='auto' (which would strided-subsample to
    the same 8k rows anyway — ops/ransac.py use_sub gate), and the cloud
    at least 2x the subset."""
    from tpu3d.utils.platform import engine_for

    if config.prepare_mode == "sparse":
        return True
    return (
        config.prepare_mode == "auto"
        and neighbor_mode == "fused"
        and config.corr_mode == "auto"
        and src_capacity >= 2 * 8192
        and engine_for("prepare") == "triton"
    )


def sparse_register_escalated(
    src_down: PointCloud,
    tgt_down: PointCloud,
    tgt_feat: FPFHFeatures,
    *,
    voxel: float,
    radius,
    corr_cap: int = 8192,
    est_cap: int = 2048,
    src_cap: int = 16384,
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    icp_distance_factor: float = 0.4,
    icp_max_iterations: int = 200,
    point_to_plane: bool = True,
    two_stage="auto",
    src_mode: str = "auto",
    escalate_below: float = 0.3,
    interpret: bool = False,
) -> tuple[RegistrationResult, RegistrationResult, bool]:
    """The sparse-prepare registration arm with loud-failure escalation.

    Fast path: source descriptors only where the correspondence subset
    reads them (fused_prepare_sparse — every retained descriptor
    bit-identical to the dense fused path), RANSAC on the subset view,
    ICP from the raw downsampled source.

    Escalation (host-level restart, ``escalate_below`` > 0): the sparse
    subset's contiguous strata runs carry less pose-constraint diversity
    than a row-strided subset of the same size — on noisy scenes the
    sparse arm occasionally misses the basin the full-prepare
    corr_mode='auto' arm finds (AB_STATS r5: 3 of 10 noisy seeds, honest
    near-zero fitness). When the refined fitness lands below the
    threshold — i.e. a result the pipeline's min_fitness warning
    (pipeline.cpp:131-134) would reject anyway — the coarse+refine
    stages re-run through the full-prepare auto arm and the better
    result wins. Clean scenes never trigger it (fitness ≫ threshold),
    so the bench fast path is unchanged; hopeless scenes (0.5-voxel
    noise, where EVERY arm honestly fails) pay one dense
    prepare and still report the loud failure.

    Returns (refined, coarse, escalated).
    """
    from tpu3d.ops.fused_features import fused_prepare_sparse

    sub_c, sub_f, _ = fused_prepare_sparse(
        src_down, radius, corr_cap=corr_cap, interpret=interpret
    )
    coarse = ransac_registration(
        sub_c, tgt_down, sub_f, tgt_feat, voxel,
        max_iterations=max_iterations, confidence=confidence, seed=seed,
        corr_mode="exact", est_cap=est_cap,
        two_stage=two_stage_opt(two_stage)
        if isinstance(two_stage, str) else two_stage,
    )
    refined = icp_refine(
        src_down, tgt_down, coarse.transformation,
        voxel * icp_distance_factor, max_iterations=icp_max_iterations,
        point_to_plane=point_to_plane, src_mode=src_mode, src_cap=src_cap,
    )
    if escalate_below > 0 and float(refined.fitness) < escalate_below:
        src_full, src_feat = fused_prepare_features(
            src_down, radius, interpret=interpret
        )
        coarse2 = ransac_registration(
            src_full, tgt_down, src_feat, tgt_feat, voxel,
            max_iterations=max_iterations, confidence=confidence,
            seed=seed, corr_mode="auto", corr_cap=corr_cap,
            est_cap=est_cap,
            two_stage=two_stage_opt(two_stage)
            if isinstance(two_stage, str) else two_stage,
        )
        refined2 = icp_refine(
            src_full, tgt_down, coarse2.transformation,
            voxel * icp_distance_factor,
            max_iterations=icp_max_iterations,
            point_to_plane=point_to_plane, src_mode=src_mode,
            src_cap=src_cap,
        )
        if float(refined2.fitness) > float(refined.fitness):
            return refined2, coarse2, True
    return refined, coarse, False


def register_pair(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    mesh=None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Full pipeline on two raw clouds: the public "register a cloud pair →
    4x4 pose + fitness + rmse" API (BASELINE.json north_star).

    ``mesh``: a ``jax.sharding.Mesh`` with a 'shard' axis of ≥2 devices
    routes every stage through the distributed stack
    (tpu3d/parallel/register_sharded.py) — the multi-chip product surface.
    """
    if config is None:
        config = RegistrationConfig()
    if mesh is not None and mesh.devices.size >= 2:
        from tpu3d.parallel.register_sharded import register_pair_sharded

        return register_pair_sharded(source, target, config, mesh)
    src_down = downsample_bucketed(source, config)
    tgt_down = downsample_bucketed(target, config)
    # One descriptor variant for BOTH clouds — a pair straddling the fused
    # threshold must not mix fused and gather descriptors.
    mode = resolve_neighbor_mode(src_down.capacity, tgt_down.capacity)
    if sparse_prepare_active(config, mode, src_down.capacity):
        # Source descriptors only where the correspondence subset needs
        # them (each retained descriptor bit-identical to the dense fused
        # path); RANSAC consumes the subset view with corr_mode='exact' —
        # the same statistical envelope as corr_mode='auto'. ICP never
        # reads source normals (p2plane uses the TARGET's), so it refines
        # from the raw downsampled source. Below-min_fitness results
        # escalate through the full-prepare auto arm (see
        # sparse_register_escalated).
        esc = config.sparse_escalate_fitness
        if esc == "auto":
            esc = config.min_fitness
        tgt_down, tgt_feat = prepare_features(tgt_down, config, "fused")
        refined, coarse, _ = sparse_register_escalated(
            src_down,
            tgt_down,
            tgt_feat,
            voxel=config.voxel_size,
            radius=jnp.float32(config.voxel_size * 5.0),
            max_iterations=config.ransac_max_iterations,
            confidence=config.ransac_confidence,
            seed=config.ransac_seed,
            icp_distance_factor=config.icp_distance_factor,
            icp_max_iterations=config.icp_max_iterations,
            point_to_plane=config.use_point_to_plane,
            two_stage=config.two_stage,
            src_mode=config.src_mode,
            escalate_below=float(esc),
        )
        return refined, coarse
    src_down, src_feat = prepare_features(src_down, config, mode)
    tgt_down, tgt_feat = prepare_features(tgt_down, config, mode)
    return register_prepared(src_down, tgt_down, src_feat, tgt_feat, config)


def register_pair_multiscale(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    levels: int = 2,
    scale_step: float = 3.0,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Coarse-to-fine registration (capability beyond the reference).

    Runs RANSAC once at the coarsest voxel level, then refines with ICP
    through progressively finer voxel sizes (each level warm-starts the
    next, with a threshold proportional to its voxel). Sturdier than a
    single-level run when the initial misalignment is large relative to the
    fine voxel size, and cheaper: the expensive FPFH+RANSAC stage sees the
    small coarse cloud only. Returns (refined at the finest level, coarse).
    """
    import dataclasses

    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if config is None:
        config = RegistrationConfig()
    voxels = [
        config.voxel_size * scale_step**i for i in reversed(range(levels))
    ]  # coarsest → finest

    coarse_cfg = dataclasses.replace(config, voxel_size=voxels[0])
    src_cd = downsample_bucketed(source, coarse_cfg)
    tgt_cd = downsample_bucketed(target, coarse_cfg)
    mode = resolve_neighbor_mode(src_cd.capacity, tgt_cd.capacity)
    src_c, sf_c = prepare_features(src_cd, coarse_cfg, mode)
    tgt_c, tf_c = prepare_features(tgt_cd, coarse_cfg, mode)
    coarse = ransac_registration(
        src_c, tgt_c, sf_c, tf_c, voxels[0],
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
    )
    T = coarse.transformation
    refined = coarse
    finest = voxels[-1]
    for voxel in voxels:
        lvl_cfg = dataclasses.replace(config, voxel_size=voxel)
        down = voxel_downsample(source, voxel)
        src_l = compact(down, bucket_capacity(max(int(down.count()), 1)))
        # Normals-only target prep: per-level ICP never reads FPFH, so
        # the full prepare_cloud here recomputed a dead 33-bin descriptor
        # sweep per level (and p2point levels skip normals too).
        tgt_l = prepare_icp_target(
            target, lvl_cfg, with_normals=config.use_point_to_plane
        )
        # Coarse levels use a generous threshold (1x voxel) to capture the
        # remaining misalignment; the finest level applies the reference's
        # icp_distance_factor semantics.
        factor = config.icp_distance_factor if voxel == finest else 1.0
        refined = icp_refine(
            src_l,
            tgt_l,
            T,
            voxel * factor,
            max_iterations=config.icp_max_iterations,
            point_to_plane=config.use_point_to_plane,
        )
        T = refined.transformation
    return refined, coarse
