"""ICP fine registration — fully on-device iteration.

Reference semantics (CPU path, src/registration.cpp:297-414 — which the
survey designates as the behavioral oracle; the CUDA variant's
untransformed-Jacobian quirk at icp.cu:109-111 is deliberately NOT copied):

  per iteration with current transform T:
    - correspondences: nearest target per *transformed* source point,
      rejected when distance > threshold (inclusive keep, :337-338);
    - break (without updating) when fewer than 3 correspondences (:361);
    - point-to-plane: J = [p×n | n] with TRANSFORMED p, residual (p−q)·n,
      solve ATA·x = −ATb, delta = Rx(a)Ry(b)Rz(g) exact trig + translation
      (:343-372); point-to-point: Kabsch over the correspondence set
      (:373-397);
    - T ← delta·T (:399); rmse over correspondence distances, fitness =
      n_corr/N (:401-404) — note both describe the PRE-update transform
      while the returned transformation is POST-update, faithfully kept;
    - converge when iter > 0 and |Δrmse| < 1e-6 (:406-409).

Device formulation: one ``lax.while_loop`` whose body reduces the whole
correspondence problem to a handful of scalars. The shared loop
(``icp_loop``) takes a pluggable ``stats_fn(T) -> IcpStats``; two backends
provide it:

  * **fused slab walk** (``nn_mode='slab'``, the at-scale path): per query
    block, the window walk (ops/walk.py) scans the target's x-sorted slab
    window and finds each point's nearest target, carrying the matched
    point and normal as payload planes (extracted with masked plane
    reductions — ZERO global gathers, radius-exact for any occupancy);
    the normal equations (6x6 JtJ / Jtr) or Kabsch moments are reduced
    from those planes.
  * **gathered** (grid/brute modes, and the sharded-target backend in
    tpu3d/parallel/icp_sharded.py): any top-1 correspondence function,
    then masked einsums over the gathered matches.

Both replace cuda/icp.cu:84-141's warp-shuffle + atomicAdd reductions with
deterministic matmul/plane reductions; the host is never touched between
iterations (the reference's per-iteration D2H of full correspondence
arrays, gpu_impl.cpp:225-242, has no analog here).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from tpu3d.ops.grid import build_grid, grid_top1
from tpu3d.ops.nn_pallas import nearest_neighbor
from tpu3d.ops.slab import SlabIndex, _block_slices, build_slab
from tpu3d.ops.transforms import (
    euler_xyz_to_matrix,
    kabsch_from_cross_cov,
    make_transform,
    transform_points,
)
from tpu3d.ops.nn_walk import top1_sweep
from tpu3d.ops.walk import walk
from tpu3d.types import PointCloud, RegistrationResult
from tpu3d.utils.platform import resolve_engine


class IcpTargetIndex(NamedTuple):
    """Per-target search structure, built ONCE and reusable across every
    registration against the same target (the pipeline registers many
    instances against one reference model, pipeline.cpp:321-339 — the
    x-sort and the normals reorder are properties of the model, like its
    FPFH, and amortize the same way)."""

    slab: SlabIndex
    nrm_sorted_t: jnp.ndarray | None  # f32[3, M] normals in slab order


def build_icp_target(target: PointCloud) -> IcpTargetIndex:
    """Precompute the slab index (+ slab-ordered normals) for a target."""
    slab = build_slab(target.points, target.mask)
    nrm = (
        None
        if target.normals is None
        else target.normals[slab.sorted_orig].T
    )
    return IcpTargetIndex(slab=slab, nrm_sorted_t=nrm)


class IcpStats(NamedTuple):
    """Sufficient statistics of one correspondence pass.

    p2plane: ata (6,6), atb (6,) populated; Kabsch stats zeros.
    p2point: sw, sp/sq (3,) weighted coordinate sums, H (3,3) the
    exact-mean-centered weighted cross-covariance; ata/atb zeros.
    Always: n_corr (Σ inliers), sum_d2 (Σ inlier squared distances).
    """

    ata: jnp.ndarray
    atb: jnp.ndarray
    sw: jnp.ndarray
    sp: jnp.ndarray
    sq: jnp.ndarray
    H: jnp.ndarray
    n_corr: jnp.ndarray
    sum_d2: jnp.ndarray


def _solve_spd6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = A⁻¹ b for a symmetric positive-(semi)definite 6x6 — unrolled
    scalar Cholesky + two substitutions (~90 scalar ops). The generic
    ``jnp.linalg.solve`` lowers to LU with pivoting (gathers + control
    flow) which costs real fractions of a millisecond PER CALL on a device,
    and this runs once per ICP iteration inside the while_loop. JtJ here
    is A = ΣJJᵀ, always SPD when the matches span 6 DoF; rank-deficient
    systems produce inf/nan exactly like LU did, and icp_loop's finite
    guard keeps the last finite pose either way."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def icp_loop(
    stats_fn: Callable[[jnp.ndarray], IcpStats],
    n_valid: jnp.ndarray,
    initial_transform: jnp.ndarray,
    max_iterations: int,
    point_to_plane: bool,
) -> RegistrationResult:
    """The shared Gauss-Newton / Kabsch iteration driver."""

    def body(state):
        T, fitness, rmse, it, done = state
        s = stats_fn(T)

        if point_to_plane:
            x = _solve_spd6(s.ata, -s.atb)
            delta = make_transform(euler_xyz_to_matrix(x[:3]), x[3:])
        else:
            R, t = kabsch_from_cross_cov(s.sw, s.sp, s.sq, s.H)
            delta = make_transform(R, t)

        newT = delta @ T
        new_rmse = jnp.sqrt(s.sum_d2 / jnp.maximum(s.n_corr, 1.0))
        new_fit = s.n_corr / n_valid

        abort = s.n_corr < 3.0  # break BEFORE updating anything (:361)
        # Singular/ill-conditioned solve (few or degenerate matches under a
        # junk initial pose): the 6x6 solve or the Kabsch step can return
        # non-finite entries. Keep the last finite T and stop — fitness and
        # rmse stay valid (they are measured at T, pre-update). Without
        # this the NaN pose survives to the caller even though the
        # reported metrics look sane.
        bad = ~jnp.all(jnp.isfinite(newT))
        converged = (it > 0) & (jnp.abs(rmse - new_rmse) < 1e-6)
        return (
            jnp.where(abort | bad, T, newT),
            jnp.where(abort, fitness, new_fit),
            jnp.where(abort, rmse, new_rmse),
            it + 1,
            abort | bad | converged,
        )

    def cond(state):
        _, _, _, it, done = state
        return (it < max_iterations) & jnp.logical_not(done)

    init = (
        initial_transform.astype(jnp.float32),
        jnp.float32(0.0),
        jnp.float32(0.0),  # RegistrationResult default rmse (hpp:29)
        jnp.int32(0),
        jnp.bool_(False),
    )
    T, fitness, rmse, _, _ = jax.lax.while_loop(cond, body, init)
    return RegistrationResult(transformation=T, fitness=fitness, rmse=rmse)


def _zeros_stats() -> dict:
    return dict(
        ata=jnp.zeros((6, 6), jnp.float32),
        atb=jnp.zeros((6,), jnp.float32),
        sw=jnp.float32(0.0),
        sp=jnp.zeros((3,), jnp.float32),
        sq=jnp.zeros((3,), jnp.float32),
        H=jnp.zeros((3, 3), jnp.float32),
    )


def _p2p_stats(P, q, wf):
    """Exact-mean-centered Kabsch statistics over full match arrays — the
    same arithmetic as transforms.kabsch, split out so both stats backends
    produce numerically identical p2point updates."""
    sw = jnp.sum(wf)
    sws = jnp.maximum(sw, 1e-12)
    sp = jnp.sum(P * wf[:, None], axis=0)
    sq = jnp.sum(q * wf[:, None], axis=0)
    Pc = (P - sp / sws) * wf[:, None]
    qc = q - sq / sws
    return dict(sw=sw, sp=sp, sq=sq, H=Pc.T @ qc)


def gathered_stats_fn(
    corr_fn: Callable[[jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]],
    src_pts: jnp.ndarray,
    smask: jnp.ndarray,
    target_points: jnp.ndarray,
    target_normals: jnp.ndarray | None,
    thr,
    point_to_plane: bool,
) -> Callable[[jnp.ndarray], IcpStats]:
    """Stats from any top-1 correspondence search: ``corr_fn(P) -> (idx,
    d2)`` with original target row indices; matches are gathered and reduced
    with masked einsums. Used by the grid/brute modes and by the
    sharded-target backend (parallel/icp_sharded.py)."""
    thr2 = jnp.asarray(thr, jnp.float32) ** 2

    def stats(T: jnp.ndarray) -> IcpStats:
        P = transform_points(T, src_pts)
        idx, d2 = corr_fn(P)
        keep = smask & (d2 <= thr2)  # inclusive, :337-338
        wf = keep.astype(jnp.float32)
        n_corr = jnp.sum(wf)
        sum_d2 = jnp.sum(jnp.where(keep, d2, 0.0))
        q = target_points[idx]
        out = _zeros_stats()

        if point_to_plane:
            nrm = target_normals[idx]
            cross = jnp.cross(P, nrm)
            J = jnp.concatenate([cross, nrm], axis=1)  # (N, 6)
            r = jnp.sum((P - q) * nrm, axis=1)
            Jw = J * wf[:, None]
            out["ata"] = Jw.T @ J  # deterministic matmul reduction
            out["atb"] = (Jw.T @ r[:, None])[:, 0]
        else:
            out.update(_p2p_stats(P, q, wf))
        return IcpStats(n_corr=n_corr, sum_d2=sum_d2, **out)

    return stats


# (query block, candidate tile) per engine for the ICP correspondence walk.
ICP_BLOCKS = {"triton": (64, 128), "xla": (256, 512)}

_P2PLANE = top1_sweep((0, 1, 2, 3, 4, 5))  # payload: matched point + normal
_P2POINT = top1_sweep((0, 1, 2))  # payload: matched point


def fused_slab_stats_fn(
    index: IcpTargetIndex,
    src_pts: jnp.ndarray,
    smask: jnp.ndarray,
    thr,
    point_to_plane: bool,
    block: int | None = None,
    sub: int | None = None,
    engine: str = "auto",
    interpret: bool = False,
) -> Callable[[jnp.ndarray], IcpStats]:
    """The fused at-scale backend: one window walk per iteration finds each
    source point's nearest target within the threshold (radius-exact for
    any occupancy, zero global gathers — the matched point and normal ride
    the walk as payload planes), then the normal equations (6x6 JtJ / Jtr)
    or the Kabsch moments are reduced from those planes.

    ``src_pts`` should be pre-sorted by (initial-transform) x so query
    blocks stay slab-coherent; every reduction here is permutation
    invariant, so no un-sorting is needed."""
    engine = resolve_engine(engine, "icp", interpret)
    b0, s0 = ICP_BLOCKS[engine]
    block = b0 if block is None else block
    sub = s0 if sub is None else sub
    slab = index.slab
    thr_f = jnp.asarray(thr, jnp.float32)
    thr2 = thr_f * thr_f
    use_p2l = point_to_plane and index.nrm_sorted_t is not None
    valid = slab.valid_sorted[None, :]
    planes = [jnp.where(valid, slab.sorted_points_t, 3.0e4)]
    if use_p2l:
        planes.append(jnp.where(valid, index.nrm_sorted_t, 0.0))
    packed = jnp.concatenate(planes, axis=0)  # (3|6, M)
    sweep = _P2PLANE if use_p2l else _P2POINT

    n = src_pts.shape[0]
    pad = (-n) % block
    smask_p = jnp.pad(smask, (0, pad))
    src_p = jnp.pad(src_pts, ((0, pad), (0, 0)))
    nb = (n + pad) // block
    mrow = smask_p.astype(jnp.float32)[None, :]

    def stats(T: jnp.ndarray) -> IcpStats:
        P = transform_points(T, src_p)  # (Np, 3)
        # Padded/invalid queries must not skew the block x-window.
        qx = jnp.where(smask_p, P[:, 0], jnp.float32(2.9e4))
        lo, length = _block_slices(slab, qx.reshape(nb, block), thr_f)
        out = walk(
            sweep, jnp.concatenate([P.T, mrow], axis=0), packed,
            lo[:, None], length[:, None], (thr2,), block=block, sub=sub,
            engine=engine, stage="icp", interpret=interpret,
        )
        bd = out[0]
        keep = bd <= thr2  # inclusive, :337-338 (masked rows carry 1e30)
        wf = keep.astype(jnp.float32)
        n_corr = jnp.sum(wf)
        sum_d2 = jnp.sum(jnp.where(keep, bd, 0.0))
        bq = out[1:4].T
        res = _zeros_stats()
        if use_p2l:
            bn = out[4:7].T
            J = jnp.concatenate([jnp.cross(P, bn), bn], axis=1)  # (Np, 6)
            r = jnp.sum((P - bq) * bn, axis=1)
            Jw = J * wf[:, None]
            res["ata"] = Jw.T @ J
            res["atb"] = Jw.T @ r
        else:
            res.update(_p2p_stats(P, bq, wf))
        return IcpStats(n_corr=n_corr, sum_d2=sum_d2, **res)

    return stats


@functools.partial(
    jax.jit,
    static_argnames=("max_iterations", "point_to_plane", "nn_mode",
                     "cell_capacity", "block", "sub", "src_cap", "src_mode",
                     "final_metrics", "polish", "polish_iters"),
)
def icp_refine(
    source: PointCloud,
    target: PointCloud,
    initial_transform: jnp.ndarray,
    distance_threshold,
    max_iterations: int = 200,
    point_to_plane: bool = True,
    nn_mode: str = "auto",
    cell_capacity: int = 16,
    block: int | None = None,
    sub: int | None = None,
    target_index: IcpTargetIndex | None = None,
    src_cap: int = 16384,
    src_mode: str = "auto",
    final_metrics: str = "auto",
    polish: str = "auto",
    polish_iters: int = 8,
    polish_threshold: float = 0.5,
) -> RegistrationResult:
    """``nn_mode`` selects the correspondence backend — ALL exact for ICP's
    semantics (matches beyond the threshold are rejected anyway,
    registration.cpp:337-338):
      'slab'  — fused slab sweep (radius-exact for ANY occupancy; the
                round-1 slice_cap truncation no longer exists); O(N·L_occ)
                per iteration, the fast path at scale.
      'grid'  — 27-cell bucket scan (ops/grid.py); exact, gather-heavy.
      'brute' — tiled full scan (ops/nn_pallas.nearest_neighbor).
      'auto'  — slab for targets ≥ 4096 points, brute below.

    ``src_mode``/``src_cap``: at scale the slab path's dominant FIXED cost
    is the 100k-row source x-sort, and every iteration scans all source
    rows — but Gauss-Newton only consumes correspondences statistically
    (a 6-dof solve from tens of thousands of residuals). 'auto' (or
    'subsample') runs the iteration on a strided ``src_cap``-row subset
    of the source when the cloud is ≥ 2x that size — the same statistical
    class as RANSAC's ``corr_mode`` (each correspondence still exact;
    fitness/rmse become subset estimates with σ ≈ 0.4% at 16k; pose noise
    scales 1/√n_corr, far below the convergence tolerance). 'exact'
    always iterates every source row (the reference's semantics,
    registration.cpp:321-339).

    ``final_metrics``: what the RETURNED fitness/rmse are when the source
    was subsetted. The r3 defect was WHICH POSE the reported number
    described: the loop's metrics are pre-update stats of the LAST
    iteration's pose, and on noisy scenes fitness is pose-steep enough
    that the ``min_fitness`` gate (pipeline.cpp:131-134) saw errors far
    past the subset's sampling sigma. All modes below fix the pose; they
    differ in whether the final pass re-scores the subset or the full
    cloud:
      'auto' (default) — ONE extra SUBSET stats pass at the returned
        pose (reuses the iteration closure; ~1 iteration's cost, no new
        sort). The reported fitness is then a pure sampling estimate of
        the full-cloud number at the right pose — sigma ~0.4% at 16k
        rows, gated <=0.02 at-same-pose in AB_STATS (clean AND noisy).
      'exact' — one extra FULL-SOURCE pass at the returned pose
        (x-sort + walk over all rows): the reported
        fitness is the exact full-cloud inlier fraction, the reference's
        own number at that pose.
      'estimate' — keep the loop's metrics (free; pre-update pose).
    Semantic note: 'auto'/'exact' metrics describe the RETURNED
    (post-update) transform, where the reference reports the pre-update
    metrics of its last iteration — at |Δrmse| < 1e-6 convergence the
    difference is below the estimate noise either way.

    ``polish``/``polish_iters``/``polish_threshold``: adaptive exact
    refinement for borderline scenes (VERDICT r4 item 3). On noisy scenes
    the subset iteration's Gauss-Newton minimum wanders inside the
    0.4-voxel inlier tube more than the full-source one (fewer residuals
    averaging the noise), and fitness is pose-steep there — the
    ``min_fitness`` warn decision (pipeline.cpp:131-134) could diverge
    from the reference's. 'auto' (default): when the source was subsetted
    AND the converged fitness lands below ``polish_threshold``, continue
    with up to ``polish_iters`` FULL-SOURCE exact iterations from the
    subset pose and report exact metrics at the polished pose. The branch
    (including its full-source x-sort) runs under ``lax.cond`` — clean
    scenes (fitness ≈ 1) pay zero device time. 'off' disables."""
    thr = jnp.asarray(distance_threshold, jnp.float32)
    use_p2l = point_to_plane and target.normals is not None  # trace-time, like
    # the reference's `point_to_plane && target.hasNormals()` (:343, :365)
    # ``block``/``sub`` (None = ICP_BLOCKS for the engine) only move the
    # work/overhead balance of the correspondence walk, never its result.
    src_pts = source.points.astype(jnp.float32)
    smask = source.mask

    if nn_mode == "auto":
        nn_mode = "slab" if target.capacity >= 4096 else "brute"

    src_full, smask_full = src_pts, smask
    use_sub = (
        nn_mode == "slab"
        and src_mode in ("subsample", "auto")
        and src_pts.shape[0] >= 2 * src_cap  # small clouds: exact always
    )
    if use_sub:
        # Strided decimation (reshape + major-axis slice — gather-free;
        # see ops/ransac.py's corr subsample and decimation_stride for
        # the layout/raster-aliasing rationale).
        from tpu3d.ops.ransac import decimation_stride

        stride = decimation_stride(src_pts.shape[0], src_cap)
        take = stride * src_cap
        src_pts = src_pts[:take].reshape(src_cap, stride, 3)[:, 0]
        smask = smask[:take].reshape(src_cap, stride)[:, 0]

    n_valid = jnp.maximum(jnp.sum(smask.astype(jnp.float32)), 1.0)

    if nn_mode == "slab":
        # Structures are built ONCE and reused every iteration (the target
        # never moves; only the source transform changes) — or passed in
        # prebuilt (``target_index``) when many sources register against
        # the same target. Re-order the source once by initial-transformed
        # x so slab query blocks stay coherent for any input row order;
        # every ICP reduction is permutation-invariant, so no un-sorting is
        # needed.
        index = (
            target_index
            if target_index is not None
            else build_icp_target(target)
        )
        x0 = transform_points(initial_transform.astype(jnp.float32), src_pts)[
            :, 0
        ]
        # Payload rides the sort network (stable, like argsort) — at the
        # src_mode='exact' 100k scale the two [order] gathers this
        # replaces are avoided (see ops/slab2.py).
        _, ssx, ssy, ssz, ssm = jax.lax.sort(
            (
                jnp.where(smask, x0, jnp.float32(3e4)),
                src_pts[:, 0], src_pts[:, 1], src_pts[:, 2],
                smask.astype(jnp.float32),
            ),
            num_keys=1,
        )
        stats = fused_slab_stats_fn(
            index,
            jnp.stack([ssx, ssy, ssz], axis=1),
            ssm > 0.5,
            thr,
            use_p2l,
            block=block,
            sub=sub,
        )
    else:
        if nn_mode == "grid":
            grid = build_grid(target.points, target.mask, thr)

            def corr_fn(P):
                return grid_top1(grid, P, cell_capacity=cell_capacity)

        else:

            def corr_fn(P):
                return nearest_neighbor(P, target.points, target.mask)

        stats = gathered_stats_fn(
            corr_fn, src_pts, smask, target.points,
            target.normals if use_p2l else None, thr, use_p2l,
        )

    res = icp_loop(
        stats, n_valid, initial_transform, max_iterations, use_p2l
    )

    if use_sub and final_metrics == "auto":
        # Subset re-score at the RETURNED pose (see the docstring): the
        # iteration closure recomputes its x-windows from the transformed
        # queries on every call, so it is exact for any pose — the subset
        # order (sorted at the initial transform) only has to stay NEAR
        # sorted for the windows to stay tight, the same property every
        # loop iteration already relies on as the pose drifts.
        s = stats(res.transformation)
        res = RegistrationResult(
            transformation=res.transformation,
            fitness=s.n_corr / n_valid,
            rmse=jnp.where(
                s.n_corr > 0,
                jnp.sqrt(s.sum_d2 / jnp.maximum(s.n_corr, 1.0)),
                0.0,
            ),
        )
    elif use_sub and final_metrics == "exact":
        # Exact final metrics: one full-source pass at the converged pose.
        # One full x-sort (multi-operand lax.sort: the coordinate planes
        # ride the sort network instead of a separate (N,3) row gather)
        # + one walk whose tile count scales with the full
        # row count (~6x the subset iteration's). The sweep always runs on
        # the slab backend (exact nearest-within-threshold for any
        # occupancy) — grid/brute iteration modes have no per-target index
        # in scope, so build one here for the single final pass.
        if nn_mode != "slab":
            index = (
                target_index
                if target_index is not None
                else build_icp_target(target)
            )
        xf = transform_points(res.transformation, src_full)[:, 0]
        key = jnp.where(smask_full, xf, jnp.float32(3e4))
        skey, sx, sy, sz = jax.lax.sort(
            (key, src_full[:, 0], src_full[:, 1], src_full[:, 2]),
            num_keys=1,
        )
        sm = skey < jnp.float32(2.9e4)
        stats_exact = fused_slab_stats_fn(
            index, jnp.stack([sx, sy, sz], axis=1), sm, thr, use_p2l,
            block=block, sub=sub,
        )
        s = stats_exact(res.transformation)
        n_valid_full = jnp.maximum(
            jnp.sum(smask_full.astype(jnp.float32)), 1.0
        )
        res = RegistrationResult(
            transformation=res.transformation,
            fitness=s.n_corr / n_valid_full,
            rmse=jnp.where(
                s.n_corr > 0,
                jnp.sqrt(s.sum_d2 / jnp.maximum(s.n_corr, 1.0)),
                0.0,
            ),
        )

    if use_sub and polish == "auto" and polish_iters > 0:
        # Adaptive exact polish (docstring): EVERYTHING — the full-source
        # x-sort included — lives inside the cond's true branch, so the
        # clean-scene bench path pays nothing.
        if nn_mode == "slab":
            index_p = index
        else:
            index_p = (
                target_index
                if target_index is not None
                else build_icp_target(target)
            )
        n_valid_full = jnp.maximum(
            jnp.sum(smask_full.astype(jnp.float32)), 1.0
        )

        def do_polish(res0):
            xf = transform_points(res0.transformation, src_full)[:, 0]
            key = jnp.where(smask_full, xf, jnp.float32(3e4))
            skey, sx, sy, sz = jax.lax.sort(
                (key, src_full[:, 0], src_full[:, 1], src_full[:, 2]),
                num_keys=1,
            )
            sm = skey < jnp.float32(2.9e4)
            stats_p = fused_slab_stats_fn(
                index_p, jnp.stack([sx, sy, sz], axis=1), sm, thr, use_p2l,
                block=block, sub=sub,
            )
            r2 = icp_loop(
                stats_p, n_valid_full, res0.transformation, polish_iters,
                use_p2l,
            )
            s2 = stats_p(r2.transformation)
            return RegistrationResult(
                transformation=r2.transformation,
                fitness=s2.n_corr / n_valid_full,
                rmse=jnp.where(
                    s2.n_corr > 0,
                    jnp.sqrt(s2.sum_d2 / jnp.maximum(s2.n_corr, 1.0)),
                    0.0,
                ),
            )

        res = jax.lax.cond(
            res.fitness < jnp.float32(polish_threshold),
            do_polish,
            lambda r: r,
            res,
        )
    return res
