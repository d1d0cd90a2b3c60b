"""Fused surface features: normals + FPFH as three window-walk sweeps.

No per-neighbor array is ever materialized and nothing is top-k'd: every
stage is a reduction over the (query block × candidate tile) plane of the
window walk (ops/walk.py), on the bucket-aligned slab2 layout
(ops/slab2.py ``AlignedSlab2`` — every query block lies inside one x
bucket, so it has exactly three candidate windows, and padding rows are
never scanned).

  Sweep A  moments about the block centre → covariance → smallest
           eigenvector (Cardano, ops/normals.py) → viewpoint flip.
  Sweep B  SPFH: Darboux angles per pair, binned by cumulative threshold
           compares — bin = clamp(floor((x+1)·5.5), 0, 10) becomes 10
           compares per angle, cum_b = Σ [x ≥ b/5.5 − 1], and
           hist_b = cum_b − cum_{b+1}. The angle numerators are bilinear
           in per-point features, with b = p × n and a = p · n precomputed
           per candidate:
               c = n_i·n_j,   e·d = a_j − p_i·n_j,
               alpha·d = n_i·b_j + b_i·n_j,   phi·d = n_i·(p_j − p_i),
               theta = atan2(phi·c − e, c).
           Coordinates are shifted by the cloud's masked centroid first:
           the scalar-triple identity holds for any shared origin, but its
           f32 cancellation error grows with |p|².
  Sweep C  FPFH = own SPFH + Σ_j SPFH_j / d_ij over the radius ball.

d² stays elementwise (exact): the self-pair must hit exactly 0 so the
reference's dist < 1e-8 skip (registration.cpp:142-146) keeps working.

Sparse query subsets (``fused_prepare_sparse``): when the consumer only
needs descriptors for a strided correspondence subset (ops/ransac.py
corr_mode='auto' semantics), the sweeps run only on the blocks that subset
transitively depends on — sweep C at the query blocks Q, sweep B at
Q ∪ windows(Q), sweep A at that set ∪ its windows. Every retained
descriptor is EXACT; blocks outside the member sets get their window
lengths zeroed, which the walk skips for free.

Semantics vs the reference: neighborhoods are radius-exact (ALL points
within radius contribute) instead of radius-capped-at-100
(registration.cpp:87's max_nn) — a superset the reference caps only for CPU
speed; and normals use the radius neighborhood instead of exactly-30-NN.
The gather path (ops/normals.py + ops/fpfh.py) keeps reference parity below
registration.FUSED_CAPACITY_THRESHOLD.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from tpu3d.ops.normals import smallest_eigvec_3x3_planes
from tpu3d.ops.walk import Sweep, walk
from tpu3d.types import FPFHFeatures, PointCloud
from tpu3d.utils.platform import resolve_engine

_BIG = 1e30

# Bin thresholds: floor((x+1)*5.5) >= b  <=>  x >= b/5.5 - 1, b = 1..10.
_BIN_THRESH = tuple(b / 5.5 - 1.0 for b in range(1, 11))

# Query block and candidate tile per engine: (block, sub). Results do not
# depend on them beyond f32 rounding of the per-block moment centre; they
# move only the work/overhead balance (PERF.md "Kernels on the H100").
BLOCKS = {"triton": (64, 64), "xla": (128, 256)}


def _sum(x):
    return jnp.sum(x, axis=1, keepdims=True)


# --------------------------------------------------------------------------
# Sweep A: radius-PCA normals
# --------------------------------------------------------------------------


def _a_prologue(w):
    """Block-local origin over VALID queries: the layout stores 3e4
    sentinels on padding rows, which would wreck the centred moments."""
    wq = jnp.where(w.q[3] > 0.5, 1.0, 0.0)
    cnt = jnp.maximum(jnp.sum(wq), 1.0)
    return tuple(jnp.sum(w.q[i] * wq) / cnt for i in range(3))


def _a_init(b):
    return tuple(jnp.zeros((b, 1), jnp.float32) for _ in range(10))


def _a_tile(w, ctr, carry):
    dx = w.load(0) - w.q[0]
    dy = w.load(1) - w.q[1]
    dz = w.load(2) - w.q[2]
    d2 = dx * dx + dy * dy + dz * dz
    wv = jnp.where(w.own & (d2 <= w.s[0]), 1.0, 0.0)  # (B, sub)
    c0 = w.load(0) - ctr[0]
    c1 = w.load(1) - ctr[1]
    c2 = w.load(2) - ctr[2]
    feats = (c0, c1, c2, c0 * c0, c1 * c1, c2 * c2, c0 * c1, c0 * c2,
             c1 * c2)
    return tuple(
        acc + _sum(wv * f) for acc, f in zip(carry, feats)
    ) + (carry[9] + _sum(wv),)


def _a_epilogue(w, ctr, mom):
    cnt = jnp.maximum(mom[9], 1.0)
    mx, my, mz = mom[0] / cnt, mom[1] / cnt, mom[2] / cnt
    nx, ny, nz = smallest_eigvec_3x3_planes(
        mom[3] / cnt - mx * mx,
        mom[6] / cnt - mx * my,
        mom[7] / cnt - mx * mz,
        mom[4] / cnt - my * my,
        mom[8] / cnt - my * mz,
        mom[5] / cnt - mz * mz,
    )
    # Orient toward the viewpoint (origin): flip when n·(−p) < 0
    # (registration.cpp:125-127); zero padding rows.
    flip = nx * w.q[0] + ny * w.q[1] + nz * w.q[2] > 0
    sgn = jnp.where(w.q[3] > 0.5, jnp.where(flip, -1.0, 1.0), 0.0)
    return [nx * sgn, ny * sgn, nz * sgn]


SWEEP_NORMALS = Sweep(_a_prologue, _a_init, _a_tile, _a_epilogue, n_q=4,
                      n_out=3)


# --------------------------------------------------------------------------
# Sweep B: SPFH histograms
# --------------------------------------------------------------------------


def _b_prologue(w):
    qx, qy, qz = w.q[0], w.q[1], w.q[2]
    nx, ny, nz = w.q[4], w.q[5], w.q[6]
    return (qy * nz - qz * ny, qz * nx - qx * nz, qx * ny - qy * nx)


def _b_init(b):
    return tuple(jnp.zeros((b, 1), jnp.float32) for _ in range(31))


def _b_tile(w, bi, carry):
    qx, qy, qz = w.q[0], w.q[1], w.q[2]
    nix, niy, niz = w.q[4], w.q[5], w.q[6]
    dx = w.load(0) - qx
    dy = w.load(1) - qy
    dz = w.load(2) - qz
    d2 = dx * dx + dy * dy + dz * dz
    njx, njy, njz = w.load(6), w.load(7), w.load(8)
    c = nix * njx + niy * njy + niz * njz
    pin = qx * njx + qy * njy + qz * njz
    anum = (
        nix * w.load(3) + niy * w.load(4) + niz * w.load(5)
        + bi[0] * njx + bi[1] * njy + bi[2] * njz
    )
    contrib = w.own & (d2 <= w.s[0]) & (d2 >= 1e-16)
    inv_d = jax.lax.rsqrt(jnp.maximum(d2, 1e-24))
    phi = (nix * dx + niy * dy + niz * dz) * inv_d
    e = (w.load(9) - pin) * inv_d
    alpha = anum * inv_d
    theta = jnp.arctan2(phi * c - e, c) * (1.0 / math.pi)
    cums = []
    for x in (alpha, phi, theta):
        xm = jnp.where(contrib, x, -_BIG)
        cums.extend(_sum(jnp.where(xm >= t, 1.0, 0.0)) for t in _BIN_THRESH)
    cums.append(_sum(jnp.where(contrib, 1.0, 0.0)))
    return tuple(a + d for a, d in zip(carry, cums))


def _b_epilogue(w, bi, carry):
    """hist_b = cum_b − cum_{b+1} per angle (cum_0 = count, cum_11 = 0),
    L1-normalized; outputs 33 bin planes + the neighbor count."""
    cnt = carry[30]
    hist = []
    for a in range(3):
        ca = carry[a * 10: (a + 1) * 10]
        hist.append(cnt - ca[0])
        hist.extend(ca[i] - ca[i + 1] for i in range(9))
        hist.append(ca[9])
    s = hist[0]
    for h in hist[1:]:
        s = s + h
    inv = jnp.where(s > 0, 1.0 / jnp.maximum(s, 1e-30), 1.0)
    return [h * inv for h in hist] + [cnt]


SWEEP_SPFH = Sweep(_b_prologue, _b_init, _b_tile, _b_epilogue, n_q=7,
                   n_out=34)


# --------------------------------------------------------------------------
# Sweep C: FPFH weighted neighbor-SPFH sum
# --------------------------------------------------------------------------


def _c_prologue(w):
    return None


def _c_init(b):
    return (jnp.zeros((32, b), jnp.float32), jnp.zeros((b, 1), jnp.float32))


def _c_tile(w, aux, carry):
    f32, f_last = carry
    dx = w.load(0) - w.q[0]
    dy = w.load(1) - w.q[1]
    dz = w.load(2) - w.q[2]
    d2 = dx * dx + dy * dy + dz * dz
    contrib = w.own & (d2 <= w.s[0]) & (d2 >= 1e-16)
    wgt = jnp.where(contrib, jax.lax.rsqrt(jnp.maximum(d2, 1e-24)), 0.0)
    # (32, sub) SPFH planes x (B, sub) weights, contracting the tile.
    f32 = f32 + jax.lax.dot_general(
        w.load_rows(3, 32), wgt, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return f32, f_last + _sum(wgt * w.load(35))


def _c_epilogue(w, aux, carry):
    return [carry[0], carry[1]]


SWEEP_FPFH = Sweep(_c_prologue, _c_init, _c_tile, _c_epilogue, n_q=4,
                   n_out=33)


# --------------------------------------------------------------------------
# The cloud-level prepare
# --------------------------------------------------------------------------


def _prepare(cloud, r, block, sub, engine, interpret, nq=None):
    """The three sweeps over the bucket-aligned padded layout.

    ``nq=None`` (dense): returns (cloud-with-normals, FPFH) in original
    row order. ``nq=k`` (sparse): computes descriptors ONLY for the rows
    of ``k`` strided query blocks and returns (subset PointCloud view,
    subset FPFHFeatures, subset original rows)."""
    from tpu3d.ops.slab2 import aligned_block_windows, build_slab2_aligned

    r2 = r * r
    n = cloud.points.shape[0]
    # Static bucket-count bound: enough buckets that the width stays
    # ~radius at density (width only widens when the x-extent demands it).
    max_buckets = 128 if n <= (1 << 18) else 512
    al = build_slab2_aligned(
        cloud.points, cloud.mask, r, block=block, max_buckets=max_buckets
    )
    pts_t = al.padded_points_t  # (3, Mp), sentinel 3e4 padding
    mp = pts_t.shape[1]
    nbk = mp // block
    lo, length = aligned_block_windows(al, r, block)  # (nbk, 3)
    run = functools.partial(
        walk, lo=lo, block=block, sub=sub, engine=engine, stage="prepare",
        interpret=interpret,
    )

    if nq is None:
        len_a = len_b = len_c = length
    else:
        # --- sparse member sets --------------------------------------------
        # Q  = nq blocks in CONTIGUOUS RUNS of q_run, runs evenly strided
        #      (static ids — Mp is static). Contiguous runs share their
        #      dilation margin (scattered single blocks dilate ~7x per hop:
        #      each block's 3 windows land in 3 buckets), while the subset
        #      stays spatially stratified (nq/q_run patches).
        # B-set = Q ∪ blocks(windows(Q))      (sweep C reads SPFH there)
        # A-set = B ∪ blocks(windows(B))      (sweep B reads normals there)
        nq = min(nq, nbk)
        # At least 4 runs when the budget allows, CENTERED in their strata
        # (left-anchored runs leave the high-x tail without queries).
        q_run = min(8, max(1, nq // 4))
        nruns = max(1, nq // q_run)
        run_stride = max(q_run, nbk // nruns)
        nq = nruns * q_run  # whole runs only
        start0 = min(
            (run_stride - q_run) // 2,
            max(0, nbk - ((nruns - 1) * run_stride + q_run)),
        )  # centre, clamped so the last run stays in bounds
        take_ids = (
            start0
            + np.arange(nruns)[:, None] * run_stride
            + np.arange(q_run)[None]
        ).ravel()
        qmask_np = np.zeros((nbk,), bool)
        qmask_np[take_ids] = True
        qmask = jnp.asarray(qmask_np)
        live = length > 0
        blk_lo = jnp.clip(lo // block, 0, nbk - 1)
        blk_hi = jnp.clip(
            (lo + jnp.maximum(length, 1) - 1) // block, 0, nbk - 1
        )

        def dilate(member):
            # Block j is covered iff some live member window's
            # [blk_lo, blk_hi] contains j (broadcast compare + reduce).
            sel = (live & member[:, None]).ravel()  # (K,)
            lo_f = jnp.where(sel, blk_lo.ravel(), nbk + 1)
            hi_f = jnp.where(sel, blk_hi.ravel(), -1)
            j = jnp.arange(nbk)
            cover = (lo_f[:, None] <= j[None, :]) & (
                j[None, :] <= hi_f[:, None]
            )
            return jnp.any(cover, axis=0)

        member_b = dilate(qmask) | qmask
        member_a = dilate(member_b) | member_b
        len_a = jnp.where(member_a[:, None], length, 0)
        len_b = jnp.where(member_b[:, None], length, 0)
        len_c = jnp.where(qmask[:, None], length, 0)

    mrow = al.valid_padded.astype(jnp.float32)[None]  # (1, Mp)
    q4 = jnp.concatenate([pts_t, mrow], axis=0)
    # Sweep A. In sparse mode rows outside the A-set get a zero-covariance
    # eigenvector — finite, and never read (sweep B's windows only reach
    # A-set rows by construction).
    nrm_t = run(SWEEP_NORMALS, q4, pts_t, length=len_a, scalars=(r2,))
    # Sweep B operands, centroid-shifted (see the module docstring).
    cnt_v = jnp.maximum(jnp.sum(mrow), 1.0)
    ctr = jnp.sum(jnp.where(al.valid_padded, pts_t, 0.0), axis=1) / cnt_v
    cpts_t = pts_t - ctr[:, None]  # sentinels stay ~3e4 — still inert
    b3 = jnp.stack(
        [
            cpts_t[1] * nrm_t[2] - cpts_t[2] * nrm_t[1],
            cpts_t[2] * nrm_t[0] - cpts_t[0] * nrm_t[2],
            cpts_t[0] * nrm_t[1] - cpts_t[1] * nrm_t[0],
        ]
    )
    arow = jnp.sum(cpts_t * nrm_t, axis=0, keepdims=True)
    packed_b = jnp.concatenate([cpts_t, b3, nrm_t, arow], axis=0)  # (10, Mp)
    q7 = jnp.concatenate([cpts_t, mrow, nrm_t], axis=0)
    spfh_planes = run(SWEEP_SPFH, q7, packed_b, length=len_b,
                      scalars=(r2,))[:33]
    packed_c = jnp.concatenate([pts_t, spfh_planes], axis=0)  # (36, Mp)
    wsum = run(SWEEP_FPFH, q4, packed_c, length=len_c, scalars=(r2,))

    if nq is not None:
        # Subset rows of the Q blocks: nruns contiguous runs, each one
        # STATIC slice of q_run blocks (never a gather). The slices use the
        # same run starts the member sets marked.
        run_starts = [int(start0 + i * run_stride) for i in range(nruns)]

        def pick(xp):  # (W, Mp) -> (W, nq*block)
            w = xp.shape[0]
            xb = xp.reshape(w, nbk, block)
            return jnp.concatenate(
                [xb[:, s: s + q_run] for s in run_starts], axis=1
            ).reshape(w, nq * block)

        sub_mask = pick(al.valid_padded[None])[0]
        f = (pick(spfh_planes) + pick(wsum)).T
        sf = jnp.sum(f, axis=1, keepdims=True)
        sub_desc = jnp.where(sf > 0, f / jnp.maximum(sf, 1e-30), f)
        sub_orig = pick(al.padded_orig[None])[0]
        sub_pts = jnp.where(sub_mask[:, None], pick(pts_t).T, 0.0)
        sub_desc = jnp.where(sub_mask[:, None], sub_desc, 0.0)
        return (
            PointCloud(points=sub_pts, mask=sub_mask),
            FPFHFeatures(descriptors=sub_desc, mask=sub_mask),
            sub_orig,
        )

    # Dense: combine + normalize over all padded rows, then back to
    # original row order — padded_orig is a permutation plus unique
    # out-of-bounds values on padding rows: one scatter with OOB drop.
    f = (spfh_planes + wsum).T
    sf = jnp.sum(f, axis=1, keepdims=True)
    fpfh_padded = jnp.where(sf > 0, f / jnp.maximum(sf, 1e-30), f)
    normals = jnp.zeros((n, 3), jnp.float32).at[al.padded_orig].set(
        nrm_t.T, mode="drop", unique_indices=True
    )
    fpfh = jnp.zeros((n, 33), jnp.float32).at[al.padded_orig].set(
        fpfh_padded, mode="drop", unique_indices=True
    )
    normals = jnp.where(cloud.mask[:, None], normals, 0.0)
    fpfh = jnp.where(cloud.mask[:, None], fpfh, 0.0)
    return (
        cloud._replace(normals=normals),
        FPFHFeatures(descriptors=fpfh, mask=cloud.mask),
    )


def _blocks(engine, interpret, block, sub):
    eng = resolve_engine(engine, "prepare", interpret)
    b0, s0 = BLOCKS[eng]
    return eng, (b0 if block is None else block), (s0 if sub is None else sub)


@functools.partial(
    jax.jit,
    static_argnames=("corr_cap", "block", "sub", "engine", "interpret"),
)
def fused_prepare_sparse(
    cloud: PointCloud,
    radius,
    corr_cap: int = 8192,
    block: int | None = None,
    sub: int | None = None,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[PointCloud, FPFHFeatures, jnp.ndarray]:
    """Normals+FPFH restricted to a ``corr_cap``-row strided-block subset.

    The RANSAC correspondence stage at scale only consumes descriptors for
    a strided source subset (ops/ransac.py corr_mode='auto'); computing
    the other ~92% of descriptors is waste. Returns

      (subset PointCloud view, subset FPFHFeatures, subset original rows)

    Every returned descriptor is EXACT (identical bits to the dense path's
    value for the same row at the same ``(block, sub)`` and engine —
    tests/test_fused_features.py asserts this). The subset view is
    spatially stratified; pass it directly to
    ``ransac_registration(..., corr_mode='exact')``."""
    engine, block, sub = _blocks(engine, interpret, block, sub)
    r = jnp.asarray(radius, jnp.float32)
    nq = max(1, corr_cap // block)
    return _prepare(cloud, r, block, sub, engine, interpret, nq=nq)


@functools.partial(
    jax.jit, static_argnames=("block", "sub", "engine", "interpret")
)
def fused_prepare_features(
    cloud: PointCloud,
    radius,
    block: int | None = None,
    sub: int | None = None,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH for a cloud, in original row order.

    ``engine``: 'triton' (one Pallas kernel per sweep), 'xla' (lax.map
    over the blocks), 'auto' (the engine table). ``interpret=True`` runs
    the Triton kernels in the Pallas interpreter (tests); with
    ``engine='auto'`` it selects 'triton'."""
    engine, block, sub = _blocks(engine, interpret, block, sub)
    r = jnp.asarray(radius, jnp.float32)
    return _prepare(cloud, r, block, sub, engine, interpret)
