"""Slab-partitioned neighbor search — contiguous-slice spatial structure.

The grid index (tpu3d/ops/grid.py) is algorithmically right but lowers to
scalar gathers + binary searches. This module restates the idea as
**contiguous slices**.

  build:  sort targets by x (one XLA sort, done once per target cloud).
  query:  queries are processed in blocks of consecutive rows. Point clouds
          produced by this framework are already x-coherent (deprojection is
          raster order; voxel downsampling emits voxel-key order, which is
          x-major), so a block spans a thin x-interval. Per block, ONE
          searchsorted pair finds the contiguous target slice whose x lies
          within [block_min − radius, block_max + radius]; a single
          ``dynamic_slice`` (sequential DMA, no gather) pulls ≤ L candidate
          rows, and a dense (block × L) distance computation finds the
          winners.

Exactness: every target within ``radius`` of a query is inside the slice —
the result equals brute force for threshold-limited semantics (ICP rejects
matches beyond the threshold, registration.cpp:337-338; FPFH neighborhoods
are radius-capped, registration.cpp:83-102) — UNLESS a block's slice
overflows the static cap L, in which case the slice keeps the L rows from
the low-x end and the overflow is reported so callers can rerun with a
bigger L. Cost: O(Q · L) with L ≈ occupancy of a thin slab, typically
50-100x smaller than the full target count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e30)


class SlabIndex(NamedTuple):
    sorted_points: jnp.ndarray  # f32[M, 3] targets sorted by x (invalid last)
    sorted_points_t: jnp.ndarray  # f32[3, M] — plane layout: coords on the
    # sublane axis so distance math reduces over axis 0 and the full lane
    # width rides the candidate axis (a (.., 3)-minor layout uses 3 of 128
    # lanes — measured 20x slower)
    sorted_orig: jnp.ndarray  # i32[M]
    sorted_x: jnp.ndarray  # f32[M] ascending (invalid = +3e4)
    valid_sorted: jnp.ndarray  # bool[M]


def build_slab(points: jnp.ndarray, mask: jnp.ndarray) -> SlabIndex:
    # The payload (coordinates, validity, original row) rides the sort
    # network (multi-operand lax.sort, stable like argsort) — carrying the
    # operands costs far less than the three same-shape [order] gathers it
    # replaces.
    big = jnp.float32(3e4)
    pts = points.astype(jnp.float32)
    x = jnp.where(mask, pts[:, 0], big)
    n = pts.shape[0]
    _, sx, sy, sz, svalid, sorig = jax.lax.sort(
        (
            x,
            pts[:, 0], pts[:, 1], pts[:, 2],
            mask.astype(jnp.float32),
            jnp.arange(n, dtype=jnp.int32),
        ),
        num_keys=1,
    )
    sorted_points = jnp.stack([sx, sy, sz], axis=1)
    return SlabIndex(
        sorted_points=sorted_points,
        sorted_points_t=jnp.stack([sx, sy, sz], axis=0),
        sorted_orig=sorig,
        sorted_x=jnp.where(svalid > 0.5, sx, big),
        valid_sorted=svalid > 0.5,
    )


def _block_slices(slab: SlabIndex, qx_blocks: jnp.ndarray, radius):
    """(n_blocks,) slice starts + lengths for [min−r, max+r] per block.

    Uses the broadcast-compare sorted_positions instead of
    jnp.searchsorted: the binary search lowers to ~17 sequential gather
    steps, and this runs once per ICP iteration."""
    from tpu3d.ops.slab2 import sorted_positions

    r = jnp.asarray(radius, jnp.float32)
    lo = sorted_positions(
        slab.sorted_x, jnp.min(qx_blocks, axis=1) - r, side="left"
    )
    # side='right' keeps targets at exactly x == block_max + radius inside
    # the window, matching the inclusive d2 <= r2 gates downstream.
    hi = sorted_positions(
        slab.sorted_x, jnp.max(qx_blocks, axis=1) + r, side="right"
    )
    return lo.astype(jnp.int32), (hi - lo).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("slice_cap", "block"))
def slab_top1(
    slab: SlabIndex,
    queries: jnp.ndarray,
    radius,
    slice_cap: int = 4096,
    block: int = 256,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest target within ``radius`` per query.

    Returns (idx i32[Q] original target rows, d2 f32[Q] — ≥1e30 when no
    target within radius, overflowed bool[] — True if any block's candidate
    slice exceeded slice_cap and the result may be approximate).
    """
    q = queries.shape[0]
    pad = (-q) % block
    qp = jnp.pad(
        queries.astype(jnp.float32), ((0, pad), (0, 0)),
        constant_values=2.9e4,  # pad queries sort past targets, match nothing
    )
    nb = qp.shape[0] // block
    qb = qp.reshape(nb, block, 3)
    lo, length = _block_slices(slab, qb[..., 0], radius)
    overflow = jnp.any(length > slice_cap)
    m = slab.sorted_points.shape[0]
    slice_cap = min(slice_cap, m)  # never larger than the target buffer
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def one(args):
        qc, lo_b, len_b = args
        start = jnp.clip(lo_b, 0, jnp.maximum(m - slice_cap, 0))
        cand = jax.lax.dynamic_slice(
            slab.sorted_points_t, (0, start), (3, slice_cap)
        )  # contiguous columns — sequential DMA, no gather
        # Validity by ABSOLUTE row: when ``start`` is clamped below lo_b
        # (slice would run past the array end), the extra early rows are
        # harmless superset candidates, and the true range tail
        # [start+cap-…, lo_b+len_b) stays included.
        cvalid = jax.lax.dynamic_slice(
            slab.valid_sorted, (start,), (slice_cap,)
        ) & (start + jnp.arange(slice_cap) < lo_b + len_b)
        # (3, block, 1) - (3, 1, L): reduce over the MAJOR axis; lanes carry
        # the candidate axis at full width.
        diff = qc.T[:, :, None] - cand[:, None, :]
        d2 = jnp.sum(diff * diff, axis=0)
        d2 = jnp.where(cvalid[None, :], d2, _BIG)
        best = jnp.argmin(d2, axis=1)
        rows = jnp.arange(block)
        bd = d2[rows, best]
        bd = jnp.where(bd <= r2, bd, _BIG)  # outside radius → no match
        return slab.sorted_orig[start + best], bd

    idx, d2 = jax.lax.map(one, (qb, lo, length))
    return idx.reshape(-1)[:q], d2.reshape(-1)[:q], overflow


@functools.partial(
    jax.jit, static_argnames=("k", "slice_cap", "block")
)
def slab_knn(
    slab: SlabIndex,
    queries: jnp.ndarray,
    radius,
    k: int,
    slice_cap: int = 8192,
    block: int = 256,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """k nearest targets within ``radius`` per query (ascending; empty slots
    at d2 ≥ 1e30), exact ``lax.top_k`` over the slice. Returns
    (idx, d2, overflowed)."""
    q = queries.shape[0]
    pad = (-q) % block
    qp = jnp.pad(
        queries.astype(jnp.float32), ((0, pad), (0, 0)), constant_values=2.9e4
    )
    nb = qp.shape[0] // block
    qb = qp.reshape(nb, block, 3)
    lo, length = _block_slices(slab, qb[..., 0], radius)
    overflow = jnp.any(length > slice_cap)
    m = slab.sorted_points.shape[0]
    slice_cap = min(slice_cap, m)  # never larger than the target buffer
    r2 = jnp.asarray(radius, jnp.float32) ** 2
    k_eff = min(k, slice_cap)

    def one(args):
        qc, lo_b, len_b = args
        start = jnp.clip(lo_b, 0, jnp.maximum(m - slice_cap, 0))
        cand = jax.lax.dynamic_slice(
            slab.sorted_points_t, (0, start), (3, slice_cap)
        )
        # Validity by ABSOLUTE row: when ``start`` is clamped below lo_b
        # (slice would run past the array end), the extra early rows are
        # harmless superset candidates, and the true range tail
        # [start+cap-…, lo_b+len_b) stays included.
        cvalid = jax.lax.dynamic_slice(
            slab.valid_sorted, (start,), (slice_cap,)
        ) & (start + jnp.arange(slice_cap) < lo_b + len_b)
        diff = qc.T[:, :, None] - cand[:, None, :]
        d2 = jnp.sum(diff * diff, axis=0)
        d2 = jnp.where(cvalid[None, :], d2, _BIG)
        neg, pos = jax.lax.top_k(-d2, k_eff)
        d2k = -neg
        d2k = jnp.where(d2k <= r2, d2k, _BIG)
        return slab.sorted_orig[start + pos], d2k

    idx, d2 = jax.lax.map(one, (qb, lo, length))
    idx = idx.reshape(-1, k_eff)[:q]
    d2 = d2.reshape(-1, k_eff)[:q]
    if k_eff < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - k_eff)))
        d2 = jnp.pad(d2, ((0, 0), (0, k - k_eff)), constant_values=_BIG)
    return idx, d2, overflow
