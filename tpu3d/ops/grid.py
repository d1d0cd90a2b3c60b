"""Spatial-grid-accelerated neighbor search (the k-d tree the CUDA reference
never built — icp.cu:11-12 punts to "k-d tree" in a comment; this is a
static-shape answer).

Targets are bucketed into cells of size h and SORTED by cell id (one XLA
sort); per-cell segments are then found by binary search. A query scans the
27 cells around it, so any target within h of the query is guaranteed to be
a candidate. That makes the search EXACT for threshold-limited semantics:

  - ICP correspondences are rejected beyond ``distance_threshold``
    (registration.cpp:337-338), so running the grid with h ≥ threshold
    returns the identical kept-correspondence set as brute force;
  - FPFH/radius neighborhoods use radius = h the same way.

Static shapes: each cell contributes at most ``cell_capacity`` candidates
(overflowing cells drop their tail — pick h near the workload's natural
density so occupancy stays below the cap; overflow trades exactness for
bounded shapes, exactly like the reference's 100-neighbor FPFH cap,
registration.cpp:87). Grid dims are clamped to 1290 per axis so cell ids fit
int32 — when a scene would exceed that, h grows to range/1290, which only
ADDS candidates (coverage never shrinks below the requested h).

Everything is traced arithmetic + one sort + gathers: O(Q · 27 · C) instead
of O(Q · M).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e30)
_MAX_DIM = 1290  # 1290^3 < 2^31


class GridIndex(NamedTuple):
    sorted_points: jnp.ndarray  # f32[M, 3] targets sorted by cell id
    sorted_orig: jnp.ndarray  # i32[M] original row of each sorted target
    sorted_cell_ids: jnp.ndarray  # i32[M] ascending
    origin: jnp.ndarray  # f32[3]
    cell_size: jnp.ndarray  # f32 — effective h (≥ requested)
    dims: jnp.ndarray  # i32[3]


def build_grid(
    points: jnp.ndarray, mask: jnp.ndarray, cell_size
) -> GridIndex:
    """Bucket + sort the target cloud. Invalid rows land in a far sentinel
    cell (id int32 max) that no query neighborhood can reach."""
    h_req = jnp.asarray(cell_size, jnp.float32)
    big = jnp.float32(3e4)
    pts = jnp.where(mask[:, None], points.astype(jnp.float32), big)
    lo = jnp.min(jnp.where(mask[:, None], points, big), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], points, -big), axis=0)
    span = jnp.maximum(hi - lo, 0.0)
    h = jnp.maximum(h_req, jnp.max(span) / (_MAX_DIM - 3))
    origin = lo - h  # coords start at ≥ 1 so -1 offsets stay in range
    dims = jnp.minimum(
        (span / h).astype(jnp.int32) + 3, _MAX_DIM
    )  # per-axis cell counts incl. the guard ring

    coords = jnp.clip(
        jnp.floor((pts - origin) / h).astype(jnp.int32), 0, dims - 1
    )
    ids = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    ids = jnp.where(mask, ids, jnp.int32(2**31 - 1))

    order = jnp.argsort(ids)
    return GridIndex(
        sorted_points=points.astype(jnp.float32)[order],
        sorted_orig=order.astype(jnp.int32),
        sorted_cell_ids=ids[order],
        origin=origin,
        cell_size=h,
        dims=dims,
    )


def _neighbor_cell_ids(grid: GridIndex, queries: jnp.ndarray) -> jnp.ndarray:
    """(Q, 27) candidate cell ids around each query (clipped into range)."""
    qc = jnp.floor((queries - grid.origin) / grid.cell_size).astype(jnp.int32)
    offs = jnp.stack(
        jnp.meshgrid(
            jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(27, 3)
    nc = qc[:, None, :] + offs[None, :, :]  # (Q, 27, 3)
    nc = jnp.clip(nc, 0, grid.dims - 1)
    return (nc[..., 0] * grid.dims[1] + nc[..., 1]) * grid.dims[2] + nc[..., 2]


@functools.partial(jax.jit, static_argnames=("cell_capacity", "chunk"))
def grid_top1(
    grid: GridIndex,
    queries: jnp.ndarray,
    cell_capacity: int = 8,
    chunk: int = 4096,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest target WITHIN cell_size of each query.

    Returns (idx i32[Q] into the original target rows, d2 f32[Q]); queries
    with no target inside the coverage radius get d2 ≥ 1e30 (callers using
    a threshold ≤ cell_size reject those, identically to brute force).
    """
    q = queries.shape[0]
    pad = (-q) % chunk
    qp = jnp.pad(queries.astype(jnp.float32), ((0, pad), (0, 0)))
    m = grid.sorted_points.shape[0]
    cc = cell_capacity

    def one(qc):
        cids = _neighbor_cell_ids(grid, qc)  # (CH, 27)
        start = jnp.searchsorted(grid.sorted_cell_ids, cids, side="left")
        end = jnp.searchsorted(grid.sorted_cell_ids, cids, side="right")
        slot = jnp.arange(cc, dtype=jnp.int32)
        cand = start[..., None] + slot  # (CH, 27, C)
        valid = cand < end[..., None]
        cand = jnp.clip(cand, 0, m - 1)
        flat = cand.reshape(qc.shape[0], -1)  # (CH, 27*C)
        vflat = valid.reshape(qc.shape[0], -1)
        pts_c = grid.sorted_points[flat]  # (CH, 27*C, 3)
        diff = pts_c - qc[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(vflat, d2, _BIG)
        best = jnp.argmin(d2, axis=1)
        rows = jnp.arange(qc.shape[0])
        return (
            grid.sorted_orig[flat[rows, best]],
            d2[rows, best],
        )

    n_chunks = (q + pad) // chunk
    idx, d2 = jax.lax.map(one, qp.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1)[:q], d2.reshape(-1)[:q]


@functools.partial(
    jax.jit, static_argnames=("k", "cell_capacity", "chunk")
)
def grid_knn(
    grid: GridIndex,
    queries: jnp.ndarray,
    k: int,
    cell_capacity: int = 128,
    chunk: int = 1024,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest targets within cell_size of each query (ascending d2; empty
    slots at d2 ≥ 1e30). The radius-capped FPFH/normal search with
    radius = cell_size is exact up to cell overflow."""
    q = queries.shape[0]
    pad = (-q) % chunk
    qp = jnp.pad(queries.astype(jnp.float32), ((0, pad), (0, 0)))
    m = grid.sorted_points.shape[0]
    cc = cell_capacity

    def one(qc):
        cids = _neighbor_cell_ids(grid, qc)
        start = jnp.searchsorted(grid.sorted_cell_ids, cids, side="left")
        end = jnp.searchsorted(grid.sorted_cell_ids, cids, side="right")
        slot = jnp.arange(cc, dtype=jnp.int32)
        cand = start[..., None] + slot
        valid = cand < end[..., None]
        cand = jnp.clip(cand, 0, m - 1)
        flat = cand.reshape(qc.shape[0], -1)
        vflat = valid.reshape(qc.shape[0], -1)
        pts_c = grid.sorted_points[flat]
        diff = pts_c - qc[:, None, :]
        d2 = jnp.where(vflat, jnp.sum(diff * diff, axis=-1), _BIG)
        neg, pos = jax.lax.top_k(-d2, k)
        rows = jnp.arange(qc.shape[0])[:, None]
        return grid.sorted_orig[flat[rows, pos]], -neg

    n_chunks = (q + pad) // chunk
    idx, d2 = jax.lax.map(one, qp.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1, k)[:q], d2.reshape(-1, k)[:q]
