"""Two-level slab index: x-buckets, y-sorted within each bucket.

The 1-D slab (ops/slab.py) turns neighbor search into contiguous-slice
scans, but its windows contain every point in a thin x-interval — for a
radius-r query over a surface-like cloud that is ~50-100x more candidates
than the true r-ball occupancy, all paid per pair. This index adds one
more level: points are bucketed by x (bucket width ~2r) and sorted by y
WITHIN each bucket, so a query block's candidates shrink to a few short
y-runs — one per touched bucket — instead of one long x-run.

Layout: a single int32 composite key ``bucket << 20 | qy`` (qy = y
quantized to 20 bits over the cloud's y-extent) sorted once per cloud —
the same single-sort cost as the 1-D slab. Both levels are then plain
``searchsorted`` on the key array, and candidate windows remain contiguous
row ranges (sequential DMA, no gather).

Exactness: windows are supersets of the true r-ball by construction —
bucket ranges cover [x−r, x+r] exactly (floor quantization is monotone),
and the y bounds are widened to the quantization grid (monotone f32
rounding keeps floor((y−ymin)·s) order-preserving, so no in-range point
can quantize outside the window). The d² ≤ r² gate downstream does the
rest. Blocks that straddle more buckets than the static window count K
get one merged "overflow" window spanning the remaining buckets without
y-trimming — a superset again, so results stay exact for ANY input
distribution (degenerate-x clouds collapse to one bucket and are simply
trimmed by y instead; degenerate-x-and-y clouds fall back to a full scan).

This replaces the k-d tree the reference punts to (cuda/icp.cu:11-12) for
the radius-neighborhood stages (FPFH prepare, registration.cpp:83-102).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_Y_BITS = 20
_Y_MAX = (1 << _Y_BITS) - 1
_NB_MAX = 2047  # bucket ids 0..2046 valid, 2047 = invalid sentinel
_SENTINEL = jnp.float32(3.0e4)


class Slab2Index(NamedTuple):
    sorted_points: jnp.ndarray  # f32[M, 3] key-sorted; invalid rows = 3e4
    sorted_points_t: jnp.ndarray  # f32[3, M] same, coordinate planes
    sorted_orig: jnp.ndarray  # i32[M] original row of each sorted row
    sorted_key: jnp.ndarray  # i32[M] ascending composite keys
    valid_sorted: jnp.ndarray  # bool[M]
    x0: jnp.ndarray  # f32 bucket origin (min valid x)
    inv_w: jnp.ndarray  # f32 1 / bucket width
    y0: jnp.ndarray  # f32 quantization origin (min valid y)
    y_scale: jnp.ndarray  # f32 quantization scale


def _bucket_of(x: jnp.ndarray, x0, inv_w) -> jnp.ndarray:
    return jnp.clip(
        jnp.floor((x - x0) * inv_w).astype(jnp.int32), 0, _NB_MAX - 1
    )


def _qy_of(y: jnp.ndarray, y0, y_scale) -> jnp.ndarray:
    return jnp.clip(
        jnp.floor((y - y0) * y_scale).astype(jnp.int32), 0, _Y_MAX
    )


def sorted_positions(
    skey: jnp.ndarray, keys: jnp.ndarray, side: str = "left", L: int = 128
) -> jnp.ndarray:
    """Exact ``jnp.searchsorted(skey, keys, side)`` without the binary
    search: XLA lowers searchsorted to a ~17-step batched binary-search
    while_loop of gathers. This formulation is one
    broadcast compare over the ``L``-strided block firsts, one (Q, L) row
    gather, and one compare over the gathered rows — all vector work.

    Derivation (side='left'; 'right' swaps < for <=): with blocks of L
    sorted rows and c = #{b : firsts[b] < k}, every row before block c−1
    is <= firsts[c−1+…] < k and every row from block c on is >= firsts[c]
    >= k, so pos = (c−1)·L + #{rows of block c−1 < k}. Padding rows carry
    dtype-max sentinels; the final clamp keeps pos <= n even when the
    query equals dtype max (real sentinel keys do — _NB_MAX<<20|_Y_MAX is
    exactly i32 max). Works for float keys too (slab.py x-windows): pad
    rows carry finfo max; NaN-free inputs assumed."""
    n = skey.shape[0]
    pad = (-n) % L
    info = (
        jnp.iinfo
        if jnp.issubdtype(skey.dtype, jnp.integer)
        else jnp.finfo
    )
    maxv = info(skey.dtype).max
    skp = jnp.pad(skey, (0, pad), constant_values=maxv)
    blocks = skp.reshape(-1, L)
    firsts = blocks[:, 0]  # (nfb,)
    kq = keys.ravel()
    lt = (lambda a, b: a < b) if side == "left" else (lambda a, b: a <= b)
    c = jnp.sum(lt(firsts[None, :], kq[:, None]), axis=1)
    j = jnp.maximum(c - 1, 0)
    rows = blocks[j]  # (Q, L) row gather
    inner = jnp.sum(lt(rows, kq[:, None]), axis=1)
    pos = jnp.minimum(j * L + inner, n)
    return pos.reshape(keys.shape).astype(jnp.int32)


def build_slab2(
    points: jnp.ndarray, mask: jnp.ndarray, bucket_width
) -> Slab2Index:
    """One argsort of composite int32 keys — same cost as the 1-D slab's
    x-sort. ``bucket_width`` should be ~2x the query radius; it is widened
    automatically so at most 2047 buckets exist."""
    pts = points.astype(jnp.float32)
    x = jnp.where(mask, pts[:, 0], _SENTINEL)
    y = jnp.where(mask, pts[:, 1], _SENTINEL)
    x0 = jnp.min(x)
    y0 = jnp.min(y)
    xext = jnp.max(jnp.where(mask, pts[:, 0], -_SENTINEL)) - x0
    yext = jnp.max(jnp.where(mask, pts[:, 1], -_SENTINEL)) - y0
    w = jnp.maximum(
        jnp.asarray(bucket_width, jnp.float32), xext / (_NB_MAX - 1)
    )
    inv_w = 1.0 / jnp.maximum(w, 1e-12)
    y_scale = (_Y_MAX - 1) / jnp.maximum(yext, 1e-12)

    bucket = jnp.where(mask, _bucket_of(pts[:, 0], x0, inv_w), _NB_MAX)
    qy = jnp.where(mask, _qy_of(pts[:, 1], y0, y_scale), _Y_MAX)
    key = (bucket << _Y_BITS) | qy  # ≤ 2^31 − 1, valid i32

    # The payload rides the sort network (multi-operand lax.sort, stable
    # like sort_key_val) instead of a separate pts[order] gather.
    skey, sx, sy, sz, order = jax.lax.sort(
        (
            key,
            jnp.where(mask, pts[:, 0], _SENTINEL),
            jnp.where(mask, pts[:, 1], _SENTINEL),
            jnp.where(mask, pts[:, 2], _SENTINEL),
            jnp.arange(pts.shape[0], dtype=jnp.int32),
        ),
        num_keys=1,
    )
    svalid = skey < (_NB_MAX << _Y_BITS)  # validity from the key itself
    # sentinel coords: invalid rows miss every d² gate with no mask DMA
    sorted_pts = jnp.stack([sx, sy, sz], axis=1)
    return Slab2Index(
        sorted_points=sorted_pts,
        sorted_points_t=jnp.stack([sx, sy, sz], axis=0),
        sorted_orig=order,
        sorted_key=skey,
        valid_sorted=svalid,
        x0=x0,
        inv_w=inv_w,
        y0=y0,
        y_scale=y_scale,
    )


def query_keys(
    index: Slab2Index, points: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Composite keys of QUERY points in the index's bucket/quantization
    frame — sort queries by this so consecutive blocks stay window-coherent
    (invalid rows key to the end)."""
    pts = points.astype(jnp.float32)
    bucket = jnp.where(
        mask, _bucket_of(pts[:, 0], index.x0, index.inv_w), _NB_MAX
    )
    qy = jnp.where(mask, _qy_of(pts[:, 1], index.y0, index.y_scale), _Y_MAX)
    return (bucket << _Y_BITS) | qy


def block_windows(
    index: Slab2Index,
    q_blocks: jnp.ndarray,  # f32[nb, B, 3] coords OR (qx, qy) (nb, B) planes
    m_blocks: jnp.ndarray,  # bool[nb, B]
    radius,
    k_max: int = 6,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block candidate windows: (lo i32[nb, K], len i32[nb, K]).

    Window k < K−1 covers bucket (b_lo + k) trimmed to the y-range of the
    block's queries that can touch it (±radius, quantization-widened);
    window K−1 merges any remaining buckets un-trimmed (exact superset).
    Windows are disjoint row ranges, so sweep accumulations never double
    count.

    ``q_blocks`` may be the (nb, B, 3) coordinate blocks or a tuple of
    (qx, qy) planes — only x/y are consumed, and plane callers avoid
    materializing an (N, 3) minor-dim-3 layout at all.
    """
    r = jnp.asarray(radius, jnp.float32)
    if isinstance(q_blocks, tuple):
        qx, qy = q_blocks
    else:
        qx, qy = q_blocks[..., 0], q_blocks[..., 1]
    qb = _bucket_of(qx, index.x0, index.inv_w)  # (nb, B)
    nb_r = jnp.ceil(r * index.inv_w).astype(jnp.int32)

    b_min = jnp.min(jnp.where(m_blocks, qb, _NB_MAX), axis=1)
    b_max = jnp.max(jnp.where(m_blocks, qb, -1), axis=1)
    b_lo = jnp.maximum(b_min - nb_r, 0)  # (nb,)
    b_hi = jnp.minimum(b_max + nb_r, _NB_MAX - 1)

    ks = jnp.arange(k_max - 1, dtype=jnp.int32)  # trimmed windows
    cand_raw = b_lo[:, None] + ks[None, :]  # (nb, K-1), may exceed b_hi
    # Key operand only: cand_raw can reach b_lo + k_max − 2 > _NB_MAX − 1,
    # and an unclipped value would overflow ``cand << 20`` into negative
    # int32 keys. Those windows are forced empty below (cand_raw > b_hi),
    # so the clip never changes a live window — it only keeps the shifted
    # keys valid. Selection/emptiness use the UNCLIPPED value so clipped
    # duplicates of bucket _NB_MAX−1 can never double-count.
    cand_b = jnp.minimum(cand_raw, _NB_MAX - 1)
    # Queries that can touch bucket c: |bucket(q) − c| ≤ nb_r.
    sel = (
        m_blocks[:, None, :]
        & (jnp.abs(qb[:, None, :] - cand_raw[:, :, None]) <= nb_r)
    )  # (nb, K-1, B)
    big = jnp.float32(jnp.inf)
    ylo = jnp.min(jnp.where(sel, qy[:, None, :], big), axis=2) - r
    yhi = jnp.max(jnp.where(sel, qy[:, None, :], -big), axis=2) + r
    qy_lo = _qy_of(ylo, index.y0, index.y_scale)
    qy_hi = _qy_of(yhi, index.y0, index.y_scale)
    key_lo = (cand_b << _Y_BITS) | qy_lo
    key_hi = (cand_b << _Y_BITS) | qy_hi
    empty = ~jnp.any(sel, axis=2) | (cand_raw > b_hi[:, None])

    # Overflow window: buckets [b_lo+K−1 .. b_hi] merged, no y trim.
    c0 = b_lo + jnp.int32(k_max - 1)
    of_lo = c0 << _Y_BITS
    of_hi = (b_hi << _Y_BITS) | _Y_MAX
    of_empty = b_hi < c0

    skey = index.sorted_key
    lo = sorted_positions(skey, key_lo, side="left")
    hi = sorted_positions(skey, key_hi, side="right")
    length = jnp.where(empty, 0, hi - lo)

    lo_of = sorted_positions(skey, of_lo, side="left")
    hi_of = sorted_positions(skey, of_hi, side="right")
    len_of = jnp.where(of_empty, 0, hi_of - lo_of)

    lo_all = jnp.concatenate([lo, lo_of[:, None]], axis=1).astype(jnp.int32)
    len_all = jnp.concatenate([length, len_of[:, None]], axis=1).astype(
        jnp.int32
    )
    return lo_all, len_all


# ---------------------------------------------------------------------------
# Bucket-aligned padded layout
# ---------------------------------------------------------------------------
#
# The plain slab2 layout blocks the sorted rows raw, so a query block that
# straddles a bucket boundary unions the y-ranges of BOTH pieces — its
# trimmed windows blow up to near-full buckets (~13% of blocks at 100k pts,
# measured 654 vs ~450 mean candidate rows/block). This variant pads each
# bucket's y-sorted run to a multiple of the query block size, so EVERY
# block lies inside exactly one bucket:
#   * windows per block drop to exactly 2·ceil(r/w)+1 = 3 (no overflow
#     window, no per-query bucket selection — all queries share the trim);
#   * padding rows are EXCLUDED from candidate windows entirely (window
#     bounds come from the un-padded key array + per-bucket offsets), so
#     sweeps never scan a sentinel.
# Exactness is unchanged: windows still cover [x−r, x+r] × (y ± r,
# quantization-widened) per block, and the d² gate does the rest.


class AlignedSlab2(NamedTuple):
    padded_points_t: jnp.ndarray  # f32[3, Mp] planes; sentinel 3e4 padding
    padded_orig: jnp.ndarray  # i32[Mp] original row; unique OOB in padding
    valid_padded: jnp.ndarray  # bool[Mp]
    sorted_key: jnp.ndarray  # i32[N] REAL rows' ascending keys (no padding)
    starts_real: jnp.ndarray  # i32[NB+1] real start row per bucket
    offsets: jnp.ndarray  # i32[NB+1] PADDED start row per bucket
    x0: jnp.ndarray
    inv_w: jnp.ndarray
    y0: jnp.ndarray
    y_scale: jnp.ndarray


def aligned_capacity(n: int, block: int, max_buckets: int) -> int:
    """Static padded size: every nonempty bucket pads by < block rows."""
    mp = n + max_buckets * (block - 1)
    return -(-mp // block) * block


def build_slab2_aligned(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    bucket_width,
    block: int = 128,
    max_buckets: int = 128,
) -> AlignedSlab2:
    """One multi-operand sort + ONE (8, Mp) gather — no scatters.

    The payload planes (x, y, z, validity, original row) ride the sort
    network itself (``lax.sort`` with num_keys=1 — the same trick the
    keys use), and the padded layout is then assembled by a single gather
    whose index map is closed-form from the tiny per-bucket tables:
    padded row p of a block owned by bucket b pulls sorted row
    ``starts[b] + (p − offsets[b])`` when that lies inside the bucket's
    real run, else an appended sentinel column. Chip A/B
    (benchmarks/sweep_build_variants.py, bit-identical outputs): shipped
    scatter formulation 1.47 ms, via-sort+scatter 1.13, this gather form
    0.68 ms at 100k rows — scatters pay ~2x a same-shape gather here and
    the 1-D dest routing disappears entirely.

    ``max_buckets`` (static, ≤ 2047) bounds the bucket count; the width
    widens automatically when the x-extent needs more, which only loosens
    the windows (still exact)."""
    assert max_buckets <= _NB_MAX
    pts = points.astype(jnp.float32)
    n = pts.shape[0]
    mp = aligned_capacity(n, block, max_buckets)
    x = jnp.where(mask, pts[:, 0], _SENTINEL)
    y = jnp.where(mask, pts[:, 1], _SENTINEL)
    x0 = jnp.min(x)
    y0 = jnp.min(y)
    xext = jnp.max(jnp.where(mask, pts[:, 0], -_SENTINEL)) - x0
    yext = jnp.max(jnp.where(mask, pts[:, 1], -_SENTINEL)) - y0
    w = jnp.maximum(
        jnp.asarray(bucket_width, jnp.float32), xext / (max_buckets - 1)
    )
    inv_w = 1.0 / jnp.maximum(w, 1e-12)
    y_scale = (_Y_MAX - 1) / jnp.maximum(yext, 1e-12)

    bucket = jnp.where(
        mask,
        jnp.clip(
            jnp.floor((pts[:, 0] - x0) * inv_w).astype(jnp.int32),
            0, max_buckets - 1,
        ),
        _NB_MAX,
    )
    qy = jnp.where(mask, _qy_of(pts[:, 1], y0, y_scale), _Y_MAX)
    key = (bucket << _Y_BITS) | qy

    i_idx = jnp.arange(n, dtype=jnp.int32)
    # The payload rides the sort network: carrying the 3 coordinate
    # planes + original row through lax.sort replaces routing them
    # afterwards with a same-shape gather or scatter.
    skey, sx, sy, sz, sorig = jax.lax.sort(
        (
            key,
            jnp.where(mask, pts[:, 0], _SENTINEL),
            jnp.where(mask, pts[:, 1], _SENTINEL),
            jnp.where(mask, pts[:, 2], _SENTINEL),
            i_idx,
        ),
        num_keys=1,
    )

    # Real bucket boundaries: one vectorized searchsorted of the NB+1
    # static bucket keys (invalid rows key to _NB_MAX<<20 and land after
    # every boundary).
    bounds = jnp.arange(max_buckets + 1, dtype=jnp.int32) << _Y_BITS
    starts = sorted_positions(skey, bounds, side="left")  # (NB+1,)
    counts = starts[1:] - starts[:-1]
    pcounts = -(-counts // block) * block
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(pcounts).astype(jnp.int32)]
    )  # (NB+1,)

    # Padded layout by ONE (8, Mp) gather with a closed-form index map:
    # padded block j (start row j·block) is owned by bucket b (the tiny
    # offsets table broadcast-compared per block, as in
    # aligned_block_windows), and its rows pull the contiguous sorted run
    # starts[b] + (p − offsets[b]); rows past the bucket's real count pull
    # the appended sentinel column n. Sorted-row validity comes from the
    # key itself (invalid rows key past every real bucket boundary, so
    # counts/in_run exclude them) — no mask routing at all. The f32 orig
    # payload is exact for n + Mp < 2^24 (asserted); padding rows carry
    # UNIQUE out-of-bounds originals (n + position) so a later
    # unique-promise scatter back to original rows can drop them.
    assert n + mp < (1 << 24), "f32 orig payload exactness bound"
    nbk = mp // block
    blk_start = jnp.arange(nbk, dtype=jnp.int32) * block
    b_blk = (
        jnp.sum(
            offsets[None, :] <= blk_start[:, None], axis=1, dtype=jnp.int32
        )
        - 1
    )
    b_blk = jnp.clip(b_blk, 0, max_buckets - 1)
    p_idx = blk_start[:, None] + jnp.arange(block, dtype=jnp.int32)[None, :]
    src_row = starts[b_blk][:, None] + (p_idx - offsets[b_blk][:, None])
    in_run = src_row < (starts[b_blk] + counts[b_blk])[:, None]
    src_row = jnp.where(in_run, src_row, n).reshape(mp)

    svalid = skey < (_NB_MAX << _Y_BITS)
    planes8 = jnp.concatenate(
        [
            sx[None], sy[None], sz[None],
            svalid.astype(jnp.float32)[None],
            sorig.astype(jnp.float32)[None],
            jnp.zeros((3, n), jnp.float32),
        ],
        axis=0,
    )  # (8, n)
    sentinel_col = jnp.array(
        [[_SENTINEL], [_SENTINEL], [_SENTINEL], [0.0], [0.0],
         [0.0], [0.0], [0.0]],
        jnp.float32,
    )
    planes8 = jnp.concatenate([planes8, sentinel_col], axis=1)  # (8, n+1)
    padded8 = planes8[:, src_row]
    pos = jnp.arange(mp, dtype=jnp.float32) + n
    valid_padded = padded8[3] > 0.5
    padded_orig = jnp.where(valid_padded, padded8[4], pos).astype(jnp.int32)
    return AlignedSlab2(
        padded_points_t=padded8[:3],
        padded_orig=padded_orig,
        valid_padded=valid_padded,
        sorted_key=skey,
        starts_real=starts,
        offsets=offsets,
        x0=x0,
        inv_w=inv_w,
        y0=y0,
        y_scale=y_scale,
    )


def aligned_block_windows(
    al: AlignedSlab2,
    radius,
    block: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block candidate windows over the SAME aligned layout (self-join):
    (lo i32[nbk, 3], len i32[nbk, 3]) — padded-row coordinates, padding
    excluded. Window k covers bucket (b−1+k) trimmed to the block's valid-
    query y-range ± radius (quantization-widened superset)."""
    r = jnp.asarray(radius, jnp.float32)
    mp = al.valid_padded.shape[0]
    nbk = mp // block
    nb = al.offsets.shape[0] - 1
    vm = al.valid_padded.reshape(nbk, block)
    qy_b = al.padded_points_t[1].reshape(nbk, block)

    blk_start = jnp.arange(nbk, dtype=jnp.int32) * block
    # Owning bucket: offsets is tiny (NB+1), one broadcast compare beats
    # a batched binary search; tail blocks map past the last bucket.
    b_blk = (
        jnp.sum(
            al.offsets[None, :] <= blk_start[:, None], axis=1,
            dtype=jnp.int32,
        )
        - 1
    )
    live = jnp.any(vm, axis=1) & (b_blk >= 0) & (b_blk < nb)

    big = jnp.float32(jnp.inf)
    ylo = jnp.min(jnp.where(vm, qy_b, big), axis=1) - r
    yhi = jnp.max(jnp.where(vm, qy_b, -big), axis=1) + r
    qy_lo = _qy_of(ylo, al.y0, al.y_scale)  # (nbk,)
    qy_hi = _qy_of(yhi, al.y0, al.y_scale)

    ks = jnp.arange(3, dtype=jnp.int32) - 1
    cand = b_blk[:, None] + ks[None, :]  # (nbk, 3)
    ok = live[:, None] & (cand >= 0) & (cand < nb)
    cc = jnp.clip(cand, 0, nb - 1)
    key_lo = (cc << _Y_BITS) | qy_lo[:, None]
    key_hi = (cc << _Y_BITS) | qy_hi[:, None]
    skey = al.sorted_key
    # ONE fused sorted_positions call for lo+hi at L=1024: two separate
    # L=128 calls measure ~1.1 ms at 100k rows, the fused L=1024 call
    # ~0.15 ms (chip, benchmarks/profile_glue2.py) — the (Q, L) row
    # gather count halves and the wider rows amortize its fixed cost.
    # side='left' for both: a 'right' search of integer key k is exactly
    # a 'left' search of k+1 (first index with a[i] > k == first with
    # a[i] >= k+1). No i32 overflow: key_hi <= (2046<<20)|_Y_MAX, so
    # key_hi+1 <= 2047<<20 < i32 max (the invalid-row sentinel key).
    both = sorted_positions(
        skey, jnp.concatenate([key_lo, key_hi + 1], axis=0),
        side="left", L=1024,
    )
    lo_r = both[:nbk]
    hi_r = both[nbk:]
    length = jnp.where(ok, hi_r - lo_r, 0).astype(jnp.int32)
    # Real row → padded row: shift by the bucket's padding offset.
    lo_p = (al.offsets[cc] + (lo_r - al.starts_real[cc])).astype(jnp.int32)
    lo_p = jnp.where(ok, lo_p, 0)
    return lo_p, length
