"""Brute-force top-1 nearest neighbor in any dimension (33-D descriptors).

RANSAC's one-time correspondence search (registration.cpp:216-232) scans
every target descriptor per source descriptor. On the GPU it runs as one
Pallas kernel through Triton: each program takes a block of queries and a
slice of the targets, walks the slice in tiles, forms the distance tile
d² = ‖t‖² − 2·q·t in registers (an IEEE-f32 ``pl.dot`` over the first
power-of-two columns plus rank-1 updates for the rest, so 33-D runs as
32 + 1) and keeps a running (min, argmin) — the (Q, M) distance matrix is
never written. Slices are combined outside with one argmin over the split
axis.

Determinism: ties resolve to the lowest target index (first-hit argmin
within a tile, strict ``<`` across tiles, lowest split first), matching the
reference CPU scan (registration.cpp:329-335).

``nearest_neighbor`` picks the engine from the table in
tpu3d/utils/platform.py; the XLA formulation is
:func:`tpu3d.ops.neighbors.nearest_neighbor_xla`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tpu3d.utils.platform import resolve_engine

_BIG = 1.0e30


def _split_dims(d: int) -> tuple[int, int]:
    """(columns through pl.dot, rank-1 remainder columns). The dot width
    is a power of two >= 16 (a Triton dot operand constraint)."""
    p = 16
    while p * 2 <= d:
        p *= 2
    if d <= 16:
        return 16, 0
    if d - p <= 2:
        return p, d - p
    return 2 * p, 0


def _nn_kernel(q_ref, qr_ref, t_ref, tr_ref, tn_ref, d_ref, i_ref, *,
               block_q, block_m, n_tiles, n_rem):
    i = pl.program_id(0)
    s = pl.program_id(1)
    rows = pl.ds(i * block_q, block_q)
    q = q_ref[rows, :]  # (BQ, Dm), already scaled by -2
    qr = [qr_ref[r, rows][:, None] for r in range(n_rem)]
    base = s * n_tiles * block_m

    def body(j, carry):
        bd, bi = carry
        off = base + j * block_m
        cols = pl.ds(off, block_m)
        d2 = tn_ref[cols][None, :] + jax.lax.dot_general(
            q, t_ref[:, cols], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # (BQ, BM)
        for r in range(n_rem):
            d2 = d2 + qr[r] * tr_ref[r, cols][None, :]
        loc_min = jnp.min(d2, axis=1, keepdims=True)
        loc_arg = jnp.argmin(d2, axis=1)[:, None] + off
        better = loc_min < bd
        return jnp.where(better, loc_min, bd), jnp.where(better, loc_arg, bi)

    bd, bi = jax.lax.fori_loop(
        0, n_tiles, body,
        (jnp.full((block_q, 1), _BIG, jnp.float32),
         jnp.zeros((block_q, 1), jnp.int32)),
    )
    d_ref[0, :] = bd.reshape(block_q)
    i_ref[0, :] = bi.reshape(block_q)


@functools.partial(
    jax.jit,
    static_argnames=("block_q", "block_m", "splits", "interpret"),
)
def nearest_neighbor_triton(
    queries: jnp.ndarray,
    targets: jnp.ndarray,
    target_mask: jnp.ndarray,
    block_q: int = 64,
    block_m: int = 64,
    splits: int = 8,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-1 nearest valid target per query: (idx i32[Q], d2 f32[Q]).

    Args: queries f32[Q, D], targets f32[M, D], target_mask bool[M]
    (invalid rows are never selected). ``splits`` cuts the targets into
    that many slices, one program each per query block, so short query
    sets still fill the card."""
    q, d = queries.shape
    m = targets.shape[0]
    dm, n_rem = _split_dims(d)
    qt = queries.astype(jnp.float32)
    tg = jnp.where(target_mask[:, None], targets.astype(jnp.float32), 0.0)
    tn = jnp.where(target_mask, jnp.sum(tg * tg, axis=1), _BIG)
    splits = max(1, min(splits, -(-m // block_m)))
    chunk = splits * block_m
    mpad = (-m) % chunk
    qpad = (-q) % block_q
    tg = jnp.pad(tg, ((0, mpad), (0, 0)))
    tn = jnp.pad(tn, (0, mpad), constant_values=_BIG)
    qt = jnp.pad(qt, ((0, qpad), (0, 0)))
    qp, mp = q + qpad, m + mpad
    main = min(d, dm)
    q_main = jnp.pad(-2.0 * qt[:, :main], ((0, 0), (0, dm - main)))
    t_main = jnp.pad(tg[:, :main], ((0, 0), (0, dm - main))).T  # (Dm, Mp)
    q_rem = jnp.zeros((1, qp), jnp.float32)
    t_rem = jnp.zeros((1, mp), jnp.float32)
    if n_rem:
        q_rem = -2.0 * qt[:, main:].T  # (n_rem, Qp)
        t_rem = tg[:, main:].T  # (n_rem, Mp)
    n_tiles = mp // chunk
    kernel = functools.partial(
        _nn_kernel, block_q=block_q, block_m=block_m, n_tiles=n_tiles,
        n_rem=n_rem,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    dist, idx = pl.pallas_call(
        kernel,
        grid=(qp // block_q, splits),
        in_specs=[any_spec] * 5,
        out_specs=[
            pl.BlockSpec((1, block_q), lambda i, s: (s, i)),
            pl.BlockSpec((1, block_q), lambda i, s: (s, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, qp), jnp.float32),
            jax.ShapeDtypeStruct((splits, qp), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="feature_nn",
    )(q_main, q_rem, t_main, t_rem, tn)
    win = jnp.argmin(dist, axis=0)  # ties -> lowest split -> lowest index
    cols = jnp.arange(qp)
    d2 = dist[win, cols][:q] + jnp.sum(qt[:q] * qt[:q], axis=1)
    return idx[win, cols][:q], jnp.maximum(d2, 0.0)


def nearest_neighbor(
    queries: jnp.ndarray,
    targets: jnp.ndarray,
    target_mask: jnp.ndarray,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-1 NN on the engine the table picks for 'feature_nn'
    (``interpret=True`` runs the Triton kernel in the interpreter)."""
    if resolve_engine(engine, "feature_nn", interpret) == "triton":
        return nearest_neighbor_triton(
            queries, targets, target_mask, interpret=interpret
        )
    from tpu3d.ops.neighbors import nearest_neighbor_xla

    return nearest_neighbor_xla(queries, targets, target_mask)
