"""Exact thresholded top-1 NN at scale: slab2 windows + the window walk.

Radius-exact for ANY occupancy (the slab2 window list adapts per block),
one kernel per query pass on the GPU (ops/walk.py), and the winner's
ORIGINAL target row rides as an f32 payload plane (exact for M < 2^24), so
no index gather ever touches device memory.

Semantics (the reference scan, registration.cpp:329-335 /
cuda/icp.cu:30-54): nearest target within ``radius``; ties resolve to the
lowest SORTED target row; queries with no in-radius target report
d2 >= 1e30. Query/target masks honored.

``TOP1`` is the shared top-1-with-payload sweep: the ICP correspondence
pass (ops/icp.py) runs it with the matched point and normal as payload.

The build (``build_walk_target``) is split from the query pass
(``slab2_top1_indexed``) so callers that scan a FIXED target many times —
the sharded-target path in tpu3d/parallel/sharded_nn.py — pay the target
sort once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu3d.ops.slab2 import Slab2Index, block_windows, build_slab2
from tpu3d.ops.walk import Sweep, walk

_BIG = 1e30


def top1_sweep(payload_rows: tuple[int, ...]) -> Sweep:
    """Nearest candidate per query within the gate ``w.s[0]`` (a squared
    distance), carrying the winner's ``payload_rows`` planes. Query planes:
    0-2 coords, 3 mask; candidate planes 0-2 coords (3e4 sentinels on
    invalid rows). Outputs: d² (1e30 where no match), then the payload."""

    def prologue(w):
        return None

    def init(b):
        return (jnp.full((b, 1), _BIG, jnp.float32),) + tuple(
            jnp.zeros((b, 1), jnp.float32) for _ in payload_rows
        )

    def tile(w, aux, carry):
        bd = carry[0]
        dx = w.load(0) - w.q[0]
        dy = w.load(1) - w.q[1]
        dz = w.load(2) - w.q[2]
        d2 = jnp.where(w.own, dx * dx + dy * dy + dz * dz, _BIG)
        loc_min = jnp.min(d2, axis=1, keepdims=True)
        loc_arg = jnp.argmin(d2, axis=1)[:, None]  # lowest-row tie break
        better = loc_min < bd  # strict: earlier tiles keep ties
        # One-hot winner extraction from the INTEGER argmin (exact, no
        # float equality on recomputed d²).
        win = jnp.where((w.col == loc_arg) & better, 1.0, 0.0)
        pay = tuple(
            jnp.where(better, jnp.sum(win * w.load(r), axis=1,
                                      keepdims=True), p)
            for r, p in zip(payload_rows, carry[1:])
        )
        return (jnp.where(better, loc_min, bd),) + pay

    def epilogue(w, aux, carry):
        keep = (w.q[3] > 0.5) & (carry[0] <= w.s[0])
        return [jnp.where(keep, carry[0], _BIG)] + list(carry[1:])

    return Sweep(prologue, init, tile, epilogue, n_q=4,
                 n_out=1 + len(payload_rows))


TOP1_INDEX = top1_sweep((3,))


class WalkTarget(NamedTuple):
    """Prebuilt target side of the slab2 walk NN. ``packed`` rows 0-2 are
    sorted coordinate planes (3e4 sentinels on invalid rows), row 3 the
    original-row payload. Scalars are kept (1,)-shaped so the structure
    shards cleanly over a mesh axis (tpu3d/parallel/sharded_nn.py)."""

    packed: jnp.ndarray  # f32[4, M]
    sorted_key: jnp.ndarray  # i32[M]
    x0: jnp.ndarray  # f32[1]
    inv_w: jnp.ndarray  # f32[1]
    y0: jnp.ndarray  # f32[1]
    y_scale: jnp.ndarray  # f32[1]


def build_walk_target(
    targets: jnp.ndarray, tmask: jnp.ndarray, radius
) -> WalkTarget:
    """One composite-key sort of the target cloud."""
    assert targets.shape[0] < (1 << 24), "f32 payload exactness bound"
    r = jnp.asarray(radius, jnp.float32)
    tslab = build_slab2(targets, tmask, r)
    packed = jnp.concatenate(
        [
            tslab.sorted_points_t,
            tslab.sorted_orig.astype(jnp.float32)[None],
        ],
        axis=0,
    )  # (4, M): coords + original-row payload
    return WalkTarget(
        packed=packed,
        sorted_key=tslab.sorted_key,
        x0=tslab.x0.reshape(1),
        inv_w=tslab.inv_w.reshape(1),
        y0=tslab.y0.reshape(1),
        y_scale=tslab.y_scale.reshape(1),
    )


def _windows_index(wt: WalkTarget) -> Slab2Index:
    """Adapter: the subset of Slab2Index that block_windows consumes."""
    return Slab2Index(
        sorted_points=None,
        sorted_points_t=None,
        sorted_orig=None,
        sorted_key=wt.sorted_key,
        valid_sorted=None,
        x0=wt.x0[0],
        inv_w=wt.inv_w[0],
        y0=wt.y0[0],
        y_scale=wt.y_scale[0],
    )


@functools.partial(
    jax.jit,
    static_argnames=("block", "sub", "k_windows", "engine", "interpret"),
)
def slab2_top1_indexed(
    wt: WalkTarget,
    queries: jnp.ndarray,  # f32[Q, 3]
    qmask: jnp.ndarray,  # bool[Q]
    radius,
    block: int = 64,
    sub: int = 64,
    k_windows: int = 10,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Query pass against a prebuilt target: returns (idx i32[Q], d2
    f32[Q]) in ORIGINAL query order — the nearest valid target within
    ``radius`` per valid query (original target row), d2 >= 1e30 where
    there is none (or the query is invalid)."""
    r = jnp.asarray(radius, jnp.float32)
    tindex = _windows_index(wt)

    qslab = build_slab2(queries, qmask, r)  # block coherence for windows
    nq = queries.shape[0]
    pad = (-nq) % block
    coords = jnp.pad(qslab.sorted_points_t, ((0, 0), (0, pad)),
                     constant_values=2.9e4)
    mb = jnp.pad(qslab.valid_sorted, (0, pad)).reshape(-1, block)
    lo, length = block_windows(
        tindex,
        (coords[0].reshape(-1, block), coords[1].reshape(-1, block)),
        mb, r, k_max=k_windows,
    )
    q4 = jnp.concatenate(
        [coords, mb.reshape(1, -1).astype(jnp.float32)], axis=0
    )
    out = walk(
        TOP1_INDEX, q4, wt.packed, lo, length, (r * r,), block=block,
        sub=sub, engine=engine, stage="nn_walk", interpret=interpret,
    )
    d2_sorted = out[0, :nq]
    idx_sorted = out[1, :nq].astype(jnp.int32)
    # Back to original query order (permutation scatter, no extra sort).
    d2 = jnp.full((nq,), _BIG, jnp.float32).at[qslab.sorted_orig].set(
        d2_sorted, unique_indices=True
    )
    idx = jnp.zeros((nq,), jnp.int32).at[qslab.sorted_orig].set(
        idx_sorted, unique_indices=True
    )
    return idx, d2


@functools.partial(
    jax.jit,
    static_argnames=("block", "sub", "k_windows", "engine", "interpret"),
)
def slab2_top1(
    queries: jnp.ndarray,  # f32[Q, 3]
    qmask: jnp.ndarray,  # bool[Q]
    targets: jnp.ndarray,  # f32[M, 3], M < 2^24
    tmask: jnp.ndarray,  # bool[M]
    radius,
    block: int = 64,
    sub: int = 64,
    k_windows: int = 10,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build + query in one call (see slab2_top1_indexed)."""
    wt = build_walk_target(targets, tmask, radius)
    return slab2_top1_indexed(
        wt, queries, qmask, radius, block=block, sub=sub,
        k_windows=k_windows, engine=engine, interpret=interpret,
    )
