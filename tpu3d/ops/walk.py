"""The window walk: every windowed sweep of the framework, on two engines.

Every radius-limited stage (the three prepare sweeps, the ICP
correspondence pass, the radius top-1 search) has one skeleton. Queries
come in blocks of ``block`` consecutive rows of a sorted layout; block b
owns K candidate windows [lo[b,k], lo[b,k]+len[b,k]) — disjoint row
ranges of a packed candidate operand (R, M). The walk visits each window
in ``ceil(len/sub)`` tiles of ``sub`` contiguous candidates, hands every
tile to the sweep's ``tile`` function, and runs the sweep's ``epilogue``
on the carry.

A tile starts at ``min(lo + t*sub, M - sub)`` and masks its rows to the
ones it OWNS by absolute row number (``own``), so clamping at the array
end never double counts and no load ever leaves the operand. Invalid
candidate rows need no mask: callers store sentinel coordinates there
that fail every distance gate.

Engines (``engine_for`` in tpu3d/utils/platform.py picks one):

  * ``'triton'`` — ONE Pallas kernel through Triton: one program per
    query block, which reads its own window row, loops over its windows
    with a traced trip count, keeps the accumulators in registers and
    runs the epilogue in-kernel. ``interpret=True`` runs the same kernel
    in the Pallas interpreter (the CPU tests).
  * ``'xla'`` — ``lax.map`` over the blocks with nested ``fori_loop``s.

A sweep is a small object with four methods, written once in plain
jax.numpy that lowers on both engines (no value slicing, no concatenate,
Python-float constants only):

  prologue(w)               -> aux      per-block values (block centre, ...)
  init(block)               -> carry
  tile(w, aux, carry)       -> carry    w.q[i] (B,1) query planes,
                                        w.s[i] scalars, w.load(i) (1,sub)
                                        candidate plane, w.load_rows(i0, n)
                                        (n,sub), w.own (1,sub), w.col (1,sub)
  epilogue(w, aux, carry)   -> [out]    each (B,1) or (n, B) planes

``walk`` returns the epilogue's outputs as planes (rows, Np).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tpu3d.utils.platform import resolve_engine


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _View:
    """What a sweep sees of the current block and tile."""

    def __init__(self, q, s, load=None, load_rows=None, own=None, col=None):
        self.q = q
        self.s = s
        self.load = load
        self.load_rows = load_rows
        self.own = own
        self.col = col


class Sweep(NamedTuple):
    prologue: object
    init: object
    tile: object
    epilogue: object
    n_q: int  # query planes read
    n_out: int  # output planes written


def _store_rows(outs, store):
    """Write epilogue outputs to consecutive plane rows."""
    j = 0
    for o in outs:
        n = o.shape[0] if o.shape[1] != 1 else 1
        store(j, n, o)
        j += n
    return j


def _walk_blocks(w_q, w_s, lo_k, len_k, m, sub, col, loader, sweep, aux,
                 carry):
    """The window loop shared by both engines (one block)."""
    k_max = len(lo_k)
    for k in range(k_max):
        lo, ln = lo_k[k], len_k[k]
        n_sub = jax.lax.div(ln + (sub - 1), sub)

        def body(t, c, lo=lo, ln=ln):
            own_lo = lo + t * sub
            start = jnp.minimum(own_lo, m - sub)
            row = start + col
            own = (row >= own_lo) & (row < lo + ln)
            load, load_rows = loader(start)
            w = _View(w_q, w_s, load, load_rows, own, col)
            return sweep.tile(w, aux, c)

        carry = jax.lax.fori_loop(0, n_sub, body, carry)
    return carry


def _xla_walk(sweep, q, packed, lo, length, scal, block, sub, n_rows):
    nb = q.shape[1] // block
    m = packed.shape[1]
    k_max = lo.shape[1]
    qb = jnp.moveaxis(q[: sweep.n_q].reshape(sweep.n_q, nb, block), 1, 0)
    col = jnp.arange(sub, dtype=jnp.int32)[None, :]
    svals = [scal[i] for i in range(scal.shape[0])]

    def loader(start):
        def load(i):
            return jax.lax.dynamic_slice(packed, (i, start), (1, sub))

        def load_rows(i0, n):
            return jax.lax.dynamic_slice(packed, (i0, start), (n, sub))

        return load, load_rows

    def one(args):
        qblk, lo_b, len_b = args
        w_q = [qblk[i][:, None] for i in range(sweep.n_q)]
        w0 = _View(w_q, svals)
        aux = sweep.prologue(w0)
        carry = _walk_blocks(
            w_q, svals, [lo_b[k] for k in range(k_max)],
            [len_b[k] for k in range(k_max)], m, sub, col, loader, sweep,
            aux, sweep.init(block),
        )
        outs = sweep.epilogue(w0, aux, carry)
        rows = []
        _store_rows(
            outs, lambda j, n, o: rows.append(o.reshape(1, block) if n == 1
                                              else o)
        )
        res = jnp.concatenate(rows, axis=0)
        return jnp.pad(res, ((0, n_rows - res.shape[0]), (0, 0)))

    out = jax.lax.map(one, (qb, lo, length))  # (nb, n_rows, B)
    return jnp.moveaxis(out, 0, 1).reshape(n_rows, nb * block)


def _triton_kernel(lo_ref, len_ref, scal_ref, q_ref, packed_ref, out_ref, *,
                   sweep, k_max, n_scal, sub, m, block):
    b = pl.program_id(0)
    w_q = [q_ref[i, :][:, None] for i in range(sweep.n_q)]
    w_s = [scal_ref[i] for i in range(n_scal)]
    col = jnp.arange(sub, dtype=jnp.int32)[None, :]

    def loader(start):
        def load(i):
            return packed_ref[i, pl.ds(start, sub)][None, :]

        def load_rows(i0, n):
            return packed_ref[pl.ds(i0, n), pl.ds(start, sub)]

        return load, load_rows

    w0 = _View(w_q, w_s)
    aux = sweep.prologue(w0)
    carry = _walk_blocks(
        w_q, w_s, [lo_ref[b * k_max + k] for k in range(k_max)],
        [len_ref[b * k_max + k] for k in range(k_max)], m, sub, col, loader,
        sweep, aux, sweep.init(block),
    )
    outs = sweep.epilogue(w0, aux, carry)

    def store(j, n, o):
        if n == 1:
            out_ref[j, :] = o.reshape(block)
        else:
            out_ref[pl.ds(j, n), :] = o

    _store_rows(outs, store)


def _triton_walk(sweep, q, packed, lo, length, scal, block, sub, n_rows,
                 interpret):
    npad = q.shape[1]
    nb = npad // block
    k_max = lo.shape[1]
    rq = _pow2(q.shape[0])
    if rq != q.shape[0]:
        q = jnp.pad(q, ((0, rq - q.shape[0]), (0, 0)))
    kernel = functools.partial(
        _triton_kernel, sweep=sweep, k_max=k_max, n_scal=scal.shape[0],
        sub=sub, m=packed.shape[1], block=block,
    )
    return pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),  # lo, flat (nb*K,)
            pl.BlockSpec(memory_space=pl.ANY),  # len, flat
            pl.BlockSpec(memory_space=pl.ANY),  # scalars
            pl.BlockSpec((rq, block), lambda i: (0, i)),  # query planes
            pl.BlockSpec(memory_space=pl.ANY),  # packed candidates
        ],
        out_specs=pl.BlockSpec((n_rows, block), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((n_rows, npad), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="window_walk",
    )(
        lo.astype(jnp.int32).reshape(-1),
        length.astype(jnp.int32).reshape(-1),
        scal,
        q,
        packed,
    )


def walk(
    sweep: Sweep,
    q: jnp.ndarray,  # f32[>= n_q, Np] query planes, Np = nb * block
    packed: jnp.ndarray,  # f32[R, M] candidate planes
    lo: jnp.ndarray,  # i32[nb, K] window starts (rows of packed)
    length: jnp.ndarray,  # i32[nb, K] window lengths
    scalars,  # sequence of f32 scalars, read as w.s[i]
    *,
    block: int,
    sub: int,
    engine: str = "auto",
    stage: str = "prepare",
    interpret: bool = False,
) -> jnp.ndarray:
    """Run ``sweep`` over every query block; returns f32[n_out, Np].

    ``block`` and ``sub`` must be powers of two (Triton block shapes).
    ``engine='auto'`` reads the engine table for ``stage``."""
    assert block & (block - 1) == 0 and sub & (sub - 1) == 0, (block, sub)
    npad = q.shape[1]
    assert npad % block == 0, (npad, block)
    q = q.astype(jnp.float32)
    packed = packed.astype(jnp.float32)
    if packed.shape[1] < sub:  # every tile must fit inside the operand
        packed = jnp.pad(
            packed, ((0, 0), (0, sub - packed.shape[1])),
            constant_values=3.0e4,
        )
    scal = jnp.stack(
        [jnp.asarray(s, jnp.float32).reshape(()) for s in scalars]
        + [jnp.float32(0.0)]
    )
    n_rows = _pow2(sweep.n_out)
    if resolve_engine(engine, stage, interpret) == "triton":
        out = _triton_walk(sweep, q, packed, lo, length, scal, block, sub,
                           n_rows, interpret)
    else:
        out = _xla_walk(sweep, q, packed, lo, length, scal, block, sub,
                        n_rows)
    return out[: sweep.n_out]
