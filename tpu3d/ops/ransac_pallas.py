"""RANSAC hypothesis scoring as one Pallas kernel through Triton.

err²[i,h] = F_i · W_h + (‖p_i‖² + ‖q_i‖²) + ‖t_h‖²   (see ops/ransac.py)

The XLA formulation writes each (points × hypotheses) err² chunk to
device memory only to threshold and sum it, one chunk after another.
Here each program owns a block of hypotheses and walks the point rows in
tiles: the rank-16 product runs as an IEEE-f32 ``pl.dot`` in registers,
the inlier compare and both sums reduce in-kernel, and only the (2, H)
result is written.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def _score_kernel(thr2_ref, feat_ref, pq_ref, w_ref, tn_ref, cnt_ref,
                  err_ref, *, block_n, n_tiles):
    thr2 = thr2_ref[0]
    w = w_ref[...]  # (16, BH)
    tn = tn_ref[...][None, :]  # (1, BH)

    def body(j, carry):
        cnt, err = carry
        cols = pl.ds(j * block_n, block_n)
        err2 = (
            jax.lax.dot_general(
                feat_ref[:, cols], w, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )  # (BN, BH)
            + pq_ref[cols][:, None]
            + tn
        )
        inl = err2 < thr2
        cnt = cnt + jnp.sum(jnp.where(inl, 1.0, 0.0), axis=0)
        err = err + jnp.sum(jnp.where(inl, jnp.maximum(err2, 0.0), 0.0),
                            axis=0)
        return cnt, err

    bh = w.shape[1]
    cnt, err = jax.lax.fori_loop(
        0, n_tiles, body,
        (jnp.zeros((bh,), jnp.float32), jnp.zeros((bh,), jnp.float32)),
    )
    cnt_ref[...] = cnt
    err_ref[...] = err


@functools.partial(
    jax.jit,
    static_argnames=("block_n", "block_h", "interpret"),
)
def score_hypotheses_triton(
    feat_t: jnp.ndarray,  # f32[16, N] rank-15 factors, zero-padded to 16
    pq_norm: jnp.ndarray,  # f32[N] ‖p‖²+‖q‖² (1e30 on invalid rows)
    w16t: jnp.ndarray,  # f32[16, H] [Rᵀt, t, vec(R), 0]
    t_norm: jnp.ndarray,  # f32[H] ‖t_h‖²
    thr2,
    block_n: int = 64,
    block_h: int = 64,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (inlier_count f32[H], err2_sum f32[H]). Padded point rows
    carry pq = 1e30 (never inliers); padded hypotheses are sliced off."""
    n = feat_t.shape[1]
    h = w16t.shape[1]
    npad = (-n) % block_n
    hpad = (-h) % block_h
    feat_t = jnp.pad(feat_t, ((0, 0), (0, npad)))
    pq_norm = jnp.pad(pq_norm, (0, npad), constant_values=1e30)
    w16t = jnp.pad(w16t, ((0, 0), (0, hpad)))
    t_norm = jnp.pad(t_norm, (0, hpad))
    hp = h + hpad
    kernel = functools.partial(
        _score_kernel, block_n=block_n, n_tiles=(n + npad) // block_n
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    cnt, err = pl.pallas_call(
        kernel,
        grid=(hp // block_h,),
        in_specs=[
            any_spec,  # thr2 (1,)
            any_spec,  # feat (16, Np)
            any_spec,  # pq (Np,)
            pl.BlockSpec((16, block_h), lambda i: (0, i)),
            pl.BlockSpec((block_h,), lambda i: (i,)),
        ],
        out_specs=[
            pl.BlockSpec((block_h,), lambda i: (i,)),
            pl.BlockSpec((block_h,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((hp,), jnp.float32),
            jax.ShapeDtypeStruct((hp,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="ransac_score",
    )(
        jnp.reshape(jnp.asarray(thr2, jnp.float32), (1,)),
        feat_t,
        pq_norm,
        w16t,
        t_norm,
    )
    return cnt[:h], err[:h]
