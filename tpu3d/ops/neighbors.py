"""Neighbor searches as batched XLA ops.

The reference does per-query brute-force scans on the host
(src/registration.cpp:63-102 ``findKNN``/``findRadiusNN``) and a CUDA
1-thread-per-point scan for ICP (cuda/icp.cu:30-54). This formulation is
*blockwise*: pairwise squared distances via one matmul per
(query-chunk × target) block, then ``lax.top_k`` / ``argmin``.
Everything is fixed-shape; invalid (padding) targets are pushed to +inf so
they can never be selected.

The top-1 search has a fused Triton kernel in :mod:`tpu3d.ops.nn_pallas`;
this module is the general/k>1 path and the XLA engine of that search.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e30)


def pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Squared euclidean distances (Q, D) x (M, D) -> (Q, M).

    Uses the ||a||² - 2a·b + ||b||² expansion so the cross term runs on the
    matrix unit. Clamped at 0 to absorb cancellation error.
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    # HIGHEST: geometric distances must be true f32 — reduced-precision
    # passes shift radius/threshold decisions and self-distances.
    cross = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    d2 = (
        jnp.sum(a * a, axis=-1)[:, None]
        - 2.0 * cross
        + jnp.sum(b * b, axis=-1)[None, :]
    )
    return jnp.maximum(d2, 0.0)


def _pad_rows(x: jnp.ndarray, multiple: int) -> jnp.ndarray:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def knn(
    queries: jnp.ndarray,
    targets: jnp.ndarray,
    target_mask: jnp.ndarray,
    k: int,
    chunk: int = 1024,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest targets per query.

    Returns (idx i32[Q, k], d2 f32[Q, k]) sorted ascending by distance; ties
    resolve to the lowest index (same as the reference's stable
    pair-comparison sorts, registration.cpp:74/95). Padding targets are at
    +inf distance — callers must mask with their own validity logic when
    fewer than k targets are valid. Exact ``lax.top_k`` — bit-matches the
    reference semantics.

    Queries are processed in fixed-size chunks via ``lax.map`` so the live
    (chunk, M) distance block stays small no matter how large Q is.
    """
    q = queries.shape[0]
    qp = _pad_rows(queries, chunk)
    invalid = jnp.where(target_mask, 0.0, _BIG)
    m = targets.shape[0]
    k_eff = min(k, m)

    def one_chunk(qc):
        d2 = pairwise_sqdist(qc, targets) + invalid[None, :]
        neg_d, idx = jax.lax.top_k(-d2, k_eff)
        if k_eff < k:  # fewer targets than k: pad with +inf slots
            idx = jnp.pad(idx, ((0, 0), (0, k - k_eff)))
            neg_d = jnp.pad(neg_d, ((0, 0), (0, k - k_eff)),
                            constant_values=-_BIG)
        return idx.astype(jnp.int32), -neg_d

    qc = qp.reshape(-1, chunk, qp.shape[-1])
    idx, d2 = jax.lax.map(one_chunk, qc)
    return idx.reshape(-1, k)[:q], d2.reshape(-1, k)[:q]


@functools.partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbor_xla(
    queries: jnp.ndarray,
    targets: jnp.ndarray,
    target_mask: jnp.ndarray,
    chunk: int = 2048,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-1 nearest target per query (XLA path).

    Mirrors the CUDA correspondence kernel's scan (cuda/icp.cu:37-46) but as
    blocked matmul + argmin. Returns (idx i32[Q], d2 f32[Q]).
    """
    q = queries.shape[0]
    qp = _pad_rows(queries, chunk)
    invalid = jnp.where(target_mask, 0.0, _BIG)

    def one_chunk(qc):
        d2 = pairwise_sqdist(qc, targets) + invalid[None, :]
        idx = jnp.argmin(d2, axis=1).astype(jnp.int32)
        return idx, jnp.min(d2, axis=1)

    qc = qp.reshape(-1, chunk, qp.shape[-1])
    idx, d2 = jax.lax.map(one_chunk, qc)
    return idx.reshape(-1)[:q], d2.reshape(-1)[:q]


def radius_capped_neighbors(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    radius: float | jnp.ndarray,
    max_nn: int,
    chunk: int = 1024,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reference ``findRadiusNN`` semantics (registration.cpp:83-102): the
    ``max_nn`` *closest* points within ``radius`` of each point (self
    included, it sits first at distance 0).

    Returns (idx i32[N, max_nn], d2 f32[N, max_nn], valid bool[N, max_nn]).
    """
    idx, d2 = knn(points, points, mask, k=max_nn, chunk=chunk)
    valid = d2 <= jnp.asarray(radius, jnp.float32) ** 2
    valid = valid & (d2 < _BIG / 2)
    return idx, d2, valid
