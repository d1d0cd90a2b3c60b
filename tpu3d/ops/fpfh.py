"""FPFH (Fast Point Feature Histograms), 33-D, as gather + one-hot matmul.

Reference semantics (src/registration.cpp:133-201):
  - neighbor set: the 100 closest points within ``radius`` (self included in
    the list, skipped in the loops; contributions with pair distance < 1e-8
    are skipped too — registration.cpp:142-146, 183-185);
  - Darboux frame per (i, j) pair: u = n_i, v = u × d̂, w = u × v with
    d̂ = (p_j - p_i)/dist (registration.cpp:148-151);
  - angles: alpha = v·n_j, phi = u·d̂, theta = atan2(w·n_j, u·n_j);
  - bins: clamp(int((x + 1)·5.5), 0, 10) per angle (theta uses theta/π),
    packed [alpha | 11 + phi | 22 + theta] (registration.cpp:156-162);
  - SPFH = L1-normalized histogram; FPFH_i = SPFH_i + Σ_j SPFH_j / dist_ij,
    L1-normalized (registration.cpp:176-196).

Device formulation: the scatter-add histogram becomes a one-hot × mask
matmul (deterministic — no atomics like cuda/icp.cu's reductions),
processed in fixed query chunks via ``lax.map`` to bound live memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu3d.ops.neighbors import radius_capped_neighbors
from tpu3d.types import FPFHFeatures, PointCloud

_MAX_NN = 100


def _bin_index(x: jnp.ndarray) -> jnp.ndarray:
    """clamp(int((x + 1) * 5.5), 0, 10) — truncation == floor here because
    the argument is non-negative before the clamp (registration.cpp:156)."""
    return jnp.clip(jnp.floor((x + 1.0) * 5.5), 0.0, 10.0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_nn", "chunk"))
def compute_fpfh(
    cloud: PointCloud,
    radius: jnp.ndarray,
    max_nn: int = _MAX_NN,
    chunk: int = 512,
    neighbors: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> FPFHFeatures:
    """``neighbors``: optional precomputed (idx, d2) self-kNN with max_nn
    columns (sorted ascending) to share one search with estimate_normals."""
    if cloud.normals is None:
        raise ValueError("compute_fpfh requires normals (run estimate_normals)")
    pts, nrm, mask = cloud.points, cloud.normals, cloud.mask
    n = cloud.capacity

    if neighbors is not None:
        idx, d2 = neighbors[0][:, :max_nn], neighbors[1][:, :max_nn]
        in_radius = (d2 <= jnp.asarray(radius, jnp.float32) ** 2) & (d2 < 1e29)
    else:
        idx, d2, in_radius = radius_capped_neighbors(pts, mask, radius, max_nn)
    dist = jnp.sqrt(d2)
    # Contribution gate: within radius, valid target, and pair distance
    # >= 1e-8 (which also removes self at distance 0).
    contrib = in_radius & (dist >= 1e-8)

    pad = (-n) % chunk

    def padded(a, fill=0):
        if pad == 0:
            return a
        widths = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
        return jnp.pad(a, widths, constant_values=fill)

    idx_p = padded(idx)
    dist_p = padded(dist, 1.0)
    contrib_p = padded(contrib, False)
    pts_p = padded(pts)
    nrm_p = padded(nrm)

    def spfh_chunk(args):
        ci, cd, cc, cp, cn = args  # (C, K), (C, K), (C, K), (C, 3), (C, 3)
        nbp = pts[ci]  # (C, K, 3)
        nbn = nrm[ci]
        diff = nbp - cp[:, None, :]
        safe_d = jnp.maximum(cd, 1e-12)
        dhat = diff / safe_d[..., None]
        u = cn[:, None, :]  # broadcast (C, 1, 3)
        v = jnp.cross(jnp.broadcast_to(u, dhat.shape), dhat)
        w = jnp.cross(jnp.broadcast_to(u, v.shape), v)
        alpha = jnp.sum(v * nbn, axis=-1)
        phi = jnp.sum(u * dhat, axis=-1)
        theta = jnp.arctan2(jnp.sum(w * nbn, axis=-1), jnp.sum(u * nbn, axis=-1))
        bins = jnp.stack(
            [
                _bin_index(alpha),
                11 + _bin_index(phi),
                22 + _bin_index(theta / jnp.pi),
            ],
            axis=-1,
        )  # (C, K, 3)
        onehot = jax.nn.one_hot(bins, 33, dtype=jnp.float32)  # (C, K, 3, 33)
        hist = jnp.einsum(
            "ckao,ck->co", onehot, cc.astype(jnp.float32)
        )  # (C, 33)
        s = jnp.sum(hist, axis=-1, keepdims=True)
        return jnp.where(s > 0, hist / jnp.maximum(s, 1e-30), hist)

    n_chunks = (n + pad) // chunk
    spfh = jax.lax.map(
        spfh_chunk,
        (
            idx_p.reshape(n_chunks, chunk, -1),
            dist_p.reshape(n_chunks, chunk, -1),
            contrib_p.reshape(n_chunks, chunk, -1),
            pts_p.reshape(n_chunks, chunk, 3),
            nrm_p.reshape(n_chunks, chunk, 3),
        ),
    ).reshape(-1, 33)[:n]

    def fpfh_chunk(args):
        ci, cd, cc, cs = args  # idx, dist, contrib, own spfh (C, 33)
        wgt = jnp.where(cc, 1.0 / jnp.maximum(cd, 1e-12), 0.0)  # (C, K)
        nb_spfh = spfh[ci]  # (C, K, 33)
        f = cs + jnp.einsum("ck,cko->co", wgt, nb_spfh)
        s = jnp.sum(f, axis=-1, keepdims=True)
        return jnp.where(s > 0, f / jnp.maximum(s, 1e-30), f)

    spfh_p = padded(spfh)
    fpfh = jax.lax.map(
        fpfh_chunk,
        (
            idx_p.reshape(n_chunks, chunk, -1),
            dist_p.reshape(n_chunks, chunk, -1),
            contrib_p.reshape(n_chunks, chunk, -1),
            spfh_p.reshape(n_chunks, chunk, 33),
        ),
    ).reshape(-1, 33)[:n]

    fpfh = jnp.where(mask[:, None], fpfh, 0.0)
    return FPFHFeatures(descriptors=fpfh, mask=mask)
