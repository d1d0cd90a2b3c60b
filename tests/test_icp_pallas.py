"""The Triton ICP correspondence walk (interpret mode) must reproduce the
gathered-stats backend exactly (same correspondences, same normal
equations) — it is the same math with a different dispatch shape."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu3d.ops.icp import (
    build_icp_target,
    gathered_stats_fn,
    fused_slab_stats_fn,
)
from tpu3d.ops.nn_pallas import nearest_neighbor
from tpu3d.types import PointCloud


def _make(rng, n=500, cap=640):
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pad = cap - n
    cloud = PointCloud(
        points=jnp.asarray(np.pad(pts, ((0, pad), (0, 0)))),
        normals=jnp.asarray(np.pad(nrm, ((0, pad), (0, 0)))),
        mask=jnp.asarray(np.arange(cap) < n),
    )
    return cloud


def test_pallas_stats_match_gathered():
    rng = np.random.default_rng(0)
    tgt = _make(rng)
    src = _make(rng)
    thr = 0.25
    index = jax.jit(build_icp_target)(tgt)

    # Sort source by x (the slab-coherence precondition).
    order = np.argsort(
        np.where(np.asarray(src.mask), np.asarray(src.points)[:, 0], 3e4)
    )
    sp = src.points[order]
    sm = src.mask[order]
    T = jnp.eye(4, dtype=jnp.float32)
    s = fused_slab_stats_fn(
        index, sp, sm, thr, True, block=64, sub=128, engine="triton",
        interpret=True,
    )(T)

    def corr_fn(Pq):
        return nearest_neighbor(Pq, tgt.points, tgt.mask)

    ref_stats = gathered_stats_fn(
        corr_fn, sp, sm, tgt.points, tgt.normals, thr, True
    )(T)

    assert float(s.n_corr) == float(ref_stats.n_corr)
    np.testing.assert_allclose(
        float(s.sum_d2), float(ref_stats.sum_d2), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s.ata), np.asarray(ref_stats.ata), rtol=2e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s.atb), np.asarray(ref_stats.atb), rtol=2e-5, atol=1e-6
    )


def test_pallas_stats_empty_windows():
    """Source far outside the target: zero correspondences, zero stats."""
    rng = np.random.default_rng(1)
    tgt = _make(rng, n=200, cap=256)
    src_pts = rng.uniform(50, 51, (128, 3)).astype(np.float32)
    index = jax.jit(build_icp_target)(tgt)
    s = fused_slab_stats_fn(
        index, jnp.asarray(src_pts), jnp.ones(128, bool), 0.1, True,
        block=128, sub=64, engine="triton", interpret=True,
    )(jnp.eye(4, dtype=jnp.float32))
    assert float(s.n_corr) == 0.0
    assert float(s.sum_d2) == 0.0
    assert float(jnp.sum(jnp.abs(s.ata))) == 0.0
    assert float(jnp.sum(jnp.abs(s.atb))) == 0.0
