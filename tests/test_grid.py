import numpy as np
import jax.numpy as jnp

from tpu3d.ops.grid import build_grid, grid_knn, grid_top1
from tpu3d.ops.neighbors import knn, nearest_neighbor_xla


def test_grid_top1_matches_bruteforce_within_radius(rng):
    t = rng.uniform(0, 1, size=(2000, 3)).astype(np.float32)
    q = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    mask = np.ones(2000, bool)
    mask[1900:] = False
    h = 0.08

    grid = build_grid(jnp.asarray(t), jnp.asarray(mask), h)
    gi, gd = grid_top1(grid, jnp.asarray(q), cell_capacity=64, chunk=128)
    bi, bd = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    gi, gd, bi, bd = map(np.asarray, (gi, gd, bi, bd))
    within = bd <= h * h  # brute-force NN inside coverage radius
    assert within.sum() > 100
    np.testing.assert_allclose(gd[within], bd[within], rtol=1e-4, atol=1e-6)
    # index can differ only at exact float ties
    mism = (gi != bi) & within
    assert np.allclose(gd[mism], bd[mism], atol=1e-6)
    # no-match queries report huge distance
    assert np.all(gd[~within] >= bd[~within] - 1e-6)


def test_grid_negative_coords_and_offsets(rng):
    # Far-from-origin coordinates: the grid's direct diff² distances stay
    # accurate where the matmul expansion loses precision — compare against
    # exact numpy brute force.
    t = rng.uniform(-5, -3, size=(800, 3)).astype(np.float32)
    q = t[:100] + rng.normal(scale=0.01, size=(100, 3)).astype(np.float32)
    mask = np.ones(800, bool)
    grid = build_grid(jnp.asarray(t), jnp.asarray(mask), 0.05)
    gi, gd = grid_top1(grid, jnp.asarray(q), cell_capacity=64, chunk=64)
    d2 = np.sum((q[:, None, :] - t[None, :, :]) ** 2, axis=2)
    bd = d2.min(axis=1)
    gd = np.asarray(gd)
    within = bd <= 0.05**2
    np.testing.assert_allclose(gd[within], bd[within], rtol=1e-4, atol=1e-9)


def test_grid_knn_matches_exact_within_radius(rng):
    t = rng.uniform(0, 0.5, size=(1500, 3)).astype(np.float32)
    mask = np.ones(1500, bool)
    radius = 0.05
    grid = build_grid(jnp.asarray(t), jnp.asarray(mask), radius)
    gi, gd = grid_knn(grid, jnp.asarray(t), k=20, cell_capacity=128, chunk=128)
    ei, ed = knn(jnp.asarray(t), jnp.asarray(t), jnp.asarray(mask), k=20)
    gi, gd, ei, ed = map(np.asarray, (gi, gd, ei, ed))
    # Wherever the exact k-NN distance is within radius, grid must agree.
    in_r = ed <= radius * radius
    np.testing.assert_allclose(gd[in_r], ed[in_r], rtol=1e-4, atol=1e-6)
    # Self is always first at d2 == 0.
    assert np.all(gi[:, 0] == np.arange(1500))


def test_grid_respects_mask(rng):
    t = rng.uniform(0, 1, size=(512, 3)).astype(np.float32)
    mask = np.zeros(512, bool)
    mask[:256] = True
    grid = build_grid(jnp.asarray(t), jnp.asarray(mask), 0.2)
    gi, gd = grid_top1(grid, jnp.asarray(t[:64]), cell_capacity=256, chunk=64)
    gi, gd = np.asarray(gi), np.asarray(gd)
    assert np.all(gi[gd < 1e29] < 256)  # only valid targets selectable
    # query = valid target → finds itself at 0
    np.testing.assert_allclose(gd[:64][np.arange(64) < 256][: 64], 0.0,
                               atol=1e-7)
