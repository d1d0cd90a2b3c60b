import numpy as np
import jax.numpy as jnp

from tpu3d.ops.neighbors import knn, nearest_neighbor_xla, radius_capped_neighbors
from tpu3d.ops.nn_pallas import nearest_neighbor_triton


def _brute_knn(q, t, k):
    d2 = np.sum((q[:, None, :] - t[None, :, :]) ** 2, axis=2)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, axis=1)


def test_knn_matches_bruteforce(rng):
    q = rng.normal(size=(200, 3)).astype(np.float32)
    t = rng.normal(size=(300, 3)).astype(np.float32)
    mask = np.ones(300, bool)
    idx, d2 = knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k=10,
                  chunk=64)
    eidx, ed2 = _brute_knn(q, t, 10)
    np.testing.assert_allclose(np.asarray(d2), ed2, rtol=1e-4, atol=1e-5)
    # Index mismatches only allowed at float near-ties.
    mism = np.asarray(idx) != eidx
    assert np.allclose(np.asarray(d2)[mism], ed2[mism], rtol=1e-4, atol=1e-5)


def test_knn_masks_invalid_targets(rng):
    q = rng.normal(size=(10, 3)).astype(np.float32)
    t = np.concatenate([q, np.zeros((5, 3), np.float32)])
    mask = np.ones(15, bool)
    mask[10:] = False
    idx, d2 = knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k=1,
                  chunk=16)
    np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(10))
    # matmul-expansion self-distance is ~0 up to f32 cancellation
    np.testing.assert_allclose(np.asarray(d2)[:, 0], 0.0, atol=1e-6)


def test_nearest_neighbor_xla_vs_pallas_interpret(rng):
    q = rng.normal(size=(150, 3)).astype(np.float32)
    t = rng.normal(size=(230, 3)).astype(np.float32)
    mask = np.ones(230, bool)
    mask[200:] = False
    ix, dx = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    ip, dp = nearest_neighbor_triton(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
        block_q=64, block_m=64, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dp), rtol=1e-4,
                               atol=1e-5)
    mism = np.asarray(ix) != np.asarray(ip)
    assert mism.mean() < 0.02  # only float near-ties may differ


def test_radius_capped_neighbors_semantics(rng):
    pts = rng.uniform(0, 1, size=(80, 3)).astype(np.float32)
    mask = np.ones(80, bool)
    radius = 0.3
    idx, d2, valid = radius_capped_neighbors(
        jnp.asarray(pts), jnp.asarray(mask), radius, max_nn=20, chunk=16
    )
    idx, d2, valid = np.asarray(idx), np.asarray(d2), np.asarray(valid)
    for i in range(80):
        ref_d2 = np.sum((pts - pts[i]) ** 2, axis=1)
        # Count tolerance: points within 1e-6 of the radius boundary may
        # flip sides under the device's d2 rounding.
        exp_lo = np.sum(ref_d2 <= radius**2 - 1e-6)
        exp_hi = np.sum(ref_d2 <= radius**2 + 1e-6)
        assert min(exp_lo, 20) <= valid[i].sum() <= min(exp_hi, 20)
        assert idx[i, 0] == i and d2[i, 0] < 1e-6  # self first at ~0
        got_d = d2[i][valid[i]]
        assert np.all(np.diff(got_d) >= -1e-6)  # ascending
