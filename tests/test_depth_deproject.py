import numpy as np
import jax.numpy as jnp

from tpu3d import oracle
from tpu3d.ops.depth import bilateral_filter, depth_preprocess
from tpu3d.ops.deproject import deproject


def test_depth_preprocess_scale_and_mask(rng):
    depth = rng.integers(0, 2000, size=(20, 30)).astype(np.uint16)
    mask = rng.integers(0, 255, size=(20, 30)).astype(np.uint8)
    out = np.asarray(
        depth_preprocess(jnp.asarray(depth), jnp.asarray(mask), 1000.0)
    )
    exp = depth.astype(np.float32) / 1000.0
    exp[mask <= 10] = 0.0  # CPU reference semantics (pipeline.cpp:50-52)
    np.testing.assert_allclose(out, exp, atol=1e-7)


def test_depth_preprocess_no_mask(rng):
    depth = rng.integers(0, 2000, size=(8, 8)).astype(np.uint16)
    out = np.asarray(depth_preprocess(jnp.asarray(depth), None, 500.0))
    np.testing.assert_allclose(out, depth / 500.0, atol=1e-6)


def test_bilateral_matches_oracle(rng):
    depth = rng.uniform(0.5, 1.5, size=(16, 20)).astype(np.float32)
    depth[rng.uniform(size=(16, 20)) < 0.2] = 0.0  # holes
    sig_s, sig_r = 1.5, 0.05
    exp = oracle.bilateral_filter(depth, sig_s, sig_r)
    got = np.asarray(
        bilateral_filter(jnp.asarray(depth), sig_s, sig_r)
    )
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)


def test_bilateral_preserves_edges(rng):
    depth = np.full((20, 20), 1.0, np.float32)
    depth[:, 10:] = 0.5  # sharp step ≫ sigma_range
    got = np.asarray(bilateral_filter(jnp.asarray(depth), 2.0, 0.01))
    np.testing.assert_allclose(got[:, :8], 1.0, atol=1e-4)
    np.testing.assert_allclose(got[:, 12:], 0.5, atol=1e-4)


def test_deproject_matches_oracle(rng):
    h, w = 12, 16
    depth = rng.uniform(0, 2.0, size=(h, w)).astype(np.float32)
    depth[depth < 0.2] = 0.0
    rgb = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    fx, fy, cx, cy = 100.0, 110.0, 8.0, 6.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    clip = 1.5

    exp_p, exp_c = oracle.deproject(depth, rgb, fx, fy, cx, cy, clip)
    out = deproject(jnp.asarray(depth), jnp.asarray(rgb), jnp.asarray(K),
                    clip)
    got = out.to_numpy()
    np.testing.assert_allclose(got["points"], exp_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["colors"], exp_c, atol=1e-6)


def test_deproject_clip_is_inclusive_of_max(rng):
    depth = np.array([[1.5, 1.5001, 0.0]], np.float32)
    K = np.array([[100.0, 0, 1], [0, 100.0, 0], [0, 0, 1]], np.float32)
    out = deproject(jnp.asarray(depth), None, jnp.asarray(K), 1.5)
    mask = np.asarray(out.mask)
    assert mask.tolist() == [True, False, False]  # z <= clip kept, z > clip dropped
