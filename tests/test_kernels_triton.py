"""The Triton kernels in the Pallas interpreter against their XLA engines
(RANSAC scoring, the window walk under vmap), and — on a card — compiled.

Every kernel is called with ``backend="triton"``; ``interpret=True`` runs
the same kernel body on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu3d.ops.icp import build_icp_target, fused_slab_stats_fn
from tpu3d.ops.ransac import build_scoring_factors, pack_hypotheses, score_w16
from tpu3d.ops.transforms import euler_xyz_to_matrix
from tpu3d.types import PointCloud


def _scoring_inputs(rng, n=700, h=300):
    p = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    q = (p + rng.normal(0, 0.002, (n, 3))).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::11] = False
    feat, pq = build_scoring_factors(jnp.asarray(p), jnp.asarray(q),
                                     jnp.asarray(mask))
    ang = rng.normal(0, 0.01, (h, 3)).astype(np.float32)
    Rs = jax.vmap(euler_xyz_to_matrix)(jnp.asarray(ang))
    ts = jnp.asarray(rng.normal(0, 0.003, (h, 3)).astype(np.float32))
    w16, tn = pack_hypotheses(Rs, ts)
    return feat, pq, w16, tn


def test_score_kernel_matches_xla(rng):
    """Inlier counts and error sums of the fused scoring kernel equal the
    chunked XLA scoring (score_w16's CPU engine) — odd N and H exercise
    the padding of both axes."""
    feat, pq, w16, tn = _scoring_inputs(rng)
    thr2 = jnp.float32(0.003 ** 2)
    ck, ek = score_w16(feat, pq, w16, tn, thr2, engine="triton",
                       interpret=True)
    cx, ex = score_w16(feat, pq, w16, tn, thr2, engine="xla")
    assert ck.shape == cx.shape == (300,)
    np.testing.assert_array_equal(np.asarray(ck), np.asarray(cx))
    assert 0 < float(jnp.max(cx)) <= 700
    np.testing.assert_allclose(np.asarray(ek), np.asarray(ex), rtol=1e-5,
                               atol=1e-12)


def test_score_kernel_under_vmap(rng):
    """register_batch vmaps the scoring over instances: the batched
    kernel equals per-instance XLA scoring."""
    ins = [_scoring_inputs(rng, n=300, h=130) for _ in range(2)]
    feat, pq, w16, tn = (jnp.stack(x) for x in zip(*ins))
    thr2 = jnp.float32(0.003 ** 2)
    ck, ek = jax.vmap(
        lambda f, p, w, t: score_w16(f, p, w, t, thr2, engine="triton",
                                     interpret=True)
    )(feat, pq, w16, tn)
    for b in range(2):
        cx, ex = score_w16(feat[b], pq[b], w16[b], tn[b], thr2,
                           engine="xla")
        np.testing.assert_array_equal(np.asarray(ck[b]), np.asarray(cx))
        np.testing.assert_allclose(np.asarray(ek[b]), np.asarray(ex),
                                   rtol=1e-5, atol=1e-12)


def test_walk_kernel_under_vmap(rng):
    """The ICP correspondence walk, vmapped over two sources the way
    parallel/batched.py vmaps ICP, equals the XLA walk per source."""
    n = 400
    t = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tgt = PointCloud(points=jnp.asarray(t), mask=jnp.ones(n, bool),
                     normals=jnp.asarray(nrm))
    index = jax.jit(build_icp_target)(tgt)
    srcs = np.stack([
        np.sort(t + rng.normal(0, 0.01, (n, 3)).astype(np.float32), axis=0)
        for _ in range(2)
    ])
    T = jnp.eye(4, dtype=jnp.float32)

    def stats(sp, engine, **kw):
        s = fused_slab_stats_fn(index, sp, jnp.ones(n, bool), 0.03, True,
                                block=64, sub=64, engine=engine, **kw)(T)
        return s.ata, s.atb, s.n_corr

    ata, atb, nc = jax.vmap(
        lambda sp: stats(sp, "triton", interpret=True))(jnp.asarray(srcs))
    for b in range(2):
        xa, xb, xn = stats(jnp.asarray(srcs[b]), "xla")
        assert float(nc[b]) == float(xn) > 0
        np.testing.assert_allclose(np.asarray(ata[b]), np.asarray(xa),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(atb[b]), np.asarray(xb),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu_device, rng):
    """On a card: the compiled kernels (scoring, walk) against their XLA
    engines."""
    with jax.default_device(gpu_device):
        feat, pq, w16, tn = _scoring_inputs(rng)
        thr2 = jnp.float32(0.003 ** 2)
        ck, _ = score_w16(feat, pq, w16, tn, thr2, engine="triton")
        cx, _ = score_w16(feat, pq, w16, tn, thr2, engine="xla")
        assert np.mean(np.asarray(ck) == np.asarray(cx)) > 0.99
