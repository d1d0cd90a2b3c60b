import numpy as np
import jax.numpy as jnp

from tpu3d.ops.slab import build_slab, slab_knn, slab_top1
from tpu3d.ops.neighbors import knn


def _surface(rng, n):
    xy = rng.uniform(-0.4, 0.4, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.05 * np.sin(20 * xy[:, 0]) * np.cos(18 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    return pts[np.argsort(pts[:, 0], kind="stable")]  # x-coherent order


def test_slab_top1_exact_within_radius(rng):
    t = _surface(rng, 3000)
    q = t + rng.normal(scale=0.002, size=t.shape).astype(np.float32)
    mask = np.ones(3000, bool)
    mask[2900:] = False
    radius = 0.01
    slab = build_slab(jnp.asarray(t), jnp.asarray(mask))
    gi, gd, ovf = slab_top1(slab, jnp.asarray(q), radius, slice_cap=1024,
                            block=128)
    assert not bool(ovf)
    d2 = np.sum(
        (q[:, None, :].astype(np.float64) - t[None, :2900].astype(np.float64))
        ** 2,
        axis=2,
    )
    bi, bd = d2.argmin(1), d2.min(1)
    gi, gd = np.asarray(gi), np.asarray(gd)
    within = bd <= (radius * 0.98) ** 2
    assert within.sum() > 1000
    np.testing.assert_allclose(gd[within], bd[within], rtol=1e-4, atol=1e-9)
    assert (gi[within] == bi[within]).mean() > 0.999  # float ties only
    assert np.all(gi[gd < 1e29] < 2900)  # invalid targets never chosen
    # beyond-radius queries report no match
    beyond = bd > (radius * 1.02) ** 2
    assert np.all(gd[beyond] >= 1e29)


def test_slab_top1_overflow_flag(rng):
    t = _surface(rng, 2000)
    slab = build_slab(jnp.asarray(t), jnp.asarray(np.ones(2000, bool)))
    # Huge radius forces every block's slice past a tiny cap.
    _, _, ovf = slab_top1(slab, jnp.asarray(t), 10.0, slice_cap=256, block=128)
    assert bool(ovf)


def test_slab_knn_matches_exact_within_radius(rng):
    t = _surface(rng, 2000)
    mask = np.ones(2000, bool)
    radius = 0.05
    slab = build_slab(jnp.asarray(t), jnp.asarray(mask))
    gi, gd, ovf = slab_knn(slab, jnp.asarray(t), radius, k=20,
                           slice_cap=2048, block=128)
    assert not bool(ovf)
    ei, ed = knn(jnp.asarray(t), jnp.asarray(t), jnp.asarray(mask), k=20)
    gi, gd, ei, ed = map(np.asarray, (gi, gd, ei, ed))
    in_r = ed <= (radius * 0.98) ** 2
    np.testing.assert_allclose(gd[in_r], ed[in_r], rtol=1e-4, atol=1e-6)
    assert np.all(gi[:, 0] == np.arange(2000))  # self first at d2=0


def test_icp_slab_matches_brute(rng):
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    tgt_pts = _surface(rng, 4096)
    src_pts = (tgt_pts + np.float32([0.003, -0.002, 0.004])).astype(np.float32)
    src = PointCloud.from_numpy(src_pts, capacity=4096)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=4096)
    T0 = jnp.eye(4)
    a = icp_refine(src, tgt, T0, 0.02, max_iterations=15,
                   point_to_plane=False, nn_mode="brute")
    b = icp_refine(src, tgt, T0, 0.02, max_iterations=15,
                   point_to_plane=False, nn_mode="slab")
    np.testing.assert_allclose(
        np.asarray(a.transformation), np.asarray(b.transformation), atol=1e-5
    )
    assert abs(float(a.fitness) - float(b.fitness)) < 1e-5


def test_icp_grid_matches_brute(rng):
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    tgt_pts = _surface(rng, 4096)
    src_pts = (tgt_pts + np.float32([0.003, -0.002, 0.004])).astype(np.float32)
    src = PointCloud.from_numpy(src_pts, capacity=4096)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=4096)
    T0 = jnp.eye(4)
    a = icp_refine(src, tgt, T0, 0.02, max_iterations=10,
                   point_to_plane=False, nn_mode="brute")
    b = icp_refine(src, tgt, T0, 0.02, max_iterations=10,
                   point_to_plane=False, nn_mode="grid")
    np.testing.assert_allclose(
        np.asarray(a.transformation), np.asarray(b.transformation), atol=1e-5
    )


def test_icp_slab_exact_on_degenerate_x(rng):
    """Worst case for the slab: every point shares one x → every block's
    window is the WHOLE target. Round 1 silently truncated at slice_cap;
    the dynamic sub-tile sweep must stay exact (just slower)."""
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    n = 1024
    yz = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    tgt_pts = np.column_stack([np.zeros(n, np.float32), yz])
    tgt_pts[:, 2] += 0.05 * np.sin(40 * tgt_pts[:, 1])
    src_pts = (tgt_pts + np.float32([0.0, 0.003, -0.002])).astype(np.float32)
    src = PointCloud.from_numpy(src_pts, capacity=n)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=n)
    T0 = jnp.eye(4)
    a = icp_refine(src, tgt, T0, 0.02, max_iterations=15,
                   point_to_plane=False, nn_mode="brute")
    b = icp_refine(src, tgt, T0, 0.02, max_iterations=15,
                   point_to_plane=False, nn_mode="slab")
    np.testing.assert_allclose(
        np.asarray(a.transformation), np.asarray(b.transformation), atol=1e-5
    )
    assert abs(float(a.fitness) - float(b.fitness)) < 1e-5
