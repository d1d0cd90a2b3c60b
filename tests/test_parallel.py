"""Multi-device logic on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.normals import estimate_normals
from tpu3d.ops.neighbors import nearest_neighbor_xla
from tpu3d.parallel import (
    make_mesh,
    nearest_neighbor_sharded,
    register_batch,
    shard_instances,
    stack_clouds,
)
from tpu3d.types import PointCloud


def _bumpy(rng, n):
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.1 * np.sin(9 * xy[:, 0]) * np.cos(7 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    return make_mesh(("shard",))


def test_sharded_nn_matches_single_device(rng, mesh):
    q = rng.normal(size=(100, 3)).astype(np.float32)
    t = rng.normal(size=(8 * 64, 3)).astype(np.float32)
    mask = np.ones(8 * 64, bool)
    mask[500:] = False

    ix, dx = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    isd, dsd = nearest_neighbor_sharded(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), mesh
    )
    np.testing.assert_allclose(np.asarray(dsd), np.asarray(dx), rtol=1e-4,
                               atol=1e-6)
    agree = (np.asarray(isd) == np.asarray(ix)).mean()
    assert agree > 0.98  # float near-ties only


def test_register_batch_recovers_poses(rng, mesh):
    tgt_pts = _bumpy(rng, 150)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=256)
    tgt = estimate_normals(tgt, k=15)
    voxel = 0.01
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))

    true_T = []
    srcs, feats = [], []
    for _ in range(4):
        aa = rng.normal(size=3) * 0.2
        th = np.linalg.norm(aa)
        k = aa / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
            np.float32
        )
        t = (rng.normal(size=3) * 0.03).astype(np.float32)
        true_T.append((R, t))
        src = PointCloud.from_numpy(((tgt_pts - t) @ R), capacity=256)
        src = estimate_normals(src, k=15)
        srcs.append(src)
        feats.append(compute_fpfh(src, jnp.float32(voxel * 5)))

    batch = stack_clouds(srcs)
    from tpu3d.types import FPFHFeatures

    fbatch = FPFHFeatures(
        descriptors=jnp.stack([f.descriptors for f in feats]),
        mask=jnp.stack([f.mask for f in feats]),
    )

    inst_mesh = make_mesh(("inst",), shape=(8,))
    # 4 instances on an 8-way axis isn't divisible — replicate instead for
    # this small test; the dryrun exercises true sharding with B == n_dev.
    refined, coarse = register_batch(
        batch, tgt, fbatch, tf, voxel,
        ransac_max_iterations=2048, icp_max_iterations=30,
    )
    T = np.asarray(refined.transformation)
    for i, (R, t) in enumerate(true_T):
        assert float(refined.fitness[i]) > 0.8, (i, refined.fitness)
        np.testing.assert_allclose(T[i, :3, :3], R, atol=0.02)
        np.testing.assert_allclose(T[i, :3, 3], t, atol=0.01)


def test_register_batch_sharded_over_mesh(rng):
    """Instances sharded across a mesh axis compile & run under jit."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    tgt_pts = _bumpy(rng, 100)
    tgt = estimate_normals(PointCloud.from_numpy(tgt_pts, capacity=128), k=10)
    voxel = 0.01
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))

    srcs, feats = [], []
    for i in range(8):
        src = estimate_normals(
            PointCloud.from_numpy(tgt_pts + np.float32(0.001 * i), capacity=128),
            k=10,
        )
        srcs.append(src)
        feats.append(compute_fpfh(src, jnp.float32(voxel * 5)))
    batch = stack_clouds(srcs)
    from tpu3d.types import FPFHFeatures

    fbatch = FPFHFeatures(
        descriptors=jnp.stack([f.descriptors for f in feats]),
        mask=jnp.stack([f.mask for f in feats]),
    )
    mesh = make_mesh(("inst",))
    batch, fbatch = shard_instances(batch, fbatch, mesh, "inst")
    refined, _ = register_batch(
        batch, tgt, fbatch, tf, voxel,
        ransac_max_iterations=256, icp_max_iterations=5, ransac_chunk=256,
    )
    assert np.asarray(refined.transformation).shape == (8, 4, 4)
    assert np.all(np.isfinite(np.asarray(refined.transformation)))


def test_slab_top1_sharded_matches_brute(rng, mesh):
    from tpu3d.parallel.sharded_nn import (
        build_slab_sharded,
        slab_top1_sharded,
    )

    q = _bumpy(rng, 96)
    t = _bumpy(rng, 8 * 64)
    mask = np.ones(8 * 64, bool)
    mask[480:] = False
    radius = 0.05

    sslab = build_slab_sharded(jnp.asarray(t), jnp.asarray(mask), mesh)
    isd, dsd = slab_top1_sharded(sslab, jnp.asarray(q), radius, mesh)

    ix, dx = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    dx = np.asarray(dx)
    in_r = dx <= radius * radius
    np.testing.assert_allclose(
        np.asarray(dsd)[in_r], dx[in_r], rtol=1e-4, atol=1e-7
    )
    agree = (np.asarray(isd)[in_r] == np.asarray(ix)[in_r]).mean()
    assert agree > 0.98  # float near-ties only


def test_icp_sharded_matches_single_chip(rng, mesh):
    from tpu3d.ops.icp import icp_refine
    from tpu3d.parallel.icp_sharded import icp_refine_sharded

    tgt_pts = _bumpy(rng, 8 * 64)  # divisible by the 8-way shard axis
    src_pts = (tgt_pts + np.float32([0.004, -0.003, 0.005])).astype(np.float32)
    src = PointCloud.from_numpy(src_pts, capacity=512)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=512)
    T0 = jnp.eye(4)
    a = icp_refine(src, tgt, T0, 0.03, max_iterations=15,
                   point_to_plane=False, nn_mode="brute")
    b = icp_refine_sharded(src, tgt, T0, 0.03, mesh=mesh,
                           max_iterations=15, point_to_plane=False)
    np.testing.assert_allclose(
        np.asarray(a.transformation), np.asarray(b.transformation), atol=1e-5
    )
    assert abs(float(a.fitness) - float(b.fitness)) < 1e-5


def test_slab2_top1_sharded_exact_incl_degenerate_x(rng, mesh):
    """The round-2 exactness machinery on shards (VERDICT r2 item 2): the
    per-shard slab2+walk has NO static cap — a degenerate-x cloud (every
    point in one bucket) must return the exact thresholded NN, matching
    the single-chip contract of registration.cpp:329-338."""
    from tpu3d.parallel.sharded_nn import (
        build_walk_sharded,
        slab2_top1_sharded,
    )

    for degenerate in (False, True):
        q = _bumpy(rng, 96)
        t = _bumpy(rng, 8 * 64)
        if degenerate:
            t[:, 0] = 0.05  # single bucket per shard — would overflow any
            q[:, 0] = 0.05  # static slice cap on the legacy 1-D slab
        mask = np.ones(8 * 64, bool)
        mask[480:] = False
        radius = 0.05
        qmask = np.ones(96, bool)

        sw = build_walk_sharded(
            jnp.asarray(t), jnp.asarray(mask), radius, mesh
        )
        isd, dsd = slab2_top1_sharded(
            sw, jnp.asarray(q), jnp.asarray(qmask), radius, mesh,
            interpret=True,
        )

        ix, dx = nearest_neighbor_xla(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask)
        )
        dx = np.asarray(dx)
        in_r = dx <= radius * radius
        # Every in-radius query matched, at the exact distance (atol covers
        # f32 summation-order noise vs the brute norm-expansion formula).
        assert (np.asarray(dsd)[in_r] < 1e29).all()
        np.testing.assert_allclose(
            np.asarray(dsd)[in_r], dx[in_r], rtol=1e-4, atol=5e-7
        )
        agree = (np.asarray(isd)[in_r] == np.asarray(ix)[in_r]).mean()
        assert agree > 0.98  # float near-ties only
        # Out-of-radius queries report no match.
        assert (np.asarray(dsd)[~in_r] >= 1e29).all()


def test_slab2_sharded_degenerate_x_at_16k(rng, mesh):
    """At-scale degenerate-x exactness (VERDICT r3 item 3): 16k target
    rows all at one x — every shard's layout collapses to a single
    bucket, the worst case for any x-partitioned index — must still be
    radius-exact against the brute oracle."""
    from tpu3d.parallel.sharded_nn import (
        build_walk_sharded,
        slab2_top1_sharded,
    )

    n, nq, radius = 16384, 512, 0.02
    t = rng.uniform(-0.15, 0.15, size=(n, 3)).astype(np.float32)
    t[:, 2] = 0.7 + 0.1 * np.sin(9 * t[:, 0]) * np.cos(7 * t[:, 1])
    t[:, 0] = 0.05
    q = (
        t[rng.integers(0, n, nq)]
        + rng.normal(scale=0.002, size=(nq, 3)).astype(np.float32)
    )
    q[:, 0] = 0.05
    mask = np.ones(n, bool)
    mask[16000:] = False

    sw = build_walk_sharded(jnp.asarray(t), jnp.asarray(mask), radius, mesh)
    isd, dsd = slab2_top1_sharded(
        sw, jnp.asarray(q), jnp.ones(nq, bool), radius, mesh,
        interpret=True,
    )
    ix, dx = nearest_neighbor_xla(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask)
    )
    dx = np.asarray(dx)
    in_r = dx <= radius * radius
    assert (np.asarray(dsd)[in_r] < 1e29).all()
    np.testing.assert_allclose(
        np.asarray(dsd)[in_r], dx[in_r], rtol=1e-4, atol=5e-7
    )
    assert (np.asarray(isd)[in_r] == np.asarray(ix)[in_r]).mean() > 0.98
    assert (np.asarray(dsd)[~in_r] >= 1e29).all()


def test_slab_top1_sharded_surfaces_overflow(rng, mesh):
    """Legacy 1-D sharded slab: the truncation flag is now surfaced, not
    silently dropped (VERDICT r2 weakness 2)."""
    from tpu3d.parallel.sharded_nn import (
        build_slab_sharded,
        slab_top1_sharded,
    )

    t = _bumpy(rng, 8 * 64)
    t[:, 0] = 0.05  # degenerate x: every shard's slab window = all rows
    mask = np.ones(8 * 64, bool)
    q = _bumpy(rng, 96)
    sslab = build_slab_sharded(jnp.asarray(t), jnp.asarray(mask), mesh)
    _, _, overflow = slab_top1_sharded(
        sslab, jnp.asarray(q), 0.05, mesh, slice_cap=16,
        return_overflow=True,
    )
    assert bool(overflow)  # cap 16 < 64 occupied rows per shard
    _, _, overflow2 = slab_top1_sharded(
        sslab, jnp.asarray(q), 0.05, mesh, slice_cap=64,
        return_overflow=True,
    )
    assert not bool(overflow2)


def test_icp_sharded_slab2_matches_single_chip(rng, mesh):
    from tpu3d.ops.icp import icp_refine
    from tpu3d.parallel.icp_sharded import icp_refine_sharded

    tgt_pts = _bumpy(rng, 8 * 64)
    src_pts = (tgt_pts + np.float32([0.004, -0.003, 0.005])).astype(
        np.float32
    )
    src = PointCloud.from_numpy(src_pts, capacity=512)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=512)
    T0 = jnp.eye(4)
    a = icp_refine(src, tgt, T0, 0.03, max_iterations=15,
                   point_to_plane=False, nn_mode="brute")
    b = icp_refine_sharded(src, tgt, T0, 0.03, mesh=mesh,
                           max_iterations=15, point_to_plane=False,
                           nn_mode="slab2")
    np.testing.assert_allclose(
        np.asarray(a.transformation), np.asarray(b.transformation),
        atol=1e-5,
    )
    assert abs(float(a.fitness) - float(b.fitness)) < 1e-5


def test_ransac_sharded_recovers_pose_and_matches_semantics(rng, mesh):
    """Hypothesis-sharded RANSAC (VERDICT r2 item 3): sharded feature NN +
    per-shard hypothesis slices + global prefix winner recovers the pose,
    and its exact scoring agrees with the single-chip scorer for the same
    transform."""
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.parallel.ransac_sharded import ransac_registration_sharded

    tgt_pts = _bumpy(rng, 512)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=512)
    tgt = estimate_normals(tgt, k=15)
    voxel = 0.01
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))

    aa = np.array([0.05, -0.04, 0.06])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.float32([0.01, -0.008, 0.012])
    src = PointCloud.from_numpy(((tgt_pts - t) @ R), capacity=512)
    src = estimate_normals(src, k=15)
    sf = compute_fpfh(src, jnp.float32(voxel * 5))

    res = ransac_registration_sharded(
        src, tgt, sf, tf, voxel, mesh=mesh, max_iterations=4096,
    )
    T = np.asarray(res.transformation)
    assert float(res.fitness) > 0.8, float(res.fitness)
    # Coarse (3-point-sample) pose only — no ICP refinement here.
    np.testing.assert_allclose(T[:3, :3], R, atol=0.08)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.04)

    # The single-chip path recovers the same pose class (hypothesis
    # streams differ by construction — reseeding-class delta).
    res1 = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=4096,
    )
    T1 = np.asarray(res1.transformation)
    np.testing.assert_allclose(T1[:3, :3], T[:3, :3], atol=0.12)
