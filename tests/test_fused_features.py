import numpy as np
import jax.numpy as jnp

from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.fused_features import fused_prepare_features
from tpu3d.ops.normals import estimate_normals
from tpu3d.types import PointCloud


def _surface(rng, n):
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def test_fused_matches_gather_path_when_cap_inactive(rng):
    """With fewer than 100 points in every radius ball, the 100-cap never
    binds, so fused (radius-exact) and gather (radius-capped) FPFH must
    agree; normals differ only by neighborhood definition (radius vs 30-NN)
    so compare them directionally."""
    pts = _surface(rng, 600)
    radius = 0.025  # ~15 points per ball at this density
    cloud = PointCloud.from_numpy(pts, capacity=1024)

    fused_cloud, fused_feat = fused_prepare_features(
        cloud, jnp.float32(radius), block=128
    )

    # Gather path with the SAME normals isolates the FPFH comparison.
    ref_cloud = cloud._replace(normals=fused_cloud.normals)
    gather_feat = compute_fpfh(ref_cloud, jnp.float32(radius))

    f1 = np.asarray(fused_feat.descriptors)[:600]
    f2 = np.asarray(gather_feat.descriptors)[:600]
    l1 = np.abs(f1 - f2).sum(axis=1)
    # f32 noise from different accumulation orders (rsqrt vs sqrt-div, plane
    # sums vs one-hot einsum). On an accelerator, bin-boundary flips from transcendental
    # ULP spread add a larger budget (see test_fpfh.py's theta-boundary note).
    import jax
    budget = 1e-3 if jax.default_backend() == "cpu" else 0.5
    assert np.quantile(l1, 0.95) < budget, np.quantile(l1, 0.95)

    # Normals: radius-PCA vs 30-NN PCA use different neighborhoods (only
    # ~15 points fall in this radius, so 30-NN reaches ~2x the area); on a
    # curved surface that's a few degrees of legitimate difference.
    knn_cloud = estimate_normals(cloud, k=30)
    n1 = np.asarray(fused_cloud.normals)[:600]
    n2 = np.asarray(knn_cloud.normals)[:600]
    dots = np.abs(np.sum(n1 * n2, axis=1))
    assert np.median(dots) > 0.99, np.median(dots)
    assert np.quantile(dots, 0.05) > 0.93, np.quantile(dots, 0.05)


def test_fused_padding_rows_zero(rng):
    pts = _surface(rng, 300)
    cloud = PointCloud.from_numpy(pts, capacity=512)
    c, f = fused_prepare_features(cloud, jnp.float32(0.03), block=128)
    assert np.all(np.asarray(c.normals)[300:] == 0)
    assert np.all(np.asarray(f.descriptors)[300:] == 0)
    sums = np.asarray(f.descriptors)[:300].sum(axis=1)
    # Isolated points (no neighbor within radius) keep an all-zero
    # descriptor, exactly like the reference's sum>0 guard
    # (registration.cpp:167, :194); everything else is L1-normalized.
    assert np.all((np.abs(sums - 1.0) < 1e-4) | (sums == 0.0))


def test_fused_registration_end_to_end(rng):
    """Fused features drive RANSAC to the right pose."""
    from tpu3d.ops.ransac import ransac_registration

    tgt_pts = _surface(rng, 800)
    aa = np.array([0.1, -0.15, 0.2])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.02, -0.01, 0.03], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    voxel = 0.006
    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=1024), jnp.float32(voxel * 5),
        block=128,
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=1024), jnp.float32(voxel * 5),
        block=128,
    )
    res = ransac_registration(src, tgt, sf, tf, voxel, max_iterations=4096)
    T = np.asarray(res.transformation)
    assert float(res.fitness) > 0.8
    np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
    # Coarse-stage tolerance: the early-exit prefix (registration.cpp:290)
    # returns the FIRST full-inlier hypothesis; its 3-point pose can sit
    # anywhere that keeps every residual inside the 1.5*voxel inlier tube
    # (rotation trading against translation), and the exact winner is
    # sampling-stream sensitive. The functional gate is the residual tube;
    # ICP is what tightens the pose downstream.
    np.testing.assert_allclose(T[:3, 3], t, atol=0.025)
    resid = np.linalg.norm(
        src_pts @ T[:3, :3].T + T[:3, 3] - tgt_pts, axis=1
    )
    assert np.mean(resid < 1.5 * voxel) > 0.99


def test_sparse_prepare_matches_dense_bit_exact(rng):
    """Every descriptor the sparse path returns must be IDENTICAL to the
    dense path's value for the same row AT THE SAME (block, sub) and engine —
    sparsity only zeroes window lengths of blocks outside the dependency
    sets, it never changes what a member block computes. (Different block
    sizes legitimately differ by bin-boundary flips: the shared
    block-center origin changes, and angle values on a bin threshold move
    one bin — mass 1/count per flip, the documented boundary-noise
    class.)"""
    from tpu3d.ops.fused_features import fused_prepare_sparse

    pts = _surface(rng, 4000)
    mask = np.ones(4096, bool)
    mask[4000:] = False
    pad = np.zeros((96, 3), np.float32)
    cloud = PointCloud(
        points=jnp.asarray(np.vstack([pts, pad])), mask=jnp.asarray(mask)
    )
    r = jnp.float32(0.02)
    for block in (128, 256):
        _, df = fused_prepare_features(
            cloud, r, engine="triton", interpret=True, block=block, sub=256
        )
        sc, sf, sorig = fused_prepare_sparse(
            cloud, r, corr_cap=1024, interpret=True, block=block, sub=256
        )
        sm = np.asarray(sf.mask)
        # Non-trivial subset: at 4k points the aligned layout is ~80%
        # bucket padding, so the Q-blocks carry a few hundred valid rows;
        # the exact count depends on where the strata-centered runs land.
        assert sm.sum() > 150, (block, sm.sum())
        rows = np.asarray(sorig)[sm]
        np.testing.assert_array_equal(
            np.asarray(sf.descriptors)[sm], np.asarray(df.descriptors)[rows]
        )
        np.testing.assert_array_equal(
            np.asarray(sc.points)[sm], np.asarray(cloud.points)[rows]
        )


def test_sparse_prepare_exact_on_degenerate_x(rng):
    """Single-bucket (degenerate-x) clouds make every window span most of
    the layout — the member sets degrade to near-dense, never to wrong
    values."""
    from tpu3d.ops.fused_features import fused_prepare_sparse

    pts = _surface(rng, 2048)
    pts[:, 0] = 0.0
    cloud = PointCloud.from_numpy(pts, capacity=2048)
    r = jnp.float32(0.02)
    _, df = fused_prepare_features(cloud, r, engine="triton", interpret=True)
    _, sf, sorig = fused_prepare_sparse(cloud, r, corr_cap=512,
                                        interpret=True)
    sm = np.asarray(sf.mask)
    rows = np.asarray(sorig)[sm]
    np.testing.assert_array_equal(
        np.asarray(sf.descriptors)[sm], np.asarray(df.descriptors)[rows]
    )


def test_sparse_prepare_drives_ransac(rng):
    """The sparse subset view plugs straight into ransac_registration
    (corr_mode='exact' — the subset IS the correspondence set) and recovers
    the pose, matching the corr_mode='auto' statistical envelope."""
    from tpu3d.ops.fused_features import fused_prepare_sparse
    from tpu3d.ops.ransac import ransac_registration

    tgt_pts = _surface(rng, 4000)
    aa = np.array([0.1, -0.15, 0.2])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.02, -0.01, 0.03], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    voxel = 0.004
    r = jnp.float32(voxel * 5)
    sub_c, sub_f, _ = fused_prepare_sparse(
        PointCloud.from_numpy(src_pts, capacity=4096), r,
        corr_cap=1024, interpret=True,
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=4096), r,
        engine="triton", interpret=True,
    )
    res = ransac_registration(
        sub_c, tgt, sub_f, tf, voxel, max_iterations=4096, corr_mode="exact"
    )
    T = np.asarray(res.transformation)
    assert float(res.fitness) > 0.8
    resid = np.linalg.norm(
        src_pts @ T[:3, :3].T + T[:3, 3] - tgt_pts, axis=1
    )
    assert np.mean(resid < 1.5 * voxel) > 0.99


def test_sparse_register_escalation_wiring(rng):
    """sparse_register_escalated with a forced always-escalate threshold
    must run the full-prepare fallback arm and still return a correct
    pose (the escalated result can only replace the sparse one when its
    fitness is higher — keep-better semantics)."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.registration import sparse_register_escalated
    import jax.numpy as jnp

    voxel = 0.004
    tgt_pts = _surface(rng, 4000)
    R = np.array([[0.995, 0.0998, 0], [-0.0998, 0.995, 0], [0, 0, 1]],
                 np.float32)
    t = np.array([0.01, -0.02, 0.015], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    src = PointCloud.from_numpy(src_pts)
    tgt = PointCloud.from_numpy(tgt_pts)
    tgt_p, tgt_f = fused_prepare_features(
        tgt, jnp.float32(voxel * 5), interpret=True
    )

    common = dict(
        voxel=voxel, radius=jnp.float32(voxel * 5), corr_cap=2048,
        max_iterations=4096, icp_max_iterations=30, seed=3,
        interpret=True,
    )
    ref0, _, esc0 = sparse_register_escalated(
        src, tgt_p, tgt_f, escalate_below=0.0, **common
    )  # escalation disabled
    ref1, _, esc1 = sparse_register_escalated(
        src, tgt_p, tgt_f, escalate_below=2.0, **common
    )  # always escalates (keep-better)
    assert not esc0
    for ref in (ref0, ref1):
        T = np.asarray(ref.transformation)
        assert float(ref.fitness) > 0.8
        np.testing.assert_allclose(T[:3, :3], R, atol=0.01)
        np.testing.assert_allclose(T[:3, 3], t, atol=0.005)
    # Keep-better: the escalated result can't be worse than the sparse one.
    assert float(ref1.fitness) >= float(ref0.fitness) - 1e-6


def test_register_pair_prepare_mode_sparse(rng):
    """Config-level wiring: prepare_mode='sparse' routes register_pair
    through the sparse source prepare (the XLA walk on the CPU) and still
    recovers the pose."""
    from tpu3d.config import RegistrationConfig
    from tpu3d.registration import register_pair

    tgt_pts = _surface(rng, 4000)
    R = np.array([[0.995, 0.0998, 0], [-0.0998, 0.995, 0], [0, 0, 1]],
                 np.float32)
    t = np.array([0.01, -0.02, 0.015], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    cfg = RegistrationConfig(
        voxel_size=0.004, ransac_max_iterations=4096,
        icp_max_iterations=30, prepare_mode="sparse",
    )
    refined, _ = register_pair(
        PointCloud.from_numpy(src_pts), PointCloud.from_numpy(tgt_pts), cfg
    )
    T = np.asarray(refined.transformation)
    assert float(refined.fitness) > 0.8
    np.testing.assert_allclose(T[:3, :3], R, atol=0.01)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.005)
