import numpy as np
import jax
import jax.numpy as jnp

_CPU = None


def _on_cpu():
    global _CPU
    if _CPU is None:
        _CPU = jax.default_backend() == "cpu"
    return _CPU

from tpu3d import oracle
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.icp import icp_refine
from tpu3d.ops.normals import estimate_normals
from tpu3d.ops.ransac import feature_correspondences, ransac_registration
from tpu3d.types import PointCloud


def _bumpy_cloud(rng, n=150):
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.1 * np.sin(9 * xy[:, 0]) * np.cos(7 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _rigid(rng, angle_scale=0.3, t_scale=0.05):
    aa = rng.normal(size=3) * angle_scale
    th = np.linalg.norm(aa)
    k = aa / th if th > 0 else np.array([1.0, 0, 0])
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3) * t_scale
    return R.astype(np.float32), t.astype(np.float32)


def test_feature_correspondences_match_oracle(rng):
    sf = rng.uniform(size=(40, 33)).astype(np.float32)
    tf = rng.uniform(size=(60, 33)).astype(np.float32)
    from tpu3d.types import FPFHFeatures

    src = FPFHFeatures(jnp.asarray(sf), jnp.ones(40, bool))
    tgt = FPFHFeatures(jnp.asarray(tf), jnp.ones(60, bool))
    got = np.asarray(feature_correspondences(src, tgt))
    exp = oracle.feature_correspondences(sf, tf)
    agree = (got == exp).mean()
    assert agree > 0.95  # float near-ties only


def test_ransac_recovers_pose(rng):
    tgt_pts = _bumpy_cloud(rng, 150)
    R, t = _rigid(rng)
    # source = target transformed by inv(T): RANSAC solves src → tgt with
    # transform T, i.e. tgt = R @ src + t.
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    tgt_normals = oracle.estimate_normals(tgt_pts, k=20)
    tgt = PointCloud.from_numpy(tgt_pts, normals=tgt_normals, capacity=256)
    src = PointCloud.from_numpy(src_pts, capacity=256)
    src = estimate_normals(src, k=20)

    voxel = 0.01
    sf = compute_fpfh(src, jnp.float32(voxel * 5))
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))

    res = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=4096, seed=42, chunk=256
    )
    T = np.asarray(res.transformation)
    # Accelerator: FPFH theta-bin boundary flips (see test_fpfh.py) degrade a few
    # correspondences; pose accuracy is unaffected.
    assert float(res.fitness) > (0.8 if _on_cpu() else 0.6), float(res.fitness)
    np.testing.assert_allclose(T[:3, :3], R, atol=0.05)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.02)


def test_ransac_inlier_scoring_matches_oracle(rng):
    # Whatever transform RANSAC returns, its fitness/rmse must equal the
    # oracle's scoring of that same transform (the fidelity gate is on
    # inlier sets, BASELINE.md).
    tgt_pts = _bumpy_cloud(rng, 100)
    R, t = _rigid(rng)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    tgt_normals = oracle.estimate_normals(tgt_pts, k=15)
    tgt = PointCloud.from_numpy(tgt_pts, normals=tgt_normals, capacity=128)
    src = estimate_normals(PointCloud.from_numpy(src_pts, capacity=128), k=15)
    voxel = 0.01
    sf = compute_fpfh(src, jnp.float32(voxel * 5))
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))
    res = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=2048, seed=7, chunk=256
    )
    T = np.asarray(res.transformation)
    corr = oracle.feature_correspondences(
        np.asarray(sf.descriptors)[:100], np.asarray(tf.descriptors)[:100]
    )
    _, fitness, rmse = oracle.score_hypothesis(
        T[:3, :3], T[:3, 3], src_pts, tgt_pts[corr], voxel * 1.5
    )
    # Capacity is 128 but only 100 source rows are valid; oracle fitness
    # uses 100 as denominator, ransac uses the valid count — same thing.
    assert abs(float(res.fitness) - fitness) < 0.03
    if fitness > 0:
        assert abs(float(res.rmse) - rmse) < 1e-3


def test_icp_matches_oracle_point_to_plane(rng):
    tgt_pts = _bumpy_cloud(rng, 120)
    tgt_normals = oracle.estimate_normals(tgt_pts, k=15)
    R, t = _rigid(rng, angle_scale=0.05, t_scale=0.01)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    T0 = np.eye(4, dtype=np.float32)
    thr = 0.05
    exp_T, exp_fit, exp_rmse = oracle.icp_refine(
        src_pts, tgt_pts, tgt_normals, T0, thr, max_iterations=30,
        point_to_plane=True,
    )

    src = PointCloud.from_numpy(src_pts, capacity=128)
    tgt = PointCloud.from_numpy(tgt_pts, normals=tgt_normals, capacity=128)
    res = icp_refine(src, tgt, jnp.asarray(T0), thr, max_iterations=30,
                     point_to_plane=True)
    got_T = np.asarray(res.transformation)

    np.testing.assert_allclose(got_T, exp_T, atol=5e-3)
    assert abs(float(res.fitness) - exp_fit) < 0.02
    # Accelerator floor: the matmul-expansion d2 carries ~1e-7 absolute error, so a
    # fully-converged rmse bottoms out near sqrt(1e-7) ≈ 3e-4.
    assert abs(float(res.rmse) - exp_rmse) < (1e-4 if _on_cpu() else 5e-4)
    # And it actually recovered the pose:
    np.testing.assert_allclose(got_T[:3, :3], R, atol=1e-2)
    np.testing.assert_allclose(got_T[:3, 3], t, atol=5e-3)


def test_icp_matches_oracle_point_to_point(rng):
    tgt_pts = _bumpy_cloud(rng, 100)
    R, t = _rigid(rng, angle_scale=0.05, t_scale=0.01)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    thr = 0.05
    exp_T, exp_fit, exp_rmse = oracle.icp_refine(
        src_pts, tgt_pts, None, T0, thr, max_iterations=30,
        point_to_plane=False,
    )
    src = PointCloud.from_numpy(src_pts, capacity=128)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=128)
    res = icp_refine(src, tgt, jnp.asarray(T0), thr, max_iterations=30,
                     point_to_plane=False)
    np.testing.assert_allclose(np.asarray(res.transformation), exp_T,
                               atol=5e-3)
    assert abs(float(res.rmse) - exp_rmse) < (1e-4 if _on_cpu() else 5e-4)


def test_icp_breaks_on_no_correspondences(rng):
    src_pts = rng.normal(size=(20, 3)).astype(np.float32)
    tgt_pts = src_pts + np.float32(100.0)  # far beyond any threshold
    src = PointCloud.from_numpy(src_pts, capacity=32)
    tgt = PointCloud.from_numpy(tgt_pts, capacity=32)
    T0 = jnp.eye(4)
    res = icp_refine(src, tgt, T0, 0.01, max_iterations=10,
                     point_to_plane=False)
    # n_corr < 3 on iter 0 → nothing updated (registration.cpp:361).
    np.testing.assert_allclose(np.asarray(res.transformation), np.eye(4))
    assert float(res.fitness) == 0.0
    assert float(res.rmse) == 0.0


def test_icp_singular_solve_keeps_finite_pose():
    """A degenerate match set (collinear points) makes the p2plane 6x6
    normal system singular; the solve returns non-finite entries. The
    loop must keep the last finite T (and stop) rather than hand a NaN
    pose to the caller — the bug class behind a NaN pipeline waypoint
    whose reported fitness/rmse looked sane."""
    from tpu3d.ops.icp import IcpStats, icp_loop

    def stats_fn(T):
        # Rank-deficient ata (only [0,0] nonzero) with an inconsistent
        # rhs → jnp.linalg.solve yields inf/nan.
        ata = jnp.zeros((6, 6), jnp.float32).at[0, 0].set(1.0)
        atb = jnp.ones((6,), jnp.float32)
        return IcpStats(
            ata=ata, atb=atb, sw=jnp.float32(8.0),
            sp=jnp.zeros((3,)), sq=jnp.zeros((3,)),
            H=jnp.zeros((3, 3)), n_corr=jnp.float32(8.0),
            sum_d2=jnp.float32(1e-4),
        )

    res = icp_loop(
        stats_fn, jnp.float32(10.0), jnp.eye(4), 10, point_to_plane=True
    )
    T = np.asarray(res.transformation)
    assert np.all(np.isfinite(T))
    np.testing.assert_allclose(T, np.eye(4))
    # Metrics measured at T stay reported.
    assert abs(float(res.fitness) - 0.8) < 1e-6
    assert np.isfinite(float(res.rmse))


def test_ransac_two_stage_matches_single_stage(rng):
    tgt_pts = _bumpy_cloud(rng, 150)
    R, t = _rigid(rng)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    tgt_normals = oracle.estimate_normals(tgt_pts, k=20)
    tgt = PointCloud.from_numpy(tgt_pts, normals=tgt_normals, capacity=256)
    src = estimate_normals(PointCloud.from_numpy(src_pts, capacity=256), k=20)
    voxel = 0.01
    sf = compute_fpfh(src, jnp.float32(voxel * 5))
    tf = compute_fpfh(tgt, jnp.float32(voxel * 5))
    a = ransac_registration(src, tgt, sf, tf, voxel, max_iterations=8192,
                            seed=3, two_stage=False)
    b = ransac_registration(src, tgt, sf, tf, voxel, max_iterations=8192,
                            seed=3, two_stage=True)
    # Same hypothesis set; the subsample can only reorder near-ties, so the
    # winning poses must agree to registration accuracy.
    np.testing.assert_allclose(np.asarray(a.transformation)[:3, 3],
                               np.asarray(b.transformation)[:3, 3], atol=5e-3)
    assert abs(float(a.fitness) - float(b.fitness)) < 0.05


def test_ransac_corr_subsample_recovers_pose(rng):
    """corr_mode='subsample' computes exact correspondences for a random
    subset only — the pose must match the exact run, fitness within the
    sampling noise."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.types import PointCloud

    voxel = 0.006
    xy = rng.uniform(-0.2, 0.2, size=(2000, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    tgt_pts = np.column_stack([xy, z]).astype(np.float32)
    aa = np.array([0.12, -0.1, 0.15])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.02, -0.01, 0.03], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    exact = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=4096, corr_mode="exact"
    )
    sub = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=4096,
        corr_mode="subsample", corr_cap=512,
    )
    for res in (exact, sub):
        T = np.asarray(res.transformation)
        assert float(res.fitness) > 0.75, float(res.fitness)
        np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
        np.testing.assert_allclose(T[:3, 3], t, atol=0.015)
    assert abs(float(sub.fitness) - float(exact.fitness)) < 0.1


def _rigid_pair(rng, n=2000):
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    tgt_pts = np.column_stack([xy, z]).astype(np.float32)
    aa = np.array([0.12, -0.1, 0.15])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.02, -0.01, 0.03], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    return src_pts, tgt_pts, R, t


def test_ransac_chunked_estimate_scoring_recovers_pose(rng):
    """The in-chunk estimate-then-exact-finalists path (est_cap active)
    must recover the same pose as full exact chunk scoring; the winner's
    reported fitness is exact in both."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng)
    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    common = dict(
        max_iterations=4096, early_exit=True, hyp_chunk=1024,
        corr_mode="exact", two_stage=False,
    )
    # est_cap=4096 > n/4 disables estimates; est_cap=256 activates them.
    exact = ransac_registration(
        src, tgt, sf, tf, voxel, est_cap=4096, **common
    )
    est = ransac_registration(
        src, tgt, sf, tf, voxel, est_cap=256, **common
    )
    for res in (exact, est):
        T = np.asarray(res.transformation)
        assert float(res.fitness) > 0.75, float(res.fitness)
        np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
        np.testing.assert_allclose(T[:3, 3], t, atol=0.015)
    # Both fitness values are EXACT rescored numbers; they may pick
    # different (equivalent) winners, so allow sampling-scale spread.
    assert abs(float(est.fitness) - float(exact.fitness)) < 0.1


def test_ransac_rotation_sampling_recovers_pose(rng):
    """Gather-free 'rotation' sampling (chunked path) must recover the
    same pose as the reference-shaped 'gather' draws, with comparable
    fitness — including on a cloud with masked-out rows (the validity
    window + exact iteration-budget accounting path)."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=1500)  # 1500 < 2048 cap:
    # ~27% of capacity rows are masked padding — rotation must skip them
    # without consuming iteration budget.
    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=2048), jnp.float32(voxel * 5)
    )
    common = dict(
        max_iterations=8192, early_exit=True, hyp_chunk=2048,
        corr_mode="exact", two_stage=False, confidence=2.0,  # no early out
    )
    results = {}
    for mode in ("gather", "rotation"):
        res = ransac_registration(
            src, tgt, sf, tf, voxel, sampling=mode, **common
        )
        T = np.asarray(res.transformation)
        assert float(res.fitness) > 0.75, (mode, float(res.fitness))
        np.testing.assert_allclose(T[:3, :3], R, atol=0.03, err_msg=mode)
        np.testing.assert_allclose(T[:3, 3], t, atol=0.015, err_msg=mode)
        results[mode] = float(res.fitness)
    assert abs(results["rotation"] - results["gather"]) < 0.1


def test_rotation_table_sort_carry_matches_reference(rng):
    """build_rotation_table compacts valid rows FIRST in STABLE original
    order via a multi-operand lax.sort (the payload rides the sort
    network — the former ``pq_packed[argsort(~mask)]`` row gather cost
    ~1 ms at the exact-envelope 100k scale). Pin the construction to the
    obvious NumPy reference: [valid rows in order | junk] doubled at
    column ``count``."""
    from tpu3d.ops.ransac import build_rotation_table

    n = 311
    pq = rng.normal(size=(n, 6)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.3
    count = int(mask.sum())
    tab = np.asarray(
        build_rotation_table(
            jnp.asarray(pq), jnp.asarray(mask), jnp.int32(count)
        )
    )
    assert tab.shape == (6, 2 * n)
    expect = pq[mask].T  # (6, count) — valid rows, original order
    np.testing.assert_array_equal(tab[:, :count], expect)
    np.testing.assert_array_equal(tab[:, count: 2 * count], expect)


def test_ransac_rotation_low_valid_fraction_full_budget(rng):
    """Rotation sampling's while_loop bound must scale with the cloud's
    VALID fraction: each chunk consumes only count-proportional iteration
    ids, so a static bound silently under-delivers the max_iterations
    budget whenever valid/capacity < 0.5 (e.g. sparse subset views that
    are mostly bucket padding). 1500 valid rows in a 4096 capacity
    (~37%) with no early exit exercises the dynamic-bound path end to
    end — the pose must still be recovered."""
    from tpu3d.ops.fused_features import fused_prepare_features

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=1500)
    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    res = ransac_registration(
        src, tgt, sf, tf, voxel, sampling="rotation", max_iterations=8192,
        early_exit=True, hyp_chunk=4096, corr_mode="exact",
        two_stage=False, confidence=2.0,  # never early-exits: full budget
    )
    T = np.asarray(res.transformation)
    assert float(res.fitness) > 0.75, float(res.fitness)
    np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.015)


def test_ransac_rotation_count_below_3_returns_identity(rng):
    """count < 3 cannot form a 3-point sample: rotation sampling must
    return the reference's no-winner default (identity, fitness 0,
    rmse 0) — and exit the chunk loop immediately rather than burning
    ceil(max_iterations/count) all-disabled chunks."""
    pts = np.zeros((2048, 3), np.float32)
    pts[0] = [0.0, 0.0, 0.7]
    pts[1] = [0.1, 0.0, 0.7]
    mask = np.zeros((2048,), bool)
    mask[:2] = True
    cloud = PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask))
    feats = rng.uniform(size=(2048, 33)).astype(np.float32)
    from tpu3d.types import FPFHFeatures

    f = FPFHFeatures(
        descriptors=jnp.asarray(feats), mask=jnp.asarray(mask)
    )
    res = ransac_registration(
        cloud, cloud, f, f, 0.005, sampling="rotation",
        max_iterations=65536, hyp_chunk=2048, early_exit=True,
        corr_mode="exact", two_stage=False,
    )
    np.testing.assert_array_equal(
        np.asarray(res.transformation), np.eye(4, dtype=np.float32)
    )
    assert float(res.fitness) == 0.0
    assert float(res.rmse) == 0.0


def test_icp_source_subsample_matches_exact(rng):
    """src_mode='subsample' iterates on a strided source subset — the
    converged pose must agree with the exact run to ICP's tolerance."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=4000)
    src, _ = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    tgt, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    # Start near the truth (ICP's convergence basin).
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t + np.float32([0.002, -0.001, 0.001])
    kw = dict(max_iterations=100, point_to_plane=True, nn_mode="slab")
    exact = icp_refine(src, tgt, jnp.asarray(T0), voxel * 2.0,
                       src_mode="exact", **kw)
    sub = icp_refine(src, tgt, jnp.asarray(T0), voxel * 2.0,
                     src_mode="subsample", src_cap=1024, **kw)
    Te = np.asarray(exact.transformation)
    Ts = np.asarray(sub.transformation)
    np.testing.assert_allclose(Ts[:3, :3], Te[:3, :3], atol=2e-3)
    np.testing.assert_allclose(Ts[:3, 3], Te[:3, 3], atol=1e-3)
    # Subset fitness is an unbiased estimate of the exact fitness.
    assert abs(float(sub.fitness) - float(exact.fitness)) < 0.1


def test_icp_final_metrics_modes(rng):
    """``final_metrics`` contract under src_mode subsetting: the reported
    fitness must describe the RETURNED pose — 'exact' equals the exact
    full-cloud fitness there; 'auto' is a subset estimate of the same
    number (sampling sigma only); 'estimate' keeps the loop's pre-update
    metrics. The exact-at-returned-pose yardstick is a 1-iteration
    src_mode='exact' run (pre-update metrics at its initial pose,
    registration.cpp:401-404), the same probe ab_stats gates on."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=4000)
    # 0.35-voxel noise: fitness sits well below 1.0 and is pose-steep,
    # the regime where the r3 pre-update reporting drifted.
    tgt_noisy = tgt_pts + rng.normal(
        0.0, 0.35 * voxel, tgt_pts.shape
    ).astype(np.float32)
    src, _ = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    tgt, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_noisy, capacity=4096),
        jnp.float32(voxel * 5),
    )
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t + np.float32([0.002, -0.001, 0.001])
    kw = dict(max_iterations=60, point_to_plane=True, nn_mode="slab",
              src_mode="subsample", src_cap=1024)
    thr = voxel * 2.0
    out = {
        m: icp_refine(src, tgt, jnp.asarray(T0), thr, final_metrics=m, **kw)
        for m in ("auto", "exact", "estimate")
    }
    for m in ("exact", "estimate"):
        np.testing.assert_allclose(
            np.asarray(out[m].transformation),
            np.asarray(out["auto"].transformation),
            atol=1e-6,
        )  # final_metrics never changes the pose

    def exact_at(T):
        probe = icp_refine(src, tgt, T, thr, max_iterations=1,
                           point_to_plane=True, nn_mode="slab",
                           src_mode="exact")
        return float(probe.fitness)

    yard = exact_at(out["auto"].transformation)
    assert abs(float(out["exact"].fitness) - yard) < 1e-5, (
        float(out["exact"].fitness), yard)
    # 'auto' = subset estimate at the same pose: sampling error only
    # (1024 of 4000 rows -> sigma ~1.5%; gate at the AB harness's 0.02
    # plus headroom for the small-n test).
    assert abs(float(out["auto"].fitness) - yard) < 0.04, (
        float(out["auto"].fitness), yard)


def test_icp_final_metrics_exact_without_slab_iteration(rng):
    """Regression: final_metrics='exact' under subsetting must work when
    the ITERATION backend is grid/brute (no slab index in scope) — the
    final exact pass builds its own slab index for the one full-source
    sweep. The reported fitness must still equal the exact full-cloud
    number at the returned pose."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=4000)
    src, _ = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    tgt, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t
    thr = voxel * 2.0
    res = icp_refine(
        src, tgt, jnp.asarray(T0), thr, max_iterations=20,
        point_to_plane=True, nn_mode="brute", src_mode="subsample",
        src_cap=1024, final_metrics="exact",
    )
    probe = icp_refine(
        src, tgt, res.transformation, thr, max_iterations=1,
        point_to_plane=True, nn_mode="slab", src_mode="exact",
    )
    assert abs(float(res.fitness) - float(probe.fitness)) < 1e-5, (
        float(res.fitness), float(probe.fitness))


def test_icp_adaptive_polish_borderline_noisy(rng):
    """Adaptive exact polish (VERDICT r4 item 3): on a noisy borderline
    scene (converged fitness < 0.5) the subset arm must continue with
    full-source exact iterations and report exact metrics — closing the
    subset-vs-exact pose/fitness divergence the min_fitness gate consumes.
    On clean scenes the polish branch must not execute at all."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import icp_refine
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=4000)
    tgt_noisy = tgt_pts + rng.normal(
        0.0, 0.35 * voxel, tgt_pts.shape
    ).astype(np.float32)
    src, _ = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    tgt, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_noisy, capacity=4096),
        jnp.float32(voxel * 5),
    )
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t + np.float32([0.002, -0.001, 0.001])
    # The pipeline's REAL distance factor (0.4 voxel) under 0.35-voxel
    # noise: fitness lands ~0.3-0.45 — the borderline regime.
    thr = voxel * 0.4
    kw = dict(max_iterations=60, point_to_plane=True, nn_mode="slab",
              src_mode="subsample", src_cap=1024)
    a_on = icp_refine(src, tgt, jnp.asarray(T0), thr, polish="auto", **kw)
    x = icp_refine(src, tgt, jnp.asarray(T0), thr, max_iterations=60,
                   point_to_plane=True, nn_mode="slab", src_mode="exact")
    assert float(a_on.fitness) < 0.5  # the scene IS borderline
    # Polished metrics are exact-class at the polished pose…
    probe = icp_refine(src, tgt, a_on.transformation, thr, max_iterations=1,
                       point_to_plane=True, nn_mode="slab", src_mode="exact")
    assert abs(float(a_on.fitness) - float(probe.fitness)) < 1e-5
    # …and the polished arm lands in the exact arm's fitness class (the
    # cross-pipeline gate ab_stats now enforces at 100k/20 seeds).
    assert abs(float(a_on.fitness) - float(x.fitness)) <= 0.05, (
        float(a_on.fitness), float(x.fitness))

    # Clean scene: fitness ~1.0 -> the cond's polish branch never runs and
    # the result is bit-identical to polish='off'.
    tgt_c, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=4096), jnp.float32(voxel * 5)
    )
    c_off = icp_refine(src, tgt_c, jnp.asarray(T0), thr, polish="off", **kw)
    c_on = icp_refine(src, tgt_c, jnp.asarray(T0), thr, polish="auto", **kw)
    assert float(c_on.fitness) > 0.9
    assert np.array_equal(
        np.asarray(c_off.transformation), np.asarray(c_on.transformation)
    )
    assert float(c_off.fitness) == float(c_on.fitness)


def test_subsample_modes_fall_back_on_small_clouds(rng):
    """Explicit 'subsample' modes on clouds smaller than the cap must fall
    back to exact paths instead of computing a zero stride."""
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import icp_refine
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.types import PointCloud

    voxel = 0.006
    src_pts, tgt_pts, R, t = _rigid_pair(rng, n=600)
    src, sf = fused_prepare_features(
        PointCloud.from_numpy(src_pts, capacity=1024), jnp.float32(voxel * 5)
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=1024), jnp.float32(voxel * 5)
    )
    res = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=2048, corr_mode="subsample"
    )
    assert float(res.fitness) > 0.5
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t
    ref = icp_refine(
        src, tgt, jnp.asarray(T0), voxel * 2.0, max_iterations=20,
        nn_mode="slab", src_mode="subsample",
    )
    assert float(ref.fitness) > 0.9


def test_exact_mode_reproduces_oracle_fitness_at_scale(rng):
    """The YAML-exposed exactness knob (corr_mode='exact',
    PARITY.md "Exact vs statistical metrics"): at a size where 'auto'
    would subsample (n >= 2*corr_cap), the exact path's reported fitness
    must equal the ORACLE's scoring of the same winning transform over
    every source row (registration.cpp:270-282) — while 'auto' reports a
    subset estimate over its own strided rows."""
    import jax.numpy as jnp

    from tpu3d import oracle
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.types import FPFHFeatures, PointCloud

    n = 4096
    pts = _bumpy_cloud(rng, n) if "_bumpy_cloud" in globals() else None
    if pts is None:
        xy = rng.uniform(-0.3, 0.3, size=(n, 2)).astype(np.float32)
        z = 0.7 + 0.05 * np.sin(17 * xy[:, 0]) * np.cos(13 * xy[:, 1])
        pts = np.column_stack([xy, z]).astype(np.float32)
    tgt_np = pts
    t_true = np.float32([0.012, -0.007, 0.009])
    src_np = (tgt_np - t_true).astype(np.float32)
    # Identical synthetic descriptors per row pair — matching is trivially
    # correct, so RANSAC's fitness is driven by geometry alone.
    desc = rng.random((n, 33)).astype(np.float32)
    src = PointCloud.from_numpy(src_np, capacity=n)
    tgt = PointCloud.from_numpy(tgt_np, capacity=n)
    sf = FPFHFeatures(descriptors=jnp.asarray(desc), mask=src.mask)
    tf = FPFHFeatures(descriptors=jnp.asarray(desc), mask=tgt.mask)
    voxel = 0.004

    exact = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=8192,
        corr_mode="exact", two_stage=False, early_exit=False,
        corr_cap=1024,
    )
    T = np.asarray(exact.transformation)
    # Oracle scoring of the SAME transform over every source row, with the
    # same (trivially correct) correspondences.
    _, fit_o, rmse_o = oracle.score_hypothesis(
        T[:3, :3], T[:3, 3], src_np, tgt_np, 1.5 * voxel
    )
    assert abs(float(exact.fitness) - float(fit_o)) < 1e-5, (
        float(exact.fitness), float(fit_o))
    # rmse: the winner's reported fitness/rmse come from a DIRECT
    # residual pass (registration.cpp:270-282) — the rank-16 scoring
    # expansion (selection only) has an f32 cancellation floor of ~3e-4
    # that used to leak into the report (worse under other FMA
    # orderings) before the direct rescore.
    assert abs(float(exact.rmse) - float(rmse_o)) < 2e-5

    # 'auto' at n >= 2*corr_cap is a subset ESTIMATE — close, not equal.
    auto = ransac_registration(
        src, tgt, sf, tf, voxel, max_iterations=8192, corr_cap=1024,
    )
    assert abs(float(auto.fitness) - float(fit_o)) < 0.05
