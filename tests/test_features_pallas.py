"""The Triton prepare-sweep kernels (interpret mode) must reproduce the
XLA walk engine: same windows, same sweeps, same math. Any difference is
f32 summation order — bin-boundary noise on a measure-zero set, and
normals of rows whose covariance eigengap is ~0."""

import jax.numpy as jnp
import numpy as np

from tpu3d.ops.fused_features import fused_prepare_features
from tpu3d.types import PointCloud


def _surface(rng, n):
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _run_both(cloud, radius, block=128, sub=128):
    xc, xf = fused_prepare_features(
        cloud, jnp.float32(radius), block=block, sub=sub, engine="xla"
    )
    pc, pf = fused_prepare_features(
        cloud, jnp.float32(radius), block=block, sub=sub,
        engine="triton", interpret=True,
    )
    return xc, xf, pc, pf


def test_pallas_sweeps_match_xla_engine(rng):
    pts = _surface(rng, 700)
    cloud = PointCloud.from_numpy(pts, capacity=1024)
    xc, xf, pc, pf = _run_both(cloud, 0.03)

    n1 = np.asarray(xc.normals)[:700]
    n2 = np.asarray(pc.normals)[:700]
    dots = np.abs(np.sum(n1 * n2, axis=1))
    # The smallest eigenvector is only DEFINED up to the covariance
    # eigengap: on rows where the two smallest eigenvalues nearly tie
    # (sparse/edge neighborhoods), engines that sum in a different order
    # may legitimately pick different vectors. Compare only rows with a
    # >=1%-of-trace eigengap, and require those to be the overwhelming
    # majority.
    cov_gap = np.empty(700, np.float32)
    for i in range(700):
        d = pts - pts[i]
        nb = d[(d * d).sum(1) <= 0.03 * 0.03]
        c = np.cov(nb.T) if nb.shape[0] > 1 else np.zeros((3, 3))
        w = np.sort(np.linalg.eigvalsh(c))
        cov_gap[i] = (w[1] - w[0]) / max(w.sum(), 1e-30)
    well = cov_gap > 0.01
    assert well.mean() > 0.9, well.mean()
    assert np.quantile(dots[well], 0.01) > 0.9999, (
        np.quantile(dots[well], 0.01))

    f1 = np.asarray(xf.descriptors)[:700]
    f2 = np.asarray(pf.descriptors)[:700]
    l1 = np.abs(f1 - f2).sum(axis=1)
    assert np.quantile(l1, 0.95) < 2e-3, np.quantile(l1, 0.95)
    # Rare bin-boundary ties (an angle within rounding of a threshold
    # lands on opposite sides under two summation orders) move mass
    # between ADJACENT bins on sparse-neighborhood rows — bounded count,
    # bounded magnitude.
    assert np.mean(l1 > 0.01) < 0.03, np.mean(l1 > 0.01)
    assert np.max(l1) < 0.5, np.max(l1)


def test_pallas_sweeps_padding_and_isolated_rows(rng):
    """Invalid rows stay zero; isolated points keep the all-zero
    descriptor (reference's sum>0 guard, registration.cpp:167,:194)."""
    pts = _surface(rng, 300)
    pts[17] += np.float32([5.0, 5.0, 5.0])  # isolated outlier
    cloud = PointCloud.from_numpy(pts, capacity=512)
    c, f = fused_prepare_features(
        cloud, jnp.float32(0.03), block=128, sub=128,
        engine="triton", interpret=True,
    )
    assert np.all(np.asarray(c.normals)[300:] == 0)
    assert np.all(np.asarray(f.descriptors)[300:] == 0)
    sums = np.asarray(f.descriptors)[:300].sum(axis=1)
    assert sums[17] == 0.0
    assert np.all((np.abs(sums - 1.0) < 1e-4) | (sums == 0.0))


def test_pallas_engine_registration_end_to_end(rng):
    """Decision-level gate: pallas-engine features drive RANSAC to the
    right pose (bin-boundary flips must not matter downstream)."""
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
        block=128, sub=128, engine="triton", interpret=True,
    )
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_pts, capacity=1024), jnp.float32(voxel * 5),
        block=128, sub=128, engine="triton", interpret=True,
    )
    res = ransac_registration(src, tgt, sf, tf, voxel, max_iterations=4096)
    T = np.asarray(res.transformation)
    assert float(res.fitness) > 0.8
    resid = np.linalg.norm(
        src_pts @ T[:3, :3].T + T[:3, 3] - tgt_pts, axis=1
    )
    assert np.mean(resid < 1.5 * voxel) > 0.99


def test_pallas_sweeps_degenerate_x(rng):
    """All points in one x-slab column (the occupancy pattern that used to
    overflow slice caps): windows are exact for any occupancy."""
    n = 400
    pts = np.zeros((n, 3), np.float32)
    pts[:, 1:] = rng.uniform(-0.1, 0.1, size=(n, 2)).astype(np.float32)
    cloud = PointCloud.from_numpy(pts, capacity=512)
    xc, xf, pc, pf = _run_both(cloud, 0.04)
    f1 = np.asarray(xf.descriptors)[:n]
    f2 = np.asarray(pf.descriptors)[:n]
    assert np.quantile(np.abs(f1 - f2).sum(axis=1), 0.95) < 2e-3


def test_pallas_engine_odd_capacity(rng):
    """Capacities that are not multiples of 128 (e.g. 200) used to crash
    the Pallas wrappers on sub-alignment; the wrappers must self-clamp."""
    pts = _surface(rng, 180)
    cloud = PointCloud.from_numpy(pts, capacity=200)
    c, f = fused_prepare_features(
        cloud, jnp.float32(0.03), engine="triton", interpret=True
    )
    sums = np.asarray(f.descriptors)[:180].sum(axis=1)
    assert np.all((np.abs(sums - 1.0) < 1e-4) | (sums == 0.0))
