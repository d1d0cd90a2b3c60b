import numpy as np
import jax.numpy as jnp

from tpu3d import oracle
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.normals import estimate_normals
from tpu3d.types import PointCloud


def _setup_cloud(rng, n=120):
    # A bumpy surface away from the origin → well-defined normals and
    # non-degenerate Darboux angles.
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.2 * np.sin(10 * xy[:, 0]) * np.cos(8 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    normals = oracle.estimate_normals(pts, k=15)
    return pts, normals


def test_fpfh_matches_oracle(rng):
    pts, normals = _setup_cloud(rng)
    radius = 0.08
    exp = oracle.compute_fpfh(pts, normals, radius)

    cloud = PointCloud.from_numpy(pts, normals=normals, capacity=128)
    got = np.asarray(
        compute_fpfh(cloud, jnp.float32(radius), chunk=64).descriptors
    )[: len(pts)]

    # Histograms are L1-normalized; compare via L1 distance per point. Bin
    # boundary flips from f32 angle differences may move a neighbor's mass
    # between adjacent bins, so allow a small budget. On an accelerator the budget is
    # larger: θ = atan2(w·n_j, u·n_j) ≈ 0 for near-parallel normals, which
    # sits EXACTLY on the bin-5/6 boundary ((θ/π + 1)·5.5 = 5.5), so
    # transcendental ULP differences flip bins — quantization noise, not a
    # defect (decision-level fidelity is gated in benchmarks/fidelity.py).
    import jax

    budget = (0.05, 0.25) if jax.default_backend() == "cpu" else (0.35, 0.8)
    l1 = np.abs(got - exp).sum(axis=1)
    assert np.quantile(l1, 0.9) < budget[0], f"p90 L1 {np.quantile(l1, 0.9)}"
    assert l1.max() < budget[1], f"max L1 {l1.max()}"


def test_fpfh_descriptors_normalized(rng):
    pts, normals = _setup_cloud(rng, n=80)
    cloud = PointCloud.from_numpy(pts, normals=normals, capacity=128)
    got = np.asarray(compute_fpfh(cloud, jnp.float32(0.08)).descriptors)
    sums = got[:80].sum(axis=1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-4)
    assert np.all(got[80:] == 0)  # padding rows zeroed


def test_fpfh_translation_invariant(rng):
    pts, normals = _setup_cloud(rng, n=80)
    c1 = PointCloud.from_numpy(pts, normals=normals, capacity=128)
    c2 = PointCloud.from_numpy(pts + np.float32(5.0), normals=normals,
                               capacity=128)
    f1 = np.asarray(compute_fpfh(c1, jnp.float32(0.08)).descriptors)
    f2 = np.asarray(compute_fpfh(c2, jnp.float32(0.08)).descriptors)
    # The offset costs f32 mantissa bits → a few neighbors land on the other
    # side of a bin boundary; allow a small per-point L1 budget (larger on
    # an accelerator — see test_fpfh_matches_oracle's note on the θ≈0 bin
    # boundary).
    import jax

    budget = 0.1 if jax.default_backend() == "cpu" else 0.6
    l1 = np.abs(f1 - f2).sum(axis=1)
    assert l1.max() < budget, f"max L1 {l1.max()}"
