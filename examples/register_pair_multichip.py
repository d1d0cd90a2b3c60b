"""Distributed registration over a device mesh — the multi-chip surface.

    python examples/register_pair_multichip.py          # real devices
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/register_pair_multichip.py

Same workload as register_pair.py, but every stage — halo-exchange
prepare sweeps, feature NN, RANSAC hypotheses, ICP correspondence
search — runs sharded over a 1-D 'shard' mesh (tpu3d/parallel/
register_sharded.py). With one device it falls back single-device.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Virtual-device smoke runs: force the CPU platform BEFORE jax initializes
# (the virtual devices exist only on the CPU backend).
if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from tpu3d import PointCloud, RegistrationConfig, register_pair  # noqa: E402
from tpu3d.parallel import make_mesh  # noqa: E402


def main():
    rng = np.random.default_rng(0)
    n = 20000
    voxel = 0.004
    r5 = 5.0 * voxel
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    # Curvature at the descriptor-radius scale keeps FPFH discriminative.
    w1, w2 = 1.2 / r5, 0.45 / r5
    z = (
        0.7
        + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(0.8 * w1 * xy[:, 1])
        + 6.0 * voxel * np.cos(w2 * xy[:, 0]) * np.cos(1.1 * w2 * xy[:, 1])
    )
    target = np.column_stack([xy, z]).astype(np.float32)

    aa = np.array([0.1, -0.05, 0.15])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.02, -0.01, 0.03], np.float32)
    source = ((target - t) @ R).astype(np.float32)

    n_dev = len(jax.devices())
    mesh = make_mesh(("shard",)) if n_dev >= 2 else None
    print(f"devices: {n_dev} → {'mesh ' + str(mesh.shape) if mesh else 'single-device'}")

    cfg = RegistrationConfig(voxel_size=voxel, ransac_max_iterations=20000)
    refined, coarse = register_pair(
        PointCloud.from_numpy(source),
        PointCloud.from_numpy(target),
        cfg,
        mesh=mesh,
    )
    T = np.asarray(refined.transformation)
    print(f"coarse fitness {float(coarse.fitness):.3f}; "
          f"refined fitness {float(refined.fitness):.3f} "
          f"rmse {float(refined.rmse):.6f}")
    print(f"rotation error  {np.abs(T[:3, :3] - R).max():.2e}")
    print(f"translation err {np.abs(T[:3, 3] - t).max():.2e}")


if __name__ == "__main__":
    main()
