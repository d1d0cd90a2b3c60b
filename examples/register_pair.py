"""Minimal example: register a synthetic cloud pair end to end.

    python examples/register_pair.py

Generates a bumpy surface, rigidly perturbs it, runs the full
downsample → normals → FPFH → RANSAC → ICP stack and prints the recovered
pose against ground truth. Works on CPU and GPU.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3d import PointCloud, RegistrationConfig, register_pair


def main():
    rng = np.random.default_rng(0)
    n = 20000
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(40 * xy[:, 0]) * np.cos(35 * xy[:, 1])
    target = np.column_stack([xy, z]).astype(np.float32)

    aa = np.array([0.1, -0.05, 0.15])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32
    )
    t = np.array([0.03, -0.02, 0.01], np.float32)
    source = ((target - t) @ R).astype(np.float32)

    cfg = RegistrationConfig(voxel_size=0.004, ransac_max_iterations=20000)
    refined, coarse = register_pair(
        PointCloud.from_numpy(source), PointCloud.from_numpy(target), cfg
    )

    T = np.asarray(refined.transformation)
    print(f"coarse fitness: {float(coarse.fitness):.3f}")
    print(f"refined fitness: {float(refined.fitness):.3f}, "
          f"rmse: {float(refined.rmse):.2e}")
    print(f"rotation error:    {np.abs(T[:3, :3] - R).max():.2e}")
    print(f"translation error: {np.abs(T[:3, 3] - t).max():.2e} m")


if __name__ == "__main__":
    main()
