"""Benchmark sweeps — BASELINE.json configs[2] and configs[3].

  configs[2]: coarse alignment — FPFH + RANSAC (10k hypotheses) on a model
              vs a rigidly transformed copy, swept over 1k → 100k points.
  configs[3]: fine alignment — ICP point-to-point vs point-to-plane at 100k
              points, 50 iterations, convergence-gated.

Usage: python benchmarks/sweep.py  → one JSON line per configuration.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import make_pair  # noqa: E402
from tpu3d.ops.fused_features import fused_prepare_features  # noqa: E402
from tpu3d.ops.icp import icp_refine  # noqa: E402
from tpu3d.ops.ransac import ransac_registration  # noqa: E402
from tpu3d.types import PointCloud  # noqa: E402


def _timed(fn, *args, iters=2):
    """Best seconds per call, each run to completion on the device."""
    jitted = jax.jit(fn)
    jax.block_until_ready(jitted(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(jitted(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    voxel = 0.005
    d = jax.devices()[0]
    print(f"# device={d.platform} {d.device_kind} x{len(jax.devices())}",
          file=sys.stderr)

    # --- configs[1]: depth→cloud stage (640x480 frame) -----------------------
    from tpu3d.models.procedural import generate_scene
    from tpu3d.ops.deproject import deproject
    from tpu3d.ops.depth import depth_preprocess
    from tpu3d.ops.normals import estimate_normals
    from tpu3d.ops.voxel import compact, voxel_downsample

    rgb, depth, K = generate_scene(640, 480)
    depth_d, rgb_d, K_d = jnp.asarray(depth), jnp.asarray(rgb), jnp.asarray(K)

    def depth_stage():
        d = depth_preprocess(depth_d, None, 1000.0, apply_mask=False)
        cloud = deproject(d, rgb_d, K_d, 1.5)
        down = voxel_downsample(cloud, jnp.float32(0.002))
        down = compact(down, 65536)
        return estimate_normals(down, k=30).normals

    dt = _timed(depth_stage)
    print(
        json.dumps(
            {
                "config": "depth_to_cloud_640x480",
                "ms": round(dt * 1000, 1),
                "frames_per_sec": round(1 / dt, 1),
            }
        )
    )

    # --- configs[2]: coarse alignment sweep ---------------------------------
    for n in (1024, 4096, 16384, 65536, 100352):
        src_np, tgt_np, R, t = make_pair(n, voxel=voxel)
        src, sf = fused_prepare_features(
            PointCloud.from_numpy(src_np, capacity=n), jnp.float32(voxel * 5)
        )
        tgt, tf = fused_prepare_features(
            PointCloud.from_numpy(tgt_np, capacity=n), jnp.float32(voxel * 5)
        )

        def coarse():
            return ransac_registration(
                src, tgt, sf, tf, voxel, max_iterations=10240
            ).fitness

        dt = _timed(coarse)
        res = ransac_registration(src, tgt, sf, tf, voxel, max_iterations=10240)
        T = np.asarray(res.transformation)
        print(
            json.dumps(
                {
                    "config": "coarse_fpfh_ransac_10k",
                    "points": n,
                    "ms": round(dt * 1000, 1),
                    "hypotheses_per_sec": round(10240 / dt),
                    "fitness": round(float(res.fitness), 4),
                    "rot_err": float(np.abs(T[:3, :3] - R).max()),
                }
            )
        )

    # --- configs[3]: fine alignment, p2p vs p2l at 100k ----------------------
    n = 100352
    src_np, tgt_np, R, t = make_pair(n, voxel=voxel)
    tgt, _ = fused_prepare_features(
        PointCloud.from_numpy(tgt_np, capacity=n), jnp.float32(voxel * 5)
    )
    src = PointCloud.from_numpy(src_np, capacity=n)
    # Start near the optimum (RANSAC's job) so ICP exercises convergence.
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t + np.float32([0.003, -0.002, 0.002])
    for p2l in (False, True):
        def fine(p2l=p2l):
            return icp_refine(
                src, tgt, jnp.asarray(T0), voxel * 2.0,
                max_iterations=50, point_to_plane=p2l,
            ).transformation

        dt = _timed(fine, iters=2)
        res = icp_refine(src, tgt, jnp.asarray(T0), voxel * 2.0,
                         max_iterations=50, point_to_plane=p2l)
        T = np.asarray(res.transformation)
        print(
            json.dumps(
                {
                    "config": "fine_icp_" + ("p2plane" if p2l else "p2point"),
                    "points": n,
                    "ms": round(dt * 1000, 1),
                    "iters_per_sec_upper": round(50 / dt),
                    "fitness": round(float(res.fitness), 4),
                    "rmse": float(res.rmse),
                    "rot_err": float(np.abs(T[:3, :3] - R).max()),
                    "trans_err": float(np.abs(T[:3, 3] - t).max()),
                }
            )
        )


if __name__ == "__main__":
    main()
