"""Reference-shaped API facade.

Users of the reference know ``Registration``'s static surface
(include/registration.hpp:32-60) and ``Pipeline``/``Robot``/``Segmentation``
classes; this module exposes the same names over the JAX ops so a
port is a one-line import change. The pythonic API in :mod:`tpu3d` is the
primary surface; this is the compatibility skin.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu3d.models.ply import load_ply
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.icp import icp_refine
from tpu3d.ops.normals import estimate_normals
from tpu3d.ops.ransac import ransac_registration
from tpu3d.ops.voxel import voxel_downsample
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult

__all__ = ["Registration", "PointCloud", "FPFHFeatures", "RegistrationResult"]


class Registration:
    """Static facade mirroring the reference class (registration.hpp:32-60)."""

    @staticmethod
    def voxelDownsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
        return voxel_downsample(cloud, jnp.float32(voxel_size))

    @staticmethod
    def estimateNormals(cloud: PointCloud, k: int = 30) -> PointCloud:
        # Reference-shaped API promises reference semantics → exact top-k.
        return estimate_normals(cloud, k=k)

    @staticmethod
    def computeFPFH(cloud: PointCloud, radius: float) -> FPFHFeatures:
        return compute_fpfh(cloud, jnp.float32(radius))

    @staticmethod
    def ransacRegistration(
        source: PointCloud,
        target: PointCloud,
        source_features: FPFHFeatures,
        target_features: FPFHFeatures,
        voxel_size: float,
        max_iterations: int = 100000,
        confidence: float = 0.999,
    ) -> RegistrationResult:
        return ransac_registration(
            source, target, source_features, target_features, voxel_size,
            max_iterations=max_iterations, confidence=confidence,
        )

    @staticmethod
    def icpRefine(
        source: PointCloud,
        target: PointCloud,
        initial_transform,
        distance_threshold: float,
        max_iterations: int = 200,
        point_to_plane: bool = True,
    ) -> RegistrationResult:
        return icp_refine(
            source, target, jnp.asarray(initial_transform, jnp.float32),
            distance_threshold, max_iterations=max_iterations,
            point_to_plane=point_to_plane,
        )

    @staticmethod
    def loadReferenceModel(path: str) -> PointCloud:
        pts, cols = load_ply(path)
        if len(pts) == 0:
            return PointCloud(
                points=jnp.zeros((0, 3), jnp.float32),
                mask=jnp.zeros((0,), bool),
            )
        return PointCloud.from_numpy(np.asarray(pts), colors=cols)
