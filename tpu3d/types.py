"""Core data types for the 3D registration framework.

Design note: XLA requires static shapes, so a point cloud is a
*fixed-capacity* buffer plus a validity mask — ``points[N, 3]`` with
``mask[N]`` — instead of the reference's dynamically-sized
``std::vector<Eigen::Vector3f>`` (reference: include/registration.hpp:10-19).
Every op in :mod:`tpu3d.ops` consumes and produces masked fixed-shape arrays
so that the whole registration stack stays inside one ``jax.jit`` trace.

Reference parity:
  - ``PointCloud``          ↔ include/registration.hpp:10-19
  - ``FPFHFeatures``        ↔ include/registration.hpp:21-24 (33-D descriptors)
  - ``RegistrationResult``  ↔ include/registration.hpp:26-30 (identity / 0 / 0 defaults)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud.

    Attributes:
      points:  f32[N, 3] — xyz; rows with ``mask == False`` are padding.
      mask:    bool[N]   — validity of each row.
      normals: f32[N, 3] or None.
      colors:  f32[N, 3] or None — RGB in [0, 1].
    """

    points: jnp.ndarray
    mask: jnp.ndarray
    normals: Optional[jnp.ndarray] = None
    colors: Optional[jnp.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jnp.ndarray:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_colors(self) -> bool:
        return self.colors is not None

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        normals: Optional[np.ndarray] = None,
        colors: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Pack a dense (n, 3) numpy array into a fixed-capacity cloud.

        ``capacity`` defaults to the next multiple of 128 (lane width) so the
        padded buffer tiles cleanly onto the device's vector units.
        """
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        if capacity is None:
            capacity = max(128, -(-n // 128) * 128)
        if n > capacity:
            raise ValueError(f"{n} points exceed capacity {capacity}")

        def pad(a):
            if a is None:
                return None
            a = np.asarray(a, dtype=np.float32).reshape(-1, 3)
            out = np.zeros((capacity, 3), dtype=np.float32)
            out[:n] = a
            return jnp.asarray(out)

        mask = np.zeros((capacity,), dtype=bool)
        mask[:n] = True
        return PointCloud(
            points=pad(points),
            mask=jnp.asarray(mask),
            normals=pad(normals),
            colors=pad(colors),
        )

    def to_numpy(self) -> dict:
        """Unpack to dense numpy arrays (drops padding). Host-side only."""
        mask = np.asarray(self.mask)
        out = {"points": np.asarray(self.points)[mask]}
        if self.normals is not None:
            out["normals"] = np.asarray(self.normals)[mask]
        if self.colors is not None:
            out["colors"] = np.asarray(self.colors)[mask]
        return out


class FPFHFeatures(NamedTuple):
    """33-bin FPFH descriptors, one row per point (padding rows are zero)."""

    descriptors: jnp.ndarray  # f32[N, 33]
    mask: jnp.ndarray  # bool[N]

    @property
    def capacity(self) -> int:
        return self.descriptors.shape[0]


class RegistrationResult(NamedTuple):
    """Result of a coarse or fine registration.

    Defaults mirror the reference (include/registration.hpp:26-30):
    identity transform, fitness 0, rmse 0.
    """

    transformation: jnp.ndarray  # f32[4, 4]
    fitness: jnp.ndarray  # f32 scalar — inlier/correspondence fraction
    rmse: jnp.ndarray  # f32 scalar — inlier RMSE

    @staticmethod
    def identity() -> "RegistrationResult":
        return RegistrationResult(
            transformation=jnp.eye(4, dtype=jnp.float32),
            fitness=jnp.float32(0.0),
            rmse=jnp.float32(0.0),
        )
