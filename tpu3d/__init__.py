"""tpu3d — 3D point-cloud registration & bin-picking framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
C++/CUDA pipeline (stojicnnnn/3DVision): depth preprocessing, pinhole
deprojection, voxel downsampling, normal estimation, FPFH features, RANSAC
coarse + ICP fine registration, pick-pose computation and robot
sequencing. It runs on an NVIDIA GPU (Hopper): static shapes, masked
buffers, blockwise ops, Pallas kernels compiled through Triton for the
window walks, hypothesis scoring and descriptor search, and multi-device
sharding via jax.sharding. On the CPU every stage runs its plain XLA
formulation (tpu3d/utils/platform.py holds the engine table).
"""

import jax as _jax

# Geometry code: matmul-based distances, covariances and normal equations
# need true f32 accumulation. Reduced-precision passes (TF32 on the GPU)
# corrupt radius/threshold decisions, so the framework pins the default
# up-front; the Pallas kernels request IEEE f32 explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from tpu3d.config import PipelineConfig, RegistrationConfig, load_config
from tpu3d.registration import (
    bucket_capacity,
    prepare_cloud,
    register_pair,
    register_pair_multiscale,
    register_prepared,
)
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult

__version__ = "0.1.0"

__all__ = [
    "FPFHFeatures",
    "PipelineConfig",
    "PointCloud",
    "RegistrationConfig",
    "RegistrationResult",
    "bucket_capacity",
    "load_config",
    "prepare_cloud",
    "register_pair",
    "register_pair_multiscale",
    "register_prepared",
    "__version__",
]
