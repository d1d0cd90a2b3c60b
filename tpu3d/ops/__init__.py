"""Geometry and registration ops (JAX/XLA, with Pallas-Triton kernels)."""

from tpu3d.ops.deproject import deproject
from tpu3d.ops.depth import bilateral_filter, depth_preprocess
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.icp import icp_refine
from tpu3d.ops.neighbors import (
    knn,
    nearest_neighbor_xla,
    pairwise_sqdist,
    radius_capped_neighbors,
)
from tpu3d.ops.nn_pallas import nearest_neighbor, nearest_neighbor_triton
from tpu3d.ops.normals import estimate_normals
from tpu3d.ops.ransac import feature_correspondences, ransac_registration
from tpu3d.ops.transforms import (
    euler_xyz_to_matrix,
    invert_transform,
    kabsch,
    make_transform,
    matrix_to_rpy_zyx,
    transform_points,
)
from tpu3d.ops.voxel import compact, voxel_downsample

__all__ = [
    "bilateral_filter",
    "compact",
    "compute_fpfh",
    "deproject",
    "depth_preprocess",
    "estimate_normals",
    "euler_xyz_to_matrix",
    "feature_correspondences",
    "icp_refine",
    "invert_transform",
    "kabsch",
    "knn",
    "make_transform",
    "matrix_to_rpy_zyx",
    "nearest_neighbor",
    "nearest_neighbor_triton",
    "nearest_neighbor_xla",
    "pairwise_sqdist",
    "radius_capped_neighbors",
    "ransac_registration",
    "transform_points",
    "voxel_downsample",
]
