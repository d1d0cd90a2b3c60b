"""Depth-frame preprocessing: scale + mask + (optional) bilateral filter.

Reference parity:
  - scale/mask: cuda/depth_processing.cu:10-54 (GPU zeroes where mask == 0)
    vs the CPU path's ``mask > 10`` threshold (src/pipeline.cpp:49-53). The
    two diverge in the reference; we follow the CPU semantics (> 10)
    everywhere — one behavior, documented fix.
  - bilateral filter: cuda/depth_processing.cu:56-155. In the reference this
    kernel is DEAD CODE (declared, flag parsed, never called — SURVEY.md
    §2.4); here it is live behind ``depth.bilateral_filter``. Same math:
    radius = int(2σ_spatial + 0.5) clamped to 5, Gaussian spatial × range
    weights, zero-depth pixels skipped as neighbors and passed through as 0
    centers.

Device formulation: the scale+mask is a trivially fused elementwise op. The
bilateral filter unrolls the (2r+1)² window into shifted adds over a padded
image — a static Python loop XLA fuses into one elementwise kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BF_MAX_RADIUS = 5  # cuda/depth_processing.cu:59 BF_MAX_RADIUS


@functools.partial(jax.jit, static_argnames=("apply_mask",))
def depth_preprocess(
    depth_raw: jnp.ndarray,
    mask: jnp.ndarray | None,
    scale_to_meters: jnp.ndarray,
    apply_mask: bool = True,
) -> jnp.ndarray:
    """u16 depth → f32 meters, zeroed outside the instance mask.

    ``mask`` uses the CPU reference's binarization: valid where mask > 10
    (cv::threshold at 10, src/pipeline.cpp:50-52).
    """
    d = depth_raw.astype(jnp.float32) / jnp.asarray(scale_to_meters, jnp.float32)
    if apply_mask and mask is not None:
        d = jnp.where(mask > 10, d, 0.0)
    return d


def _bf_radius(sigma_spatial: float) -> int:
    # cuda/depth_processing.cu:126-131
    return min(int(2.0 * sigma_spatial + 0.5), _BF_MAX_RADIUS)


def _bilateral_math(padded, h, w, radius, inv_spatial2, inv_range2):
    """Shared unrolled window accumulation. ``padded`` is (h+2r, w+2r).
    All offsets are static Python ints, so plain slicing works in both the
    XLA path and inside the Pallas kernel (where dynamic_slice-of-value is
    not lowerable)."""
    center = padded[radius : radius + h, radius : radius + w]
    sum_w = jnp.zeros((h, w), jnp.float32)
    sum_v = jnp.zeros((h, w), jnp.float32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = padded[
                radius + dy : radius + dy + h, radius + dx : radius + dx + w
            ]
            rd = nb - center
            wgt = jnp.exp(
                (dx * dx + dy * dy) * inv_spatial2 + rd * rd * inv_range2
            )
            wgt = jnp.where(nb > 0.0, wgt, 0.0)
            sum_w = sum_w + wgt
            sum_v = sum_v + wgt * nb
    out = jnp.where(sum_w > 0.0, sum_v / jnp.maximum(sum_w, 1e-30), center)
    return jnp.where(center > 0.0, out, 0.0)


@functools.partial(jax.jit, static_argnames=("sigma_spatial", "sigma_range"))
def bilateral_filter(
    depth: jnp.ndarray,
    sigma_spatial: float = 2.0,
    sigma_range: float = 0.05,
) -> jnp.ndarray:
    """Edge-preserving depth smoothing (cuda/depth_processing.cu:56-155).
    The tap unroll fuses into one elementwise kernel."""
    h, w = depth.shape
    radius = _bf_radius(sigma_spatial)
    inv_spatial2 = -0.5 / (sigma_spatial * sigma_spatial)
    inv_range2 = -0.5 / (sigma_range * sigma_range)
    padded = jnp.pad(depth.astype(jnp.float32), radius)
    return _bilateral_math(padded, h, w, radius, inv_spatial2, inv_range2)
