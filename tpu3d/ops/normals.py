"""Normal estimation: k-NN covariance + batched 3x3 eigendecomposition.

Reference semantics (src/registration.cpp:105-130): for every point, take
its k=30 nearest neighbors (self included — findKNN scans the whole cloud,
registration.cpp:63-81), form the covariance of the neighborhood, take the
eigenvector of the smallest eigenvalue, and orient it toward the viewpoint
(origin): flip when ``n · (-p) < 0`` (registration.cpp:125-127).

Device formulation: chunked pairwise-distance top-k (matmul + ``top_k``),
then one *batched* ``jnp.linalg.eigh`` over all N covariance matrices — no
per-point host loop. Eigenvector sign is arbitrary out of eigh (as it is out
of Eigen); the viewpoint flip makes it deterministic wherever ``n·p ≠ 0``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu3d.ops.neighbors import knn
from tpu3d.types import PointCloud


def smallest_eigvec_3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric 3x3
    matrices — closed form (Cardano eigenvalues + spectral projector), pure
    elementwise math. Replaces batched ``jnp.linalg.eigh`` (iterative, the
    cost center of normal estimation at 100k points). Sign is arbitrary,
    like eigh/Eigen; callers orient it. Degenerate inputs (λ1 ≈ λ2) return
    some vector in the eigenspace — the same ambiguity eigh has.
    """
    # Scale-normalize for f32 conditioning (eigenvectors are scale-free).
    scale = jnp.maximum(
        jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True), 1e-30
    )
    A = A / scale

    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (
        (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    )
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    eye = jnp.eye(3, dtype=A.dtype)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] ** 2)
        - B[..., 0, 1]
        * (B[..., 0, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 0, 2])
        + B[..., 0, 2]
        * (B[..., 0, 1] * B[..., 1, 2] - B[..., 1, 1] * B[..., 0, 2])
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam3 = q + 2.0 * p * jnp.cos(phi)  # largest
    lam1 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3

    # Spectral projector onto the λ1 eigenspace: (A−λ2 I)(A−λ3 I).
    P = (A - lam2[..., None, None] * eye) @ (A - lam3[..., None, None] * eye)
    norms = jnp.sum(P * P, axis=-2)  # column norms (..., 3)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(
        P, best[..., None, None].repeat(3, -2), axis=-1
    )[..., 0]
    # Fully-degenerate fallback (A ∝ I): projector vanishes — use e_z.
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    ez = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where(vnorm > 1e-20, v / jnp.maximum(vnorm, 1e-30), ez)
    return v


def smallest_eigvec_3x3_planes(a00, a01, a02, a11, a12, a22):
    """Plane-wise variant of :func:`smallest_eigvec_3x3`: six (N,)
    component vectors in, three (N,) eigenvector components out. Same
    Cardano + spectral-projector math, but every op is elementwise, so it
    also runs inside the window-walk kernels (ops/fused_features.py)."""
    scale = jnp.abs(a00)
    for c in (a01, a02, a11, a12, a22):
        scale = jnp.maximum(scale, jnp.abs(c))
    scale = jnp.maximum(scale, 1e-30)
    a00, a01, a02 = a00 / scale, a01 / scale, a02 / scale
    a11, a12, a22 = a11 / scale, a12 / scale, a22 / scale

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    inv_p = 1.0 / p
    b00, b11, b22 = (a00 - q) * inv_p, (a11 - q) * inv_p, (a22 - q) * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam3 = q + 2.0 * p * jnp.cos(phi)  # largest
    lam1 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3

    # Spectral projector P = (A−λ2)(A−λ3) = A² − (λ2+λ3)A + λ2λ3 I
    # (symmetric: the factors commute).
    s = lam2 + lam3
    t = lam2 * lam3
    P00 = a00 * a00 + a01 * a01 + a02 * a02 - s * a00 + t
    P01 = a00 * a01 + a01 * a11 + a02 * a12 - s * a01
    P02 = a00 * a02 + a01 * a12 + a02 * a22 - s * a02
    P11 = a01 * a01 + a11 * a11 + a12 * a12 - s * a11 + t
    P12 = a01 * a02 + a11 * a12 + a12 * a22 - s * a12
    P22 = a02 * a02 + a12 * a12 + a22 * a22 - s * a22 + t

    n0 = P00 * P00 + P01 * P01 + P02 * P02
    n1 = P01 * P01 + P11 * P11 + P12 * P12
    n2 = P02 * P02 + P12 * P12 + P22 * P22
    # First-max column pick (matches argmax's lowest-index tie break).
    m0 = (n0 >= n1) & (n0 >= n2)
    m1 = n1 >= n2
    vx = jnp.where(m0, P00, jnp.where(m1, P01, P02))
    vy = jnp.where(m0, P01, jnp.where(m1, P11, P12))
    vz = jnp.where(m0, P02, jnp.where(m1, P12, P22))
    vn = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    ok = vn > 1e-20
    inv = 1.0 / jnp.maximum(vn, 1e-30)
    # Fully-degenerate fallback (A ∝ I): projector vanishes — use e_z.
    vx = jnp.where(ok, vx * inv, 0.0)
    vy = jnp.where(ok, vy * inv, 0.0)
    vz = jnp.where(ok, vz * inv, 1.0)
    return vx, vy, vz


@functools.partial(
    jax.jit, static_argnames=("k", "chunk", "eig_method")
)
def estimate_normals(
    cloud: PointCloud,
    k: int = 30,
    chunk: int = 1024,
    neighbors: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    eig_method: str = "analytic",
) -> PointCloud:
    """``neighbors``: optional precomputed (idx, d2) self-kNN with ≥ k
    columns, sorted ascending — lets the pipeline run ONE neighbor search
    shared between normals (first k columns) and FPFH (all 100)."""
    pts = cloud.points
    if neighbors is not None:
        idx, d2 = neighbors[0][:, :k], neighbors[1][:, :k]
    else:
        idx, d2 = knn(pts, pts, cloud.mask, k=k, chunk=chunk)
    # Neighbors beyond the valid count come back at +inf distance; weight
    # them out (reference uses min(k, n) neighbors, registration.cpp:74-78).
    w = (d2 < 1e29).astype(jnp.float32)  # (N, k)

    nb = pts[idx]  # (N, k, 3)
    wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)  # (N, 1)
    centroid = jnp.sum(nb * w[..., None], axis=1) / wsum  # (N, 3)
    diff = (nb - centroid[:, None, :]) * w[..., None]  # weighted once…
    diff_u = nb - centroid[:, None, :]
    # cov = Σ w (p-c)(p-c)ᵀ / Σ w  — scaling matches registration.cpp:120
    cov = jnp.einsum("nki,nkj->nij", diff, diff_u) / wsum[..., None]

    if eig_method == "eigh":
        _, eigvecs = jnp.linalg.eigh(cov)
        normals = eigvecs[..., :, 0]  # smallest-eigenvalue eigenvector
    else:
        normals = smallest_eigvec_3x3(cov)
    # Orient toward the viewpoint/origin: flip when n·(-p) < 0.
    flip = jnp.sum(normals * (-pts), axis=-1) < 0
    normals = jnp.where(flip[:, None], -normals, normals)
    normals = jnp.where(cloud.mask[:, None], normals, 0.0)

    return cloud._replace(normals=normals)
