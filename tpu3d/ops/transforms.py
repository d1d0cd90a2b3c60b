"""SE(3) helpers and batched Kabsch alignment.

All functions are pure jnp and batch-friendly; they are traced into the
surrounding jit (RANSAC hypothesis batches, ICP updates).

Reference parity:
  - Kabsch with reflection fix ↔ src/registration.cpp:254-264 (RANSAC) and
    :383-396 (point-to-point ICP update).
  - Euler XYZ composition for the point-to-plane update ↔
    src/registration.cpp:368-372 (AngleAxis X * Y * Z, full trig — not the
    small-angle approximation).
  - ZYX RPY extraction with the gimbal-lock branch ↔ src/robot.cpp:38-56.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_transform(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble 4x4 homogeneous transforms from (..., 3, 3) and (..., 3)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def transform_points(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) transform(s) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def invert_transform(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse: [Rᵀ, -Rᵀt] (cheaper + stabler than LU)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def euler_xyz_to_matrix(angles: jnp.ndarray) -> jnp.ndarray:
    """R = Rx(a) @ Ry(b) @ Rz(g) for angles (..., 3).

    Matches the reference's point-to-plane delta-rotation convention
    (src/registration.cpp:369-371): exact AngleAxis products, full trig.
    """
    a, b, g = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cg, sg = jnp.cos(g), jnp.sin(g)
    row0 = jnp.stack([cb * cg, -cb * sg, sb], axis=-1)
    row1 = jnp.stack(
        [ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb], axis=-1
    )
    row2 = jnp.stack(
        [sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_rpy_zyx(R: jnp.ndarray) -> jnp.ndarray:
    """Extract (roll, pitch, yaw) in radians, ZYX convention with the
    reference's gimbal-lock branch (src/robot.cpp:42-52)."""
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    regular = jnp.abs(R[..., 2, 0]) < 0.999
    roll = jnp.where(
        regular,
        jnp.arctan2(R[..., 2, 1], R[..., 2, 2]),
        jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
    )
    yaw = jnp.where(regular, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]), 0.0)
    return jnp.stack([roll, pitch, yaw], axis=-1)


def kabsch(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted Kabsch: find (R, t) minimising Σ w_i ||R src_i + t - tgt_i||².

    Batched over leading axes: src/tgt (..., N, 3), weights (..., N).
    Reflection fix flips the last singular direction exactly like the
    reference (src/registration.cpp:258-262: V.col(2) *= -1 when det < 0 —
    valid because SVD returns singular values in descending order, so column
    2 is the smallest).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
    src_mean = jnp.sum(src * w, axis=-2, keepdims=True) / wsum
    tgt_mean = jnp.sum(tgt * w, axis=-2, keepdims=True) / wsum
    src_c = (src - src_mean) * w
    tgt_c = tgt - tgt_mean
    # H = Σ w (src - s̄)(tgt - t̄)ᵀ  (3x3), matching registration.cpp:254/383.
    H = jnp.swapaxes(src_c, -1, -2) @ tgt_c
    U, _, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    R = V @ jnp.swapaxes(U, -1, -2)
    det = jnp.linalg.det(R)
    V_fixed = V.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    R = V_fixed @ jnp.swapaxes(U, -1, -2)
    t = tgt_mean[..., 0, :] - (R @ src_mean[..., 0, :, None])[..., 0]
    return R, t


def kabsch_from_cross_cov(
    sw: jnp.ndarray,
    sp: jnp.ndarray,
    sq: jnp.ndarray,
    H: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Kabsch (R, t) from sufficient statistics — the reduced form used by
    the ICP stats backends (ops/icp.py), identical to :func:`kabsch`.

    Args: sw scalar Σw; sp, sq (3,) weighted coordinate sums Σw·p / Σw·q;
    H (3,3) the CENTERED weighted cross-covariance Σ w (p−p̄)(q−q̄)ᵀ —
    callers compute it with the exact weighted means (two linear passes) so
    no large-moment cancellation enters.
    """
    sws = jnp.maximum(sw, 1e-12)
    src_mean = sp / sws
    tgt_mean = sq / sws
    U, _, Vt = jnp.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    det = jnp.linalg.det(R)
    V_fixed = V.at[:, 2].multiply(jnp.where(det < 0, -1.0, 1.0))
    R = V_fixed @ U.T
    t = tgt_mean - R @ src_mean
    return R, t


def _det3(a):
    """Batched 3x3 determinant, explicit cofactor expansion (elementwise)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def kabsch_quat(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    newton_iters: int = 12,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Horn/QCP quaternion absolute-orientation — same optimum as
    :func:`kabsch` (the reflection fix is inherent: a quaternion always
    parameterizes a proper rotation) but with NO batched SVD. The largest
    eigenvalue of the 4x4 Horn matrix is found by Newton iteration on its
    characteristic quartic from the upper bound λ₀ = E₀ (the QCP method,
    Theobald 2005), and the eigenvector by the adjugate of N − λI — all
    fused elementwise math. This is the RANSAC hot path — ~100k hypothesis
    solves per call — where a batched iterative ``linalg.svd`` is slow and
    this is a few elementwise kernels.

    Degenerate samples (collinear/coincident points) yield an arbitrary
    valid rotation; RANSAC's duplicate rejection + fitness scoring discards
    them, mirroring how the reference tolerates Jacobi-SVD output on such
    samples (registration.cpp:254-262).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
    src_mean = jnp.sum(src * w, axis=-2, keepdims=True) / wsum
    tgt_mean = jnp.sum(tgt * w, axis=-2, keepdims=True) / wsum
    src_c = src - src_mean
    tgt_c = tgt - tgt_mean
    src_cw = src_c * w
    # Correlation entries as (...,) PLANES — everything downstream stays
    # structure-of-arrays: batched (H,4,4) micro-ops put dims 4x4 on the
    # sublane/lane axes and waste 124 of 128 lanes (measured ~10x slower).
    def _corr(i, j):
        return jnp.sum(src_cw[..., i] * tgt_c[..., j], axis=-1)

    sxx, sxy, sxz = _corr(0, 0), _corr(0, 1), _corr(0, 2)
    syx, syy, syz = _corr(1, 0), _corr(1, 1), _corr(1, 2)
    szx, szy, szz = _corr(2, 0), _corr(2, 1), _corr(2, 2)
    # Upper bound on λ_max: E0 = ½ Σ w (‖src_c‖² + ‖tgt_c‖²) ≥ Σ w tgt·R src.
    e0 = 0.5 * jnp.sum(
        weights * (jnp.sum(src_c * src_c, -1) + jnp.sum(tgt_c * tgt_c, -1)),
        axis=-1,
    )
    q0, qx, qy, qz = _qcp_quat_planes(
        sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0, newton_iters
    )

    row0 = jnp.stack(
        [
            q0 * q0 + qx * qx - qy * qy - qz * qz,
            2 * (qx * qy - q0 * qz),
            2 * (qx * qz + q0 * qy),
        ],
        -1,
    )
    row1 = jnp.stack(
        [
            2 * (qy * qx + q0 * qz),
            q0 * q0 - qx * qx + qy * qy - qz * qz,
            2 * (qy * qz - q0 * qx),
        ],
        -1,
    )
    row2 = jnp.stack(
        [
            2 * (qz * qx - q0 * qy),
            2 * (qz * qy + q0 * qx),
            q0 * q0 - qx * qx - qy * qy + qz * qz,
        ],
        -1,
    )
    R = jnp.stack([row0, row1, row2], -2)
    t = tgt_mean[..., 0, :] - (R @ src_mean[..., 0, :, None])[..., 0]
    return R, t


def _qcp_quat_planes(
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0, newton_iters=12
):
    """Largest-eigenvalue quaternion of the Horn matrix from correlation
    PLANES (QCP: Newton on the characteristic quartic from λ₀ = E0, then
    adjugate columns + Rayleigh polish) — shared by :func:`kabsch_quat`
    and the gather-free 3-point solver :func:`kabsch3_planes`."""
    # Horn matrix N (symmetric, traceless) as 10 unique planes.
    n00 = sxx + syy + szz
    n01 = syz - szy
    n02 = szx - sxz
    n03 = sxy - syx
    n11 = sxx - syy - szz
    n12 = sxy + syx
    n13 = szx + sxz
    n22 = -sxx + syy - szz
    n23 = syz + szy
    n33 = -sxx - syy + szz

    # M = N² (symmetric) — explicit plane products.
    m00 = n00 * n00 + n01 * n01 + n02 * n02 + n03 * n03
    m01 = n00 * n01 + n01 * n11 + n02 * n12 + n03 * n13
    m02 = n00 * n02 + n01 * n12 + n02 * n22 + n03 * n23
    m03 = n00 * n03 + n01 * n13 + n02 * n23 + n03 * n33
    m11 = n01 * n01 + n11 * n11 + n12 * n12 + n13 * n13
    m12 = n01 * n02 + n11 * n12 + n12 * n22 + n13 * n23
    m13 = n01 * n03 + n11 * n13 + n12 * n23 + n13 * n33
    m22 = n02 * n02 + n12 * n12 + n22 * n22 + n23 * n23
    m23 = n02 * n03 + n12 * n13 + n22 * n23 + n23 * n33
    m33 = n03 * n03 + n13 * n13 + n23 * n23 + n33 * n33

    tr2 = m00 + m11 + m22 + m33
    tr3 = (
        n00 * m00 + n11 * m11 + n22 * m22 + n33 * m33
        + 2.0 * (n01 * m01 + n02 * m02 + n03 * m03
                 + n12 * m12 + n13 * m13 + n23 * m23)
    )
    tr4 = (
        m00 * m00 + m11 * m11 + m22 * m22 + m33 * m33
        + 2.0 * (m01 * m01 + m02 * m02 + m03 * m03
                 + m12 * m12 + m13 * m13 + m23 * m23)
    )
    # Characteristic quartic λ⁴ + c2 λ² + c1 λ + c0 (c3 = −tr N = 0).
    c2 = -0.5 * tr2
    c1 = -tr3 / 3.0
    c0 = -0.25 * (tr4 + c2 * tr2)

    lam = e0  # λ_max ≤ E0: Newton from above converges monotonically
    for _ in range(newton_iters):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / jnp.where(jnp.abs(dp) > 1e-20, dp, 1e-20)

    # Eigenvector: adjugate of A = N − λI (symmetric ⇒ every nonzero column
    # is the null direction). Build all 4 columns (plane cofactors), keep
    # the largest; polish with Rayleigh-quotient rounds — f32 cancellation
    # in the quartic coefficients limits the Newton λ near exact fits
    # (λ_max = E0) and the Rayleigh update λ ← vᵀNv recovers the digits.
    def _adj_best_col(lam_):
        a00, a11 = n00 - lam_, n11 - lam_
        a22, a33 = n22 - lam_, n33 - lam_
        A = [
            [a00, n01, n02, n03],
            [n01, a11, n12, n13],
            [n02, n12, a22, n23],
            [n03, n13, n23, a33],
        ]

        def det3(r, c):
            (i0, i1, i2), (j0, j1, j2) = r, c
            return (
                A[i0][j0] * (A[i1][j1] * A[i2][j2] - A[i1][j2] * A[i2][j1])
                - A[i0][j1] * (A[i1][j0] * A[i2][j2] - A[i1][j2] * A[i2][j0])
                + A[i0][j2] * (A[i1][j0] * A[i2][j1] - A[i1][j1] * A[i2][j0])
            )

        idx = [0, 1, 2, 3]
        cand = []  # 4 candidate columns, each 4 planes
        for k in range(4):
            rows = tuple(i for i in idx if i != k)
            col = []
            for i in range(4):
                cs = tuple(j for j in idx if j != i)
                col.append(((-1.0) ** (i + k)) * det3(rows, cs))
            cand.append(col)
        norms = [sum(c[i] * c[i] for i in range(4)) for c in cand]
        # Select the largest column with nested where (planes, no gathers).
        best_col = cand[0]
        best_norm = norms[0]
        for k in range(1, 4):
            take = norms[k] > best_norm
            best_col = [
                jnp.where(take, cand[k][i], best_col[i]) for i in range(4)
            ]
            best_norm = jnp.where(take, norms[k], best_norm)
        inv = jax.lax.rsqrt(jnp.maximum(best_norm, 1e-60))
        return [c * inv for c in best_col]

    v = _adj_best_col(lam)

    def _rayleigh(v_):
        v0, v1, v2, v3 = v_
        nv0 = n00 * v0 + n01 * v1 + n02 * v2 + n03 * v3
        nv1 = n01 * v0 + n11 * v1 + n12 * v2 + n13 * v3
        nv2 = n02 * v0 + n12 * v1 + n22 * v2 + n23 * v3
        nv3 = n03 * v0 + n13 * v1 + n23 * v2 + n33 * v3
        return v0 * nv0 + v1 * nv1 + v2 * nv2 + v3 * nv3

    for _ in range(2):
        lam = _rayleigh(v)
        v = _adj_best_col(lam)
    # Final EXACT re-normalization + degeneracy fallback. The in-column
    # normalization above divides by a norm computed from raw 3x3
    # cofactors; for tiny near-collinear samples (~1e-4 m extent) those
    # cofactors sit at ~1e-19 and their SQUARES underflow f32 (flushed to
    # zero on some devices), so the "normalized" quaternion can come out with
    # ‖q‖ ≠ 1 (measured 1.0044) or NaN. A non-unit quaternion yields a
    # SCALED rotation matrix — which breaks every consumer that relies on
    # ‖Rp‖ = ‖p‖, most damagingly RANSAC's rank-16 scoring expansion
    # (err² = F·W + ‖p‖² + ‖q‖² + ‖t‖² turns negative for every point, so
    # one degenerate 3-point sample scores fitness 1.0 and hijacks the
    # winner selection — a bug the ab_stats gate caught live). Here the
    # components are already O(1), so this renormalization is exact; fully
    # degenerate/non-finite solutions fall back to the identity quaternion
    # (an arbitrary valid rotation, honestly scored — same contract as the
    # reference's Jacobi-SVD on such samples, registration.cpp:254-262).
    v0, v1, v2, v3 = v
    nrm = v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3
    ok = jnp.isfinite(nrm) & (nrm > 1e-12)
    inv = jax.lax.rsqrt(jnp.where(ok, nrm, 1.0))
    return (
        jnp.where(ok, v0 * inv, 1.0),
        jnp.where(ok, v1 * inv, 0.0),
        jnp.where(ok, v2 * inv, 0.0),
        jnp.where(ok, v3 * inv, 0.0),
    )


def kabsch3_planes(ps, qs):
    """Gather-free-layout 3-point Kabsch: inputs and outputs are PLANES.

    ``ps``/``qs``: tuples of 3 sample tuples of (h,) coordinate planes —
    ps[k][c] is coordinate c of sample k for every hypothesis. Returns
    (r_planes (9 planes, row-major), t_planes (3 planes)). Same optimum as
    :func:`kabsch_quat` (identical QCP core); exists because the RANSAC
    hot path solves ~100k tiny problems per call and an (h, 3, 3) gather +
    minor-dim-3 micro-ops costs more than 1-D plane gathers and
    elementwise plane math."""
    third = jnp.float32(1.0 / 3.0)
    pm = [(ps[0][c] + ps[1][c] + ps[2][c]) * third for c in range(3)]
    qm = [(qs[0][c] + qs[1][c] + qs[2][c]) * third for c in range(3)]
    pc = [[ps[k][c] - pm[c] for c in range(3)] for k in range(3)]
    qc = [[qs[k][c] - qm[c] for c in range(3)] for k in range(3)]

    def corr(i, j):
        return (
            pc[0][i] * qc[0][j] + pc[1][i] * qc[1][j] + pc[2][i] * qc[2][j]
        )

    sxx, sxy, sxz = corr(0, 0), corr(0, 1), corr(0, 2)
    syx, syy, syz = corr(1, 0), corr(1, 1), corr(1, 2)
    szx, szy, szz = corr(2, 0), corr(2, 1), corr(2, 2)
    e0 = 0.5 * sum(
        pc[k][c] * pc[k][c] + qc[k][c] * qc[k][c]
        for k in range(3)
        for c in range(3)
    )
    q0, qx, qy, qz = _qcp_quat_planes(
        sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0
    )
    r = (
        q0 * q0 + qx * qx - qy * qy - qz * qz,
        2 * (qx * qy - q0 * qz),
        2 * (qx * qz + q0 * qy),
        2 * (qy * qx + q0 * qz),
        q0 * q0 - qx * qx + qy * qy - qz * qz,
        2 * (qy * qz - q0 * qx),
        2 * (qz * qx - q0 * qy),
        2 * (qz * qy + q0 * qx),
        q0 * q0 - qx * qx - qy * qy + qz * qz,
    )
    t = tuple(
        qm[i] - (r[3 * i] * pm[0] + r[3 * i + 1] * pm[1]
                 + r[3 * i + 2] * pm[2])
        for i in range(3)
    )
    return r, t
