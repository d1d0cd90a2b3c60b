"""Where is the descriptor-NN precision cliff?

The feature NN (ops/nn_pallas.py) runs its 33-D cross term in IEEE f32.
A cheaper formulation is only acceptable if it keeps correspondence
quality. This script computes real FPFH descriptors on the bench fixture
(on the default device), then evaluates candidate cross-term precisions:

  - on the device: the dot algorithms the GPU offers (``TF32_TF32_F32``,
    ``TF32_TF32_F32_X3``, ``BF16_BF16_F32_X3``, ``F32_F32_F32``) through
    ``lax.dot_general``;
  - exactly in NumPy: f64 (the reference), f32, bf16/int8 limb
    decompositions and mantissa-truncated d² keys (the packed-argmin-key
    epilogue would quantize exactly like this).

Quality metric: fraction of source points whose descriptor-NN
correspondence lands within the RANSAC inlier threshold (1.5 x voxel) of
the true-pose position. Argmin agreement with f64 is reported too, but
quality is the decision metric (near-tie index churn is harmless).

Run: python benchmarks/nn_precision_quality.py  [TPU3D_NPQ_N to override n]
Prints one JSON line with the device it ran on.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from bench import make_pair  # noqa: E402
from tpu3d.ops.fused_features import fused_prepare_features  # noqa: E402
from tpu3d.types import PointCloud  # noqa: E402


def bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def cross_chunked(qd, td, mode, chunk=2048):
    """Argmin of d2 under each cross-term formulation ('dev:<ALGO>' runs
    on the device with that lax.DotAlgorithmPreset; the rest are exact
    NumPy limb simulations).

    qd (n, d) source descriptors, td (m, d) target descriptors; returns the
    argmin over m of d2 = |t|^2 - 2 cross (+|q|^2, constant per row).
    """
    tnorm = np.sum(td.astype(np.float64) ** 2, axis=1).astype(np.float32)
    if mode.startswith("bf16"):
        q_hi = bf16(qd)
        q_lo = bf16(qd - q_hi)
        t_hi = bf16(td)
        t_lo = bf16(td - t_hi)
    if mode.startswith("dev:"):
        algo = getattr(jax.lax.DotAlgorithmPreset, mode[4:])
        tdj = jnp.asarray(td)
        tnj = jnp.asarray(tnorm)
        f = jax.jit(lambda q: jnp.argmin(
            tnj[None, :] - 2.0 * jax.lax.dot_general(
                q, tdj, (((1,), (1,)), ((), ())), precision=algo,
                preferred_element_type=jnp.float32), axis=1))
        return np.concatenate([
            np.asarray(f(jnp.asarray(qd[s:s + chunk])))
            for s in range(0, qd.shape[0], chunk)
        ])
    if mode == "bf16x3n":
        # Single-pass packed bf16x3: the query side carries the exact -2
        # scale before the hi/lo split, and ||t||^2 rides the contraction
        # as two bf16 limbs — d2 accumulates inside one f32 chain.
        s2 = -2.0 * qd
        s2_hi = bf16(s2)
        s2_lo = bf16(s2 - s2_hi)
        tn32 = np.sum(td * td, axis=1).astype(np.float32)
        n_hi = bf16(tn32)
        n_lo = bf16(tn32 - n_hi)
    if mode.startswith("int8"):
        # Symmetric two-limb int8 quantization: v ~ a/127 + b/127^2 with
        # a = round(v*127), b = round((v - a/127)*127^2), both in [-127,127]
        # (|v - a/127| <= 1/254 so |b| <= 127/2 + 1). Step ~6.2e-5 of the
        # descriptor range. Products accumulate exactly in int32 (d<=33:
        # 33*127^2 < 2^31), mirroring the MXU's s8xs8->s32 path.
        qa = np.clip(np.round(qd * 127.0), -127, 127).astype(np.int32)
        qb = np.clip(
            np.round((qd - qa / 127.0) * 127.0 * 127.0), -127, 127
        ).astype(np.int32)
        ta = np.clip(np.round(td * 127.0), -127, 127).astype(np.int32)
        tb = np.clip(
            np.round((td - ta / 127.0) * 127.0 * 127.0), -127, 127
        ).astype(np.int32)
    out = np.empty((qd.shape[0],), np.int64)
    for s in range(0, qd.shape[0], chunk):
        e = min(s + chunk, qd.shape[0])
        if mode == "f32":
            cr = qd[s:e] @ td.T
        elif mode == "f64":
            cr = (qd[s:e].astype(np.float64) @ td.T.astype(np.float64)).astype(
                np.float32
            )
        elif mode == "bf16x1":
            cr = q_hi[s:e] @ t_hi.T
        elif mode == "bf16x3":
            cr = q_hi[s:e] @ t_hi.T + q_hi[s:e] @ t_lo.T + q_lo[s:e] @ t_hi.T
        elif mode == "bf16x3n":
            d2 = (
                s2_hi[s:e] @ t_hi.T
                + s2_lo[s:e] @ t_hi.T
                + s2_hi[s:e] @ t_lo.T
                + n_hi[None, :]
                + n_lo[None, :]
            )
            out[s:e] = np.argmin(d2, axis=1)
            continue
        elif mode == "int8x1":
            cr = (qa[s:e] @ ta.T).astype(np.float32) / (127.0 * 127.0)
        elif mode == "int8x3":
            hi = qa[s:e] @ ta.T
            mid = qa[s:e] @ tb.T + qb[s:e] @ ta.T
            cr = (hi.astype(np.float32) * 127.0 + mid.astype(np.float32)) / (
                127.0**3
            )
        elif mode.startswith("trunc"):
            # f32 cross, then clear the low k mantissa bits of d2 — the
            # packed-argmin-key epilogue would quantize exactly like this.
            cr = qd[s:e] @ td.T
        else:
            raise ValueError(mode)
        d2 = tnorm[None, :] - 2.0 * cr
        if mode.startswith("trunc"):
            k = int(mode[5:])
            bits = d2.view(np.int32)
            d2 = (bits & np.int32(~((1 << k) - 1))).view(np.float32)
        out[s:e] = np.argmin(d2, axis=1)
    return out


def main():
    n = int(os.environ.get("TPU3D_NPQ_N", "16384"))
    voxel = float(os.environ.get("TPU3D_NPQ_VOXEL", "0.005"))
    src_np, tgt_np, R_true, t_true = make_pair(n, voxel=voxel)
    radius = jnp.float32(voxel * 5)
    src, src_f = jax.jit(
        lambda c: fused_prepare_features(c, radius)
    )(PointCloud.from_numpy(src_np, capacity=n))
    tgt, tgt_f = jax.jit(
        lambda c: fused_prepare_features(c, radius)
    )(PointCloud.from_numpy(tgt_np, capacity=n))
    qd = np.asarray(src_f.descriptors, np.float32)
    td = np.asarray(tgt_f.descriptors, np.float32)
    sp = np.asarray(src.points, np.float32)
    tp = np.asarray(tgt.points, np.float32)
    thr = 1.5 * voxel
    true_pos = sp @ R_true.T + t_true

    modes = [
        "f64", "f32", "bf16x3", "bf16x3n", "int8x3", "trunc10", "trunc13",
        "trunc16", "int8x1", "bf16x1", "dev:F32_F32_F32",
        "dev:TF32_TF32_F32_X3", "dev:TF32_TF32_F32", "dev:BF16_BF16_F32_X3",
    ]
    ref = None
    res = {}
    for mode in modes:
        idx = cross_chunked(qd, td, mode)
        d = np.linalg.norm(true_pos - tp[idx], axis=1)
        quality = float((d < thr).mean())
        if ref is None:
            ref = idx
        agree = float((idx == ref).mean())
        res[mode] = {"quality": round(quality, 4), "idx_agree": round(agree, 4)}
        print(
            f"{mode:8s} quality {quality:.4f}  idx-agree-vs-f64 {agree:.4f}",
            file=sys.stderr, flush=True,
        )
    d = jax.devices()[0]
    print(json.dumps({"n": n, "voxel": voxel, "modes": res,
                      "device": {"platform": d.platform,
                                 "kind": d.device_kind}}))


if __name__ == "__main__":
    main()
