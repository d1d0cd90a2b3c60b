"""Benchmark: full registration throughput on one GPU.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
Diagnostics go to stderr. With no GPU visible the bench exits nonzero
without a result: a CPU timing is not a device number.

Headline metric (BASELINE.json): registration pairs/sec at 100k points —
the full FPFH + RANSAC + ICP stack (reference workload defaults: 100k RANSAC
hypotheses, ICP to convergence capped at 200, FPFH radius 5×voxel) on a
synthetic bumpy-surface pair with a known rigid offset, on the engines the
library picks (tpu3d/utils/platform.py). Every timing ends in
``jax.block_until_ready``; the value is the median of the timed reps.

vs_baseline: speedup over the single-thread CPU reference path. The
reference binary needs OpenCV/GLFW/realsense and can't build here, so the
CPU denominator is *measured* from the NumPy oracle (a faithful
transliteration of registration.cpp, see tpu3d/oracle.py) at a reduced size
and extrapolated by the known O(N²)/O(H·N) scaling of each stage; the
measurement is cached in BASELINE_CPU.json with its derivation.

Env knobs: TPU3D_BENCH_N (default 100352), TPU3D_BENCH_RANSAC (default
100000), TPU3D_BENCH_ICP (default 200), TPU3D_BENCH_EST_CAP (default 2048),
TPU3D_BENCH_CORR_CAP (default 2048), TPU3D_BENCH_SRC_CAP (default 4096),
TPU3D_BENCH_REPS (default 5), TPU3D_BENCH_EXACT (default 1: also time the
exact envelope on stderr).

The correspondence/ICP-source subset caps run TIGHTER here than the
library defaults (8192/16384); benchmarks/ab_stats.py and
benchmarks/robustness.py read the same env knobs, so their quality gates
cover exactly this configuration.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)
_CPU_BASELINE_PATH = os.path.join(_REPO, "BASELINE_CPU.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_caps() -> tuple[int, int]:
    """(corr_cap, src_cap) for the headline configuration — shared with
    benchmarks/ab_stats.py and benchmarks/robustness.py so the quality
    gates validate the exact caps the bench runs. Library defaults stay
    8192/16384."""
    return (
        int(os.environ.get("TPU3D_BENCH_CORR_CAP", "2048")),
        int(os.environ.get("TPU3D_BENCH_SRC_CAP", "4096")),
    )


def bench_est_cap() -> int:
    """RANSAC in-chunk estimate subset (ops/ransac.py ``est_cap``)."""
    return int(os.environ.get("TPU3D_BENCH_EST_CAP", "2048"))


def make_pair(n: int, seed: int = 0, voxel: float = 0.005):
    """Bumpy-surface pair with curvature at the FPFH-radius (5×voxel) scale
    so descriptors are discriminative — a flat/slowly-varying surface makes
    FPFH degenerate regardless of implementation (same failure as the
    reference's planar demo scene)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    r = 5.0 * voxel
    w1, w2, w3 = 1.2 / r, 0.9 / r, 0.35 / r
    z = (
        0.7
        + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(w1 * 0.8 * xy[:, 1])
        + 4.0 * voxel * np.sin(w2 * xy[:, 0] + 1.3) * np.sin(w2 * 0.7 * xy[:, 1])
        + 8.0 * voxel * np.cos(w3 * xy[:, 0] - 0.4) * np.cos(w3 * 1.1 * xy[:, 1])
    )
    tgt = np.column_stack([xy, z]).astype(np.float32)
    aa = np.array([0.08, -0.06, 0.1])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)
    t = np.array([0.02, -0.015, 0.01], np.float32)
    src = ((tgt - t) @ R).astype(np.float32)
    return src, tgt, R, t


def measure_cpu_baseline(n_target: int, ransac_iters: int, icp_iters: int) -> dict:
    """Measure the oracle (CPU reference transliteration) at a small size and
    extrapolate to the benchmark size by each stage's complexity."""
    # Multi-entry cache keyed by (n_target, ransac_iters): the quick-bench
    # config must not clobber the 100k entry (it did in r4, forcing a
    # re-measure under concurrent pytest load that inflated the oracle 28%
    # and so the speedup claim). Legacy single-entry files are absorbed.
    entries = []
    if os.path.exists(_CPU_BASELINE_PATH):
        with open(_CPU_BASELINE_PATH) as f:
            cached = json.load(f)
        entries = cached["entries"] if "entries" in cached else [cached]
        for e in entries:
            if (
                e.get("n_target") == n_target
                and e.get("ransac_iters") == ransac_iters
            ):
                return e

    from tpu3d import oracle

    n_small = 1500
    src, tgt, _, _ = make_pair(n_small, seed=3)
    times = {}

    def best_of(fn, reps=3):
        """min-of-N timing — single-shot small-sample timings vary ~2x with
        host load, which would make vs_baseline noisy between runs."""
        best = float("inf")
        out = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return best, out

    times["normals_small_s"], normals = best_of(
        lambda: oracle.estimate_normals(tgt, k=30)
    )  # O(N²)

    times["fpfh_small_s"], _ = best_of(
        lambda: oracle.compute_fpfh(tgt[:400], normals[:400], 0.01)
    )  # O(N²) at n=400

    # RANSAC: per-iteration cost is O(N) scoring; feature NN is O(N·M·33).
    def score200():
        for _ in range(200):
            oracle.score_hypothesis(np.eye(3, dtype=np.float32),
                                    np.zeros(3, np.float32), src, tgt, 0.003)

    times["ransac_200score_small_s"], _ = best_of(score200)

    # ICP: one iteration is O(N·M) NN + solve.
    times["icp_2iter_small_s"], _ = best_of(
        lambda: oracle.icp_refine(src, tgt, normals,
                                  np.eye(4, dtype=np.float32), 0.05,
                                  max_iterations=2, point_to_plane=True)
    )

    s = n_target / n_small
    est = {
        "normals_s": times["normals_small_s"] * s * s,
        "fpfh_s": times["fpfh_small_s"] * (n_target / 400) ** 2,
        "ransac_s": times["ransac_200score_small_s"] / 200 * ransac_iters * s
        + 33 * n_target * n_target / 1e9,  # feature NN at ~1 GFLOP/s scalar C++
        "icp_s": times["icp_2iter_small_s"] / 2 * min(icp_iters, 30) * s * s,
    }
    # ×2: both clouds get normals+FPFH in the reference pipeline; we bench
    # one prepared target + one full source prep, matching register_pair's
    # per-instance cost (target prep is amortized) — use 1× here
    # (conservative in the CPU's favor).
    total = est["normals_s"] + est["fpfh_s"] + est["ransac_s"] + est["icp_s"]
    out = {
        "n_target": n_target,
        "ransac_iters": ransac_iters,
        "measured_small": times,
        "extrapolated": est,
        "cpu_pair_seconds": total,
        "method": (
            "NumPy-oracle transliteration of registration.cpp measured at "
            "n=1500 (n=400 for FPFH), extrapolated by stage complexity "
            "(normals/FPFH/ICP O(N^2), RANSAC O(H*N) + feature-NN O(N*M*33)); "
            "ICP capped at 30 effective iterations (observed convergence)."
        ),
    }
    entries.append(out)
    with open(_CPU_BASELINE_PATH, "w") as f:
        json.dump({"entries": entries}, f, indent=2)
    return out


def device_info() -> dict:
    """The device the numbers come from, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(fn, *args, reps: int) -> list[float]:
    """Seconds per call, each call run to completion on the device."""
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def main():
    n = int(os.environ.get("TPU3D_BENCH_N", "100352"))
    ransac_iters = int(os.environ.get("TPU3D_BENCH_RANSAC", "100000"))
    icp_iters = int(os.environ.get("TPU3D_BENCH_ICP", "200"))
    reps = int(os.environ.get("TPU3D_BENCH_REPS", "5"))
    corr_cap, src_cap = bench_caps()
    est_cap = bench_est_cap()

    import jax
    import jax.numpy as jnp

    from tpu3d.utils.platform import enable_compile_cache

    enable_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu":
        log(f"no GPU visible (devices: {jax.devices()}); a bench on "
            f"{dev['platform']} is not a device measurement")
        sys.exit(2)

    from tpu3d.ops.fused_features import (
        fused_prepare_features,
        fused_prepare_sparse,
    )
    from tpu3d.ops.icp import build_icp_target, icp_refine
    from tpu3d.ops.ransac import ransac_registration
    from tpu3d.registration import sparse_prepare_active
    from tpu3d.config import RegistrationConfig
    from tpu3d.types import PointCloud

    log(f"devices={jax.devices()}")
    log(f"pair size n={n}, ransac={ransac_iters}, icp<= {icp_iters}")

    voxel = 0.002
    src_np, tgt_np, R_true, t_true = make_pair(n)
    # Target prep (amortized in the pipeline): features and the ICP slab
    # index are per-model structures (pipeline.cpp:291-294 vs :92-95).
    tgt, tgt_feat = fused_prepare_features(
        PointCloud.from_numpy(tgt_np, capacity=n), jnp.float32(voxel * 5)
    )
    tgt_index = jax.jit(build_icp_target)(tgt)
    src_cloud = PointCloud.from_numpy(src_np, capacity=n)
    # The library's own choice: the sparse source prepare where
    # registration.sparse_prepare_active enables it (descriptors only for
    # the blocks the correspondence subset reads, each one exact).
    sparse = sparse_prepare_active(RegistrationConfig(), "fused", n)
    log(f"prepare mode: {'sparse' if sparse else 'dense'}")

    def full_pair(src_pts, src_mask):
        source = PointCloud(points=src_pts, mask=src_mask)
        if sparse:
            sub_c, sub_f, _ = fused_prepare_sparse(
                source, jnp.float32(voxel * 5), corr_cap=corr_cap
            )
            coarse = ransac_registration(
                sub_c, tgt, sub_f, tgt_feat, voxel,
                max_iterations=ransac_iters, corr_mode="exact",
                est_cap=est_cap,
            )
        else:
            source, sfeat = fused_prepare_features(
                source, jnp.float32(voxel * 5)
            )
            coarse = ransac_registration(
                source, tgt, sfeat, tgt_feat, voxel,
                max_iterations=ransac_iters, corr_cap=corr_cap,
                est_cap=est_cap,
            )
        refined = icp_refine(
            source, tgt, coarse.transformation, voxel * 0.4,
            max_iterations=icp_iters, point_to_plane=True,
            target_index=tgt_index, src_cap=src_cap,
        )
        return refined.transformation, refined.fitness, refined.rmse

    jitted = jax.jit(full_pair)
    t0 = time.perf_counter()
    T, fit, rmse = jax.block_until_ready(
        jitted(src_cloud.points, src_cloud.mask)
    )
    T_np = np.asarray(T)
    log(f"compile+first run: {time.perf_counter() - t0:.1f}s "
        f"fitness={float(fit):.3f} rmse={float(rmse):.6f}")
    rot_err = np.abs(T_np[:3, :3] - R_true).max()
    trn_err = np.abs(T_np[:3, 3] - t_true).max()
    log(f"pose error: rot {rot_err:.4f}, trans {trn_err:.5f} m")
    quality_ok = rot_err < 0.02 and trn_err < 0.005

    times = timed(jitted, src_cloud.points, src_cloud.mask, reps=reps)
    pair_s = statistics.median(times)
    log(f"pair times: {['%.5f' % t for t in times]} s "
        f"(median {pair_s * 1000:.3f} ms)")

    cpu = measure_cpu_baseline(n, ransac_iters, icp_iters)
    speedup = cpu["cpu_pair_seconds"] / pair_s
    log(f"cpu reference (extrapolated oracle): {cpu['cpu_pair_seconds']:.0f}s"
        f" → speedup {speedup:.0f}x; quality_ok={quality_ok}")
    if not quality_ok:
        log("pose gate failed — no result")
        sys.exit(1)
    print(
        json.dumps(
            {
                "metric": f"registration_pairs_per_sec_{n}pts",
                "value": 1.0 / pair_s,
                "unit": "pairs/s",
                "vs_baseline": speedup,
                "device": dev,
            }
        ),
        flush=True,
    )

    # EXACT envelope: dense prepare + corr_mode='exact' + src_mode='exact'
    # + single-stage scoring — the zero-statistical-shortcut configuration
    # (PARITY.md "exactness knobs"). stderr only; TPU3D_BENCH_EXACT=0 skips.
    if os.environ.get("TPU3D_BENCH_EXACT", "1") == "1":
        def exact_pair(src_pts, src_mask):
            source = PointCloud(points=src_pts, mask=src_mask)
            source, sfeat = fused_prepare_features(
                source, jnp.float32(voxel * 5)
            )
            coarse = ransac_registration(
                source, tgt, sfeat, tgt_feat, voxel,
                max_iterations=ransac_iters, corr_mode="exact",
                two_stage=False,
            )
            refined = icp_refine(
                source, tgt, coarse.transformation, voxel * 0.4,
                max_iterations=icp_iters, point_to_plane=True,
                target_index=tgt_index, src_mode="exact",
            )
            return refined.transformation, refined.fitness, refined.rmse

        je = jax.jit(exact_pair)
        Te, fit_e, _ = jax.block_until_ready(
            je(src_cloud.points, src_cloud.mask)
        )
        e_times = timed(je, src_cloud.points, src_cloud.mask, reps=3)
        Te_np = np.asarray(Te)
        log(
            f"exact envelope: {statistics.median(e_times) * 1000:.3f} "
            f"ms/pair (median of 3), fitness {float(fit_e):.3f}, pose err "
            f"rot {np.abs(Te_np[:3, :3] - R_true).max():.4f} trans "
            f"{np.abs(Te_np[:3, 3] - t_true).max():.5f}"
        )


if __name__ == "__main__":
    main()
