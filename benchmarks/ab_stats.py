"""A/B harness for the statistical shortcuts (VERDICT r2 item 5).

Quantifies, across >=20 seeds at bench scale (100k points), what the
estimate-based selection actually costs vs exact evaluation:

  1. est-winner miss: chunked RANSAC with in-chunk ESTIMATE scoring +
     exact top-16 rescore (the default) vs the SAME chunk stream scored
     EXACTLY — identical correspondences and hypothesis draws, so any
     fitness difference is precisely the estimate-selection loss
     (ops/ransac.py est_cap path; semantics of registration.cpp:284-290).
  2. false early exit: whether the estimate-driven confidence cutoff
     (fitness_est > confidence) fires when the exact path's does not.
  3. statistical-vs-exact END POSE: the full default pipeline
     (corr_mode/src_mode auto, estimate scoring) vs the all-exact pipeline
     (corr_mode='exact', src_mode='exact', two_stage=False) — pose and
     fitness deltas after ICP.

Run on the GPU:  python benchmarks/ab_stats.py
Prints one JSON line; exit 0 iff gates pass. TPU3D_AB_SEEDS overrides the
seed count.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax.numpy as jnp  # noqa: E402

from bench import bench_caps, bench_est_cap, make_pair  # noqa: E402
from tpu3d.ops.fused_features import (  # noqa: E402
    fused_prepare_features,
    fused_prepare_sparse,
)
from tpu3d.ops.icp import icp_refine  # noqa: E402
from tpu3d.ops.ransac import ransac_registration  # noqa: E402
from tpu3d.registration import sparse_register_escalated  # noqa: E402
from tpu3d.types import PointCloud  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    n = 100352
    voxel = 0.002
    n_seeds = int(os.environ.get("TPU3D_AB_SEEDS", "20"))
    radius = jnp.float32(voxel * 5)
    confidence = 0.999
    # Headline-config caps (bench.py bench_caps) — the sparse-path items
    # (4)/(5) below validate the exact configuration the bench times.
    corr_cap, src_cap = bench_caps()
    est_cap = bench_est_cap()

    rows = []
    for seed in range(n_seeds):
        src_np, tgt_np, R_true, t_true = make_pair(n, seed=seed, voxel=voxel)
        rng = np.random.default_rng(seed + 5000)
        # Half the seeds get 0.25-voxel noise: pushes fitness off 1.0 into
        # the near-tie plateau where estimate selection could actually err.
        noisy = seed % 2 == 1
        if noisy:
            src_np = src_np + rng.normal(0, 0.25 * voxel, src_np.shape
                                         ).astype(np.float32)
            tgt_np = tgt_np + rng.normal(0, 0.25 * voxel, tgt_np.shape
                                         ).astype(np.float32)
        src = PointCloud.from_numpy(src_np, capacity=n)
        tgt = PointCloud.from_numpy(tgt_np, capacity=n)
        src_p, src_f = fused_prepare_features(src, radius)
        tgt_p, tgt_f = fused_prepare_features(tgt, radius)

        # (1)+(2): same draws/correspondences, estimate vs exact scoring.
        est = ransac_registration(
            src_p, tgt_p, src_f, tgt_f, voxel, max_iterations=100000,
            seed=seed, confidence=confidence,
        )  # est_cap=2048 default -> in-chunk estimate scoring
        exact_sc = ransac_registration(
            src_p, tgt_p, src_f, tgt_f, voxel, max_iterations=100000,
            seed=seed, confidence=confidence, est_cap=8192,
        )  # 8192 < 2*8192 -> exact chunk scoring, same stream
        fit_est = float(est.fitness)
        fit_exc = float(exact_sc.fitness)

        # (3): default statistical pipeline vs all-exact pipeline.
        ref_a = icp_refine(src_p, tgt_p, est.transformation, voxel * 0.4,
                           max_iterations=200)
        # Reported-fitness fidelity AT THE SAME POSE: a 1-iteration exact
        # run at ref_a's returned pose measures the exact full-cloud
        # fitness there (metrics are pre-update, registration.cpp:401-404).
        # |fit_icp_auto − this| is the estimator/reporting error item — the
        # cross-pipeline fit_icp_auto vs fit_icp_exact delta below mixes in
        # pose divergence (two arms settle in different noise-tube minima,
        # r3 per_seed: the 0.12 deltas ride 0.75-voxel pose deltas) and is
        # reported informationally, not gated.
        exact_at_a = icp_refine(
            src_p, tgt_p, ref_a.transformation, voxel * 0.4,
            max_iterations=1, src_mode="exact",
        )
        coarse_x = ransac_registration(
            src_p, tgt_p, src_f, tgt_f, voxel, max_iterations=100000,
            seed=seed, corr_mode="exact", two_stage=False,
            early_exit=False,
        )
        ref_x = icp_refine(src_p, tgt_p, coarse_x.transformation,
                           voxel * 0.4, max_iterations=200,
                           src_mode="exact")
        # (4): sparse-prepare subset pipeline (the bench default at scale,
        # bench.py full_pair) — block-strided exact-descriptor subset into
        # RANSAC corr_mode='exact', ICP from the raw source. Judged against
        # the TRUE pose on the same scales as the default pipeline: the
        # only new variable vs (3)'s corr_mode='auto' is the subset's
        # spatial stratification (block patches vs row stride).
        sub_c, sub_f, _ = fused_prepare_sparse(src, radius,
                                               corr_cap=corr_cap)
        coarse_s = ransac_registration(
            sub_c, tgt_p, sub_f, tgt_f, voxel, max_iterations=100000,
            seed=seed, confidence=confidence, corr_mode="exact",
            est_cap=est_cap,
        )  # sampling='auto' -> gather-free rotation draws on this path
        # (5): sampling design A/B — the SAME subset/correspondences with
        # the reference-shaped iid 'gather' draws. Isolates the rotation
        # sampler: coarse fitness must agree to sampling noise.
        coarse_g = ransac_registration(
            sub_c, tgt_p, sub_f, tgt_f, voxel, max_iterations=100000,
            seed=seed, confidence=confidence, corr_mode="exact",
            sampling="gather", est_cap=est_cap,
        )
        # The PRODUCT sparse arm (register_pair's composition): sparse
        # prepare + RANSAC + ICP, with the below-min_fitness escalation
        # through the full-prepare auto arm
        # (registration.sparse_register_escalated — a loud-failure
        # restart; clean scenes never trigger it). The gates consume
        # what production consumes.
        ref_s, _, esc_s = sparse_register_escalated(
            src, tgt_p, tgt_f, voxel=voxel, radius=radius,
            corr_cap=corr_cap, est_cap=est_cap, src_cap=src_cap,
            max_iterations=100000, confidence=confidence, seed=seed,
            escalate_below=0.3,
        )
        # Sparse-arm reported-fitness fidelity at ITS pose (the number the
        # min_fitness gate consumes on the bench configuration) — same
        # probe as exact_at_a above.
        exact_at_s = icp_refine(
            src, tgt_p, ref_s.transformation, voxel * 0.4,
            max_iterations=1, src_mode="exact",
        )
        Ts = np.asarray(ref_s.transformation)
        rot_true_s = float(np.abs(Ts[:3, :3] - R_true).max())
        trn_true_s = float(np.abs(Ts[:3, 3] - t_true).max())

        Ta = np.asarray(ref_a.transformation)
        Tx = np.asarray(ref_x.transformation)
        rot_d = float(np.abs(Ta[:3, :3] - Tx[:3, :3]).max())
        trn_d = float(np.abs(Ta[:3, 3] - Tx[:3, 3]).max())
        rot_true = float(np.abs(Ta[:3, :3] - R_true).max())
        trn_true = float(np.abs(Ta[:3, 3] - t_true).max())
        rot_true_x = float(np.abs(Tx[:3, :3] - R_true).max())
        trn_true_x = float(np.abs(Tx[:3, 3] - t_true).max())

        row = {
            "seed": seed,
            "noisy": noisy,
            "fit_est_sel": round(fit_est, 5),
            "fit_exact_sel": round(fit_exc, 5),
            "winner_fit_delta": round(fit_exc - fit_est, 5),
            "early_exit_est": fit_est > confidence,
            "early_exit_exact": fit_exc > confidence,
            "pose_rot_delta_vs_exact": round(rot_d, 6),
            "pose_trn_delta_vs_exact": round(trn_d, 7),
            "pose_rot_err_true": round(rot_true, 6),
            "pose_trn_err_true": round(trn_true, 7),
            "pose_rot_err_true_exact": round(rot_true_x, 6),
            "pose_trn_err_true_exact": round(trn_true_x, 7),
            "fit_icp_auto": round(float(ref_a.fitness), 5),
            "fit_icp_auto_exact_at_pose": round(float(exact_at_a.fitness), 5),
            "fit_icp_exact": round(float(ref_x.fitness), 5),
            "pose_rot_err_true_sparse": round(rot_true_s, 6),
            "pose_trn_err_true_sparse": round(trn_true_s, 7),
            "fit_icp_sparse": round(float(ref_s.fitness), 5),
            "fit_icp_sparse_exact_at_pose": round(
                float(exact_at_s.fitness), 5
            ),
            "sparse_escalated": bool(esc_s),
            "fit_coarse_rotation": round(float(coarse_s.fitness), 5),
            "fit_coarse_gather": round(float(coarse_g.fitness), 5),
        }
        rows.append(row)
        log(row)

    miss = [r for r in rows if r["winner_fit_delta"] > 1e-4]
    # Direction matters: est exiting when exact would NOT (premature stop,
    # possibly a worse prefix winner) is the dangerous case; est NOT
    # exiting when exact would (0.9988 est vs 0.9990 exact at the 0.999
    # line) just does a little more work — report it, don't gate it.
    false_exit = [
        r for r in rows
        if r["early_exit_est"] and not r["early_exit_exact"]
    ]
    missed_exit = [
        r for r in rows
        if r["early_exit_exact"] and not r["early_exit_est"]
    ]
    sigma = 0.25 * voxel
    clean = [r for r in rows if not r["noisy"]]
    noisy_rows = [r for r in rows if r["noisy"]]
    summary = {
        "n_seeds": n_seeds,
        "est_winner_miss_rate": len(miss) / n_seeds,
        "max_winner_fit_delta": max(r["winner_fit_delta"] for r in rows),
        "false_early_exit_rate": len(false_exit) / n_seeds,
        "missed_early_exit_rate": len(missed_exit) / n_seeds,
        "max_pose_rot_delta_vs_exact": max(
            r["pose_rot_delta_vs_exact"] for r in rows
        ),
        "max_pose_trn_delta_vs_exact": max(
            r["pose_trn_delta_vs_exact"] for r in rows
        ),
        "max_pose_rot_err_true_clean": max(
            (r["pose_rot_err_true"] for r in clean), default=0.0
        ),
        "max_pose_trn_err_true_clean": max(
            (r["pose_trn_err_true"] for r in clean), default=0.0
        ),
        "max_pose_rot_err_true_noisy": max(
            (r["pose_rot_err_true"] for r in noisy_rows), default=0.0
        ),
        "max_pose_trn_err_true_noisy": max(
            (r["pose_trn_err_true"] for r in noisy_rows), default=0.0
        ),
        # Reported fitness vs exact AT THE SAME POSE (the number the
        # min_fitness gate consumes — see the exact_at_a note above). With
        # icp_refine's final_metrics='auto' subset re-score at the returned
        # pose this is the subset's sampling error (sigma ~0.4% at 16k
        # rows); >0.02 means the reporting path regressed.
        "max_icp_fit_delta_clean": max(
            (abs(r["fit_icp_auto"] - r["fit_icp_auto_exact_at_pose"])
             for r in clean),
            default=0.0,
        ),
        "max_icp_fit_delta_noisy": max(
            (abs(r["fit_icp_auto"] - r["fit_icp_auto_exact_at_pose"])
             for r in noisy_rows),
            default=0.0,
        ),
        # Cross-pipeline fitness spread (auto/sparse arm vs all-exact arm).
        # GATED since r5 (VERDICT r4 item 3): the adaptive exact polish
        # (ops/icp.py `polish`) continues borderline-fitness subset runs
        # with full-source iterations, so every arm's converged pose is
        # exact-class where the min_fitness warn decision
        # (pipeline.cpp:131-134) is live — the residual spread is local-
        # minimum wander of the EXACT iteration under noise, not a
        # subset artifact.
        "max_icp_fit_cross_pipeline_clean": max(
            (abs(r["fit_icp_auto"] - r["fit_icp_exact"]) for r in clean),
            default=0.0,
        ),
        "max_icp_fit_cross_pipeline_noisy": max(
            (abs(r["fit_icp_auto"] - r["fit_icp_exact"])
             for r in noisy_rows),
            default=0.0,
        ),
        "max_icp_fit_sparse_cross_clean": max(
            (abs(r["fit_icp_sparse"] - r["fit_icp_exact"]) for r in clean),
            default=0.0,
        ),
        "max_icp_fit_sparse_cross_noisy": max(
            (abs(r["fit_icp_sparse"] - r["fit_icp_exact"])
             for r in noisy_rows),
            default=0.0,
        ),
        # Sparse-arm reported fitness vs exact AT THE SAME POSE — the
        # direct analog of max_icp_fit_delta_* for the bench-default arm.
        "max_icp_fit_sparse_at_pose_delta": max(
            (abs(r["fit_icp_sparse"] - r["fit_icp_sparse_exact_at_pose"])
             for r in rows),
            default=0.0,
        ),
        # How much WORSE than the all-exact pipeline is the statistical
        # one, against ground truth (can be negative = better)?
        "max_trn_excess_vs_exact": max(
            r["pose_trn_err_true"] - r["pose_trn_err_true_exact"]
            for r in rows
        ),
        "max_rot_excess_vs_exact": max(
            r["pose_rot_err_true"] - r["pose_rot_err_true_exact"]
            for r in rows
        ),
        "mean_trn_excess_vs_exact": float(np.mean([
            r["pose_trn_err_true"] - r["pose_trn_err_true_exact"]
            for r in rows
        ])),
        "mean_trn_excess_sparse_vs_exact": float(np.mean([
            r["pose_trn_err_true_sparse"] - r["pose_trn_err_true_exact"]
            for r in rows
        ])),
        "max_pose_rot_err_true_sparse_clean": max(
            (r["pose_rot_err_true_sparse"] for r in clean), default=0.0
        ),
        "max_pose_trn_err_true_sparse_clean": max(
            (r["pose_trn_err_true_sparse"] for r in clean), default=0.0
        ),
        "max_pose_rot_err_true_sparse_noisy": max(
            (r["pose_rot_err_true_sparse"] for r in noisy_rows),
            default=0.0,
        ),
        "max_pose_trn_err_true_sparse_noisy": max(
            (r["pose_trn_err_true_sparse"] for r in noisy_rows),
            default=0.0,
        ),
        "max_trn_excess_sparse_vs_exact": max(
            r["pose_trn_err_true_sparse"] - r["pose_trn_err_true_exact"]
            for r in rows
        ),
        "max_rot_excess_sparse_vs_exact": max(
            r["pose_rot_err_true_sparse"] - r["pose_rot_err_true_exact"]
            for r in rows
        ),
        # Rotation-vs-gather coarse fitness: same subset, different draw
        # design. Signed mean catches a systematic sampler weakness; the
        # abs max is sampling-luck spread.
        "mean_coarse_fit_rotation_minus_gather": float(np.mean([
            r["fit_coarse_rotation"] - r["fit_coarse_gather"]
            for r in rows
        ])),
        "max_abs_coarse_fit_sampling_delta": max(
            abs(r["fit_coarse_rotation"] - r["fit_coarse_gather"])
            for r in rows
        ),
    }
    # Gates. (a) Estimate selection may pick a near-tie runner-up (the
    # documented sigma-class delta) but must not lose real fitness, and it
    # must never exit EARLIER than exact scoring would. (b) The yardstick
    # for the statistical pipeline is the TRUE pose (robustness.py's
    # scales): at noisy low-fitness scenes auto and exact legitimately
    # settle in different near-truth local minima, so their mutual delta
    # is reported, not gated. (c) Fitness estimates must agree with exact
    # on clean scenes; under noise fitness is a steep function of pose
    # inside the 0.4-voxel tube, so the noisy delta is informational.
    ok = (
        summary["max_winner_fit_delta"] <= 0.01
        and summary["false_early_exit_rate"] == 0.0
        and summary["max_pose_rot_err_true_clean"] <= 1e-3
        and summary["max_pose_trn_err_true_clean"] <= 1e-4
        and summary["max_pose_rot_err_true_noisy"] <= 0.02
        # Under heavy noise the 0.4-voxel inlier tube biases BOTH
        # pipelines by a few noise sigmas (reference semantics — the tube
        # keeps a pose-correlated subsample); the absolute gate reflects
        # that, and the excess-over-exact gate pins the SHORTCUT's own
        # contribution to a fraction of the noise.
        and summary["max_pose_trn_err_true_noisy"] <= 5.0 * sigma + 1e-4
        # Excess-over-exact separates the SHORTCUT's contribution from the
        # noise floor. Under noise ICP settles in a local minimum inside
        # the inlier tube and the per-seed excess is a roughly SYMMETRIC
        # ± wander (see per_seed: half the excesses are negative — the
        # statistical arms land CLOSER to truth than exact on ~half the
        # seeds). The right bias detector is therefore the MEAN excess
        # (gated at 0.5 sigma); the per-seed MAX is a variance statistic
        # with FAT tails (ICP hops between local minima inside the noise
        # tube, so excesses are not Gaussian — 3.5 sigma observed on one
        # seed with zero mean bias), gated at 4 sigma to catch gross
        # outliers. Absolute error vs truth stays gated at 5 sigma above.
        and summary["max_trn_excess_vs_exact"] <= 4.0 * sigma
        and summary["mean_trn_excess_vs_exact"] <= 0.5 * sigma
        and summary["max_rot_excess_vs_exact"] <= 5e-3
        and summary["max_icp_fit_delta_clean"] <= 0.02
        and summary["max_icp_fit_delta_noisy"] <= 0.02
        # Every arm's gate-consumed fitness must stay in the exact
        # pipeline's class (VERDICT r4 item 3; enabled by the adaptive
        # exact polish in ops/icp.py).
        and summary["max_icp_fit_cross_pipeline_noisy"] <= 0.05
        and summary["max_icp_fit_sparse_cross_noisy"] <= 0.05
        and summary["max_icp_fit_sparse_at_pose_delta"] <= 0.02
        # The sparse-prepare arm rides the SAME gates as the default
        # statistical pipeline — its subset is just stratified by layout
        # block instead of row stride.
        and summary["max_pose_rot_err_true_sparse_clean"] <= 1e-3
        and summary["max_pose_trn_err_true_sparse_clean"] <= 1e-4
        and summary["max_pose_rot_err_true_sparse_noisy"] <= 0.02
        and summary["max_pose_trn_err_true_sparse_noisy"] <= 5.0 * sigma + 1e-4
        and summary["max_trn_excess_sparse_vs_exact"] <= 4.0 * sigma
        and summary["mean_trn_excess_sparse_vs_exact"] <= 0.5 * sigma
        and summary["max_rot_excess_sparse_vs_exact"] <= 5e-3
        # Rotation draws must not be systematically WEAKER than iid
        # gather draws (mean), and per-seed spread stays sampling-scale.
        and summary["mean_coarse_fit_rotation_minus_gather"] >= -0.01
        and summary["max_abs_coarse_fit_sampling_delta"] <= 0.05
    )
    print(json.dumps({**summary, "pass": ok, "per_seed": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
