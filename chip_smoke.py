#!/usr/bin/env python3
"""Run tpu3d's main path once on one GPU and check what comes out.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --multi      # four GPUs: only the sharded path
    python chip_smoke.py --rehearse   # CPU, tiny sizes, kernels interpreted

Phases (one process, one device):

  kernels   each hand-written kernel against the plain XLA formulation of
            the same semantics, at the widths the library runs: the
            normals + FPFH window walk (100,352-point cloud), the radius
            top-1 walk, the ICP correspondence walk, RANSAC hypothesis
            scoring (100,000 hypotheses x 2,048 and x 8,192 rows) and the
            33-D feature NN (8,192 and 100,352 queries x 100,352 targets);
  register  ``register_pair`` on the 100,352-point bench pair with the
            default RegistrationConfig at voxel 0.002, once with dense and
            once with sparse source prepare, against the known pose;
  pipeline  ``Pipeline.run`` with the values of config/pipeline_config.yaml
            (procedural 1280x720 scene, voxel 0.001, no camera, no robot,
            no viewer), once with its dummy grid model and once with the
            part's own model at voxel 0.005: every mask posed, no host ICP
            retry, and against the part model fitness at or above
            min_fitness.

Each phase prints its compile seconds, ``peak_bytes_in_use`` and every
comparison beside its tolerance. Any failed phase makes the exit code
nonzero, and then the last line is not the OK line. With no GPU the script
exits nonzero before any phase (``--rehearse`` excepted, which never prints
the OK line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

FAILURES: list[str] = []


def say(*a):
    print(*a, flush=True)


def check(name: str, ok: bool, detail: str):
    say(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        FAILURES.append(name)


def card_line() -> str:
    """Card name and power limit, read by nvidia-smi in a child process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def memory_peak():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phase:
    """Prints a phase header and, at the end, wall/compile seconds and
    peak device memory."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        say(f"\n== phase {self.name} ==")
        self.t0 = time.perf_counter()
        self.failed_before = len(FAILURES)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            say(f"  [FAIL] {self.name} raised {exc_type.__name__}: {exc}")
            FAILURES.append(self.name)
        say(f"  phase {self.name}: {time.perf_counter() - self.t0:.1f} s "
            f"wall, peak_bytes_in_use={memory_peak()}")
        return True  # the next phase still runs


def first_and_steady(fn, *args):
    """(first-call seconds incl. compile, steady-call seconds, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return first, time.perf_counter() - t0, out


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# Phase 1: kernels vs the plain XLA formulation
# ---------------------------------------------------------------------------


def phase_kernels(n: int, n_hyp: int, interpret: bool = False):
    """Every kernel against its XLA formulation at ``n`` points."""
    import jax
    import jax.numpy as jnp

    from bench import make_pair
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import build_icp_target, fused_slab_stats_fn
    from tpu3d.ops.nn_pallas import nearest_neighbor
    from tpu3d.ops.nn_walk import slab2_top1
    from tpu3d.ops.ransac import build_scoring_factors, score_w16
    from tpu3d.types import PointCloud

    voxel = 0.002
    r = jnp.float32(voxel * 5)
    src_np, tgt_np, R, t = make_pair(n)
    tgt = PointCloud.from_numpy(tgt_np, capacity=n)
    src = PointCloud.from_numpy(src_np, capacity=n)
    kw = dict(engine="triton", interpret=interpret)

    # --- prepare: normals + FPFH at the same (block, sub) ----------------
    def prep(engine, **k):
        return jax.jit(lambda c: fused_prepare_features(
            c, r, block=64, sub=64, engine=engine, **k))

    c_s, t_s, (kc, kf) = first_and_steady(prep(**kw), tgt)
    _, x_s, (xc, xf) = first_and_steady(prep("xla"), tgt)
    say(f"  prepare: kernel first {c_s:.2f} s / steady {t_s * 1e3:.3f} ms;"
        f" xla steady {x_s * 1e3:.3f} ms")
    dots = np.abs(np.sum(np.asarray(kc.normals) * np.asarray(xc.normals), 1))
    frac = float(np.mean(dots >= 1 - 1e-5))
    # Rows whose two smallest covariance eigenvalues (nearly) tie have no
    # well-defined normal; summation order alone can rotate it.
    check("normals", frac >= 0.999,
          f"|n.n_ref| >= 1-1e-5 on {frac:.6f} of rows (need >= 0.999); "
          f"min {dots.min():.6f}")
    diff = np.abs(np.asarray(kf.descriptors) - np.asarray(xf.descriptors))
    row_bad = float(np.mean(diff.max(axis=1) > 1e-5))
    # An angle within a few ulps of a bin threshold can land in the next
    # bin (the engines' atan2/rsqrt differ in the last bits); that moves
    # 1/count of one SPFH, and sweep C spreads it to every FPFH row within
    # the radius (~30 rows here), so flips are counted in rows, not pairs.
    # The largest such change on an H100 was 2.2e-3 (PERF.md); the limit
    # allows about twice that, and a TF32 sweep C fails the row count.
    check("fpfh", row_bad <= 1e-2 and diff.max() <= 5e-3,
          f"rows with a bin off by > 1e-5: {row_bad:.6f} (need <= 1e-2); "
          f"max-abs {diff.max():.3e} (need <= 5e-3)")

    # --- radius top-1 walk --------------------------------------------------
    rad = jnp.float32(2 * voxel)

    def top1(engine, **k):
        return jax.jit(lambda q, m, tp, tm: slab2_top1(
            q, m, tp, tm, rad, engine=engine, **k))

    src_at = src_np @ R.T + t  # source in the target frame
    args = (jnp.asarray(src_at), src.mask, tgt.points, tgt.mask)
    c_s, t_s, (ki, kd) = first_and_steady(top1(**kw), *args)
    _, x_s, (xi, xd) = first_and_steady(top1("xla"), *args)
    say(f"  walk top-1: kernel first {c_s:.2f} s / steady "
        f"{t_s * 1e3:.3f} ms; xla steady {x_s * 1e3:.3f} ms")
    ki, kd, xi, xd = map(np.asarray, (ki, kd, xi, xd))
    hit = xd < 1e29
    same = (ki == xi) | ~hit
    tie = np.abs(kd - xd) <= 1e-6 * np.maximum(xd, 1e-30)
    check("walk top-1", bool(np.all(same | tie)) and
          bool(np.all((kd < 1e29) == hit)) and rel(kd[hit], xd[hit]) <= 1e-6,
          f"index mismatches outside ties {int(np.sum(~(same | tie)))}; "
          f"d2 rel {rel(kd[hit], xd[hit]):.2e} (need <= 1e-6)")

    # --- ICP correspondence walk + normal equations -----------------------
    index = jax.jit(build_icp_target)(xc)
    thr = voxel * 0.4
    T = jnp.asarray(np.block([[R, t[:, None]], [np.zeros((1, 3)), 1]]),
                    jnp.float32)

    def icp(engine, **k):
        return jax.jit(lambda p, m, T: fused_slab_stats_fn(
            index, p, m, thr, True, engine=engine, **k)(T))

    order = np.argsort(src_at[:, 0], kind="stable")
    args = (jnp.asarray(src_np[order]), src.mask, T)
    c_s, t_s, ks = first_and_steady(icp(**kw), *args)
    _, x_s, xs = first_and_steady(icp("xla"), *args)
    say(f"  icp stats: kernel first {c_s:.2f} s / steady {t_s * 1e3:.3f} ms;"
        f" xla steady {x_s * 1e3:.3f} ms; n_corr {float(ks.n_corr):.0f}")
    worst = max(rel(ks.ata, xs.ata), rel(ks.atb, xs.atb),
                rel(ks.n_corr, xs.n_corr), rel(ks.sum_d2, xs.sum_d2))
    check("icp JtJ/Jtr", worst <= 1e-5 and float(ks.n_corr) > 0,
          f"max rel {worst:.2e} (need <= 1e-5)")

    # --- RANSAC hypothesis scoring ----------------------------------------
    rng = np.random.default_rng(1)
    for rows in (min(2048, n // 2), min(8192, n)):
        sel = np.sort(rng.choice(n, rows, replace=False))
        p = jnp.asarray(src_np[sel])
        q = jnp.asarray(tgt_np[sel])
        feat, pq = build_scoring_factors(p, q, jnp.ones(rows, bool))
        # Hypotheses scattered around the true pose, so inlier counts span
        # the whole range and many points sit near the threshold.
        aa = rng.normal(size=(n_hyp, 3)) * 0.003
        th = np.linalg.norm(aa, axis=1, keepdims=True)
        k_ = aa / np.maximum(th, 1e-12)
        Kx = np.zeros((n_hyp, 3, 3))
        Kx[:, 0, 1], Kx[:, 0, 2] = -k_[:, 2], k_[:, 1]
        Kx[:, 1, 0], Kx[:, 1, 2] = k_[:, 2], -k_[:, 0]
        Kx[:, 2, 0], Kx[:, 2, 1] = -k_[:, 1], k_[:, 0]
        s_, c_ = np.sin(th)[:, :, None], np.cos(th)[:, :, None]
        dR = np.eye(3) + s_ * Kx + (1 - c_) * Kx @ Kx
        Rs = (dR @ R).astype(np.float32)
        ts = (t + rng.normal(size=(n_hyp, 3)) * 0.002).astype(np.float32)
        from tpu3d.ops.ransac import pack_hypotheses

        w16, tn = pack_hypotheses(jnp.asarray(Rs), jnp.asarray(ts))
        thr2 = jnp.float32((1.5 * voxel) ** 2)

        def score(engine, **k):
            return jax.jit(lambda f, pq_, w, tn_: score_w16(
                f, pq_, w, tn_, thr2, engine=engine, **k))

        c_s, t_s, (kc_, ke_) = first_and_steady(score(**kw), feat, pq, w16,
                                                tn)
        _, x_s, (xc_, xe_) = first_and_steady(score("xla"), feat, pq, w16,
                                              tn)
        say(f"  score {n_hyp}x{rows}: kernel first {c_s:.2f} s / steady "
            f"{t_s * 1e3:.3f} ms; xla steady {x_s * 1e3:.3f} ms")
        # Reference: the direct residual |R p + t - q|^2 in float64 on a
        # sample of hypotheses. Both engines evaluate the rank-16 expansion
        # in f32, whose terms are O(|p|^2) while err2 ~ thr2 is five orders
        # smaller; a point counts as ambiguous when its exact err2 lies
        # within the error bound of a 16-term f32 FMA chain on rounded
        # factors (20 u sum|terms|) of thr2.
        hs = rng.choice(n_hyp, 256, replace=False)
        f64 = np.asarray(feat, np.float64)
        w64 = np.asarray(w16, np.float64)[:, hs]
        pq64 = np.asarray(pq, np.float64)
        tn64 = np.asarray(tn, np.float64)[hs]
        res = (np.einsum("hij,nj->nhi", Rs[hs].astype(np.float64),
                         np.asarray(p, np.float64))
               + ts[hs].astype(np.float64)[None]
               - np.asarray(q, np.float64)[:, None])
        e2 = np.sum(res * res, axis=2)  # (rows, 256)
        delta = 20 * 2.0 ** -24 * (np.abs(f64).T @ np.abs(w64)
                                   + pq64[:, None] + tn64[None])
        t2 = float(thr2)
        lo_c = np.sum(e2 < t2 - delta, axis=0)
        hi_c = np.sum(e2 < t2 + delta, axis=0)
        # Where the band is empty the count must be exact.
        for eng, cnt in (("kernel", kc_), ("xla", xc_)):
            c = np.asarray(cnt)[hs]
            inside = (c >= lo_c) & (c <= hi_c)
            check(f"score x{rows} {eng}", bool(np.all(inside)),
                  f"counts within the f64 ambiguity band on "
                  f"{np.mean(inside):.4f} of 256 sampled hypotheses "
                  f"(need 1.0); mean band width "
                  f"{np.mean(hi_c - lo_c):.1f} rows, empty (exact count "
                  f"required) on {np.mean(hi_c == lo_c):.4f}")
        kc_, xc_ = np.asarray(kc_), np.asarray(xc_)
        say(f"  score x{rows}: kernel vs xla identical counts on "
            f"{np.mean(kc_ == xc_):.4f} of hypotheses, max |dcount| "
            f"{np.abs(kc_ - xc_).max():.0f}")

    # --- 33-D feature NN ----------------------------------------------------
    sd = np.asarray(kf.descriptors)  # target descriptors
    _, sf = jax.jit(lambda c: fused_prepare_features(c, r, **kw))(src)
    qd_all = np.asarray(sf.descriptors)
    for nq in (min(8192, n), n):
        qd = jnp.asarray(qd_all[np.linspace(0, n - 1, nq).astype(int)])

        def fnn(engine, **k):
            return jax.jit(lambda a, b, m: nearest_neighbor(
                a, b, m, engine=engine, **k))

        args = (qd, jnp.asarray(sd), tgt.mask)
        c_s, t_s, (ki, kd) = first_and_steady(fnn(**kw), *args)
        _, x_s, (xi, xd) = first_and_steady(fnn("xla"), *args)
        say(f"  feature NN {nq}x{n}x33: kernel first {c_s:.2f} s / steady "
            f"{t_s * 1e3:.3f} ms; xla steady {x_s * 1e3:.3f} ms")
        ki, xi = np.asarray(ki), np.asarray(xi)
        bad = np.nonzero(ki != xi)[0]
        q64 = np.asarray(qd, np.float64)[bad]
        tk = sd[ki[bad]].astype(np.float64)
        tx = sd[xi[bad]].astype(np.float64)
        dk = np.sum((q64 - tk) ** 2, axis=1)
        dx = np.sum((q64 - tx) ** 2, axis=1)
        # Both engines expand d2 = |q|^2 - 2 q.t + |t|^2 in f32 (33 products
        # plus two norms), each within ~40 u (|q| + |t|)^2 of the exact
        # value; two candidates closer than the sum of both bounds are a
        # tie, and synthetic FPFH has many exactly duplicated descriptors.
        u = 2.0 ** -24
        nq_ = np.sqrt(np.sum(q64 ** 2, 1))
        bound = 40 * u * ((nq_ + np.sqrt(np.sum(tk ** 2, 1))) ** 2
                          + (nq_ + np.sqrt(np.sum(tx ** 2, 1))) ** 2)
        near_tie = np.abs(dk - dx) <= bound
        dup = np.all(tk == tx, axis=1)
        check(f"feature NN x{nq}", bool(np.all(near_tie)),
              f"differing rows {len(bad)} of {nq} ({np.mean(dup) if len(bad) else 0:.3f} of "
              f"them pick identical descriptors); all near-ties within "
              f"the f32 expansion bound: {bool(np.all(near_tie))}")


# ---------------------------------------------------------------------------
# Phase 2: register_pair on the bench pair
# ---------------------------------------------------------------------------


def pose_gate(name, refined, R, t):
    T = np.asarray(refined.transformation)
    rot = float(np.abs(T[:3, :3] - R).max())
    trn = float(np.abs(T[:3, 3] - t).max())
    fit = float(refined.fitness)
    check(name, rot < 0.02 and trn < 0.005 and fit >= 0.9,
          f"rot err {rot:.5f} (< 0.02), trans err {trn:.6f} m (< 0.005), "
          f"fitness {fit:.4f} (>= 0.9), rmse {float(refined.rmse):.6f}")


def phase_register(n: int, overrides: dict | None = None):
    import jax

    from bench import make_pair
    from tpu3d.config import RegistrationConfig
    from tpu3d.registration import register_pair
    from tpu3d.types import PointCloud

    src_np, tgt_np, R, t = make_pair(n)
    src = PointCloud.from_numpy(src_np)
    tgt = PointCloud.from_numpy(tgt_np)
    for mode in ("dense", "sparse"):
        cfg = RegistrationConfig(voxel_size=0.002, prepare_mode=mode,
                                 **(overrides or {}))
        first, steady, (refined, _) = first_and_steady(
            lambda: register_pair(src, tgt, cfg))
        jax.block_until_ready(refined)
        say(f"  register_pair {mode}: first call {first:.2f} s (compile "
            f"~{first - steady:.2f} s), steady {steady * 1e3:.3f} ms")
        pose_gate(f"register_pair {mode}", refined, R, t)


# ---------------------------------------------------------------------------
# Phase 3: the bin-picking pipeline
# ---------------------------------------------------------------------------


def demo_config(width=1280, height=720, voxel=0.001, ransac=100000,
                icp=200):
    """config/pipeline_config.yaml's values, built in Python (no YAML)."""
    from tpu3d.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.camera.width, cfg.camera.height = width, height
    cfg.depth.scale_to_meters = 1000.0
    cfg.depth.clipping_max = 1.5
    cfg.depth.bilateral_filter = False
    cfg.registration.voxel_size = voxel
    cfg.registration.ransac_max_iterations = ransac
    cfg.registration.icp_max_iterations = icp
    cfg.registration.min_fitness = 0.3
    cfg.use_camera = False
    cfg.use_robot = False
    cfg.use_gpu = True
    cfg.visualization = "none"
    cfg.camera_extrinsics = np.array(
        [0.00705456, 0.99996948, -0.00335601, 0.43244419,
         0.99984465, -0.00710781, -0.01612942, -0.03129219,
         -0.01615278, -0.0032417, -0.99986428, 0.39502932,
         0.0, 0.0, 0.0, 1.0], np.float32).reshape(4, 4)
    return cfg


def scene_model_ply(cfg, path):
    """The part as the procedural scene shows it — the masked box face and
    its floor ring, deprojected — saved as a PLY reference model. Against
    it the true pose is the identity and fitness can reach 1."""
    from tpu3d.models.ply import save_ply
    from tpu3d.models.procedural import generate_box_mask, generate_scene

    w, h = cfg.camera.width, cfg.camera.height
    _, depth, K = generate_scene(w, h, cfg.depth.scale_to_meters)
    z = depth.astype(np.float32) / np.float32(cfg.depth.scale_to_meters)
    keep = (generate_box_mask(w, h) > 0) & (z > 0) & (
        z <= cfg.depth.clipping_max)
    v, u = np.nonzero(keep)
    zz = z[v, u]
    pts = np.stack([(u - K[0, 2]) * zz / K[0, 0],
                    (v - K[1, 2]) * zz / K[1, 1], zz], axis=1)
    save_ply(path, pts.astype(np.float32))


def phase_pipeline(cfg, part_voxel=0.005):
    """Two runs. First the configuration as given, with its dummy
    reference model (a 5 mm planar grid, which no pose can match within
    the 0.4·voxel ICP threshold — the reference warns of low fitness there
    too, pipeline.cpp:131-134). Then the same scene against the part's own
    deprojected model at ``part_voxel``, where fitness is gated: the part
    is the flat box top, so at voxels of 2 mm and below the 5-voxel FPFH
    radius sees nothing but plane, every interior descriptor is the same,
    and feature RANSAC has no correct correspondences to find (the
    reference's algorithm, not the device, sets that limit: the CPU
    engines reach a fitness of 0.0045 there too, PERF.md)."""
    import copy
    import tempfile

    from tpu3d.pipeline.pipeline import Pipeline

    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "part.ply")
        scene_model_ply(cfg, model)
        part = copy.deepcopy(cfg)
        part.reference_model_path = model
        part.registration.voxel_size = part_voxel
        runs = [("dummy grid", cfg, False),
                (f"part model, voxel {part_voxel}", part, True)]
        for label, c, gate_fitness in runs:
            pipe = Pipeline(c, sleep_fn=lambda s: None)
            t0 = time.perf_counter()
            poses = pipe.run()
            say(f"  Pipeline.run ({label}): "
                f"{time.perf_counter() - t0:.2f} s (compile included)")
            posed = [p for p in poses if p is not None
                     and np.all(np.isfinite(np.asarray(p)))]
            check(f"pipeline poses ({label})",
                  len(poses) > 0 and len(posed) == len(poses),
                  f"{len(posed)} of {len(poses)} masks posed")
            check(f"pipeline host retries ({label})",
                  pipe.host_icp_retries == 0,
                  f"host ICP retries {pipe.host_icp_retries} (need 0)")
            fits = [r["fitness"] for r in pipe.instance_results]
            need = c.registration.min_fitness
            if gate_fitness:
                check(f"pipeline fitness ({label})",
                      bool(fits) and min(fits) >= need,
                      f"fitness {fits} (need >= {need})")
            else:
                say(f"  pipeline fitness ({label}): {fits} (not gated: a "
                    f"5 mm grid cannot reach {need})")


# ---------------------------------------------------------------------------
# --multi: the sharded path on four devices
# ---------------------------------------------------------------------------


def phase_multi(n: int, overrides: dict | None = None):
    """register_pair over a ('shard',) mesh of every visible device, and
    the same pair on one device in the same process, as the comparison
    (tolerance of tests/test_register_sharded.py)."""
    from bench import make_pair
    from tpu3d.config import RegistrationConfig
    from tpu3d.parallel.mesh import make_mesh
    from tpu3d.registration import register_pair
    from tpu3d.types import PointCloud

    src_np, tgt_np, R, t = make_pair(n)
    src = PointCloud.from_numpy(src_np)
    tgt = PointCloud.from_numpy(tgt_np)
    cfg = RegistrationConfig(voxel_size=0.002, **(overrides or {}))
    mesh = make_mesh(("shard",))
    say(f"  mesh: {mesh.devices.size} devices")
    first, steady, (ref_m, _) = first_and_steady(
        lambda: register_pair(src, tgt, cfg, mesh=mesh))
    say(f"  sharded register_pair: first {first:.2f} s, steady "
        f"{steady * 1e3:.3f} ms")
    pose_gate("sharded register_pair", ref_m, R, t)
    first, steady, (ref_1, _) = first_and_steady(
        lambda: register_pair(src, tgt, cfg))
    say(f"  single-device register_pair: first {first:.2f} s, steady "
        f"{steady * 1e3:.3f} ms")
    pose_gate("single-device register_pair", ref_1, R, t)
    Tm = np.asarray(ref_m.transformation)
    T1 = np.asarray(ref_1.transformation)
    d = float(np.abs(Tm - T1).max())
    check("sharded vs single", d < 2e-3,
          f"max |T_sharded - T_single| {d:.2e} (need < 2e-3)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, tiny sizes, kernels in the Pallas "
                         "interpreter; never prints the OK line")
    ap.add_argument("--multi", action="store_true",
                    help="only the sharded path, on every visible GPU")
    args = ap.parse_args(argv)

    say(card_line())
    if args.rehearse:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from tpu3d.utils.platform import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    say(f"jax.devices(): {devices}")
    if not args.rehearse and devices[0].platform != "gpu":
        say("no GPU visible: nothing to check")
        return 2

    if args.multi:
        with Phase("multi"):
            phase_multi(4096 if args.rehearse else 100352,
                        _TINY if args.rehearse else None)
    elif args.rehearse:
        with Phase("kernels"):
            phase_kernels(2048, 512, interpret=True)
        with Phase("register"):
            phase_register(4096, _TINY)
        with Phase("pipeline"):
            phase_pipeline(demo_config(320, 240, voxel=0.005, ransac=4000,
                                       icp=30))
    else:
        with Phase("kernels"):
            phase_kernels(100352, 100000)
        with Phase("register"):
            phase_register(100352)
        with Phase("pipeline"):
            phase_pipeline(demo_config())

    if FAILURES:
        say(f"\nFAILED: {', '.join(FAILURES)}")
        return 1
    if args.rehearse:
        say("\nrehearsal passed (CPU; no device result)")
        return 0
    d = devices[0]
    say(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


# Rehearsal-size registration settings (CPU time budget).
_TINY = dict(ransac_max_iterations=4096, icp_max_iterations=30)


if __name__ == "__main__":
    sys.exit(main())
