"""Kernel vs XLA, end to end: ``register_pair`` on the 100,352-point bench
pair with every stage on its Triton kernel, then with one stage at a time
switched to its XLA formulation; plus a block-size sweep of each kernel.

    python benchmarks/engines.py                      # needs a GPU
    python benchmarks/engines.py --parts sweep        # block sweeps only
    python benchmarks/engines.py --modes dense        # one prepare mode
    python benchmarks/engines.py --parts sharded      # radius top-1 walk

The ``sharded`` part times the sharded registration (over a mesh of every
visible device, one device included) with the radius top-1 walk on its
kernel and on XLA: that walk serves only the sharded ICP.

Every end-to-end configuration retraces and recompiles ``register_pair``
(~100-120 s each on an H100), so the full run takes over 25 minutes;
give it a time limit to match, or pick parts and modes.

Prints one line per configuration (median of the timed reps, each run to
completion with ``block_until_ready``) and, last, one JSON object with
every number, the card's name and power limit, and the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="e2e,sweep",
                    help="comma list: e2e (register_pair per engine mix), "
                         "sweep (per-kernel block sizes), sharded "
                         "(sharded register_pair, top-1 walk per engine)")
    ap.add_argument("--modes", default="dense,sparse",
                    help="prepare modes of the e2e part")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")

    import jax
    import jax.numpy as jnp

    from tpu3d.utils.platform import ENGINES, enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("no GPU visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)

    from bench import make_pair
    from tpu3d.config import RegistrationConfig
    from tpu3d.registration import register_pair
    from tpu3d.types import PointCloud

    n = 100352
    src_np, tgt_np, R, t = make_pair(n)
    src = PointCloud.from_numpy(src_np)
    tgt = PointCloud.from_numpy(tgt_np)
    result = {"card": card, "device": jax.devices()[0].device_kind,
              "end_to_end_ms": {}, "kernel_ms": {}}
    stages = ("prepare", "icp", "score", "feature_nn")
    table = ENGINES["gpu"]
    runs = [("all-triton", None)] + [(f"{s}=xla", s) for s in stages] + [
        ("all-triton (again)", None)]
    for mode in args.modes.split(",") if "e2e" in parts else ():
        cfg = RegistrationConfig(voxel_size=0.002, prepare_mode=mode)
        for label, stage in runs:
            saved = dict(table)
            if stage is not None:
                table[stage] = "xla"
            jax.clear_caches()
            try:
                med, reps = timed(lambda: register_pair(src, tgt, cfg), 3)
                T = np.asarray(register_pair(src, tgt, cfg)[0].transformation)
                err = float(max(np.abs(T[:3, :3] - R).max(),
                                np.abs(T[:3, 3] - t).max()))
            finally:
                table.clear()
                table.update(saved)
            key = f"{mode} {label}"
            result["end_to_end_ms"][key] = {"median": med, "reps": reps,
                                            "pose_err": err}
            print(f"register_pair {key}: {med:.3f} ms (reps "
                  f"{['%.3f' % x for x in reps]}), pose err {err:.2e}",
                  flush=True)

    if "sharded" in parts:
        from jax.sharding import Mesh

        from tpu3d.parallel.register_sharded import register_pair_sharded

        mesh = Mesh(np.array(jax.devices()), ("shard",))
        cfg = RegistrationConfig(voxel_size=0.002)
        # The XLA walk costs seconds per call here: one timed call each.
        for label, engine, reps in (("all-triton", "triton", 3),
                                    ("nn_walk=xla", "xla", 1)):
            saved = table["nn_walk"]
            table["nn_walk"] = engine
            jax.clear_caches()
            try:
                fn = lambda: register_pair_sharded(src, tgt, cfg, mesh)
                refined, _ = jax.block_until_ready(fn())  # compile + warm
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn())
                    times.append((time.perf_counter() - t0) * 1e3)
                med = statistics.median(times)
            finally:
                table["nn_walk"] = saved
            T = np.asarray(refined.transformation)
            err = float(max(np.abs(T[:3, :3] - R).max(),
                            np.abs(T[:3, 3] - t).max()))
            key = f"sharded x{mesh.devices.size} {label}"
            result["end_to_end_ms"][key] = {"median": med, "reps": times,
                                            "pose_err": err}
            print(f"register_pair_sharded {key}: {med:.3f} ms (reps "
                  f"{['%.3f' % x for x in times]}), pose err {err:.2e}",
                  flush=True)

    # --- per-kernel block sweeps (kernel alone, same inputs) --------------
    if "sweep" not in parts:
        result["device_count"] = len(jax.devices())
        print(json.dumps(result))
        return 0
    from tpu3d.ops.fused_features import fused_prepare_features
    from tpu3d.ops.icp import build_icp_target, fused_slab_stats_fn
    from tpu3d.ops.nn_pallas import nearest_neighbor_triton
    from tpu3d.ops.ransac import build_scoring_factors, score_w16
    from tpu3d.ops.ransac_pallas import score_hypotheses_triton

    r = jnp.float32(0.01)
    tc = PointCloud.from_numpy(tgt_np, capacity=n)
    for block, sub in ((32, 64), (64, 64), (64, 128), (128, 64)):
        f = jax.jit(lambda c, b=block, s=sub: fused_prepare_features(
            c, r, block=b, sub=s, engine="triton"))
        med, _ = timed(lambda: f(tc), 5)
        result["kernel_ms"][f"prepare {block}x{sub}"] = med
        print(f"prepare block={block} sub={sub}: {med:.3f} ms", flush=True)

    prepared, feats = jax.jit(lambda c: fused_prepare_features(c, r))(tc)
    index = jax.jit(build_icp_target)(prepared)
    T = jnp.asarray(np.block([[R, t[:, None]], [np.zeros((1, 3)), 1]]),
                    jnp.float32)
    src_at = src_np @ R.T + t
    sp = jnp.asarray(src_np[np.argsort(src_at[:, 0], kind="stable")][:16384])
    for block, sub in ((32, 128), (64, 64), (64, 128), (128, 128)):
        f = jax.jit(lambda p, T, b=block, s=sub: fused_slab_stats_fn(
            index, p, jnp.ones(p.shape[0], bool), 0.0008, True, block=b,
            sub=s, engine="triton")(T).ata)
        med, _ = timed(lambda: f(sp, T), 10)
        result["kernel_ms"][f"icp {block}x{sub}"] = med
        print(f"icp block={block} sub={sub}: {med:.3f} ms", flush=True)

    rng = np.random.default_rng(0)
    sel = rng.choice(n, 2048, replace=False)
    feat, pq = build_scoring_factors(jnp.asarray(src_np[sel]),
                                     jnp.asarray(tgt_np[sel]),
                                     jnp.ones(2048, bool))
    w = jnp.asarray(rng.normal(size=(16, 25600)).astype(np.float32)) * 0.01
    tn = jnp.zeros((25600,), jnp.float32)
    for bn, bh in ((32, 64), (64, 64), (64, 128), (128, 64)):
        f = jax.jit(lambda a, b_, c, d, bn=bn, bh=bh: score_hypotheses_triton(
            a, b_, c, d, 9e-6, block_n=bn, block_h=bh))
        med, _ = timed(lambda: f(feat, pq, w, tn), 20)
        result["kernel_ms"][f"score 25600x2048 {bn}x{bh}"] = med
        print(f"score 25600x2048 block_n={bn} block_h={bh}: {med:.3f} ms",
              flush=True)
    f = jax.jit(lambda a, b_, c, d: score_w16(a, b_, c, d, 9e-6,
                                              engine="xla"))
    med, _ = timed(lambda: f(feat, pq, w, tn), 20)
    result["kernel_ms"]["score 25600x2048 xla"] = med
    print(f"score 25600x2048 xla: {med:.3f} ms", flush=True)

    sdesc = feats.descriptors
    qd = sdesc[:: n // 8192][:8192]
    for bq, bm, sp_ in ((64, 64, 8), (32, 64, 8), (64, 128, 8), (64, 64, 4),
                        (128, 64, 8)):
        f = jax.jit(lambda a, b_, m, bq=bq, bm=bm, s=sp_:
                    nearest_neighbor_triton(a, b_, m, block_q=bq,
                                            block_m=bm, splits=s))
        med, _ = timed(lambda: f(qd, sdesc, feats.mask), 10)
        result["kernel_ms"][f"feature_nn 8192 {bq}x{bm}/{sp_}"] = med
        print(f"feature NN 8192x{n} block_q={bq} block_m={bm} "
              f"splits={sp_}: {med:.3f} ms", flush=True)

    result["device_count"] = len(jax.devices())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
