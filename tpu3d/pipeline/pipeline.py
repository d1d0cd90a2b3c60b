"""Pipeline orchestrator: capture → segment → register → pick.

Stage structure and degrade-don't-crash behavior mirror Pipeline::run
(src/pipeline.cpp:183-380) and Pipeline::processInstance (:25-150); the
compute inside each stage is the JAX op stack. Differences by design:

  - per-instance work is enqueued to a host thread pool (parity with the
    reference's ThreadPool fan-out, pipeline.cpp:321-339) whose real job
    here is overlapping host prep with device compute — the heavy math is
    serialized on the accelerator by JAX's dispatch anyway, and
    ``tpu3d.parallel`` offers a vmap-batched fan-out when instance clouds
    share a capacity bucket;
  - the deprojection honors ``depth.clipping_max`` on every path (the
    reference's GPU path hardcodes 10.0 m, gpu_impl.cpp:97 — divergence
    fixed);
  - ``depth.bilateral_filter`` actually filters (dead code in the
    reference, SURVEY.md §2.4).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from tpu3d.config import PipelineConfig
from tpu3d.io.robot import Robot
from tpu3d.io.segmentation import get_masks, resize_mask_nearest
from tpu3d.models.ply import load_ply
from tpu3d.models.procedural import (
    generate_box_mask,
    generate_reference_grid,
    generate_scene,
)
from tpu3d.ops.deproject import deproject
from tpu3d.ops.depth import bilateral_filter, depth_preprocess
from tpu3d.ops.icp import icp_refine
from tpu3d.ops.ransac import ransac_registration
from tpu3d.ops.transforms import invert_transform
from tpu3d.pipeline.dedup import filter_duplicates
from tpu3d.registration import (
    downsample_bucketed,
    prepare_features,
    resolve_neighbor_mode,
    sparse_prepare_active,
    two_stage_opt as _two_stage_opt,
)
from tpu3d.types import PointCloud
from tpu3d.viz.viewer import SceneViewer


class Pipeline:
    def __init__(self, config: PipelineConfig, sleep_fn=time.sleep):
        self.config = config
        self.viewer: Optional[SceneViewer] = None
        self._sleep_fn = sleep_fn
        self.waypoints: List[np.ndarray] = []  # result of the last run()
        self.instance_results: List[dict] = []  # per-instance fitness/rmse/T
        self._forced_K: Optional[np.ndarray] = None  # test hook: override K
        # One descriptor variant for the whole run (set when the reference
        # model is prepared) so instance clouds never mix fused and gather
        # FPFH against the model's.
        self._neighbor_mode: str = "auto"
        # Multi-chip routing (config `parallel:` block): when a mesh
        # resolves, every instance registration runs the distributed stack
        # (tpu3d/parallel/register_sharded.py) instead of the single-device
        # ops. Counter is a test/diagnostic hook.
        from tpu3d.parallel.register_sharded import parallel_mesh

        self._mesh = parallel_mesh(config.parallel)
        self._sharded_registrations = 0
        self.host_icp_retries = 0  # accelerator ICP faults retried on host
        print(
            f"Pipeline created (threads={config.num_threads},"
            f" accelerator={'on' if config.use_gpu else 'off'}"
            + (
                f", mesh={self._mesh.devices.size}x'shard'"
                if self._mesh is not None
                else ""
            )
            + ")"
        )

    # ---------------------------------------------------------------- stage 4
    def process_instance(
        self,
        mask: np.ndarray,
        depth_raw: np.ndarray,
        rgb: Optional[np.ndarray],
        K: np.ndarray,
        ref_cloud: PointCloud,
        ref_features,
        instance_id: int,
    ) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        print(f"\n--- Processing instance {instance_id} ---")
        with self._compute_device():  # pool threads don't inherit run()'s
            prep = self._prepare_instance_inner(
                mask, depth_raw, rgb, K, instance_id
            )
            if prep is None:
                return None
            return self._register_instance_inner(
                prep[0], prep[1], ref_cloud, ref_features, instance_id, t0
            )

    def prepare_instance(
        self, mask, depth_raw, rgb, K, instance_id
    ) -> Optional[tuple]:
        """Per-instance host+device prep up to FPFH: mask → depth → cloud →
        (downsampled cloud, features). Runs on pool threads."""
        print(f"\n--- Preparing instance {instance_id} ---")
        with self._compute_device():
            return self._prepare_instance_inner(
                mask, depth_raw, rgb, K, instance_id
            )

    def _prepare_instance_inner(
        self, mask, depth_raw, rgb, K, instance_id
    ) -> Optional[tuple]:
        cfg = self.config
        try:
            if mask is not None and mask.shape != depth_raw.shape:
                mask = resize_mask_nearest(mask, *depth_raw.shape)

            depth_m = depth_preprocess(
                jnp.asarray(depth_raw),
                None if mask is None else jnp.asarray(mask),
                cfg.depth.scale_to_meters,
                apply_mask=cfg.segmentation.apply_mask,
            )
            if cfg.depth.bilateral_filter:
                depth_m = bilateral_filter(
                    depth_m,
                    cfg.depth.bilateral_sigma_spatial,
                    cfg.depth.bilateral_sigma_range,
                )
            if int(jnp.sum(depth_m > 0)) == 0:
                print(f"Instance {instance_id}: empty depth after masking")
                return None

            cloud = deproject(
                depth_m,
                None if rgb is None else jnp.asarray(rgb),
                jnp.asarray(K, jnp.float32),
                cfg.depth.clipping_max,
            )
            n_pts = int(cloud.count())
            if n_pts == 0:
                print(f"Instance {instance_id}: empty point cloud")
                return None
            print(f"Instance {instance_id}: {n_pts} points")

            down = downsample_bucketed(
                cloud,
                cfg.registration,
                capacity=cfg.registration.max_points or None,
            )
            # registration.prepare_mode — sparse query-subset source
            # prepare (descriptors computed at registration time, only
            # where RANSAC reads them). Gated on the run-wide descriptor
            # mode being 'fused': the subset descriptors are fused-class
            # and must never mix with a gather-mode reference model.
            if self._neighbor_mode == "fused" and sparse_prepare_active(
                cfg.registration, self._neighbor_mode, down.capacity
            ):
                return (down, None)
            if self._mesh is not None and self._neighbor_mode == "fused":
                from tpu3d.parallel.register_sharded import (
                    prepare_features_sharded,
                )

                c, f, _ = prepare_features_sharded(
                    down, cfg.registration, self._mesh,
                    halo=cfg.parallel.halo or None,
                )
                return (c, f)
            return prepare_features(
                down, cfg.registration, self._neighbor_mode
            )
        except Exception as e:  # degrade like pipeline.cpp:146-149
            print(f"Instance {instance_id} prepare error: {e}")
            return None

    def _register_instance_inner(
        self, source, source_features, ref_cloud, ref_features, instance_id,
        t0,
    ) -> Optional[np.ndarray]:
        cfg = self.config
        try:
            ransac_src, ransac_feat = source, source_features
            corr_mode = cfg.registration.corr_mode
            if source_features is None:
                # prepare_mode sparse (see _prepare_instance_inner): the
                # source's descriptors are computed here, only for the
                # correspondence subset — each bit-identical to the dense
                # fused path; RANSAC consumes the subset view exactly.
                from tpu3d.ops.fused_features import fused_prepare_sparse

                ransac_src, ransac_feat, _ = fused_prepare_sparse(
                    source,
                    jnp.float32(cfg.registration.voxel_size * 5.0),
                )
                corr_mode = "exact"
            if self._mesh is not None:
                # `parallel:` block active — the distributed stack (sharded
                # feature NN + hypothesis-sharded RANSAC + sharded-target
                # ICP). RANSAC consumes the (possibly sparse-subset) view;
                # ICP always refines the full source cloud.
                from tpu3d.parallel.register_sharded import (
                    register_prepared_sharded,
                )

                refined, coarse = register_prepared_sharded(
                    ransac_src,
                    ref_cloud,
                    ransac_feat,
                    ref_features,
                    cfg.registration,
                    self._mesh,
                    corr_mode=corr_mode,
                    icp_source=source,
                )
                self._sharded_registrations += 1
                fitness = float(refined.fitness)  # sync — faults surface
                print(
                    f"RANSAC result: fitness={float(coarse.fitness):.4f},"
                    f" RMSE={float(coarse.rmse):.6f} [sharded x"
                    f"{self._mesh.devices.size}]"
                )
                if (
                    source_features is None
                    and fitness < self._sparse_escalate_threshold()
                ):
                    # Sparse-arm escalation, sharded flavor (same
                    # loud-failure restart as the single-device path
                    # below): retry with the full-prepare descriptors —
                    # sharded when the halo check allows, exactly like
                    # the normal prepared path.
                    print(
                        f"Instance {instance_id}: sparse sharded fitness"
                        f" {fitness:.4f} below threshold — escalating"
                        " through the full-prepare arm"
                    )
                    from tpu3d.parallel.register_sharded import (
                        prepare_features_sharded,
                    )

                    src_full, src_feat, _ = prepare_features_sharded(
                        source, cfg.registration, self._mesh,
                        halo=cfg.parallel.halo or None,
                    )
                    refined2, coarse2 = register_prepared_sharded(
                        src_full, ref_cloud, src_feat, ref_features,
                        cfg.registration, self._mesh,
                        corr_mode=cfg.registration.corr_mode,
                        icp_source=source,
                    )
                    if float(refined2.fitness) > fitness:
                        refined, coarse = refined2, coarse2
                return self._finish_instance(
                    refined, coarse, instance_id, t0
                )
            coarse = ransac_registration(
                ransac_src,
                ref_cloud,
                ransac_feat,
                ref_features,
                cfg.registration.voxel_size,
                max_iterations=cfg.registration.ransac_max_iterations,
                confidence=cfg.registration.ransac_confidence,
                seed=cfg.registration.ransac_seed,
                corr_mode=corr_mode,
                two_stage=_two_stage_opt(cfg.registration.two_stage),
            )
            print(
                f"RANSAC result: fitness={float(coarse.fitness):.4f},"
                f" RMSE={float(coarse.rmse):.6f}"
            )

            icp_threshold = (
                cfg.registration.voxel_size * cfg.registration.icp_distance_factor
            )
            try:
                refined = self._icp_accel(
                    source, ref_cloud, coarse.transformation, icp_threshold
                )
                fitness = float(refined.fitness)  # sync — device faults
                # surface here, not at some later host read
            except Exception as icp_err:
                # Accelerator-stage failure → host-backend retry, the analog
                # of the reference's GPU-ICP try/catch → CPU fallback
                # (pipeline.cpp:114-121). Counted, so a run that hid a
                # device fault this way is visible (chip_smoke.py fails).
                self.host_icp_retries += 1
                print(
                    f"Accelerator ICP failed ({icp_err}); retrying on the"
                    " host backend"
                )
                refined = self._icp_host(
                    source, ref_cloud, coarse.transformation, icp_threshold
                )
                fitness = float(refined.fitness)
            if (
                source_features is None
                and fitness < self._sparse_escalate_threshold()
            ):
                # Sparse-arm loud-failure escalation (see
                # registration.sparse_register_escalated): the subset's
                # contiguous strata occasionally miss the basin the
                # row-strided full-prepare arm finds on noisy scenes —
                # below the warn threshold, retry through that arm and
                # keep the better result before reporting.
                print(
                    f"Instance {instance_id}: sparse-arm fitness"
                    f" {fitness:.4f} below threshold — escalating through"
                    " the full-prepare arm"
                )
                src_full, src_feat = prepare_features(
                    source, cfg.registration, "fused"
                )
                coarse2 = ransac_registration(
                    src_full, ref_cloud, src_feat, ref_features,
                    cfg.registration.voxel_size,
                    max_iterations=cfg.registration.ransac_max_iterations,
                    confidence=cfg.registration.ransac_confidence,
                    seed=cfg.registration.ransac_seed,
                    corr_mode=cfg.registration.corr_mode,
                    two_stage=_two_stage_opt(cfg.registration.two_stage),
                )
                refined2 = self._icp_accel(
                    src_full, ref_cloud, coarse2.transformation,
                    icp_threshold,
                )
                if float(refined2.fitness) > fitness:
                    refined, coarse = refined2, coarse2
            return self._finish_instance(refined, coarse, instance_id, t0)
        except Exception as e:  # degrade like pipeline.cpp:146-149
            print(f"Instance {instance_id} error: {e}")
            return None

    def _finish_instance(
        self, refined, coarse, instance_id, t0
    ) -> np.ndarray:
        """Common result tail: metrics print, min_fitness warn
        (pipeline.cpp:131-134 — warn but still use the pose), camera→world
        pose and the per-instance record."""
        cfg = self.config
        fitness = float(refined.fitness)
        print(
            f"ICP result: fitness={fitness:.4f},"
            f" RMSE={float(refined.rmse):.6f}"
        )
        if fitness < cfg.registration.min_fitness:
            print(f"Instance {instance_id}: low fitness {fitness:.4f}")

        T_camera_object = np.asarray(
            invert_transform(refined.transformation)
        )
        T_world_object = cfg.camera_extrinsics @ T_camera_object
        self.instance_results.append(
            {
                "instance_id": instance_id,
                "fitness": fitness,
                "rmse": float(refined.rmse),
                "coarse_fitness": float(coarse.fitness),
                "T_world_object": T_world_object,
            }
        )

        ms = (time.perf_counter() - t0) * 1000.0
        print(
            f"Instance {instance_id} done in {ms:.1f} ms"
            f" (fitness={fitness:.4f})"
        )
        return T_world_object

    def _register_instances(
        self, prepared, ref_cloud, ref_features
    ) -> List[Optional[np.ndarray]]:
        """Register every prepared instance against the reference model.

        Instances whose clouds landed in the same capacity bucket are
        stacked and registered as ONE vmap-batched device call
        (register_batch) — the device answer to the reference's per-instance
        thread fan-out (pipeline.cpp:321-339); singletons use the scalar
        path. Returns one pose (or None) per input instance, in order."""
        cfg = self.config
        poses: List[Optional[np.ndarray]] = [None] * len(prepared)
        groups: dict = {}
        for i, prep in enumerate(prepared):
            if prep is None:
                continue
            # prepare_mode sparse instances (prep[1] is None) batch like
            # any others: the sparse gate depends only on capacity+config,
            # so a capacity bucket is uniformly sparse or dense, and
            # _register_batch_group computes the subset views before the
            # one fused device call (register_batch ransac_sources).
            groups.setdefault(prep[0].capacity, []).append(i)

        self._batched_groups = 0  # test/diagnostic hook
        for cap, ids in sorted(groups.items()):
            # With a `parallel:` mesh active the mesh IS the parallel axis —
            # each instance's RANSAC/ICP already spans every device, so the
            # vmap fan-out (which would need a 2-D ('inst','shard') mesh) is
            # skipped; instances run sequentially, each fully distributed.
            if len(ids) >= 2 and self._mesh is None:
                try:
                    poses_b = self._register_batch_group(
                        [prepared[i] for i in ids], ids, ref_cloud,
                        ref_features,
                    )
                    for i, p in zip(ids, poses_b):
                        poses[i] = p
                    self._batched_groups += 1
                    continue
                except Exception as e:
                    print(
                        f"Batched registration failed ({e}); falling back"
                        " to per-instance"
                    )
            for i in ids:
                poses[i] = self._register_instance_inner(
                    prepared[i][0], prepared[i][1], ref_cloud, ref_features,
                    i, time.perf_counter(),
                )
        return poses

    def _register_batch_group(
        self, preps, ids, ref_cloud, ref_features
    ) -> List[Optional[np.ndarray]]:
        """One fused RANSAC+ICP program for a same-capacity instance group."""
        from tpu3d.parallel.batched import register_batch, stack_clouds
        from tpu3d.types import FPFHFeatures

        cfg = self.config.registration
        print(
            f"\n--- Registering {len(ids)} instances batched"
            f" (capacity {preps[0][0].capacity}) ---"
        )
        batch = stack_clouds([p[0] for p in preps])
        rbatch = None
        if preps[0][1] is None:
            # prepare_mode sparse group: compute each instance's exact
            # correspondence-subset view now (same subset capacity across
            # the group — corr_cap/block are static), then register the
            # whole group as ONE vmap program: RANSAC on the views, ICP
            # on the full clouds (register_batch ransac_sources).
            from tpu3d.ops.fused_features import fused_prepare_sparse

            subs = [
                fused_prepare_sparse(
                    p[0],
                    jnp.float32(cfg.voxel_size * 5.0),
                )[:2]
                for p in preps
            ]
            rbatch = stack_clouds([s for s, _ in subs])
            fbatch = FPFHFeatures(
                descriptors=jnp.stack([f.descriptors for _, f in subs]),
                mask=jnp.stack([f.mask for _, f in subs]),
            )
        else:
            fbatch = FPFHFeatures(
                descriptors=jnp.stack([p[1].descriptors for p in preps]),
                mask=jnp.stack([p[1].mask for p in preps]),
            )
        t0 = time.perf_counter()
        refined, coarse = register_batch(
            batch,
            ref_cloud,
            fbatch,
            ref_features,
            cfg.voxel_size,
            ransac_sources=rbatch,
            ransac_max_iterations=cfg.ransac_max_iterations,
            ransac_confidence=cfg.ransac_confidence,
            icp_distance_factor=cfg.icp_distance_factor,
            icp_max_iterations=cfg.icp_max_iterations,
            point_to_plane=cfg.use_point_to_plane,
            seed=cfg.ransac_seed,
            corr_mode=cfg.corr_mode,
            src_mode=cfg.src_mode,
            two_stage=_two_stage_opt(cfg.two_stage),
        )
        T_all = np.asarray(refined.transformation)  # sync — faults surface
        fit_all = np.asarray(refined.fitness)
        rmse_all = np.asarray(refined.rmse)
        cfit_all = np.asarray(coarse.fitness)
        ms = (time.perf_counter() - t0) * 1000.0
        print(f"Batch of {len(ids)} registered in {ms:.1f} ms")

        out = []
        esc_thr = self._sparse_escalate_threshold()
        for b, instance_id in enumerate(ids):
            fitness = float(fit_all[b])
            print(
                f"Instance {instance_id}: RANSAC fitness={float(cfit_all[b]):.4f},"
                f" ICP fitness={fitness:.4f}, RMSE={float(rmse_all[b]):.6f}"
            )
            if preps[0][1] is None and fitness < esc_thr:
                # Sparse-group instance below the warn threshold: re-route
                # through the per-instance path, whose sparse-arm
                # escalation retries the full-prepare arm (the other
                # instances in the batch keep their batched result).
                print(
                    f"Instance {instance_id}: sparse batched fitness"
                    f" {fitness:.4f} below threshold — re-running"
                    " per-instance with escalation"
                )
                pose = self._register_instance_inner(
                    preps[b][0], None, ref_cloud, ref_features,
                    instance_id, time.perf_counter(),
                )
                out.append(pose)
                continue
            if fitness < cfg.min_fitness:
                # Warn but still use the pose, like pipeline.cpp:131-134.
                print(f"Instance {instance_id}: low fitness {fitness:.4f}")
            T_camera_object = np.asarray(invert_transform(T_all[b]))
            T_world_object = self.config.camera_extrinsics @ T_camera_object
            self.instance_results.append(
                {
                    "instance_id": instance_id,
                    "fitness": fitness,
                    "rmse": float(rmse_all[b]),
                    "coarse_fitness": float(cfit_all[b]),
                    "T_world_object": T_world_object,
                }
            )
            out.append(T_world_object)
        return out

    def _sparse_escalate_threshold(self) -> float:
        """Fitness below which the sparse-prepare arm retries through the
        full-prepare arm ('auto' → min_fitness; 0 disables)."""
        esc = getattr(
            self.config.registration, "sparse_escalate_fitness", "auto"
        )
        if esc == "auto":
            return float(self.config.registration.min_fitness)
        return float(esc)

    def _icp_accel(self, source, target, init_T, threshold):
        """ICP on whatever backend is current (split out so tests can fault
        the accelerator attempt and exercise the host retry)."""
        cfg = self.config.registration
        return icp_refine(
            source,
            target,
            init_T,
            threshold,
            max_iterations=cfg.icp_max_iterations,
            point_to_plane=cfg.use_point_to_plane,
            src_mode=cfg.src_mode,
        )

    def _icp_host(self, source, target, init_T, threshold):
        """Host-backend ICP retry: inputs are pulled to host memory and the
        computation is pinned to the CPU backend."""
        import jax

        cpu = jax.devices("cpu")[0]

        def to_host(tree):
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(np.asarray(x), cpu), tree
            )

        cfg = self.config.registration
        with jax.default_device(cpu):
            return icp_refine(
                to_host(source),
                to_host(target),
                to_host(jnp.asarray(init_T)),
                threshold,
                max_iterations=cfg.icp_max_iterations,
                point_to_plane=cfg.use_point_to_plane,
                src_mode=cfg.src_mode,
            )

    def _compute_device(self):
        """``use_gpu=false`` pins compute to the host CPU backend — the
        analog of the reference's per-call-site GPU gating
        (pipeline.cpp:43-55). Returns a context manager."""
        import contextlib

        import jax

        if self.config.use_gpu:
            return contextlib.nullcontext()
        try:
            return jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:
            print("use_gpu=false requested but no CPU backend is registered;"
                  " using the default device")
            return contextlib.nullcontext()

    # ------------------------------------------------------------------- run
    def run(self) -> List[np.ndarray]:
        with self._compute_device():
            return self._run()

    def _run(self) -> List[np.ndarray]:
        t_start = time.perf_counter()
        print("\n=== Starting Pipeline ===")
        self.instance_results = []  # fresh per run (save_results consistency)
        cfg = self.config

        rgb: Optional[np.ndarray] = None
        depth: Optional[np.ndarray] = None
        K = np.eye(3, dtype=np.float32)

        if cfg.use_camera:
            print("\n[1/5] Camera capture (RealSense)...")
            from tpu3d.io.camera import RealSenseCamera

            camera = RealSenseCamera(cfg.camera.width, cfg.camera.height)
            frame = camera.capture() if camera.connect() else None
            if frame is None:
                print("Camera capture failed.")
                return []
            rgb, depth = frame
            K = camera.get_intrinsics()
            # Honor the device-reported depth unit. The reference reads it
            # (camera.cpp:23-24) but then converts with the config scale
            # anyway (pipeline.cpp:44-47) — a latent bug for cameras whose
            # unit isn't 1 mm; here the live capture wins over the config.
            if getattr(camera, "depth_scale", None):
                cfg.depth.scale_to_meters = 1.0 / camera.depth_scale
            camera.disconnect()
        else:
            print("\n[1/5] Using dummy data...")
            if cfg.dummy_rgb_path and cfg.dummy_depth_path:
                try:
                    import cv2

                    rgb = cv2.imread(cfg.dummy_rgb_path, cv2.IMREAD_COLOR)
                    depth = cv2.imread(cfg.dummy_depth_path, cv2.IMREAD_UNCHANGED)
                    K = np.array(
                        [[900, 0, 640], [0, 900, 360], [0, 0, 1]], np.float32
                    )
                except Exception:
                    rgb = depth = None
            if rgb is None or depth is None:
                print("Generating procedural test scene...")
                rgb, depth, K = generate_scene(
                    cfg.camera.width, cfg.camera.height, cfg.depth.scale_to_meters
                )
            if self._forced_K is not None:
                K = np.asarray(self._forced_K, np.float32)

        print("\n[2/5] Segmentation...")
        if not cfg.use_camera and not cfg.segmentation.masks_input_dir:
            print("Generating dummy mask for box...")
            masks = [generate_box_mask(depth.shape[1], depth.shape[0])]
        else:
            masks = get_masks(
                rgb,
                cfg.segmentation.sam_server_url,
                cfg.segmentation.sam_query,
                cfg.segmentation.masks_input_dir,
            )
        if not masks:
            print("No segmentation masks found.")
            return []
        print(f"Found {len(masks)} masks")

        print("\n[3/5] Loading reference model...")
        if not cfg.reference_model_path and not cfg.use_camera:
            print("Generating dummy reference model...")
            ref_pts, _ = generate_reference_grid()
            ref_raw = PointCloud.from_numpy(ref_pts)
        else:
            pts, cols = load_ply(cfg.reference_model_path)
            if len(pts) == 0:
                print("Warning: Empty reference model. Registration may fail.")
            ref_raw = PointCloud.from_numpy(pts, colors=cols)

        ref_down = downsample_bucketed(
            ref_raw,
            cfg.registration,
            capacity=cfg.registration.max_points or None,
        )
        self._neighbor_mode = resolve_neighbor_mode(ref_down.capacity)
        if self._mesh is not None and self._neighbor_mode == "fused":
            # Distributed halo-exchange prepare for the reference model
            # (falls back single-device inside when the halo check fails).
            from tpu3d.parallel.register_sharded import (
                prepare_features_sharded,
            )

            ref_cloud, ref_features, _ = prepare_features_sharded(
                ref_down, cfg.registration, self._mesh,
                halo=cfg.parallel.halo or None,
            )
        else:
            ref_cloud, ref_features = prepare_features(
                ref_down, cfg.registration, self._neighbor_mode
            )

        if cfg.visualization != "none":
            self.viewer = SceneViewer()
            self.viewer.start()
            scene = self._scene_cloud(depth, rgb, K)
            if scene is not None:
                self.viewer.set_point_cloud("scene", *scene)

        print(f"\n[4/5] Processing {len(masks)} instances (parallel)...")
        t_proc = time.perf_counter()
        # Phase 1 — per-instance prep (mask/depth/deproject/FPFH) fans out
        # over the host pool (parity with the reference's ThreadPool,
        # pipeline.cpp:321-339; here its real job is overlapping host prep
        # with device compute).
        with ThreadPoolExecutor(max_workers=max(cfg.num_threads, 1)) as pool:
            prep_futures = [
                pool.submit(self.prepare_instance, masks[i], depth, rgb, K, i)
                for i in range(len(masks))
            ]
            prepared = [f.result() for f in prep_futures]

        # Phase 2 — registration. Instances sharing a capacity bucket run
        # as ONE vmap-batched device program (tpu3d/parallel/batched.py);
        # stragglers take the single-instance path.
        poses = self._register_instances(prepared, ref_cloud, ref_features)

        raw_waypoints = []
        for i, result in enumerate(poses):
            if result is not None:
                raw_waypoints.append(result)
                if self.viewer is not None and self.viewer.is_running():
                    self.viewer.set_pose(f"pose_{i}", result)
        proc_ms = (time.perf_counter() - t_proc) * 1000.0
        print(f"\nAll instances processed in {proc_ms:.1f} ms")

        final_waypoints = filter_duplicates(raw_waypoints, 0.1)
        self.waypoints = final_waypoints

        if self.viewer is not None and final_waypoints:
            self.viewer.set_path([wp[:3, 3] for wp in final_waypoints])

        if cfg.use_robot:
            print("\n[5/5] Robot execution...")
            robot = Robot(cfg.robot.ip, sleep_fn=self._sleep_fn)
            if robot.connect():
                for i, wp in enumerate(final_waypoints):
                    print(f"\nPicking object {i + 1}/{len(final_waypoints)}")
                    robot.pick(wp, cfg.robot.approach_offset_z)
                robot.disconnect()
        else:
            print("\n[5/5] Robot execution skipped (use_robot=false)")
            print(f"Computed {len(final_waypoints)} pick poses.")

        total_ms = (time.perf_counter() - t_start) * 1000.0
        print(f"\n=== Pipeline complete: {total_ms:.1f} ms ===")

        if self.viewer is not None:
            self.viewer.export_scene_json(self.viewer.json_path)
            self.viewer.export_html(self.viewer.html_path)
            print(f"Viewer scene written to {self.viewer.html_path}")
            print("(open it directly, or call viewer.serve() for the "
                  "live fetch-poll view)")
            self.viewer.stop()
        return final_waypoints

    def save_results(self, path: str):
        """Persist pick poses + per-instance metrics (.npz). The reference
        has no persistence at all (SURVEY.md §5 checkpoint/resume: none) —
        this closes that gap minimally: a run's outputs can be reloaded and
        replayed against the robot without re-registering."""
        np.savez(
            path,
            waypoints=np.asarray(self.waypoints, np.float32).reshape(-1, 4, 4),
            fitness=np.asarray(
                [r["fitness"] for r in self.instance_results], np.float32
            ),
            rmse=np.asarray(
                [r["rmse"] for r in self.instance_results], np.float32
            ),
            instance_ids=np.asarray(
                [r["instance_id"] for r in self.instance_results], np.int32
            ),
        )

    @staticmethod
    def load_results(path: str) -> dict:
        data = np.load(path)
        return {k: data[k] for k in data.files}

    def _scene_cloud(self, depth, rgb, K):
        """Stride-2 subsampled full-scene cloud for the viewer
        (pipeline.cpp:302-314)."""
        cfg = self.config
        d = depth[::2, ::2].astype(np.float32) / cfg.depth.scale_to_meters
        K2 = K.copy()
        K2[:2] /= 2.0  # stride-2 pixel grid
        cloud = deproject(
            jnp.asarray(d),
            None if rgb is None else jnp.asarray(rgb[::2, ::2]),
            jnp.asarray(K2, jnp.float32),
            cfg.depth.clipping_max,
        )
        data = cloud.to_numpy()
        if len(data["points"]) == 0:
            return None
        return data["points"], data.get("colors")
