"""Hermetic end-to-end tests — mirroring the reference's test strategy
(SURVEY.md §4: procedural scene + dummy mask + planar reference, hardware
faked by config flags), plus a ground-truth fixture with a bumpy surface and
a PLY reference model so full-stack registration accuracy is asserted."""

import numpy as np
import pytest

from tpu3d.config import PipelineConfig
from tpu3d.models.ply import save_ply
from tpu3d.pipeline.dedup import filter_duplicates
from tpu3d.pipeline.pipeline import Pipeline


def _demo_config() -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.use_camera = False
    cfg.use_robot = False
    cfg.visualization = "none"
    cfg.camera.width = 320
    cfg.camera.height = 240
    cfg.registration.voxel_size = 0.005
    cfg.registration.ransac_max_iterations = 2000
    cfg.registration.icp_max_iterations = 30
    cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
    return cfg


def test_demo_pipeline_end_to_end_parity():
    """The reference's demo: plane patch vs planar grid. Degenerate FPFH on a
    uniform plane means coarse alignment cannot lock in-plane pose — the
    reference behaves identically (low fitness warning, pose still used,
    pipeline.cpp:131-134). Assert the orchestration contract, not pose."""
    cfg = _demo_config()
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    waypoints = pipe.run()
    assert len(waypoints) == 1
    assert waypoints[0].shape == (4, 4)
    assert len(pipe.instance_results) == 1
    res = pipe.instance_results[0]
    assert 0.0 <= res["fitness"] <= 1.0
    assert np.isfinite(res["rmse"])


def _bumpy_frame(w=240, h=180, z0=0.6):
    """Depth frame of a bumpy surface (rich FPFH structure everywhere)."""
    u = np.arange(w)[None, :]
    v = np.arange(h)[:, None]
    z = z0 + 0.03 * np.sin(u * 0.11) * np.cos(v * 0.13) + 0.01 * np.sin(
        u * 0.031 + v * 0.027
    )
    K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32)
    return z.astype(np.float32), K


def test_pipeline_with_ply_reference_ground_truth(tmp_path):
    """Reference model = the scene cloud itself (written to PLY): the true
    refined transform is identity, so the waypoint must be ≈ extrinsics."""
    z, K = _bumpy_frame()
    scale = 10000.0  # 0.1 mm depth units to keep u16 quantization negligible
    depth_u16 = (z * scale).astype(np.uint16)

    # Ground-truth cloud in camera frame from the QUANTIZED depth.
    from tpu3d import oracle

    pts, _ = oracle.deproject(
        depth_u16.astype(np.float32) / scale,
        None,
        K[0, 0],
        K[1, 1],
        K[0, 2],
        K[1, 2],
        clipping_max=1.5,
    )
    ply_path = str(tmp_path / "ref.ply")
    save_ply(ply_path, pts)

    cfg = _demo_config()
    cfg.camera.width, cfg.camera.height = 240, 180
    cfg.depth.scale_to_meters = scale
    cfg.reference_model_path = ply_path
    cfg.registration.voxel_size = 0.008
    cfg.registration.ransac_max_iterations = 4000
    cfg.registration.icp_max_iterations = 40
    cfg.dummy_rgb_path = cfg.dummy_depth_path = ""
    cfg.segmentation.apply_mask = False

    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    # Inject the synthetic frame through the dummy-data path.
    import cv2

    rgb_path = str(tmp_path / "rgb.png")
    depth_path = str(tmp_path / "depth.png")
    cv2.imwrite(rgb_path, np.zeros((180, 240, 3), np.uint8) + 90)
    cv2.imwrite(depth_path, depth_u16)
    cfg.dummy_rgb_path, cfg.dummy_depth_path = rgb_path, depth_path
    # Dummy-data path hardcodes K (900,640,360) like pipeline.cpp:206-208 —
    # override with our synthetic intrinsics for the ground-truth check.
    pipe._forced_K = K

    waypoints = pipe.run()
    assert len(waypoints) == 1
    res = pipe.instance_results[0]
    assert res["fitness"] > 0.8, res
    T = waypoints[0]
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=0.02)
    np.testing.assert_allclose(T[:3, 3], 0.0, atol=0.01)


def test_demo_pipeline_with_robot_and_viewer(tmp_path):
    cfg = _demo_config()
    cfg.use_robot = True
    cfg.visualization = "opengl"
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    waypoints = pipe.run()
    assert len(waypoints) == 1
    assert pipe.viewer is not None


def test_pipeline_save_load_results(tmp_path):
    cfg = _demo_config()
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    pipe.run()
    path = str(tmp_path / "run.npz")
    pipe.save_results(path)
    out = Pipeline.load_results(path)
    assert out["waypoints"].shape == (1, 4, 4)
    assert out["fitness"].shape == (1,)
    np.testing.assert_allclose(out["waypoints"][0], pipe.waypoints[0])


def test_filter_duplicates_semantics():
    def T(x, y, z):
        M = np.eye(4, dtype=np.float32)
        M[:3, 3] = (x, y, z)
        return M

    # Second is within 0.1 of the first and closer to origin → replaces it.
    # Third is its own cluster.
    out = filter_duplicates([T(1.0, 0, 0), T(0.95, 0, 0), T(2.0, 0, 0)], 0.1)
    assert len(out) == 2
    np.testing.assert_allclose(out[0][:3, 3], (0.95, 0, 0))
    np.testing.assert_allclose(out[1][:3, 3], (2.0, 0, 0))

    out = filter_duplicates([T(1.0, 0, 0), T(1.05, 0, 0), T(1.11, 0, 0)], 0.1)
    assert len(out) == 2


def test_cli_main(tmp_path, capsys):
    """python -m tpu3d <config> surface (main.cpp:80-94 contract)."""
    from tpu3d.__main__ import main

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        "camera:\n  width: 320\n  height: 240\n"
        "registration:\n  voxel_size: 0.005\n  ransac_max_iterations: 500\n"
        "  icp_max_iterations: 10\n"
        "use_camera: false\nuse_robot: false\nvisualization: \"none\"\n"
    )
    rc = main([str(cfg_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Config loaded from" in out
    assert "Pipeline complete" in out


def test_pipeline_with_bilateral_filter():
    """depth.bilateral_filter=true end to end — live behavior for the
    reference's dead-code flag (SURVEY §2.4)."""
    cfg = _demo_config()
    cfg.depth.bilateral_filter = True
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 5
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    waypoints = pipe.run()
    assert len(waypoints) == 1


def test_pipeline_batches_same_bucket_instances(tmp_path):
    """≥2 masks in one capacity bucket must take the vmap-batched path
    (VERDICT r1 #4) and register each instance correctly."""
    import cv2

    z, K = _bumpy_frame()
    scale = 10000.0
    depth_u16 = (z * scale).astype(np.uint16)
    h, w = depth_u16.shape

    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for j, (x0, x1) in enumerate([(10, 110), (120, 220), (10, 110)]):
        m = np.zeros((h, w), np.uint8)
        y0 = 20 + 40 * (j == 2)
        m[y0 : y0 + 100, x0:x1] = 255
        cv2.imwrite(str(mask_dir / f"mask_{j}.png"), m)

    from tpu3d import oracle

    pts, _ = oracle.deproject(
        depth_u16.astype(np.float32) / scale, None,
        K[0, 0], K[1, 1], K[0, 2], K[1, 2], clipping_max=1.5,
    )
    ply_path = str(tmp_path / "ref.ply")
    save_ply(ply_path, pts)

    cfg = _demo_config()
    cfg.camera.width, cfg.camera.height = 240, 180
    cfg.depth.scale_to_meters = scale
    cfg.reference_model_path = ply_path
    cfg.registration.voxel_size = 0.008
    cfg.registration.ransac_max_iterations = 2000
    cfg.registration.icp_max_iterations = 30
    cfg.registration.max_points = 8192  # one shared capacity bucket
    # (the full-frame model has ~5.9k voxels at 8 mm — must not truncate)
    cfg.segmentation.masks_input_dir = str(mask_dir)

    rgb_path = str(tmp_path / "rgb.png")
    depth_path = str(tmp_path / "depth.png")
    cv2.imwrite(rgb_path, np.zeros((h, w, 3), np.uint8) + 90)
    cv2.imwrite(depth_path, depth_u16)
    cfg.dummy_rgb_path, cfg.dummy_depth_path = rgb_path, depth_path

    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    pipe._forced_K = K
    pipe.run()
    assert pipe._batched_groups >= 1  # the vmap path actually ran
    assert len(pipe.instance_results) == 3
    for res in pipe.instance_results:
        # each instance is a crop of the reference → identity pose
        assert res["fitness"] > 0.7, res
        T = res["T_world_object"]
        np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=0.05)
        np.testing.assert_allclose(T[:3, 3], 0.0, atol=0.02)


def test_pipeline_prepare_mode_sparse_routing():
    """registration.prepare_mode='sparse' must actually flow through the
    pipeline (it is advertised in config/pipeline_config.yaml): prepare
    returns a features-less marker (source descriptors are deferred to
    registration time), _register_instances keeps such instances on the
    vmap-batched path (register_batch ransac_sources — sparse prepare and
    instance batching compose), and registration completes with a finite
    pose."""
    from tpu3d.registration import prepare_features

    z, K = _bumpy_frame()
    scale = 10000.0
    depth_u16f = (z * scale).astype(np.float32)

    cfg = _demo_config()
    cfg.camera.width, cfg.camera.height = 240, 180
    cfg.depth.scale_to_meters = scale
    cfg.registration.voxel_size = 0.008
    cfg.registration.prepare_mode = "sparse"
    cfg.registration.ransac_max_iterations = 1500
    cfg.registration.icp_max_iterations = 20
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    # The run-wide descriptor mode a fused-scale reference model would
    # set; sparse prepare is gated on it (subset descriptors are
    # fused-class and must not mix with a gather-mode model).
    pipe._neighbor_mode = "fused"

    prep = pipe._prepare_instance_inner(None, depth_u16f, None, K, 0)
    assert prep is not None
    down, feats = prep
    assert feats is None, "sparse prepare must defer descriptors"

    # Self-registration: the reference model is the instance cloud itself.
    ref_cloud, ref_features = prepare_features(
        down, cfg.registration, "fused"
    )
    poses = pipe._register_instances(
        [prep, prep], ref_cloud, ref_features
    )
    # Two same-capacity sparse instances batch exactly like dense ones:
    # subset views are computed per instance, then one vmap program runs
    # RANSAC on the views and ICP on the full clouds.
    assert pipe._batched_groups == 1
    for pose in poses:
        assert pose is not None, "sparse-path registration failed"
        assert pose.shape == (4, 4) and np.all(np.isfinite(pose))

    # Gate sanity: without the fused run-wide mode the knob stays inert
    # (descriptor-class consistency beats the optimization).
    pipe._neighbor_mode = "auto"
    prep2 = pipe._prepare_instance_inner(None, depth_u16f, None, K, 1)
    assert prep2 is not None and prep2[1] is not None


def test_pipeline_sparse_escalation_paths(capsys):
    """The sparse-arm escalation must be reachable from BOTH pipeline
    paths: the per-instance registration and the batched-group re-route.
    A forced always-escalate threshold exercises the wiring on a clean
    scene (keep-better semantics: results stay correct)."""
    from tpu3d.registration import prepare_features

    z, K = _bumpy_frame()
    scale = 10000.0
    depth_u16f = (z * scale).astype(np.float32)

    cfg = _demo_config()
    cfg.camera.width, cfg.camera.height = 240, 180
    cfg.depth.scale_to_meters = scale
    cfg.registration.voxel_size = 0.008
    cfg.registration.prepare_mode = "sparse"
    cfg.registration.sparse_escalate_fitness = 2.0  # always escalate
    cfg.registration.ransac_max_iterations = 1500
    cfg.registration.icp_max_iterations = 20
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    pipe._neighbor_mode = "fused"

    prep = pipe._prepare_instance_inner(None, depth_u16f, None, K, 0)
    assert prep is not None and prep[1] is None
    down = prep[0]
    ref_cloud, ref_features = prepare_features(
        down, cfg.registration, "fused"
    )

    # Per-instance path.
    import time as _time

    pose = pipe._register_instance_inner(
        prep[0], None, ref_cloud, ref_features, 0, _time.perf_counter()
    )
    assert pose is not None and np.all(np.isfinite(pose))
    out = capsys.readouterr().out
    assert "escalating through the full-prepare arm" in out

    # Batched path: the group registers batched, then every instance
    # (fitness < 2.0) re-routes through the per-instance path, which
    # escalates.
    poses = pipe._register_instances([prep, prep], ref_cloud, ref_features)
    out = capsys.readouterr().out
    assert "re-running per-instance with escalation" in out
    for pose in poses:
        assert pose is not None and np.all(np.isfinite(pose))
    # Self-registration against its own crop: identity pose survives the
    # escalated arm.
    for res in pipe.instance_results[-2:]:
        T = res["T_world_object"]
        np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=0.05)


def test_pipeline_icp_host_retry(monkeypatch):
    """Accelerator-stage ICP failure must retry on the host backend and
    still produce a pose (pipeline.cpp:114-121 parity)."""
    cfg = _demo_config()
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)

    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected accelerator fault")

    monkeypatch.setattr(pipe, "_icp_accel", boom)
    waypoints = pipe.run()
    assert calls["n"] >= 1  # the accel attempt actually happened
    assert len(waypoints) == 1  # host retry delivered the pose
    assert np.all(np.isfinite(waypoints[0]))


def test_pipeline_counts_host_icp_retries(monkeypatch):
    """Each host retry of a failed accelerator ICP is counted, so a run
    that hid a device fault behind the fallback is visible (chip_smoke.py
    fails on a nonzero count); a clean run counts zero."""
    cfg = _demo_config()
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    clean = Pipeline(cfg, sleep_fn=lambda s: None)
    clean.run()
    assert clean.host_icp_retries == 0

    pipe = Pipeline(cfg, sleep_fn=lambda s: None)

    def boom(*a, **k):
        raise RuntimeError("injected accelerator fault")

    monkeypatch.setattr(pipe, "_icp_accel", boom)
    waypoints = pipe.run()
    assert len(waypoints) == 1
    assert pipe.host_icp_retries == 1
