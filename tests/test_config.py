import numpy as np

from tpu3d.config import PipelineConfig, load_config


def test_defaults_match_reference_struct():
    """Defaults mirror include/pipeline_config.hpp:11-68."""
    c = PipelineConfig()
    assert (c.camera.width, c.camera.height) == (1280, 720)
    assert c.depth.scale_to_meters == 1000.0
    assert c.depth.clipping_max == 1.5
    assert c.depth.bilateral_filter is False
    assert c.registration.voxel_size == 0.001
    assert c.registration.ransac_max_iterations == 100000
    assert c.registration.ransac_confidence == 0.999
    assert c.registration.icp_distance_factor == 0.4
    assert c.registration.icp_max_iterations == 200
    assert c.registration.min_fitness == 0.3
    assert c.registration.use_point_to_plane is True
    assert c.robot.ip == "192.168.1.184"
    assert c.robot.speed == 80
    assert abs(c.robot.approach_offset_z + 0.101) < 1e-9
    assert c.segmentation.apply_mask is True
    assert c.use_camera is True and c.use_robot is True
    assert c.num_threads == 8 and c.use_gpu is True
    np.testing.assert_array_equal(c.camera_extrinsics, np.eye(4))


def test_load_demo_config():
    c = load_config("config/pipeline_config.yaml")
    assert c.use_camera is False and c.use_robot is False
    assert c.camera.width == 1280
    assert c.visualization == "opengl"
    # 4x4 row-major extrinsics from the YAML list of 16.
    assert abs(c.camera_extrinsics[0, 3] - 0.43244419) < 1e-6
    assert abs(c.camera_extrinsics[2, 2] + 0.99986428) < 1e-6


def test_parse_error_falls_back_to_all_defaults(tmp_path):
    """main.cpp:73-75: any parse error → every field at its default."""
    bad = tmp_path / "bad.yaml"
    bad.write_text("camera: [unclosed\n  ]::!bogus {{{")
    c = load_config(str(bad))
    assert c.camera.width == 1280
    assert c.use_camera is True  # default, NOT the demo file's false


def test_missing_keys_get_defaults(tmp_path):
    p = tmp_path / "partial.yaml"
    p.write_text("registration:\n  voxel_size: 0.01\nuse_robot: false\n")
    c = load_config(str(p))
    assert c.registration.voxel_size == 0.01
    assert c.registration.ransac_max_iterations == 100000
    assert c.use_robot is False
    assert c.use_camera is True


def test_quirk_keys_are_loadable():
    """The reference never parses ransac_confidence / icp_distance_factor /
    use_point_to_plane from YAML (main.cpp:27-32) — we do, as a documented
    superset (tpu3d/config.py docstring)."""
    import tempfile, os

    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(
            "registration:\n  ransac_confidence: 0.5\n"
            "  icp_distance_factor: 2.0\n  use_point_to_plane: false\n"
        )
        path = f.name
    try:
        c = load_config(path)
        assert c.registration.ransac_confidence == 0.5
        assert c.registration.icp_distance_factor == 2.0
        assert c.registration.use_point_to_plane is False
    finally:
        os.unlink(path)


def test_nonexistent_file_falls_back():
    c = load_config("/nonexistent/nope.yaml")
    assert c.camera.width == 1280


def test_exactness_knobs_parse_and_default():
    """registration.corr_mode/src_mode/two_stage: YAML-exposed exactness
    knobs for the statistical fast paths (default 'auto'; 'exact'
    reproduces reference-exact fitness/rmse through the pipeline)."""
    import tempfile, os

    c = load_config(None)
    assert c.registration.corr_mode == "auto"
    assert c.registration.src_mode == "auto"
    assert c.registration.two_stage == "auto"

    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(
            "registration:\n  corr_mode: exact\n  src_mode: exact\n"
            "  two_stage: off\n"
        )
        path = f.name
    try:
        c = load_config(path)
        assert c.registration.corr_mode == "exact"
        assert c.registration.src_mode == "exact"
        assert c.registration.two_stage == "off"
    finally:
        os.unlink(path)

    from tpu3d.pipeline.pipeline import _two_stage_opt

    assert _two_stage_opt("auto") == "auto"
    assert _two_stage_opt("on") is True
    assert _two_stage_opt("off") is False


def test_yaml_path_without_pyyaml_is_an_error(monkeypatch):
    """A YAML path with PyYAML missing raises instead of running silently
    on defaults; a config built in Python needs no YAML at all."""
    import sys

    import pytest

    monkeypatch.setitem(sys.modules, "yaml", None)  # import -> ImportError
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config("config/pipeline_config.yaml")
    assert load_config(None).camera.width == 1280
