import json

import jax.numpy as jnp
import numpy as np
import pytest

from tpu3d.utils.profiling import StageRecorder
from tpu3d.utils.timing import device_timeit


def test_device_timeit_reports_sane_numbers():
    def f(x):
        return x * 2.0

    out = device_timeit(f, jnp.ones((128, 128)), iters=2)
    assert out["best_ms"] > 0
    assert out["best_ms"] <= out["median_ms"] <= max(out["times_ms"])
    assert len(out["times_ms"]) == 2


def test_stage_recorder(tmp_path):
    rec = StageRecorder()
    with rec.stage("a", n=3):
        pass
    with rec.stage("b"):
        pass
    assert set(rec.summary()) == {"a", "b"}
    assert rec.records[0]["n"] == 3
    path = str(tmp_path / "stages.json")
    rec.dump(path)
    loaded = json.load(open(path))
    assert loaded[0]["stage"] == "a"


def test_compute_platform_honors_default_device():
    """use_gpu=false pins compute to the CPU device of a GPU-backend
    process; engine choices must follow the DEVICE, not the backend (a
    compiled GPU kernel dispatched to a CPU device fails)."""
    import jax

    from tpu3d.utils.platform import compute_platform, engine_for

    # On the hermetic CPU test platform both agree.
    assert compute_platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert compute_platform() == "cpu"
        assert engine_for("prepare") == "xla"


@pytest.mark.parametrize("platform,engine", [("gpu", "triton"),
                                             ("cpu", "xla")])
def test_engine_table(platform, engine):
    """One table maps (stage, platform) to an engine: the kernels on the
    GPU, the XLA formulations on the CPU."""
    from tpu3d.utils.platform import ENGINES, engine_for

    for stage in ENGINES[platform]:
        assert engine_for(stage, platform) in ("triton", "xla")
    assert engine_for("prepare", platform) == engine


def test_engine_table_rejects_unknown():
    from tpu3d.utils.platform import engine_for, resolve_engine

    with pytest.raises(RuntimeError, match="gpu"):
        engine_for("prepare", "tpu")
    with pytest.raises(KeyError):
        engine_for("no_such_stage", "cpu")
    with pytest.raises(ValueError):
        resolve_engine("mosaic", "prepare")
    assert resolve_engine("auto", "score") == "xla"  # the CPU test host
    assert resolve_engine("auto", "score", interpret=True) == "triton"
    assert resolve_engine("xla", "score", interpret=True) == "xla"


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from tpu3d.utils.platform import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_fixed_repo_path(monkeypatch):
    import os

    import jax

    from tpu3d.utils.platform import enable_compile_cache, repo_cache_dir

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == repo_cache_dir() == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
