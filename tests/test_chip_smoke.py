"""chip_smoke.py: its phase functions at rehearsal size on the CPU, and its
refusal to report without a GPU or without the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_failures():
    chip_smoke.FAILURES.clear()
    yield
    chip_smoke.FAILURES.clear()


def test_rehearse_kernel_phase():
    chip_smoke.phase_kernels(1024, 256, interpret=True)
    assert chip_smoke.FAILURES == []


def test_rehearse_register_phase():
    chip_smoke.phase_register(4096, chip_smoke._TINY)
    assert chip_smoke.FAILURES == []


def test_rehearse_pipeline_phase():
    chip_smoke.phase_pipeline(chip_smoke.demo_config(
        320, 240, voxel=0.005, ransac=4000, icp=30))
    assert chip_smoke.FAILURES == []


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
