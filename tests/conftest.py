"""Test config: hermetic CPU runs with a virtual 8-device mesh.

Runs before the first jax backend initialization: forces the CPU platform
and 8 virtual host devices so multi-device sharding logic is exercised
without a GPU (SURVEY.md §4 implication). Set TPU3D_TEST_PLATFORM=gpu to
run the suite on a card instead; tests marked ``gpu`` need one and skip
without it (the ``gpu_device`` fixture decides, at test time).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_platform = os.environ.get("TPU3D_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none. Decided here,
    at test time — never while a module is imported."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with TPU3D_TEST_PLATFORM=gpu)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Work around a latent XLA-CPU JIT crash at high compile counts.

    With the full suite in one process (~130+ compiled executables), the
    CPU backend deterministically SEGFAULTs compiling a trivial jnp.pad
    (faulthandler: backend_compile_and_load → Segmentation fault; first
    seen 2026-08-21 after the suite grew past ~170 tests — the crash
    lands on whichever compile crosses the threshold, not on any
    specific test). Dropping compiled executables between modules keeps
    the per-process live-executable count bounded. Cross-module cache
    reuse is minimal, so the runtime cost is small.
    """
    yield
    import jax

    jax.clear_caches()
