"""Where computation runs, and which engine each stage uses there.

``jax.default_backend()`` reports the highest-priority BACKEND, which is
wrong inside a ``jax.default_device(cpu)`` context — the pipeline's
``use_gpu=false`` host mode (pipeline.cpp:43-55 analog) runs on the CPU
device of a GPU-backend process, and dispatching a compiled GPU kernel
there fails. Every engine choice therefore consults the DEFAULT DEVICE
first (``compute_platform``), then reads the one table below.
"""

from __future__ import annotations

import os

import jax

# Stage -> engine, per platform. 'triton' is the hand-written Pallas kernel
# compiled through Triton (kept only where it beat XLA end to end on the
# card, PERF.md "Kernels on the H100"); 'xla' is the plain jax.numpy / lax
# formulation of the same semantics.
ENGINES = {
    "gpu": {
        "prepare": "triton",  # normals + FPFH window walk (ops/fused_features)
        "icp": "triton",  # ICP top-1 + payload window walk (ops/icp)
        "nn_walk": "triton",  # radius top-1 walk (ops/nn_walk)
        "score": "triton",  # RANSAC hypothesis scoring (ops/ransac)
        "feature_nn": "triton",  # 33-D descriptor NN (ops/nn_pallas)
    },
    "cpu": {
        "prepare": "xla",
        "icp": "xla",
        "nn_walk": "xla",
        "score": "xla",
        "feature_nn": "xla",
    },
}


def compute_platform() -> str:
    """Platform of the device new computations land on: honors the
    ``jax.default_device`` context/config, falls back to the default
    backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        platform = getattr(dev, "platform", None)
        if platform is not None:
            return platform
    return jax.default_backend()


def engine_for(stage: str, platform: str | None = None) -> str:
    """The engine ``stage`` runs on ``platform`` (default: the compute
    platform). Unknown platforms and stages are errors, not defaults."""
    platform = compute_platform() if platform is None else platform
    if platform not in ENGINES:
        raise RuntimeError(
            f"tpu3d runs on 'gpu' or 'cpu'; the compute platform is "
            f"{platform!r}"
        )
    table = ENGINES[platform]
    if stage not in table:
        raise KeyError(f"unknown stage {stage!r}; stages: {sorted(table)}")
    return table[stage]


def resolve_engine(engine: str, stage: str, interpret: bool = False) -> str:
    """'auto' -> the table's choice, or the Triton kernel when a test asks
    for the interpreter; an explicit engine passes through."""
    if engine == "auto":
        return "triton" if interpret else engine_for(stage)
    if engine not in ("triton", "xla"):
        raise ValueError(f"engine must be 'auto', 'triton' or 'xla': {engine}")
    return engine


def repo_cache_dir() -> str:
    """``<repo>/.jax_cache`` — a fixed path, so the cache key stays stable."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache. An existing
    ``JAX_COMPILATION_CACHE_DIR`` wins and nothing is set here; otherwise
    the cache lives at ``repo_cache_dir()``. Returns the directory used."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = repo_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
