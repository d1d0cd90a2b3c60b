"""Wall-clock timing that synchronizes with the device.

The reference times stages with chrono around host calls
(pipeline.cpp:34,139-142). JAX dispatch is asynchronous, so every timing
here ends in ``jax.block_until_ready`` — a timing without it measures the
enqueue, not the work.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def device_timeit(
    fn: Callable, *args, iters: int = 3, warmup: int = 1
) -> dict:
    """Time ``fn(*args)`` to completion on the device.

    Returns {'best_ms', 'median_ms', 'mean_ms', 'times_ms'}; the warmup
    calls (compilation included) are not timed."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    return {
        "best_ms": min(times),
        "median_ms": statistics.median(times),
        "mean_ms": sum(times) / len(times),
        "times_ms": times,
    }


class StageTimer:
    """Per-stage wall timers with the reference's print style."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    def time(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        out = jax.block_until_ready(out)
        self.stages[name] = (time.perf_counter() - t0) * 1000.0
        return out

    def report(self):
        for name, ms in self.stages.items():
            print(f"  {name}: {ms:.1f} ms")
