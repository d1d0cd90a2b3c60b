"""Utilities: synchronized timing, profiling helpers, the engine table."""

from tpu3d.utils.timing import StageTimer, device_timeit

__all__ = ["StageTimer", "device_timeit"]
