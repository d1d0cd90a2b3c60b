"""Structured tracing & profiling (SURVEY.md §5: the reference only has
chrono prints around stages, pipeline.cpp:34,139-142 — this is the
structured upgrade).

  - ``trace(logdir)``: context manager around ``jax.profiler.trace`` —
    captures device timelines viewable in TensorBoard/Perfetto.
  - ``annotate(name)``: TraceAnnotation for host-side stage marking inside a
    trace.
  - ``StageRecorder``: wall-clock per-stage records with JSON export, the
    structured replacement for the reference's stdout timings.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/tpu3d_trace"):
    """Capture a device profile for the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host annotation appearing on the trace timeline."""
    return jax.profiler.TraceAnnotation(name)


class StageRecorder:
    """Per-stage wall-clock records (ms), exportable as JSON."""

    def __init__(self):
        self.records: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(
                {
                    "stage": name,
                    "ms": (time.perf_counter() - t0) * 1000.0,
                    **meta,
                }
            )

    def summary(self) -> dict:
        return {r["stage"]: r["ms"] for r in self.records}

    def dump(self, path: Optional[str] = None) -> str:
        payload = json.dumps(self.records, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    def report(self):
        for r in self.records:
            print(f"  {r['stage']}: {r['ms']:.1f} ms")
