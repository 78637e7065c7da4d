"""Tracing / profiling hooks.

The reference's only observability is wall-clock deltas -> examples/sec
summaries (`train.py:513-521,542-544`) plus `log_device_placement`.
The rebuild keeps those (cli/ emits the same summary tags) and adds
JAX-native equivalents:

  * `trace(logdir)` — `jax.profiler` trace context producing TensorBoard
    profile dumps (device timelines, XLA op breakdown);
  * `StepTimer` — rolling step-time stats with the examples/sec math the
    reference logs, plus p50/p90 for tail visibility;
  * `annotate(name)` — `jax.profiler.TraceAnnotation` for host-side
    phases (input pipeline, metrics) so they show up on the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace for the enclosed steps."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    import jax

    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Rolling per-step wall-clock stats."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, examples: int) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return examples / dt

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "p50_ms": ts[n // 2] * 1e3,
            "p90_ms": ts[min(n - 1, int(n * 0.9))] * 1e3,
            "mean_ms": sum(ts) / n * 1e3,
        }
