"""Profiling / tracing hooks (SURVEY §5 'Tracing/profiling': absent in
the reference — only tqdm bars).

``profile_trace`` wraps a region with jax.profiler (TensorBoard trace);
``StepTimer`` measures the host-clock interval between step dispatches
and derives clips/sec (a steady-state rate once dispatch is throttled
by the device).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """jax.profiler trace context; no-op when disabled or unsupported."""
    if not enabled:
        yield
        return
    import jax

    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception as e:  # noqa: BLE001 — some backends lack a profiler
        print(f"profiler unavailable: {e}")
        started = False
    try:
        yield
    finally:
        if started:
            jax.profiler.stop_trace()


class StepTimer:
    """Rolling step timing + throughput."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def metrics(self, clips_per_step: int) -> Dict[str, float]:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {
            "step_time_ms": mean * 1e3,
            "clips_per_sec": clips_per_step / mean,
        }
