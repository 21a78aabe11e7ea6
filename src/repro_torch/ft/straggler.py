"""Straggler detection: per-step wall-time ring buffer + outlier policy.

The port's copy of ``repro.ft.straggler`` (stdlib only).

At pod scale a slow host (thermal throttling, failing HBM, network flap)
shows up as a step-time outlier on *every* host (SPMD lockstep).  The
monitor keeps a rolling median and flags steps exceeding ``threshold x
median``; the launcher policy is: after ``patience`` consecutive flags,
checkpoint + re-dispatch excluding the slow host.  The tests exercise the
detection with injected step times.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Callable


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.5,
                 patience: int = 3,
                 on_straggler: Callable[[int, float, float], None] | None
                 = None):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self._times: deque[float] = deque(maxlen=window)
        self._consecutive = 0
        self._t0: float | None = None
        self.flagged_steps: list[int] = []
        self.tripped = False

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, step: int, duration: float | None = None) -> bool:
        """Record a step; returns True if the re-dispatch policy tripped."""
        if duration is None:
            assert self._t0 is not None, "step_start() not called"
            duration = time.perf_counter() - self._t0
        median = (statistics.median(self._times) if len(self._times) >= 8
                  else None)
        self._times.append(duration)
        if median is not None and duration > self.threshold * median:
            self.flagged_steps.append(step)
            self._consecutive += 1
            if self.on_straggler:
                self.on_straggler(step, duration, median)
            if self._consecutive >= self.patience:
                self.tripped = True
        else:
            self._consecutive = 0
        return self.tripped
