"""Sliding-window timer with ETA strings (port of nerf_tpu/utils/timer.py).

A bounded deque of recent durations, tic/toc, the windowed mean, and a
remaining-time estimate formatted h:m:s.  The clock is injectable.
"""

from __future__ import annotations

import time
from collections import deque


class Timer:
    def __init__(self, window: int = 10, clock=time.perf_counter):
        self._durations = deque(maxlen=max(1, int(window)))
        self._clock = clock
        self._start = None

    def tic(self) -> None:
        self._start = self._clock()

    def toc(self) -> float:
        """Record the duration since tic(); returns it in seconds."""
        if self._start is None:
            return 0.0
        dt = self._clock() - self._start
        self._durations.append(dt)
        self._start = None
        return dt

    def record(self, dt: float) -> None:
        """Append a duration measured elsewhere."""
        self._durations.append(float(dt))

    def get_mean_time(self) -> float:
        if not self._durations:
            return 0.0
        return sum(self._durations) / len(self._durations)

    def remaining_time(self, steps_left: int) -> float:
        return self.get_mean_time() * max(0, int(steps_left))

    @staticmethod
    def format_seconds(sec: float) -> str:
        sec = max(0, int(sec))
        h, rem = divmod(sec, 3600)
        m, s = divmod(rem, 60)
        return f"{h}h {m}m {s}s" if h else (f"{m}m {s}s" if m else f"{s}s")

    def eta_str(self, steps_left: int) -> str:
        return self.format_seconds(self.remaining_time(steps_left))
