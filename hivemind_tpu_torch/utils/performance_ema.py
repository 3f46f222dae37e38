"""Debiased exponential moving average of throughput (samples/sec), with a pause
context for excluding idle time (the port's copy of
hivemind_tpu/utils/performance_ema.py)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from threading import Lock


class PerformanceEMA:
    def __init__(self, alpha: float = 0.1, paused: bool = False):
        self.alpha = alpha
        self.samples_per_second = 0.0
        self._ema_seconds_per_sample = 0.0
        self._num_updates = 0
        self._last_update = time.perf_counter()
        self.paused = paused
        self._lock = Lock()

    def update(self, task_size: float, interval: float | None = None) -> float:
        """Register that ``task_size`` units were processed; returns updated rate."""
        assert task_size > 0
        with self._lock:
            now = time.perf_counter()
            if interval is None:
                assert not self.paused, "provide interval explicitly while paused"
                interval = max(now - self._last_update, 1e-9)
            self._last_update = now
            seconds_per_sample = interval / task_size
            self._ema_seconds_per_sample = (
                self.alpha * seconds_per_sample + (1 - self.alpha) * self._ema_seconds_per_sample
            )
            self._num_updates += 1
            bias_correction = 1 - (1 - self.alpha) ** self._num_updates
            self.samples_per_second = bias_correction / max(self._ema_seconds_per_sample, 1e-20)
            return self.samples_per_second

    def reset_timer(self) -> None:
        self._last_update = time.perf_counter()

    @contextmanager
    def pause(self):
        """Exclude the time inside this context from throughput estimation."""
        was_paused, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was_paused
            self.reset_timer()

    @contextmanager
    def update_threadsafe(self, task_size: float):
        """Measure the duration of the context body and update with it."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.update(task_size, interval=max(time.perf_counter() - start, 1e-9))

    def __repr__(self):
        return f"PerformanceEMA({self.samples_per_second:.3g} samples/s, {self._num_updates} updates)"
