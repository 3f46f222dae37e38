"""Profiling hooks over ``torch.profiler`` and the CUDA caching allocator (the port
of hivemind_tpu/utils/profiling.py).

- :func:`trace_span` — one name on both timelines: the torch profiler's trace
  (``record_function``) and the telemetry tracer's span.
- :func:`profile_to` — capture a host + device trace for a ``with`` block and
  write it as a Chrome trace (Perfetto, ``chrome://tracing``).
- :func:`device_memory_stats` — a card's memory under the JAX package's keys
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), the "am I about to
  run out" probe for schedulers and monitors.
- :class:`StepProfiler` — rolling tokens/s and achieved FLOP/s for training loops.
- :class:`JsonlMetricsSink` — metric records as JSON lines.

The port has no jit, so there is no ``tracked_jit``: its compile events are the
kernel builds of ``ops/_build.py``, which feed the compile tracker themselves.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

from hivemind_tpu_torch.utils.performance_ema import PerformanceEMA


@contextlib.contextmanager
def trace_span(name: str, **attributes):
    """Label a host-side region under one name on both timelines: the torch
    profiler's trace (device view: kernels and copies) and the telemetry tracer
    (host view: the flight recorder, the ``/trace`` Perfetto export)."""
    import torch

    from hivemind_tpu_torch.telemetry.tracing import trace as _telemetry_trace

    with _telemetry_trace(name, **attributes):
        with torch.profiler.record_function(name):
            yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a host + device trace for the duration of the block and write it to
    ``logdir/trace.json`` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> Dict[str, Any]:
    """Memory of one card from the CUDA caching allocator: ``bytes_in_use``
    (allocated), ``peak_bytes_in_use`` (the allocator's high-water mark) and
    ``bytes_limit`` (the card's total memory). Empty when there is no card; with
    no ``device`` given, also empty until this process has used CUDA, so a probe
    never creates a CUDA context."""
    import torch

    if not torch.cuda.is_available():
        return {}
    if device is None:
        if not torch.cuda.is_initialized():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


class StepProfiler:
    """Rolling throughput for a training loop.

    >>> prof = StepProfiler(flops_per_token=flops)
    >>> for batch in data:
    ...     loss = train_step(batch)
    ...     prof.step(tokens=batch_tokens)
    >>> prof.tokens_per_second, prof.achieved_flops
    """

    def __init__(self, flops_per_token: Optional[float] = None, alpha: float = 0.1):
        self.flops_per_token = flops_per_token
        self.ema = PerformanceEMA(alpha=alpha)
        self.total_tokens = 0
        self._started = time.perf_counter()

    def step(self, tokens: int) -> None:
        self.total_tokens += tokens
        self.ema.update(tokens)

    @property
    def tokens_per_second(self) -> float:
        return self.ema.samples_per_second

    @property
    def achieved_flops(self) -> Optional[float]:
        if self.flops_per_token is None:
            return None
        return self.tokens_per_second * self.flops_per_token

    def mfu(self, peak_flops: float) -> Optional[float]:
        achieved = self.achieved_flops
        return None if achieved is None else achieved / peak_flops

    def summary(self) -> Dict[str, Any]:
        return {
            "tokens_per_second": round(self.tokens_per_second, 1),
            "total_tokens": self.total_tokens,
            "elapsed_s": round(time.perf_counter() - self._started, 3),
            "achieved_tflops": None
            if self.achieved_flops is None
            else round(self.achieved_flops / 1e12, 3),
        }


class JsonlMetricsSink:
    """Append metric records as JSON lines. Non-finite floats serialize as null so
    every line stays strict JSON (jq/pandas-parsable)."""

    def __init__(self, path: Optional[str]):
        self._file = open(path, "a") if path else None

    def log(self, record: Dict[str, Any]) -> None:
        if self._file is None:
            return
        import json
        import math

        clean = {
            key: (None if isinstance(value, float) and not math.isfinite(value) else value)
            for key, value in record.items()
        }
        self._file.write(json.dumps(clean, allow_nan=False) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
