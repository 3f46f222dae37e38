"""Telemetry (the port of hivemind_tpu/telemetry/): a zero-dependency,
thread-safe metrics registry with a Prometheus text exporter, peer snapshots,
and distributed tracing with a per-process flight recorder. Metric names, help
strings, labels and wire forms are the JAX package's, so one dashboard reads
both.

- :mod:`~hivemind_tpu_torch.telemetry.registry` — Counter / Gauge / Histogram with
  labels; the process-wide :data:`REGISTRY` all layers record into.
- :mod:`~hivemind_tpu_torch.telemetry.tracing` — cross-peer spans, the
  :data:`~hivemind_tpu_torch.telemetry.tracing.RECORDER` ring buffer, and
  Chrome-trace/Perfetto export.
- :mod:`~hivemind_tpu_torch.telemetry.exporter` — ``GET /metrics`` + ``GET /trace``
  over stdlib HTTP.
- :mod:`~hivemind_tpu_torch.telemetry.monitor` — the per-peer snapshot and the
  swarm-wide aggregation view (its DHT publisher and monitor come with the DHT).
- :mod:`~hivemind_tpu_torch.telemetry.ledger` — the per-round attribution ledger:
  one structured record per averaging round / optimizer epoch with per-peer
  straggler scores, served at ``GET /ledger``.
- :mod:`~hivemind_tpu_torch.telemetry.watchdog` — event-loop lag probe with stall
  stack capture and executor-queue-depth gauges.
- :mod:`~hivemind_tpu_torch.telemetry.serving` — the serving-path attribution
  layer: one record per expert request decomposed into queue-wait /
  batch-assembly / device-compute / serialize, per-expert quantiles, plus
  client-side expert scorecards; served at ``GET /serving``.
- :mod:`~hivemind_tpu_torch.telemetry.device` — device-side observability: the
  compile tracker (fed by the kernel builds), CUDA memory/leak/transfer
  telemetry sampled by the watchdog tick, and the StepTimeline's comm/compute
  overlap scoring.
- :mod:`~hivemind_tpu_torch.telemetry.blackbox` — the black-box flight recorder:
  crash-durable on-disk spools of msgpack frames. It is NOT imported here:
  importing this package loads no msgpack. Import the module itself for it.
"""

from hivemind_tpu_torch.telemetry.device import (
    COMPILE_TRACKER,
    MEMORY_MONITOR,
    STEP_TIMELINE,
    DeviceMemoryMonitor,
    JitCompileTracker,
    StepTimeline,
    add_device_listener,
    arm_device_telemetry,
    device_snapshot,
    device_telemetry_armed,
    disarm_device_telemetry,
    record_transfer,
    remove_device_listener,
    reset_device_telemetry,
    span_lane,
)
from hivemind_tpu_torch.telemetry.exporter import MetricsExporter, render_prometheus
from hivemind_tpu_torch.telemetry.ledger import LEDGER, RoundLedger
from hivemind_tpu_torch.telemetry.serving import (
    SCORECARDS,
    SERVING_LEDGER,
    ExpertScorecards,
    ServingLedger,
    is_overload_error,
)
from hivemind_tpu_torch.telemetry.watchdog import (
    EventLoopWatchdog,
    ensure_watchdog,
    watchdog_summary,
)
from hivemind_tpu_torch.telemetry.tracing import (
    RECORDER,
    Span,
    SpanRecorder,
    current_span,
    finish_span,
    render_chrome_trace,
    set_slow_span_threshold,
    start_span,
    trace,
)
from hivemind_tpu_torch.telemetry.monitor import aggregate_swarm_view, build_peer_snapshot
from hivemind_tpu_torch.telemetry.registry import (
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "REGISTRY",
    "RECORDER",
    "COMPILE_TRACKER",
    "MEMORY_MONITOR",
    "STEP_TIMELINE",
    "JitCompileTracker",
    "DeviceMemoryMonitor",
    "StepTimeline",
    "add_device_listener",
    "remove_device_listener",
    "arm_device_telemetry",
    "disarm_device_telemetry",
    "device_telemetry_armed",
    "device_snapshot",
    "record_transfer",
    "reset_device_telemetry",
    "span_lane",
    "LEDGER",
    "RoundLedger",
    "SERVING_LEDGER",
    "SCORECARDS",
    "ServingLedger",
    "ExpertScorecards",
    "is_overload_error",
    "EventLoopWatchdog",
    "ensure_watchdog",
    "watchdog_summary",
    "DEFAULT_BUCKETS",
    "Span",
    "SpanRecorder",
    "trace",
    "current_span",
    "start_span",
    "finish_span",
    "render_chrome_trace",
    "set_slow_span_threshold",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsExporter",
    "render_prometheus",
    "build_peer_snapshot",
    "aggregate_swarm_view",
]
