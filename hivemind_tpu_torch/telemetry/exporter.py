"""Prometheus text-format exposition over a stdlib HTTP endpoint.

``render_prometheus`` produces the text exposition format (version 0.0.4) from a
:class:`~hivemind_tpu_torch.telemetry.registry.MetricsRegistry`; ``MetricsExporter``
serves it at ``GET /metrics`` from a daemon-threaded ``ThreadingHTTPServer`` —
no ``prometheus_client`` dependency, nothing async, and
zero cost to the instrumented process until something actually scrapes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from hivemind_tpu_torch.telemetry.ledger import LEDGER, RoundLedger
from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER, ServingLedger
from hivemind_tpu_torch.telemetry.tracing import RECORDER, SpanRecorder, render_chrome_trace
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labelnames, labelvalues, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label_value(str(v))}"' for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _format_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if float(value).is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


def render_prometheus(registry: MetricsRegistry = REGISTRY) -> str:
    """The registry as Prometheus text exposition (one scrape)."""
    lines = []
    for metric in registry.collect():
        name = metric.name
        lines.append(f"# HELP {name} {metric.documentation or name}")
        lines.append(f"# TYPE {name} {metric.metric_type}")
        if metric.metric_type == "histogram":
            for key, child in metric.series():
                buckets, total, count = child.snapshot()
                for bound, cumulative in zip(metric.buckets, buckets):
                    labels = _format_labels(metric.labelnames, key, f'le="{_format_value(bound)}"')
                    lines.append(f"{name}_bucket{labels} {cumulative}")
                labels = _format_labels(metric.labelnames, key, 'le="+Inf"')
                lines.append(f"{name}_bucket{labels} {count}")
                plain = _format_labels(metric.labelnames, key)
                lines.append(f"{name}_sum{plain} {_format_value(total)}")
                lines.append(f"{name}_count{plain} {count}")
        else:
            # counters expose a _total sample; a declared ..._total name is kept as-is
            sample = name
            if metric.metric_type == "counter" and not name.endswith("_total"):
                sample = name + "_total"
            for key, child in metric.series():
                labels = _format_labels(metric.labelnames, key)
                lines.append(f"{sample}{labels} {_format_value(child.value)}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY  # overridden per-server
    recorder: SpanRecorder = RECORDER  # overridden per-server
    ledger: RoundLedger = LEDGER  # overridden per-server
    serving_ledger: ServingLedger = SERVING_LEDGER  # overridden per-server

    def do_GET(self):  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus(self.registry).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
        elif path == "/metrics.json":
            body = json.dumps(self.registry.snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/ledger":
            # raw round/epoch attribution records + straggler scores:
            # "where did epoch N's wall time go, and which peer caused it" —
            # serialization happens HERE, never on the record path
            body = json.dumps(self.ledger.export(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/serving":
            # per-request serving attribution: records with their
            # queue-wait/assembly/compute/serialize decomposition, per-expert
            # quantiles, per-client attribution, slowest exemplars, the live
            # saturation gauges, and this process's client-side scorecards
            body = json.dumps(self.serving_ledger.export(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/trace":
            # the flight recorder as Chrome trace-event JSON: save the response
            # to a file and open it in Perfetto / chrome://tracing (one pid row
            # per peer; serialization happens HERE, never on the record path)
            body = json.dumps(render_chrome_trace(self.recorder.snapshot()), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/healthz":
            body = b"ok\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 (stdlib API)
        pass  # scrapes must not spam the training logs


class MetricsExporter:
    """Serve ``/metrics`` (Prometheus text), ``/metrics.json`` (compact
    snapshot), ``/trace`` (Chrome trace-event JSON from the span flight
    recorder), ``/ledger`` (raw per-round attribution records), ``/serving``
    (raw per-request serving attribution + scorecards) and ``/healthz`` on a
    daemon thread.

    :param port: TCP port; 0 picks a free one (read it back via ``.port``)
    :param host: bind host; default loopback — pass "0.0.0.0" for remote scrapers
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: MetricsRegistry = REGISTRY,
        recorder: SpanRecorder = RECORDER,
        ledger: RoundLedger = LEDGER,
        serving_ledger: ServingLedger = SERVING_LEDGER,
        start: bool = True,
    ):
        self.registry = registry
        self.recorder = recorder
        self.ledger = ledger
        self.serving_ledger = serving_ledger
        handler = type(
            "_BoundMetricsHandler",
            (_MetricsHandler,),
            {"registry": registry, "recorder": recorder, "ledger": ledger,
             "serving_ledger": serving_ledger},
        )
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter", daemon=True
        )
        self._thread.start()
        logger.info(f"metrics exporter listening on :{self.port}/metrics")

    def shutdown(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            self._server.shutdown()
            thread.join(timeout=5.0)
        self._server.server_close()
