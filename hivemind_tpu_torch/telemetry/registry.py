"""The cross-layer metrics registry: Counter / Gauge / Histogram with labels (the
port's copy of hivemind_tpu/telemetry/registry.py).

Zero dependencies, thread-safe, always-on. Design constraints:

- **Cheap on the hot path.** ``metric.labels(...)`` returns a child handle that
  callers cache; a cached child's ``inc``/``set``/``observe`` is one lock + one
  float op. Creating a child is a dict lookup under the metric lock. No string
  formatting happens until scrape/snapshot time.
- **Always-on.** There is no enabled flag to check: recording into the registry
  IS the disabled-exporter path, so it must stay within noise on the hot path.
  Rendering cost is paid only by scrapers.
- **Prometheus-compatible.** Histograms keep cumulative ``le`` buckets plus
  ``_sum``/``_count``; the exporter (telemetry/exporter.py) renders the standard
  text exposition format.

The process-wide :data:`REGISTRY` is what instrumented modules use; tests build
private ``MetricsRegistry`` instances.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_LabelKey = Tuple[str, ...]

# latency-flavored default buckets (seconds): RPC and phase timings span ~100us..60s
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_VALID_METRIC_TYPES = ("counter", "gauge", "histogram")


class _Child:
    """One labeled time series of a Counter or Gauge."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class _HistogramChild:
    """One labeled histogram series: cumulative buckets + sum + count."""

    __slots__ = ("_lock", "_bounds", "_buckets", "_sum", "_count")

    def __init__(self, lock: threading.Lock, bounds: Sequence[float]):
        self._lock = lock
        self._bounds = bounds
        self._buckets = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            # linear scan: bucket lists are short (~14) and values skew small,
            # so this beats bisect's call overhead on the common case
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._buckets[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._buckets), self._sum, self._count


class Metric:
    """Base for one named metric family (all label combinations)."""

    metric_type = "untyped"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[_LabelKey, object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *labelvalues, **labelkwargs):
        """Get-or-create the child for one label combination. Accepts positional
        values (in declaration order) or keywords; callers on hot paths should
        cache the returned child."""
        if labelkwargs:
            assert not labelvalues, "pass labels positionally or by keyword, not both"
            labelvalues = tuple(labelkwargs[name] for name in self.labelnames)
        key = tuple(str(v) for v in labelvalues)
        assert len(key) == len(self.labelnames), (
            f"{self.name} expects labels {self.labelnames}, got {key}"
        )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def _no_labels(self):
        assert not self.labelnames, f"{self.name} requires labels {self.labelnames}"
        return self.labels()

    def remove(self, *labelvalues, **labelkwargs) -> None:
        """Drop one label combination's series. For metrics whose label values
        are swarm-supplied (peer ids), callers MUST bound cardinality by
        evicting stale series — the registry itself keeps everything forever."""
        if labelkwargs:
            assert not labelvalues, "pass labels positionally or by keyword, not both"
            labelvalues = tuple(labelkwargs[name] for name in self.labelnames)
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children.pop(key, None)

    def series(self) -> Iterable[Tuple[_LabelKey, object]]:
        with self._lock:
            return list(self._children.items())


class Counter(Metric):
    """Monotonically increasing value (rendered with a ``_total`` suffix)."""

    metric_type = "counter"

    def _make_child(self) -> _Child:
        return _Child(threading.Lock())

    def inc(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels else self._no_labels()).inc(amount)

    def value(self, **labels) -> float:
        return (self.labels(**labels) if labels else self._no_labels()).value


class Gauge(Metric):
    """A value that can go up and down."""

    metric_type = "gauge"

    def _make_child(self) -> _Child:
        return _Child(threading.Lock())

    def set(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels else self._no_labels()).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels else self._no_labels()).inc(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels else self._no_labels()).dec(amount)

    def value(self, **labels) -> float:
        return (self.labels(**labels) if labels else self._no_labels()).value


class Histogram(Metric):
    """Distribution with cumulative ``le`` buckets (Prometheus semantics)."""

    metric_type = "histogram"

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, documentation, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(threading.Lock(), self.buckets)

    def observe(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels else self._no_labels()).observe(value)

    def time(self, **labels):
        """Context manager observing the block's wall duration in seconds."""
        return _Timer(self.labels(**labels) if labels else self._no_labels())


class _Timer:
    __slots__ = ("_child", "_start")

    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._start)
        return False


class MetricsRegistry:
    """Thread-safe get-or-create home for metrics. One process-wide instance
    (:data:`REGISTRY`) serves all instrumented layers; components may also carry
    a private registry (tests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, documentation: str, labelnames: Sequence[str], **kwargs) -> Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, documentation, labelnames, **kwargs)
                self._metrics[name] = metric
                return metric
        assert isinstance(metric, cls), (
            f"metric {name!r} is already registered as a {metric.metric_type}"
        )
        assert metric.labelnames == tuple(labelnames), (
            f"metric {name!r} is already registered with labels {metric.labelnames}"
        )
        return metric

    def counter(self, name: str, documentation: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, documentation, labelnames)

    def gauge(self, name: str, documentation: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, documentation, labelnames)

    def histogram(
        self,
        name: str,
        documentation: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, documentation, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def snapshot(self) -> Dict[str, dict]:
        """Compact JSON-able view: per metric, per label-tuple value (histograms:
        count/sum only — the swarm view aggregates totals, not shapes). This is
        what the DHT publisher ships and what run artifacts embed."""
        out: Dict[str, dict] = {}
        for metric in self.collect():
            series: Dict[str, object] = {}
            for key, child in metric.series():
                label = ",".join(f"{n}={v}" for n, v in zip(metric.labelnames, key)) or "_"
                if metric.metric_type == "histogram":
                    _buckets, total, count = child.snapshot()  # type: ignore[union-attr]
                    series[label] = {"count": count, "sum": round(total, 6)}
                else:
                    series[label] = round(child.value, 6)  # type: ignore[union-attr]
            out[metric.name] = {"type": metric.metric_type, "series": series}
        return out


REGISTRY = MetricsRegistry()
