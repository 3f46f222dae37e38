"""Device-side observability for the CUDA card (the port of
hivemind_tpu/telemetry/device.py): the accelerator's sibling of the
ledger/watchdog stack. Three instruments:

- :class:`JitCompileTracker` — the compile ledger. The port has no jit: its
  compile event is an ``nvcc`` build of one kernel library in ``ops/_build.py``,
  recorded under the site ``build.<source>`` (e.g. ``build.flash_attention``)
  with the build's wall seconds. A library loaded from the build cache is not a
  compile. Detects **recompile storms** (N compiles of one site inside a window
  → loud warning, exactly once per window).
- :class:`DeviceMemoryMonitor` — allocated / peak bytes and live allocations
  per card from the CUDA caching allocator, sampled by the watchdog tick. It
  never creates a CUDA context: a process that has not used the card pays
  nothing because telemetry looked. A monotonic-growth heuristic flags
  suspected leaks.
- :class:`StepTimeline` — assembled from finished spans: comm wall-time
  (``allreduce.round``, ``averaging.matchmaking``) intersected with compute
  intervals (``optimizer.update``, ``device.compute``) yields an **overlap
  efficiency** scalar — the fraction of comm hidden under compute. Ratios are
  stamped onto the RoundLedger's round records and epoch rollups.

Counting (kernel builds, :func:`record_transfer`, span listeners) is always-on
and hot-path cheap; :func:`arm_device_telemetry` additionally hooks the memory
sampler into the watchdog tick. Everything surfaces through
:func:`device_snapshot` and through device listeners (the black-box spool's
``device`` frames).
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.registry import REGISTRY
from hivemind_tpu_torch.telemetry import tracing as _tracing
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_COMPILES = REGISTRY.counter(
    "hivemind_device_compiles_total",
    "kernel library compiles observed, by site (build.<source>: one nvcc build)",
    ("site",),
)
_COMPILE_SECONDS = REGISTRY.histogram(
    "hivemind_device_compile_seconds",
    "wall seconds per observed compile (one nvcc build of one kernel library)",
    ("site",),
)
_STORMS = REGISTRY.counter(
    "hivemind_device_recompile_storms_total",
    "recompile storms detected: >= storm_threshold compiles of one site inside "
    "storm_window_s (fires once per window per site)",
    ("site",),
)
_MEMORY_BYTES = REGISTRY.gauge(
    "hivemind_device_memory_bytes",
    "bytes allocated per card by the CUDA caching allocator (torch.cuda.memory_allocated)",
    ("device",),
)
_MEMORY_PEAK_BYTES = REGISTRY.gauge(
    "hivemind_device_memory_peak_bytes",
    "peak allocated bytes per card: the allocator's max_memory_allocated, or the "
    "high-water mark of sampled bytes when that is larger",
    ("device",),
)
_LIVE_BUFFERS = REGISTRY.gauge(
    "hivemind_device_live_buffers",
    "live allocations per card at the last sample (allocation.all.current)",
    ("device",),
)
_LEAKS = REGISTRY.counter(
    "hivemind_device_memory_leak_suspected_total",
    "times the monotonic-growth heuristic fired: live bytes grew on every one "
    "of leak_samples consecutive watchdog samples by >= leak_min_growth total",
)
_TRANSFER = REGISTRY.counter(
    "hivemind_device_transfer_bytes_total",
    "bytes crossing the host<->device boundary on instrumented hot paths "
    "(expert batch upload/download, decode KV steps, state averaging mirrors)",
    ("direction",),
)
_OVERLAP = REGISTRY.gauge(
    "hivemind_device_overlap_ratio",
    "overlap efficiency of the most recent comm round: fraction of its wall "
    "time hidden under recorded compute intervals",
)

# cached children: record_transfer sits on per-batch/per-token paths
_TRANSFER_H2D = _TRANSFER.labels(direction="host_to_device")
_TRANSFER_D2H = _TRANSFER.labels(direction="device_to_host")

_H2D = "host_to_device"
_D2H = "device_to_host"

# Prometheus counters are process-cumulative by contract, but device_snapshot()
# promises "empty when nothing device-side has happened" after a reset — so the
# snapshot view subtracts the baseline captured by reset_device_telemetry().
_TRANSFER_BASELINE = {_H2D: 0, _D2H: 0}

# device-record listeners: the black-box spool subscribes here so compile /
# storm / leak / overlap / memory records survive a crash as ``device`` frames
_DEVICE_LISTENERS: List[Callable[[str, Dict[str, Any]], None]] = []


def add_device_listener(listener: Callable[[str, Dict[str, Any]], None]) -> None:
    """Subscribe ``listener(kind, record)`` to device telemetry records. Kinds:
    ``compile`` | ``storm`` | ``memory`` | ``leak`` | ``overlap``."""
    if listener not in _DEVICE_LISTENERS:
        _DEVICE_LISTENERS.append(listener)


def remove_device_listener(listener: Callable[[str, Dict[str, Any]], None]) -> None:
    try:
        _DEVICE_LISTENERS.remove(listener)
    except ValueError:
        pass


def _notify(kind: str, record: Dict[str, Any]) -> None:
    for listener in list(_DEVICE_LISTENERS):
        try:
            listener(kind, record)
        except Exception as e:  # a broken subscriber must not break the hot path
            logger.warning(f"device listener failed on {kind}: {e!r}")


def record_transfer(nbytes: int, direction: str) -> None:
    """Account ``nbytes`` crossing the host↔device boundary. Direction is
    ``host_to_device`` or ``device_to_host``. One cached-child counter inc —
    cheap enough for per-batch and per-token call sites."""
    if nbytes <= 0:
        return
    if direction == _H2D:
        _TRANSFER_H2D.inc(nbytes)
    elif direction == _D2H:
        _TRANSFER_D2H.inc(nbytes)
    else:
        raise ValueError(f"unknown transfer direction {direction!r}")


def transfer_totals() -> Dict[str, int]:
    """Bytes transferred since the last :func:`reset_device_telemetry` (the raw
    ``hivemind_device_transfer_bytes_total`` counters never reset)."""
    return {
        _H2D: int(_TRANSFER_H2D.value) - _TRANSFER_BASELINE[_H2D],
        _D2H: int(_TRANSFER_D2H.value) - _TRANSFER_BASELINE[_D2H],
    }


# ------------------------------------------------------------------ compiles


class JitCompileTracker:
    """Process-wide compile ledger. Each ``nvcc`` build of a kernel library
    (``ops/_build.py``) reports here under ``build.<source>``. Detects recompile
    storms: ``storm_threshold``
    compiles of one site within ``storm_window_s`` fires a loud warning and a
    counter — exactly once per window, so a runaway site cannot also flood the
    logs."""

    def __init__(self, storm_threshold: int = 5, storm_window_s: float = 60.0):
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._seconds: Dict[str, float] = {}
        self._signatures: Dict[str, str] = {}  # last abstract signature per site
        self._recent: Dict[str, deque] = {}  # site -> recent compile timestamps
        self._storm_fired_at: Dict[str, float] = {}
        self._storms = 0
        self._last: Optional[Dict[str, Any]] = None

    def record_compile(
        self, site: str, duration_s: float = 0.0, signature: Optional[str] = None
    ) -> None:
        now = _tracing.telemetry_time()
        storm = False
        with self._lock:
            self._counts[site] = self._counts.get(site, 0) + 1
            self._seconds[site] = self._seconds.get(site, 0.0) + float(duration_s)
            if signature:
                self._signatures[site] = signature
            recent = self._recent.get(site)
            if recent is None:
                recent = self._recent[site] = deque(maxlen=max(self.storm_threshold * 4, 16))
            recent.append(now)
            in_window = sum(1 for t in recent if now - t <= self.storm_window_s)
            if in_window >= self.storm_threshold:
                fired = self._storm_fired_at.get(site)
                if fired is None or now - fired >= self.storm_window_s:
                    self._storm_fired_at[site] = now
                    self._storms += 1
                    storm = True
            record = {
                "site": site,
                "count": self._counts[site],
                "dur_s": round(float(duration_s), 6),
                "signature": signature,
            }
            self._last = record
        _COMPILES.inc(site=site)
        _COMPILE_SECONDS.observe(float(duration_s), site=site)
        span = _tracing.current_span()
        if span is not None:
            span.add_event("device.compile", site=site, dur_ms=round(duration_s * 1e3, 3))
        if storm:
            _STORMS.inc(site=site)
            logger.warning(
                f"RECOMPILE STORM at site {site!r}: >= {self.storm_threshold} compiles "
                f"within {self.storm_window_s:.0f}s (total {self._counts[site]}; last "
                f"signature {signature!r}) — the build cache is not being reused"
            )
            _notify("storm", {"site": site, "count": self._counts[site]})
        _notify("compile", record)

    # ------------------------------------------------------------- inspection

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        """Cumulative compiles across sites (the steady-state mark: 0 once every
        kernel library is built)."""
        with self._lock:
            return sum(self._counts.values())

    def storm_count(self) -> int:
        with self._lock:
            return self._storms

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            sites = {
                site: {
                    "count": count,
                    "seconds": round(self._seconds.get(site, 0.0), 4),
                    **(
                        {"signature": self._signatures[site]}
                        if site in self._signatures
                        else {}
                    ),
                }
                for site, count in sorted(self._counts.items())
            }
            return {
                "total": sum(self._counts.values()),
                "seconds": round(sum(self._seconds.values()), 4),
                "storms": self._storms,
                "sites": sites,
                "last": dict(self._last) if self._last else None,
            }

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._seconds.clear()
            self._signatures.clear()
            self._recent.clear()
            self._storm_fired_at.clear()
            self._storms = 0
            self._last = None


COMPILE_TRACKER = JitCompileTracker()


# ------------------------------------------------------------------- memory


class DeviceMemoryMonitor:
    """Allocated/peak bytes and live allocations per card, from the CUDA caching
    allocator.

    ``sample()`` NEVER imports torch or creates a CUDA context: it reads
    ``sys.modules`` (the same discipline as the watchdog's executor sampler) and
    returns None unless ``torch.cuda.is_initialized()`` — so a process that has
    not used the card pays nothing. Per card (``cuda:<i>``) it reads
    ``memory_allocated`` (the bytes gauge), ``max_memory_allocated`` (the peak),
    ``memory_stats()["allocation.all.current"]`` (live allocations) and
    ``memory_reserved`` (``backend_bytes_in_use``: what the allocator holds from
    the driver).

    Leak heuristic: allocated bytes strictly grew on ``leak_samples``
    consecutive samples AND the total growth exceeds ``leak_min_growth`` bytes →
    warn + counter, then restart the episode (no refiring every tick)."""

    def __init__(self, leak_samples: int = 8, leak_min_growth: int = 8 << 20):
        self.leak_samples = int(leak_samples)
        self.leak_min_growth = int(leak_min_growth)
        self._lock = threading.Lock()
        self._trend: deque = deque(maxlen=max(self.leak_samples, 2))
        self._peak: Dict[str, int] = {}
        self._leaks = 0
        self.last_sample: Optional[Dict[str, Any]] = None

    def sample(self, modules=None) -> Optional[Dict[str, Any]]:
        torch = (modules if modules is not None else sys.modules).get("torch")
        cuda = getattr(torch, "cuda", None)
        try:
            if cuda is None or not cuda.is_initialized():
                return None
            per_device = {}
            for index in range(cuda.device_count()):
                stats = cuda.memory_stats(index)
                per_device[f"cuda:{index}"] = (
                    int(cuda.memory_allocated(index)),
                    int(stats.get("allocation.all.current", 0)),
                    int(cuda.max_memory_allocated(index)),
                    int(cuda.memory_reserved(index)),
                )
        except Exception:
            return None
        snapshot: Dict[str, Any] = {"devices": {}, "total_bytes": 0, "buffers": 0}
        with self._lock:
            for key, (nbytes, buffers, backend_peak, reserved) in sorted(per_device.items()):
                self._peak[key] = max(self._peak.get(key, 0), nbytes, backend_peak)
                snapshot["devices"][key] = {
                    "bytes": nbytes, "buffers": buffers, "peak_bytes": self._peak[key],
                    "backend_bytes_in_use": reserved,
                }
                snapshot["total_bytes"] += nbytes
                snapshot["buffers"] += buffers
                _MEMORY_BYTES.set(nbytes, device=key)
                _MEMORY_PEAK_BYTES.set(self._peak[key], device=key)
                _LIVE_BUFFERS.set(buffers, device=key)
            self._trend.append(snapshot["total_bytes"])
            leak = (
                len(self._trend) == self._trend.maxlen
                and all(b > a for a, b in zip(self._trend, list(self._trend)[1:]))
                and self._trend[-1] - self._trend[0] >= self.leak_min_growth
            )
            if leak:
                self._leaks += 1
                growth = self._trend[-1] - self._trend[0]
                self._trend.clear()  # restart the episode: fire once, not every tick
            self.last_sample = snapshot
        if leak:
            _LEAKS.inc()
            logger.warning(
                f"suspected device memory leak: allocated bytes grew monotonically "
                f"across {self.leak_samples} samples (+{growth} bytes, now "
                f"{snapshot['total_bytes']}) — check for caches or sessions pinned "
                f"on the card"
            )
            _notify("leak", {"growth_bytes": growth, "total_bytes": snapshot["total_bytes"]})
        return snapshot

    def leak_count(self) -> int:
        with self._lock:
            return self._leaks

    def reset(self) -> None:
        with self._lock:
            self._trend.clear()
            self._peak.clear()
            self._leaks = 0
            self.last_sample = None


MEMORY_MONITOR = DeviceMemoryMonitor()


# ------------------------------------------------------------------ timeline

# top-level comm spans only: peer_exchange / local_reduce are CHILDREN of
# allreduce.round — counting them too would double-count comm wall time
COMM_SPAN_NAMES = frozenset({"allreduce.round", "averaging.matchmaking", "averaging.aggregate"})
COMPUTE_SPAN_NAMES = frozenset({"optimizer.update", "device.compute", "moe.forward", "moe.backward"})
# child spans that still belong on the comm LANE in the Perfetto export
_COMM_LANE_PREFIXES = ("allreduce.", "averaging.")


def span_lane(name: str) -> Optional[str]:
    """Perfetto lane for a span name: ``comm`` / ``compute`` / None (default
    lane). Used by the chrome-trace exports to render compute-vs-comm rows."""
    if name in COMPUTE_SPAN_NAMES:
        return "compute"
    if name in COMM_SPAN_NAMES or name.startswith(_COMM_LANE_PREFIXES):
        return "comm"
    return None


class StepTimeline:
    """Comm/compute correlation from finished spans (registered as a span
    listener at import, like the RoundLedger).

    Compute spans (``optimizer.update``, ``device.compute``, expert
    forward/backward) append intervals to a bounded per-peer ring. When a
    top-level comm span finishes, its wall window is intersected with the union
    of that peer's recorded compute intervals: ``overlap_ratio`` = overlapped
    seconds / comm seconds — 0.0 when the round ran bare, 1.0 when it hid
    entirely under compute. Each ratio is stamped onto the RoundLedger (round
    records + epoch rollups) and pushed to device listeners; ``optimizer.step``
    spans additionally close per-step records carrying the grad-ready offset."""

    def __init__(self, capacity: int = 256, step_capacity: int = 64):
        self._lock = threading.Lock()
        self._compute: Dict[str, deque] = {}  # peer -> deque[(start, end)]
        self._records: deque = deque(maxlen=capacity)  # comm overlap records
        self._steps: deque = deque(maxlen=step_capacity)
        self._grad_ready: Dict[str, float] = {}
        self._capacity = capacity
        self._overlap_sum = 0.0
        self._overlap_count = 0

    # ------------------------------------------------------------ span intake

    def on_span(self, span) -> None:
        name = span.name
        if name in COMPUTE_SPAN_NAMES:
            self._on_compute(span)
        elif name in COMM_SPAN_NAMES:
            self._on_comm(span)
        elif name == "optimizer.step":
            self._on_step(span)

    def _peer_of(self, span) -> str:
        attrs = span.attributes or {}
        return str(attrs.get("peer", ""))

    def _on_compute(self, span) -> None:
        peer = self._peer_of(span)
        end = span.end if span.end is not None else _tracing.telemetry_time()
        with self._lock:
            ring = self._compute.get(peer)
            if ring is None:
                ring = self._compute[peer] = deque(maxlen=self._capacity)
            ring.append((span.start, end))

    def note_grad_ready(self, peer: str = "") -> None:
        """Optimizers mark the moment gradients finished accumulating; the next
        ``optimizer.step`` record carries the offset (backward → comm handoff)."""
        with self._lock:
            self._grad_ready[str(peer)] = _tracing.telemetry_time()

    def _on_comm(self, span) -> None:
        peer = self._peer_of(span)
        end = span.end if span.end is not None else _tracing.telemetry_time()
        start, dur = span.start, max(end - span.start, 0.0)
        with self._lock:
            intervals = [
                iv
                for iv in self._compute.get(peer, ())
                if iv[1] > start and iv[0] < end
            ]
            overlapped = _union_overlap(intervals, start, end)
            ratio = round(overlapped / dur, 4) if dur > 0 else 0.0
            record = {
                "kind": span.name,
                "peer": peer,
                "start": round(start, 6),
                "dur_s": round(dur, 6),
                "overlap_s": round(overlapped, 6),
                "overlap_ratio": ratio,
            }
            self._records.append(record)
            self._overlap_sum += ratio
            self._overlap_count += 1
        _OVERLAP.set(ratio)
        if span.name == "allreduce.round":
            # stamp the ledger lazily: device → ledger is a one-way dependency
            from hivemind_tpu_torch.telemetry.ledger import LEDGER

            LEDGER.note_overlap(peer, ratio)
        _notify("overlap", record)

    def _on_step(self, span) -> None:
        peer = self._peer_of(span)
        end = span.end if span.end is not None else _tracing.telemetry_time()
        record = {
            "peer": peer,
            "start": round(span.start, 6),
            "dur_s": round(max(end - span.start, 0.0), 6),
        }
        attrs = span.attributes or {}
        if "epoch" in attrs:
            record["epoch"] = attrs["epoch"]
        with self._lock:
            grad_ready = self._grad_ready.get(peer)
            if grad_ready is not None and span.start <= grad_ready <= end:
                record["grad_ready_s"] = round(grad_ready - span.start, 6)
            self._steps.append(record)

    # ------------------------------------------------------------- inspection

    def overlap_summary(self) -> Dict[str, Any]:
        with self._lock:
            if not self._overlap_count:
                return {"rounds": 0}
            return {
                "rounds": self._overlap_count,
                "last": self._records[-1]["overlap_ratio"] if self._records else None,
                "mean": round(self._overlap_sum / self._overlap_count, 4),
            }

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._steps)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            records = list(self._records)[-5:]
            steps = len(self._steps)
        out = {"overlap": self.overlap_summary(), "steps": steps}
        if records:
            out["recent"] = records
        return out

    def clear(self) -> None:
        with self._lock:
            self._compute.clear()
            self._records.clear()
            self._steps.clear()
            self._grad_ready.clear()
            self._overlap_sum = 0.0
            self._overlap_count = 0


def _union_overlap(intervals: List[Tuple[float, float]], start: float, end: float) -> float:
    """Seconds of [start, end] covered by the union of ``intervals``."""
    total = 0.0
    cursor = start
    for iv_start, iv_end in sorted(intervals):
        lo, hi = max(iv_start, cursor), min(iv_end, end)
        if hi > lo:
            total += hi - lo
            cursor = hi
        if cursor >= end:
            break
    return total


STEP_TIMELINE = StepTimeline()
_tracing.add_span_listener(STEP_TIMELINE.on_span)


# ------------------------------------------------------------------ snapshot


def device_snapshot() -> Dict[str, Any]:
    """The ``device`` section of the DHT peer snapshot / hivemind-top board:
    compile totals per site, last memory sample, transfer totals, overlap
    summary. Empty dict when nothing device-side has happened (lightweight
    peers publish no device section at all)."""
    out: Dict[str, Any] = {}
    compiles = COMPILE_TRACKER.summary()
    if compiles["total"]:
        out["compiles"] = compiles
    memory = MEMORY_MONITOR.last_sample
    if memory:
        out["memory"] = memory
    if MEMORY_MONITOR.leak_count():
        out["leaks_suspected"] = MEMORY_MONITOR.leak_count()
    transfers = transfer_totals()
    if any(transfers.values()):
        out["transfer_bytes"] = transfers
    overlap = STEP_TIMELINE.overlap_summary()
    if overlap.get("rounds"):
        out["overlap"] = overlap
    return out


def compact_device_snapshot(section: Dict[str, Any]) -> Dict[str, Any]:
    """Shrink a device section for snapshot budgets: drop per-site compile
    detail and the per-device memory map, keep the headline numbers."""
    out: Dict[str, Any] = {}
    compiles = section.get("compiles")
    if compiles:
        out["compiles"] = {
            "total": compiles.get("total"),
            "seconds": compiles.get("seconds"),
            "storms": compiles.get("storms"),
        }
    memory = section.get("memory")
    if memory:
        out["memory"] = {
            "total_bytes": memory.get("total_bytes"),
            "buffers": memory.get("buffers"),
        }
    for key in ("leaks_suspected", "transfer_bytes", "overlap"):
        if key in section:
            out[key] = section[key]
    return out


# -------------------------------------------------------------------- arming

_ARMED = False


def _watchdog_sampler() -> None:
    MEMORY_MONITOR.sample()
    memory = MEMORY_MONITOR.last_sample
    if memory:
        _notify("memory", memory)


def arm_device_telemetry() -> None:
    """Turn on the sampled half of device telemetry: the memory sampler rides
    the watchdog tick. The counting half (kernel builds, transfers, the span
    timeline) is always-on. Idempotent."""
    global _ARMED
    from hivemind_tpu_torch.telemetry import watchdog as _watchdog

    _watchdog.add_tick_sampler(_watchdog_sampler)
    _ARMED = True


def disarm_device_telemetry() -> None:
    global _ARMED
    from hivemind_tpu_torch.telemetry import watchdog as _watchdog

    _watchdog.remove_tick_sampler(_watchdog_sampler)
    _ARMED = False


def device_telemetry_armed() -> bool:
    return _ARMED


def reset_device_telemetry() -> None:
    """Test hygiene (conftest): zero the trackers and disarm the samplers, the
    device-side mirror of LEDGER.clear()/disarm_blackbox()."""
    disarm_device_telemetry()
    COMPILE_TRACKER.reset()
    MEMORY_MONITOR.reset()
    STEP_TIMELINE.clear()
    del _DEVICE_LISTENERS[:]
    _TRANSFER_BASELINE[_H2D] = int(_TRANSFER_H2D.value)
    _TRANSFER_BASELINE[_D2H] = int(_TRANSFER_D2H.value)
