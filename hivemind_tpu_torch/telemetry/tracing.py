"""Distributed tracing (the port's copy of hivemind_tpu/telemetry/tracing.py):
cross-peer spans, an always-on flight recorder, and Chrome-trace/Perfetto export.

The registry's metrics answer "how much / how often"; this module answers *why was this
round slow, and which peer stalled it*. The pieces:

- :class:`Span` — one timed operation: ``trace_id``/``span_id``/``parent_id``
  (64-bit), monotonic start/end, attributes, and a list of timestamped events
  (chaos injections, breaker trips, retries land here — see
  ``resilience/chaos.py``, ``resilience/breaker.py``, ``resilience/policy.py``).
- :func:`trace` — contextvar-scoped span context manager; :func:`current_span`
  reads the active one. Works across ``await`` (tasks inherit contextvars).
- :class:`SpanRecorder` — the flight recorder: a bounded per-process ring
  buffer of *finished* spans. Always on, fixed memory, oldest-evicted. Spans
  whose duration crosses :func:`set_slow_span_threshold` are additionally kept
  in a small side ring and logged with their event chain.
- :func:`render_chrome_trace` — Chrome trace-event JSON (loads directly in
  Perfetto / ``chrome://tracing``). Each distinct ``peer`` attribute becomes
  one pid row, so multi-peer-in-one-process tests and real swarm dumps both
  read as one row per peer. Served at ``GET /trace`` by
  :class:`~hivemind_tpu_torch.telemetry.exporter.MetricsExporter`.

Cross-peer propagation: the transport piggybacks the active span's
``(trace_id, span_id)`` on the mux OPEN frame (16 bytes, only when a span is
active), so a server-side handler span becomes a child of the remote caller's
span; :func:`pack_context` / :func:`unpack_context` define the wire form, which
a torch peer and a JAX peer share.

Cost discipline: with tracing disabled
(``HIVEMIND_TRACE=0``) an instrumented site costs one module-bool check and
one contextvar read; with it enabled (the default) a span is one small object
plus a ring-buffer append at exit — no serialization happens anywhere off the
export path.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CTX_STRUCT = struct.Struct(">QQ")  # (trace_id, span_id) — the wire context

# ------------------------------------------------------------- telemetry clock
#
# Spans are timed with :func:`telemetry_time` — ``time.perf_counter`` by
# default (monotonic, immune to NTP steps). The simulator swaps it for the
# virtual loop clock via :func:`set_telemetry_time_source` (mirroring
# ``set_dht_time_source``: a module-global function pointer, NOT a
# monkeypatch, because callers across the tree bind these functions at
# import). Export adds the wall anchor from :func:`wall_anchor` so timelines
# from different peers align on the wall clock.
#
# The anchor used to be computed ONCE at import: over a
# long run perf_counter and the wall clock drift apart (and an NTP step moves
# the wall clock outright), so an import-time anchor skews cross-peer merges
# by however much the clocks diverged since startup. It is now re-computed
# when older than _ANCHOR_MAX_AGE_S, and the spool segment headers record the
# anchor plus the drift observed at the last re-anchor (wall_anchor_info) so
# post-mortem merges can bound the residual skew.

_ANCHOR_MAX_AGE_S = 60.0
# {"anchor": wall - perf at last re-anchor, "at": monotonic re-anchor time,
#  "drift_s": anchor movement observed at the last re-anchor} — dict ops are
# GIL-atomic; a racing re-anchor just recomputes the same values.
_anchor_state: Dict[str, float] = {
    "anchor": time.time() - time.perf_counter(), "at": time.monotonic(), "drift_s": 0.0
}

_time_source = None  # swapped by the sim; None = time.perf_counter
_wall_source = None  # paired wall clock; None = time.time


def set_telemetry_time_source(source=None, wall_source=None) -> None:
    """Swap the clock spans/ledgers/watchdogs are timed with (None restores
    the defaults). ``source`` replaces ``perf_counter`` for span timing;
    ``wall_source`` replaces ``time.time`` for record timestamps and defaults
    to ``source`` — the virtual loop clock starts at an epoch-magnitude value,
    so it serves as both, and the wall anchor is then exactly 0.0 (per-peer
    spools from one sim merge without skew correction)."""
    global _time_source, _wall_source
    _time_source = source
    _wall_source = wall_source if wall_source is not None else source


def telemetry_time() -> float:
    """The span clock: ``perf_counter`` unless the sim swapped it."""
    if _time_source is not None:
        return _time_source()
    return time.perf_counter()


def wall_time() -> float:
    """Wall-clock timestamps for ledger/watchdog records: ``time.time``
    unless the sim swapped the clock (virtual time is epoch-magnitude)."""
    if _wall_source is not None:
        return _wall_source()
    return time.time()


def _reanchor() -> None:
    state = _anchor_state
    new_anchor = time.time() - time.perf_counter()
    state["drift_s"] = round(new_anchor - state["anchor"], 6)
    state["anchor"] = new_anchor
    state["at"] = time.monotonic()


def wall_anchor() -> float:
    """Offset such that ``telemetry_time() + wall_anchor() ≈ wall_time()``.
    Re-anchored when stale; exactly 0.0 under a virtual clock."""
    if _time_source is not None:
        return 0.0
    state = _anchor_state
    if time.monotonic() - state["at"] > _ANCHOR_MAX_AGE_S:
        _reanchor()
    return state["anchor"]


def wall_anchor_info() -> Dict[str, Any]:
    """Anchor + drift estimate for spool segment headers: ``{"anchor",
    "drift_s", "age_s", "clock"}`` where drift_s is how far the anchor moved
    at the last re-anchor (≈ clock divergence per _ANCHOR_MAX_AGE_S window)."""
    if _time_source is not None:
        return {"anchor": 0.0, "drift_s": 0.0, "age_s": 0.0, "clock": "virtual"}
    anchor = wall_anchor()
    state = _anchor_state
    return {
        "anchor": round(anchor, 6),
        "drift_s": state["drift_s"],
        "age_s": round(time.monotonic() - state["at"], 3),
        "clock": "wall",
    }

_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "hivemind_current_span", default=None
)

# best-effort per-THREAD view of the innermost open `trace` block, for observers
# that cannot read another thread's contextvars (the event-loop watchdog wants
# "which span was executing when the loop stalled"). Only `trace` blocks update
# it. While a thread is synchronously blocked INSIDE a trace block, the entry is
# the blocking span; if the blocker runs outside any trace block (a bare loop
# callback), the entry may be a suspended task's still-open span — the watchdog's
# stall event then carries the accurate blocking FRAME but an approximate span
# association. Dict ops are GIL-atomic.
_THREAD_SPANS: Dict[int, "Span"] = {}


def thread_current_span(thread_id: int) -> Optional["Span"]:
    """The innermost `trace` block open on the given thread (best-effort)."""
    return _THREAD_SPANS.get(thread_id)

# one rng for id generation; seeded from the OS so forked peers diverge.
# random.Random methods are atomic under the GIL — no lock needed.
_ids = random.Random(int.from_bytes(os.urandom(8), "big") ^ os.getpid())


def seed_trace_ids(seed: int) -> None:
    """Reseed the trace/span id rng. The rng is OS-seeded so forked peers
    diverge — which also means two same-seed sim runs produce different ids;
    sim scenarios call this so spool contents are bit-identical per seed."""
    global _ids
    _ids = random.Random(seed)

enabled = os.environ.get("HIVEMIND_TRACE", "1") != "0"


def _new_id() -> int:
    return _ids.getrandbits(64) or 1  # 0 is reserved for "no id"


class Span:
    """One timed operation. Created via :func:`trace` / :func:`start_span`;
    finished spans land in the flight recorder."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attributes", "events", "thread_id",
    )

    def __init__(
        self,
        name: str,
        trace_id: Optional[int] = None,
        parent_id: Optional[int] = None,
        attributes: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id if trace_id else _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = telemetry_time()
        self.end: Optional[float] = None
        self.attributes = attributes
        self.events: Optional[List[Tuple[float, str, Optional[Dict[str, Any]]]]] = None
        self.thread_id = threading.get_ident()

    # ------------------------------------------------------------------ recording

    def set(self, key: str, value: Any) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes[key] = value

    def add_event(self, name: str, **attributes: Any) -> None:
        """Record a timestamped event on this span (chaos injection, breaker
        trip, retry attempt, ...). Cheap: one tuple append."""
        if self.events is None:
            self.events = []
        self.events.append((telemetry_time(), name, attributes or None))

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else telemetry_time()) - self.start

    def context_bytes(self) -> bytes:
        """The 16-byte wire context piggybacked on RPC envelopes."""
        return _CTX_STRUCT.pack(self.trace_id, self.span_id)

    # ------------------------------------------------------------------ export

    def summary(self) -> Dict[str, Any]:
        """Compact JSON-able view (DHT peer snapshots, monitor timelines)."""
        out: Dict[str, Any] = {
            "name": self.name,
            "trace": f"{self.trace_id:016x}",
            "span": f"{self.span_id:016x}",
            "start": round(self.start + wall_anchor(), 6),
            "dur_ms": round(self.duration * 1e3, 3),
        }
        if self.parent_id:
            out["parent"] = f"{self.parent_id:016x}"
        if self.attributes:
            out.update({k: v for k, v in self.attributes.items() if isinstance(v, (str, int, float, bool))})
        if self.events:
            out["events"] = [name for _t, name, _a in self.events]
        return out

    def __repr__(self) -> str:
        state = f"{self.duration * 1e3:.2f}ms" if self.end is not None else "open"
        return f"Span({self.name!r}, trace={self.trace_id:016x}, {state})"


def pack_context(span: Optional[Span]) -> Optional[bytes]:
    """Wire context of a span (None when there is nothing to propagate)."""
    return None if span is None else span.context_bytes()


def unpack_context(raw: Optional[bytes]) -> Optional[Tuple[int, int]]:
    """Parse a remote peer's 16-byte context; None when absent or malformed
    (a peer must not be able to crash a handler with a bad envelope)."""
    if raw is None or len(raw) != _CTX_STRUCT.size:
        return None
    try:
        trace_id, span_id = _CTX_STRUCT.unpack(raw)
    except struct.error:  # pragma: no cover - length is checked above
        return None
    return (trace_id, span_id) if trace_id and span_id else None


# ---------------------------------------------------------------------- recorder


class SpanRecorder:
    """The flight recorder: a fixed-capacity ring of finished spans. Appends
    are one deque op (GIL-atomic); the oldest span is evicted at capacity, so
    memory is bounded no matter how long the process runs."""

    def __init__(self, capacity: int = 4096, slow_capacity: int = 32):
        self._ring: "deque[Span]" = deque(maxlen=capacity)
        self._slow: "deque[Span]" = deque(maxlen=slow_capacity)
        self.slow_threshold = float(os.environ.get("HIVEMIND_SLOW_SPAN_S", "10.0"))
        self.dropped = 0  # spans evicted so far (diagnosing undersized rings)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, span: Span) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(span)
        if span.end is not None and span.end - span.start >= self.slow_threshold:
            self._slow.append(span)
            chain = [name for _t, name, _a in span.events] if span.events else []
            logger.warning(
                f"slow span {span.name!r}: {span.duration:.3f}s "
                f"(threshold {self.slow_threshold}s), events={chain}, "
                f"trace={span.trace_id:016x}"
            )

    def snapshot(self) -> List[Span]:
        return list(self._ring)

    def slow_spans(self) -> List[Span]:
        return list(self._slow)

    def summaries(self, limit: int = 30) -> List[Dict[str, Any]]:
        """The most recent ``limit`` finished spans, compact (peer snapshots)."""
        ring = self._ring
        spans = list(ring)[-limit:] if limit else list(ring)
        return [span.summary() for span in spans]

    def clear(self) -> None:
        self._ring.clear()
        self._slow.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)


RECORDER = SpanRecorder()


def set_slow_span_threshold(seconds: float) -> None:
    """Spans at least this long are kept in the slow ring and logged with
    their event chain (the "why was this round slow" log line)."""
    RECORDER.slow_threshold = float(seconds)


# ---------------------------------------------------------------------- creation


def current_span() -> Optional[Span]:
    """The span active in this task/thread, or None."""
    return _current_span.get()


def install_span(span: Optional[Span]):
    """Make ``span`` current WITHOUT a context manager (returns the reset token
    for :func:`uninstall_span`). For operations whose span outlives the block
    that created it — e.g. futures-mode DHT gets, where the span is finished
    from a done-callback after the creating coroutine returned."""
    return _current_span.set(span)


def uninstall_span(token) -> None:
    _current_span.reset(token)


def start_span(
    name: str,
    parent: Optional[Span] = None,
    remote_context: Optional[Tuple[int, int]] = None,
    **attributes: Any,
) -> Optional[Span]:
    """Create a span WITHOUT installing it as current (for code that cannot
    hold a context manager open, e.g. async generators — a generator's body
    runs in its consumer's context, so installing would leak). Finish with
    :func:`finish_span`. Returns None when tracing is disabled."""
    if not enabled:
        return None
    if parent is None and remote_context is None:
        parent = _current_span.get()
    if remote_context is not None:
        trace_id, parent_id = remote_context
    else:
        trace_id = parent.trace_id if parent is not None else None
        parent_id = parent.span_id if parent is not None else None
    span = Span(name, trace_id=trace_id, parent_id=parent_id, attributes=attributes or None)
    for listener in _SPAN_START_LISTENERS:
        try:
            listener(span)
        except Exception as e:  # pragma: no cover - listeners must stay harmless
            logger.debug(f"span start listener failed on {span.name!r}: {e!r}")
    return span


# finished-span listeners (the round ledger subscribes here): called after the
# recorder append, exceptions swallowed — attribution must never fail the
# operation it observes. Kept as a plain list read without a lock (GIL-atomic);
# registration happens at import/startup time.
_SPAN_LISTENERS: List = []

# span-START listeners (the black-box spool subscribes here): a crash-killed
# peer's last operation never reaches finish_span, so post-mortem needs the
# open span on disk BEFORE the work runs. Every code path creating a span goes
# through start_span (trace.__enter__ included), so this is the one hook.
_SPAN_START_LISTENERS: List = []


def add_span_listener(listener) -> None:
    """Register ``listener(span)`` to run on every finished span."""
    if listener not in _SPAN_LISTENERS:
        _SPAN_LISTENERS.append(listener)


def remove_span_listener(listener) -> None:
    try:
        _SPAN_LISTENERS.remove(listener)
    except ValueError:
        pass


def add_span_start_listener(listener) -> None:
    """Register ``listener(span)`` to run on every span CREATION (the span is
    still open — its ``end`` is None and attributes may still grow)."""
    if listener not in _SPAN_START_LISTENERS:
        _SPAN_START_LISTENERS.append(listener)


def remove_span_start_listener(listener) -> None:
    try:
        _SPAN_START_LISTENERS.remove(listener)
    except ValueError:
        pass


def finish_span(span: Optional[Span], recorder: Optional[SpanRecorder] = None) -> None:
    """Stamp the end time and append to the flight recorder. None-safe so call
    sites need no enabled-check of their own."""
    if span is None:
        return
    span.end = telemetry_time()
    (recorder if recorder is not None else RECORDER).record(span)
    for listener in _SPAN_LISTENERS:
        try:
            listener(span)
        except Exception as e:  # pragma: no cover - listeners must stay harmless
            logger.debug(f"span listener failed on {span.name!r}: {e!r}")


class trace:
    """``with trace("dht.store", peer=...) as span:`` — create a child of the
    current span, install it for the block, record it at exit. The standard
    way to instrument a code path; use :func:`start_span` only where a context
    manager cannot wrap the operation."""

    __slots__ = ("_name", "_attributes", "_remote", "_parent", "span", "_token", "_thread_prev")

    def __init__(
        self,
        name: str,
        remote_context: Optional[Tuple[int, int]] = None,
        parent: Optional[Span] = None,
        **attributes: Any,
    ):
        self._name = name
        self._attributes = attributes
        self._remote = remote_context
        self._parent = parent
        self.span: Optional[Span] = None
        self._token = None
        self._thread_prev: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        if not enabled:
            return None
        self.span = start_span(
            self._name, parent=self._parent, remote_context=self._remote, **self._attributes
        )
        self._token = _current_span.set(self.span)
        tid = threading.get_ident()
        self._thread_prev = _THREAD_SPANS.get(tid)
        _THREAD_SPANS[tid] = self.span
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
            tid = threading.get_ident()
            # interleaved asyncio tasks enter/exit in non-stack order: only
            # restore when the table still points at US (otherwise a later
            # task's live entry would be clobbered), and never reinstall a
            # span that already finished while we were suspended
            if _THREAD_SPANS.get(tid) is self.span:
                if self._thread_prev is not None and self._thread_prev.end is None:
                    _THREAD_SPANS[tid] = self._thread_prev
                else:
                    _THREAD_SPANS.pop(tid, None)
            self._thread_prev = None
        if self.span is not None:
            if exc_type is not None:
                self.span.add_event("error", type=exc_type.__name__)
            finish_span(self.span)
        return False


# ---------------------------------------------------------------------- export


# fixed tids for the compute-vs-comm lanes; real thread ids are
# huge, so small constants cannot collide in practice
_LANE_TIDS = {"compute": 1, "comm": 2}


def _span_lane(name: str) -> Optional[str]:
    """Lazy bridge to device.span_lane — device.py imports tracing, so tracing
    must not import it back at module scope."""
    try:
        from hivemind_tpu_torch.telemetry.device import span_lane

        return span_lane(name)
    except Exception:
        return None


def render_chrome_trace(
    spans: Optional[Iterable[Span]] = None, default_peer: str = "local"
) -> Dict[str, Any]:
    """Spans as a Chrome trace-event JSON object (the ``{"traceEvents": [...]}``
    form; opens directly in Perfetto / ``chrome://tracing``).

    pid/tid mapping: each distinct ``peer`` span attribute becomes one pid row
    (named via ``process_name`` metadata); tids are the recording threads,
    EXCEPT comm/compute spans: those land on two fixed named lanes
    per peer — ``compute`` (tid 1) and ``comm`` (tid 2) — so the overlap the
    StepTimeline scores is visible as two stacked rows in Perfetto. Span
    events render as instant events on the same row, and every event carries
    its trace/span/parent ids in ``args`` so traces remain greppable."""
    spans = RECORDER.snapshot() if spans is None else list(spans)
    anchor = wall_anchor()
    peers: Dict[str, int] = {}
    lanes_used: set = set()  # (pid, lane)
    events: List[Dict[str, Any]] = []
    for span in spans:
        peer = default_peer
        if span.attributes is not None:
            peer = str(span.attributes.get("peer", default_peer))
        pid = peers.get(peer)
        if pid is None:
            pid = peers[peer] = len(peers) + 1
        ts_us = (span.start + anchor) * 1e6
        dur_us = max(span.duration * 1e6, 0.001)
        args: Dict[str, Any] = {
            "trace_id": f"{span.trace_id:016x}",
            "span_id": f"{span.span_id:016x}",
        }
        if span.parent_id:
            args["parent_id"] = f"{span.parent_id:016x}"
        if span.attributes:
            args.update(
                {k: v for k, v in span.attributes.items() if isinstance(v, (str, int, float, bool))}
            )
        lane = _span_lane(span.name)
        if lane is not None:
            tid = _LANE_TIDS[lane]
            args["lane"] = lane
            lanes_used.add((pid, lane))
        else:
            tid = span.thread_id % 2**31
        events.append(
            {
                "name": span.name, "cat": "span", "ph": "X",
                "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                "pid": pid, "tid": tid, "args": args,
            }
        )
        for when, event_name, event_attrs in span.events or ():
            instant_args = {"span_id": f"{span.span_id:016x}"}
            if event_attrs:
                instant_args.update(event_attrs)
            events.append(
                {
                    "name": event_name, "cat": "event", "ph": "i", "s": "t",
                    "ts": round((when + anchor) * 1e6, 3),
                    "pid": pid, "tid": tid, "args": instant_args,
                }
            )
    for peer, pid in peers.items():
        events.append(
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"peer {peer}"},
            }
        )
    for pid, lane in sorted(lanes_used):
        events.append(
            {
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": _LANE_TIDS[lane], "args": {"name": lane},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_chrome_trace_json(spans: Optional[Iterable[Span]] = None) -> str:
    return json.dumps(render_chrome_trace(spans), default=str)
