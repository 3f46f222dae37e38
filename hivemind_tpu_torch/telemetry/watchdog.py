"""Event-loop watchdog (the port of hivemind_tpu/telemetry/watchdog.py): lag
probe, stall stack capture, and executor-queue-depth gauges.

A server's request path runs on one asyncio loop — so the most
common *silent* failure mode is a blocked event loop: a synchronous call that
sneaks onto the loop thread makes this peer stop answering matchmaking, DHT
RPCs and part streams at once, and to the rest of the swarm it is
indistinguishable from a network straggler. The watchdog makes that failure
loud and attributable:

- **lag probe** — a daemon thread schedules a heartbeat callback onto the
  watched loop every ``HIVEMIND_WATCHDOG_INTERVAL_S`` (default 0.25 s) and
  observes scheduled→executed delta into the
  ``hivemind_event_loop_lag_seconds`` histogram (label: ``loop``);
- **stall capture** — when the heartbeat does not land within
  ``HIVEMIND_STALL_THRESHOLD_S`` (default 1.0 s), the loop thread's stack is
  captured *right now* via ``sys._current_frames()`` — naming the exact frame
  that is blocking — logged, attached as an ``event_loop.stall`` event on the
  span active on the loop thread, kept on ``last_stall`` for programmatic
  consumers, and counted in ``hivemind_event_loop_stalls_total``. One stall
  episode counts once, however long it lasts;
- **executor gauges** — each tick samples the shared thread pools' backlog
  into ``hivemind_executor_queue_depth`` (label: ``executor`` ∈ ``blocking`` /
  ``aead``; the port's transport, which owns the ``aead`` pool, comes later): a deep blocking-pool queue with a healthy loop means
  the *executor* is the bottleneck, not the loop.

Wiring: :func:`ensure_watchdog` is idempotent per loop and called wherever a
loop-owning component starts, so any process that serves is watched without
the operator doing anything. ``HIVEMIND_WATCHDOG=0`` disables it.
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.telemetry.tracing import thread_current_span, wall_time
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

enabled = os.environ.get("HIVEMIND_WATCHDOG", "1") != "0"

DEFAULT_STALL_THRESHOLD_S = float(os.environ.get("HIVEMIND_STALL_THRESHOLD_S", "1.0"))
DEFAULT_INTERVAL_S = float(os.environ.get("HIVEMIND_WATCHDOG_INTERVAL_S", "0.25"))

# loop lag skews far smaller than RPC latency: sub-millisecond buckets matter
_LAG_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LOOP_LAG = REGISTRY.histogram(
    "hivemind_event_loop_lag_seconds",
    "scheduled-to-executed delta of the watchdog heartbeat on an event loop",
    ("loop",),
    buckets=_LAG_BUCKETS,
)
_STALLS = REGISTRY.counter(
    "hivemind_event_loop_stalls_total",
    "event-loop stalls (heartbeat missing past the stall threshold)",
    ("loop",),
)
_EXECUTOR_DEPTH = REGISTRY.gauge(
    "hivemind_executor_queue_depth",
    "tasks queued (not yet running) in a shared thread pool",
    ("executor",),
)


# extra per-tick samplers: device telemetry registers its memory
# probe here so card-memory gauges ride the existing watchdog cadence instead of
# growing another daemon thread. Samplers must be cheap and never instantiate
# lazy state (same discipline as _executor_queue_depths).
_TICK_SAMPLERS: List = []


def add_tick_sampler(sampler) -> None:
    """Register a zero-arg callable invoked on every watchdog tick (all
    watchdogs). Idempotent; exceptions are swallowed per tick."""
    if sampler not in _TICK_SAMPLERS:
        _TICK_SAMPLERS.append(sampler)


def remove_tick_sampler(sampler) -> None:
    try:
        _TICK_SAMPLERS.remove(sampler)
    except ValueError:
        pass


def _run_tick_samplers() -> None:
    for sampler in list(_TICK_SAMPLERS):
        try:
            sampler()
        except Exception as e:
            logger.debug(f"watchdog tick sampler failed: {e!r}")


def _executor_queue_depths() -> Dict[str, int]:
    """Backlogs of the shared pools; only pools that already exist are sampled
    (peeking must never instantiate an executor)."""
    depths: Dict[str, int] = {}
    asyncio_utils = sys.modules.get("hivemind_tpu_torch.utils.asyncio_utils")
    if asyncio_utils is not None:
        executor = getattr(asyncio_utils, "_blocking_executor", None)
        if executor is not None:
            depths["blocking"] = executor._work_queue.qsize()
    crypto_channel = sys.modules.get("hivemind_tpu_torch.p2p.crypto_channel")
    if crypto_channel is not None:
        aead = getattr(crypto_channel, "_aead_executor", None)
        if aead is not None:
            depths["aead"] = aead._work_queue.qsize()
    return depths


class EventLoopWatchdog:
    """Watch one asyncio loop from a daemon thread. Use :func:`ensure_watchdog`
    in production code; tests construct private instances with tight thresholds
    and their own registry."""

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        name: str = "loop",
        *,
        interval: Optional[float] = None,
        stall_threshold: Optional[float] = None,
        registry: MetricsRegistry = REGISTRY,
        start: bool = True,
    ):
        self.loop = loop
        self.name = name
        self.interval = interval if interval is not None else DEFAULT_INTERVAL_S
        self.stall_threshold = (
            stall_threshold if stall_threshold is not None else DEFAULT_STALL_THRESHOLD_S
        )
        self._lag = registry.histogram(
            "hivemind_event_loop_lag_seconds",
            _LOOP_LAG.documentation,
            ("loop",),
            buckets=_LAG_BUCKETS,
        ).labels(name)
        self._stall_counter = registry.counter(
            "hivemind_event_loop_stalls_total", _STALLS.documentation, ("loop",)
        ).labels(name)
        self._depth_gauge = registry.gauge(
            "hivemind_executor_queue_depth", _EXECUTOR_DEPTH.documentation, ("executor",)
        )
        self.max_lag = 0.0
        self.stalls = 0
        self.last_stall: Optional[Dict[str, Any]] = None
        self._loop_thread_id: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"loop-watchdog-{self.name}", daemon=True
        )
        self._thread.start()

    @property
    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.loop.is_closed():
                break
            if not self._tick():
                break
            self._sample_executors()
            _run_tick_samplers()
            self._stop.wait(self.interval)

    def _tick(self) -> bool:
        """One heartbeat round-trip; returns False when the loop is gone."""
        fired = threading.Event()
        executed: List[float] = []

        def _beat() -> None:
            executed.append(time.perf_counter())
            if self._loop_thread_id is None:
                self._loop_thread_id = threading.get_ident()
            fired.set()

        scheduled = time.perf_counter()
        try:
            self.loop.call_soon_threadsafe(_beat)
        except RuntimeError:
            return False  # loop closed under us: a normal shutdown, not a stall
        if not fired.wait(self.stall_threshold):
            # a stopping/closed loop discards scheduled callbacks: that is a
            # clean shutdown, not a stall (is_running stays True while a
            # genuinely BLOCKED loop sits inside a callback, so real stalls
            # still capture)
            if self._stop.is_set() or self.loop.is_closed() or not self.loop.is_running():
                return False
            self._capture_stall(scheduled)
            # keep waiting for THIS heartbeat: the episode's full length lands
            # in the histogram once, and heartbeats never pile up behind a stall
            while not fired.wait(self.stall_threshold):
                # same exits as above: a loop stopped (but perhaps never
                # closed) after the capture must not wedge this thread forever
                if self._stop.is_set() or self.loop.is_closed() or not self.loop.is_running():
                    return False
        lag = max(executed[0] - scheduled, 0.0)
        self.max_lag = max(self.max_lag, lag)
        self._lag.observe(lag)
        return True

    def _capture_stall(self, scheduled: float) -> None:
        stack = "<loop thread not identified yet>"
        blocked_for = time.perf_counter() - scheduled
        if self._loop_thread_id is not None:
            frame = sys._current_frames().get(self._loop_thread_id)
            if frame is not None:
                stack = "".join(traceback.format_stack(frame))
        self.stalls += 1
        self._stall_counter.inc()
        # the stack's last line names the blocking call — the short form that
        # travels in snapshots/events; the full stack stays local (log + here)
        frame_tail = stack.strip().splitlines()[-1].strip() if stack else ""
        self.last_stall = {
            "time": round(wall_time(), 3),
            "loop": self.name,
            "blocked_s_at_capture": round(blocked_for, 3),
            "threshold_s": self.stall_threshold,
            "frame": frame_tail[:200],
            "stack": stack,
        }
        logger.warning(
            f"event loop {self.name!r} stalled: heartbeat missing for "
            f"{blocked_for:.2f}s (threshold {self.stall_threshold}s); loop thread stack:\n{stack}"
        )
        if self._loop_thread_id is not None:
            span = thread_current_span(self._loop_thread_id)
            if span is not None and span.end is None:
                span.add_event(
                    "event_loop.stall",
                    loop=self.name,
                    blocked_s=round(blocked_for, 3),
                    frame=frame_tail[:200],
                )

    def _sample_executors(self) -> None:
        try:
            for label, depth in _executor_queue_depths().items():
                self._depth_gauge.set(depth, executor=label)
        except Exception as e:  # pragma: no cover - private-attr peeking may drift
            logger.debug(f"executor depth sampling failed: {e!r}")

    def shutdown(self, timeout: float = 2.0) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)


# ---------------------------------------------------------------- process-wide

_WATCHDOGS: Dict[int, EventLoopWatchdog] = {}
_watchdogs_lock = threading.Lock()


def ensure_watchdog(
    loop: Optional[asyncio.AbstractEventLoop] = None, name: str = "hmtpu-loop"
) -> Optional[EventLoopWatchdog]:
    """Start (or return) the watchdog for ``loop`` (default: the running loop).
    Idempotent per loop object — the averager, DHT and MoE server all share one
    loop and one watchdog. Returns None when disabled (``HIVEMIND_WATCHDOG=0``)
    or no loop is available."""
    if not enabled:
        return None
    if loop is None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return None
    with _watchdogs_lock:
        existing = _WATCHDOGS.get(id(loop))
        if existing is not None and existing.is_alive and not loop.is_closed():
            return existing
        watchdog = EventLoopWatchdog(loop, name=name)
        _WATCHDOGS[id(loop)] = watchdog
        return watchdog


def active_watchdogs() -> List[EventLoopWatchdog]:
    with _watchdogs_lock:
        return [w for w in _WATCHDOGS.values() if w.is_alive]


def shutdown_all() -> None:
    """Stop every registered watchdog (test isolation; conftest calls this)."""
    with _watchdogs_lock:
        watchdogs = list(_WATCHDOGS.values())
        _WATCHDOGS.clear()
    for watchdog in watchdogs:
        watchdog.shutdown()


def watchdog_summary() -> Dict[str, Any]:
    """Rollup for BENCH artifacts and the dashboard: stall count, worst lag,
    and the loops being watched."""
    watchdogs = active_watchdogs()
    summary: Dict[str, Any] = {
        "loops": sorted({w.name for w in watchdogs}),
        "stalls": sum(w.stalls for w in watchdogs),
        "max_lag_s": round(max((w.max_lag for w in watchdogs), default=0.0), 6),
        "stall_threshold_s": max((w.stall_threshold for w in watchdogs), default=DEFAULT_STALL_THRESHOLD_S),
    }
    last = [w.last_stall for w in watchdogs if w.last_stall is not None]
    if last:
        newest = max(last, key=lambda s: s["time"])
        summary["last_stall"] = {k: v for k, v in newest.items() if k != "stack"}
    return summary
