"""Per-peer circuit breakers (the port's copy of
hivemind_tpu/resilience/breaker.py): ONE health-score implementation behind
every ban list in the stack.

Before this module three modules kept independent ad-hoc ban state: the DHT
node's ``Blacklist`` (timed exponential backoff), the MoE client's dead-expert
masking (no memory at all — every batch re-probed every dead expert), and each
all-reduce round's ``banned_senders`` set (permanent within the round). All
three are now :class:`BreakerBoard` instances with different parameters:

========================  ===================  =====================================
consumer                  board name           parameters
========================  ===================  =====================================
DHT node blacklist        ``dht_blacklist``    threshold 1, timed backoff, dht clock
MoE expert blacklist      ``moe_expert``       threshold 2, 30 s recovery, backoff 2x
all-reduce sender bans    ``allreduce_senders``threshold 1, infinite recovery
========================  ===================  =====================================

State machine (classic closed -> open -> half-open):

- **closed**: requests flow; ``failure_threshold`` consecutive failures trip it.
- **open**: requests are refused (``key in board`` is True) until
  ``recovery_time`` elapses; the window doubles (``backoff_rate``) per re-trip,
  capped at ``max_recovery_time``.
- **half-open**: the window elapsed. :meth:`BreakerBoard.allow` admits up to
  ``half_open_max_probes`` concurrent probe requests; a probe success closes the
  breaker (full reset), a probe failure re-opens it with a longer window.
  ``in`` / :meth:`BreakerBoard.is_banned` are PURE reads (half-open reads as
  not-banned) so checking cannot consume probe slots.

Telemetry (registered in the process-wide registry, docs/observability.md):
``hivemind_breaker_trips_total{board}``, ``hivemind_breaker_tripped{board}``
(tripped = open or awaiting a probe), and
``hivemind_breaker_probe_outcomes_total{board,outcome}``.
"""

from __future__ import annotations

import enum
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional

from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import current_span as _current_span

_BREAKER_TRIPS = _TELEMETRY.counter(
    "hivemind_breaker_trips_total", "circuit-breaker trips (-> open)", ("board",)
)
_BREAKER_TRIPPED = _TELEMETRY.gauge(
    "hivemind_breaker_tripped", "breakers currently open or awaiting a probe", ("board",)
)
_BREAKER_PROBES = _TELEMETRY.counter(
    "hivemind_breaker_probe_outcomes_total", "half-open probe outcomes", ("board", "outcome")
)


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class BreakerOpenError(RuntimeError):
    """A request was refused because the target's breaker is open."""


class CircuitBreaker:
    """One protected target. Not thread-safe on its own — the owning
    :class:`BreakerBoard` serializes access."""

    __slots__ = (
        "failure_threshold", "recovery_time", "backoff_rate", "max_recovery_time",
        "half_open_max_probes", "_clock", "_consecutive_failures", "_open_until",
        "_current_recovery", "_probes_admitted", "_last_probe_at", "trip_count",
    )

    def __init__(
        self,
        *,
        failure_threshold: int = 1,
        recovery_time: float = 5.0,
        backoff_rate: float = 2.0,
        max_recovery_time: float = float("inf"),
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.recovery_time = recovery_time
        self.backoff_rate = backoff_rate
        self.max_recovery_time = max_recovery_time
        self.half_open_max_probes = half_open_max_probes
        self._clock = clock
        self._consecutive_failures = 0
        self._open_until: Optional[float] = None
        self._current_recovery = recovery_time
        self._probes_admitted = 0
        self._last_probe_at: Optional[float] = None
        self.trip_count = 0

    @property
    def state(self) -> BreakerState:
        if self._open_until is None:
            return BreakerState.CLOSED
        if self._clock() < self._open_until:
            return BreakerState.OPEN
        return BreakerState.HALF_OPEN

    @property
    def tripped(self) -> bool:
        """Open or half-open: tripped at some point and not yet closed again."""
        return self._open_until is not None

    def is_banned(self) -> bool:
        """Pure read: True only while hard-open (no side effects, so callers may
        check as often as they like)."""
        return self.state is BreakerState.OPEN

    def allow(self) -> bool:
        """Probe-limited admission: True when a request may proceed. In
        half-open this consumes one of ``half_open_max_probes`` slots. A probe
        that never reports back (cancelled task, crashed caller) must not wedge
        the breaker: once ``recovery_time`` passes since the last admission with
        no verdict, the slots re-open."""
        state = self.state
        if state is BreakerState.CLOSED:
            return True
        if state is BreakerState.OPEN:
            return False
        now = self._clock()
        if (
            self._probes_admitted >= self.half_open_max_probes
            and self._last_probe_at is not None
            and self.recovery_time != float("inf")
            and now - self._last_probe_at >= self.recovery_time
        ):
            self._probes_admitted = 0
        if self._probes_admitted < self.half_open_max_probes:
            self._probes_admitted += 1
            self._last_probe_at = now
            return True
        return False

    def record_failure(self) -> tuple:
        """Returns (tripped_now: bool, probe_outcome: Optional[str])."""
        if self.recovery_time <= 0:
            return False, None  # breaking disabled (Blacklist base_time=0 parity)
        state = self.state
        if state is BreakerState.OPEN:
            return False, None  # in-flight stragglers failing adds no new evidence
        if state is BreakerState.HALF_OPEN:
            self._trip()
            return True, "failure"
        self._consecutive_failures += 1
        if self._consecutive_failures >= self.failure_threshold:
            self._trip()
            return True, None
        return False, None

    def record_success(self) -> Optional[str]:
        """Returns the probe outcome ("success") when this closed a half-open
        breaker, else None."""
        was_half_open = self.state is BreakerState.HALF_OPEN
        self._consecutive_failures = 0
        self._open_until = None
        self._current_recovery = self.recovery_time
        self._probes_admitted = 0
        # a success forgives history entirely (DHT Blacklist parity): the next
        # trip escalates from the base window and ban_counter reads 0
        self.trip_count = 0
        return "success" if was_half_open else None

    def _trip(self) -> None:
        self.trip_count += 1
        self._consecutive_failures = 0
        self._probes_admitted = 0
        self._open_until = self._clock() + self._current_recovery
        self._current_recovery = min(self._current_recovery * self.backoff_rate, self.max_recovery_time)


_ALL_BOARDS: "weakref.WeakSet[BreakerBoard]" = weakref.WeakSet()


class BreakerBoard:
    """A keyed family of :class:`CircuitBreaker` with shared parameters and one
    telemetry identity. Thread-safe. ``key in board`` means *banned right now*
    (pure read); :meth:`allow` is the mutating probe-admission check."""

    def __init__(
        self,
        name: str,
        *,
        maxsize: int = 10_000,
        failure_threshold: int = 1,
        recovery_time: float = 5.0,
        backoff_rate: float = 2.0,
        max_recovery_time: float = float("inf"),
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.maxsize = maxsize
        self._kwargs = dict(
            failure_threshold=failure_threshold,
            recovery_time=recovery_time,
            backoff_rate=backoff_rate,
            max_recovery_time=max_recovery_time,
            half_open_max_probes=half_open_max_probes,
            clock=clock,
        )
        self._breakers: "OrderedDict[Hashable, CircuitBreaker]" = OrderedDict()
        self._lock = threading.Lock()
        self._tripped_keys: set = set()
        _ALL_BOARDS.add(self)

    # ------------------------------------------------------------------ internals

    def _get(self, key: Hashable, create: bool) -> Optional[CircuitBreaker]:
        breaker = self._breakers.get(key)
        if breaker is None and create:
            breaker = self._breakers[key] = CircuitBreaker(**self._kwargs)
            if len(self._breakers) > self.maxsize:
                self._evict()
        elif breaker is not None:
            self._breakers.move_to_end(key)
        return breaker

    def _evict(self) -> None:
        """Drop oldest non-tripped entries past the cap (tripped ones carry the
        very state the board exists for)."""
        for stale_key in list(self._breakers):
            if len(self._breakers) <= self.maxsize:
                return
            if not self._breakers[stale_key].tripped:
                del self._breakers[stale_key]
        while len(self._breakers) > self.maxsize:  # pathological: everyone tripped
            dropped_key, _ = self._breakers.popitem(last=False)
            self._note_recovered(dropped_key)

    def _note_tripped(self, key: Hashable) -> None:
        if key not in self._tripped_keys:
            self._tripped_keys.add(key)
            _BREAKER_TRIPPED.set(len(self._tripped_keys), board=self.name)

    def _note_recovered(self, key: Hashable) -> None:
        if key in self._tripped_keys:
            self._tripped_keys.discard(key)
            _BREAKER_TRIPPED.set(len(self._tripped_keys), board=self.name)

    # ------------------------------------------------------------------ API

    def register_failure(self, key: Hashable) -> None:
        with self._lock:
            breaker = self._get(key, create=True)
            tripped_now, probe_outcome = breaker.record_failure()
            if tripped_now:
                _BREAKER_TRIPS.inc(board=self.name)
                self._note_tripped(key)
            if probe_outcome is not None:
                _BREAKER_PROBES.inc(board=self.name, outcome=probe_outcome)
        if tripped_now or probe_outcome is not None:
            # trips and failed probes are trace-worthy: the operation that
            # tripped the breaker carries the event on its active span
            span = _current_span()
            if span is not None:
                if tripped_now:
                    span.add_event("breaker.trip", board=self.name, key=str(key))
                if probe_outcome is not None:
                    span.add_event("breaker.probe", board=self.name, key=str(key), outcome=probe_outcome)

    def register_success(self, key: Hashable) -> None:
        with self._lock:
            breaker = self._get(key, create=False)
            if breaker is None:
                return
            probe_outcome = breaker.record_success()
            if probe_outcome is not None:
                _BREAKER_PROBES.inc(board=self.name, outcome=probe_outcome)
            self._note_recovered(key)
        if probe_outcome is not None:
            span = _current_span()
            if span is not None:
                span.add_event("breaker.probe", board=self.name, key=str(key), outcome=probe_outcome)

    def allow(self, key: Hashable) -> bool:
        """Probe-admission check (mutating in half-open): call ONCE per request."""
        with self._lock:
            breaker = self._get(key, create=False)
            return True if breaker is None else breaker.allow()

    def is_banned(self, key: Hashable) -> bool:
        with self._lock:
            breaker = self._breakers.get(key)
            return breaker is not None and breaker.is_banned()

    def __contains__(self, key: Hashable) -> bool:
        return self.is_banned(key)

    def state(self, key: Hashable) -> BreakerState:
        with self._lock:
            breaker = self._breakers.get(key)
            return BreakerState.CLOSED if breaker is None else breaker.state

    def trip_count(self, key: Hashable) -> int:
        with self._lock:
            breaker = self._breakers.get(key)
            return 0 if breaker is None else breaker.trip_count

    @property
    def ban_counter(self) -> Dict[Hashable, int]:
        """Legacy DHT ``Blacklist.ban_counter`` view: key -> times tripped."""
        with self._lock:
            return {key: b.trip_count for key, b in self._breakers.items() if b.trip_count}

    def tripped_keys(self) -> list:
        """Keys currently open or awaiting a probe (the soak's recovery check)."""
        with self._lock:
            return [key for key, b in self._breakers.items() if b.tripped]

    def all_closed(self) -> bool:
        return not self.tripped_keys()

    def reconfigure(self, **overrides) -> None:
        """Change breaker parameters (e.g. shrink recovery_time for a soak) and
        clear — existing breakers carry old parameters, so they are dropped."""
        unknown = set(overrides) - set(self._kwargs)
        assert not unknown, f"unknown breaker parameters: {unknown}"
        self._kwargs.update(overrides)
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._breakers.clear()
            self._tripped_keys.clear()
            _BREAKER_TRIPPED.set(0, board=self.name)

    def __len__(self) -> int:
        with self._lock:
            return len(self._breakers)

    def __repr__(self) -> str:
        return f"BreakerBoard({self.name!r}, {len(self)} keys, {len(self.tripped_keys())} tripped)"


def reset_all_boards() -> None:
    """Clear every live board (test isolation: boards are often module-level)."""
    for board in list(_ALL_BOARDS):
        board.clear()


def all_board_states() -> Dict[str, Dict[str, object]]:
    """Compact health view of every live board — what the DHT-published peer
    snapshot carries so the swarm monitor can show WHICH peers are degraded,
    not just their counters. Only boards with any tripped key appear."""
    out: Dict[str, Dict[str, object]] = {}
    for board in list(_ALL_BOARDS):
        tripped = [str(key) for key in board.tripped_keys()]
        if tripped:
            out[board.name] = {"tripped": sorted(tripped)[:16], "num_tripped": len(tripped)}
    return out
