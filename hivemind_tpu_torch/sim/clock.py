"""Virtual time for the in-process swarm simulator.

The simulator runs hundreds-to-thousands of peers whose protocols are paced by
timers — matchmaking windows, DHT expirations, republish cadences, WAN link
delays. Sleeping those out in wall time would make a 1k-peer scenario take
hours and make every run racy. :class:`VirtualClockEventLoop` makes time
*event-driven* instead: ``loop.time()`` is a simulated clock, and whenever the
loop would block waiting for its next timer it jumps the clock straight to
that timer's deadline. A scenario that simulates 600 seconds of swarm time
completes in however long its CPU work actually takes, and — because callback
order is decided by the timer heap and FIFO ready queue, never by the host's
scheduler — the same seed replays the exact same execution.

``get_dht_time`` (utils/timed_storage.py) must track the same clock so DHT
expirations, declaration windows and blacklist backoffs live in simulated
time; :func:`install_virtual_time` wires both and restores wall time on exit.
"""

from __future__ import annotations

import asyncio
import math
from typing import Optional

from hivemind_tpu_torch.telemetry.tracing import set_telemetry_time_source
from hivemind_tpu_torch.utils.timed_storage import set_dht_time_source

# consecutive selector polls with nothing scheduled and nothing ready before the
# loop declares the simulation deadlocked (a real deadlock, e.g. awaiting a
# future nobody will ever resolve, would otherwise spin silently forever)
_MAX_IDLE_POLLS = 500


class SimDeadlockError(RuntimeError):
    """The virtual-clock loop has no timers, no ready callbacks and no I/O:
    nothing can ever make progress again."""


class VirtualClockEventLoop(asyncio.SelectorEventLoop):
    """An asyncio loop whose clock is simulated (see module docstring).

    All waits must be timer- or callback-driven (pure in-process simulation).
    Real file descriptors still poll (zero-timeout), so a stray
    ``call_soon_threadsafe`` from another thread is delivered rather than
    deadlocking — but anything thread-timed breaks determinism and has no
    place in a scenario.
    """

    def __init__(self, start_time: float = 1_000_000_000.0):
        super().__init__()
        self._vtime = float(start_time)
        self._idle_polls = 0
        self._real_select = self._selector.select
        self._selector.select = self._virtual_select  # type: ignore[method-assign]
        # virtual time is epoch-magnitude (~1e9) where a double's ulp is ~1.2e-7:
        # with the host's nanosecond clock resolution, a timer landing within one
        # ulp of "now" would never satisfy `when < time() + resolution` and the
        # loop would spin forever on a sub-ulp timeout. One microsecond of sim
        # granularity makes those timers fire; nothing in the swarm is sub-µs.
        self._clock_resolution = max(self._clock_resolution, 1e-6)

    def time(self) -> float:
        return self._vtime

    def _virtual_select(self, timeout: Optional[float] = None):
        events = self._real_select(0)
        if events:
            self._idle_polls = 0
            return events
        if timeout is None:
            # no timer scheduled: only a cross-thread wakeup could help. Poll
            # briefly on the real clock (without advancing virtual time) so a
            # threadsafe callback still lands; a deterministic scenario never
            # reaches this branch, so a long stay here is a deadlocked sim.
            self._idle_polls += 1
            if self._idle_polls > _MAX_IDLE_POLLS:
                raise SimDeadlockError(
                    "virtual clock: no timers, no ready callbacks and no I/O — "
                    "the simulation is waiting on something that can never happen"
                )
            return self._real_select(0.02)
        self._idle_polls = 0
        if timeout > 0:
            # jump straight to the next timer deadline; a timeout below the
            # current ulp must still advance by one representable tick or the
            # loop would spin at a frozen clock
            advanced = self._vtime + timeout
            if advanced <= self._vtime:
                advanced = math.nextafter(self._vtime, math.inf)
            self._vtime = advanced
        return events


def install_virtual_time(loop: VirtualClockEventLoop) -> None:
    """Point ``get_dht_time`` AND the telemetry clock (spans, ledgers,
    watchdog stamps, black-box spools) at the loop's virtual
    clock. Virtual time starts at an epoch magnitude, so it serves as both
    the span clock and the wall clock; the wall anchor is exactly 0 and
    same-seed runs spool bit-identical telemetry."""
    set_dht_time_source(loop.time)
    set_telemetry_time_source(loop.time)


def uninstall_virtual_time() -> None:
    """Restore wall-clock swarm time (always call from a finally block)."""
    set_dht_time_source(None)
    set_telemetry_time_source(None)
