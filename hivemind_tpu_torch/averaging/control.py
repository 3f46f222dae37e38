"""StepControl: the caller's handle for one averaging step
(the port of hivemind_tpu/averaging/control.py; upstream: hivemind/averaging/control.py).

Upstream hivemind backs this with an 18-byte shared-memory buffer piped between processes;
in the single-process runtime it is a plain object whose mutable fields are read from
both the user thread and the event-loop thread (GIL-atomic scalar reads/writes), with
concurrent futures for the cross-thread completion path."""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from enum import Enum
from typing import Any, Optional

from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time


class AveragingStage(Enum):
    IDLE = 0
    LOOKING_FOR_GROUP = 1
    AWAITING_TRIGGER = 2
    RUNNING_ALLREDUCE = 3
    FINISHED = 4


class StepControl:
    """Two-phase step handle: schedule (matchmaking may begin early) → trigger
    (caller permits the all-reduce to actually run once gradients are ready)."""

    def __init__(
        self,
        scheduled_time: DHTExpiration,
        deadline: Optional[float],
        allow_retries: bool,
        weight: float,
        data_for_gather: bytes = b"",
    ):
        self._scheduled_time = scheduled_time
        self.deadline = deadline
        self.allow_retries = allow_retries
        self._weight = weight
        self.data_for_gather = data_for_gather
        self.stage = AveragingStage.IDLE
        self.began_allreduce = False
        self._trigger_event = threading.Event()
        self._trigger_waiters: list = []  # (loop, asyncio.Event) pairs
        self._lock = threading.Lock()
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self._cancelled = False

    # ---------------------------------------------------------------- schedule/weight

    @property
    def scheduled_time(self) -> DHTExpiration:
        return self._scheduled_time

    @scheduled_time.setter
    def scheduled_time(self, value: DHTExpiration) -> None:
        if self.began_allreduce:
            raise RuntimeError("cannot reschedule: all-reduce already started")
        self._scheduled_time = value

    def reset_for_retry(self, new_scheduled_time: DHTExpiration) -> None:
        """A failed attempt is being retried: rearm scheduling state (the property
        setters deliberately refuse changes once began_allreduce is set)."""
        self.began_allreduce = False
        self._scheduled_time = new_scheduled_time

    @property
    def weight(self) -> float:
        return self._weight

    @weight.setter
    def weight(self, value: float) -> None:
        assert value >= 0
        if self.began_allreduce:
            raise RuntimeError("cannot change weight: all-reduce already started")
        self._weight = value

    # ---------------------------------------------------------------- trigger

    def allow_allreduce(self) -> None:
        """Phase-two commit: permit the scheduled step to run its all-reduce."""
        self.triggered or self._fire_trigger()

    def _fire_trigger(self) -> None:
        with self._lock:
            self._trigger_event.set()
            for loop, event in self._trigger_waiters:
                loop.call_soon_threadsafe(event.set)
            self._trigger_waiters.clear()

    @property
    def triggered(self) -> bool:
        return self._trigger_event.is_set()

    async def wait_for_trigger(self) -> None:
        if self._trigger_event.is_set():
            return
        loop = asyncio.get_event_loop()
        event = asyncio.Event()
        with self._lock:
            if self._trigger_event.is_set():
                return
            self._trigger_waiters.append((loop, event))
        await event.wait()

    # ---------------------------------------------------------------- completion

    def cancel(self) -> bool:
        self._cancelled = True
        self._fire_trigger()  # wake anything waiting so it can observe cancellation
        if not self.future.done():
            return self.future.cancel()
        return False

    @property
    def cancelled(self) -> bool:
        return self._cancelled or self.future.cancelled()

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.future.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self.future.exception(timeout)

    def set_result(self, result: Any) -> None:
        if not self.future.done():
            self.future.set_result(result)
        self.stage = AveragingStage.FINISHED

    def set_exception(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)
        self.stage = AveragingStage.FINISHED

    def get_timeout(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - get_dht_time())

    def __repr__(self):
        return (
            f"StepControl(stage={self.stage.name}, scheduled_in={self._scheduled_time - get_dht_time():.2f}s, "
            f"weight={self._weight}, triggered={self.triggered}, done={self.done()})"
        )
