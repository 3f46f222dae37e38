"""Composable retry and deadline policies (the port's copy of
hivemind_tpu/resilience/policy.py) — the one place failure-handling *shape* is
decided.

Before this module, every layer hand-rolled its own loops: p2p retried dials,
the DHT retried via its blacklist, matchmaking slept ad-hoc jittered intervals,
and the MoE client kept three separate ``for attempt in range(...)`` loops.
Each had its own backoff curve and its own bugs. A :class:`RetryPolicy` is a
small immutable value describing *when to retry and how long to wait*; call
sites either run a callable through :meth:`RetryPolicy.execute` /
:meth:`RetryPolicy.execute_sync` or pull :meth:`RetryPolicy.delay` into an
existing loop they cannot invert.

:class:`Deadline` replaces stacked independent ``asyncio.wait_for`` timeouts
with ONE remaining-time budget that shrinks as it propagates through nested
awaits — three sequential 5 s waits under a 10 s budget can no longer add up
to 15 s of worst-case latency.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional, Tuple, Type, TypeVar

from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import current_span as _current_span

T = TypeVar("T")

_RETRIES = _TELEMETRY.counter(
    "hivemind_resilience_retries_total", "retries performed by named RetryPolicy sites", ("site",)
)


class DeadlineExceeded(asyncio.TimeoutError):
    """The remaining-time budget ran out. Subclasses ``asyncio.TimeoutError`` so
    every existing ``except asyncio.TimeoutError`` failure path handles it."""


class Deadline:
    """A monotonic remaining-time budget. ``Deadline(None)`` is unlimited.

    The object is cheap and immutable; pass it DOWN through nested calls so
    that each layer waits at most what the whole operation has left.
    """

    __slots__ = ("_expires_at",)

    def __init__(self, seconds: Optional[float] = None, *, _expires_at: Optional[float] = None):
        if _expires_at is not None:
            self._expires_at = _expires_at
        else:
            self._expires_at = None if seconds is None else time.monotonic() + seconds

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        return cls(seconds)

    @classmethod
    def unlimited(cls) -> "Deadline":
        return cls(None)

    @property
    def expired(self) -> bool:
        return self._expires_at is not None and time.monotonic() >= self._expires_at

    def remaining(self) -> Optional[float]:
        """Seconds left, clamped at 0.0; None means unlimited."""
        if self._expires_at is None:
            return None
        return max(0.0, self._expires_at - time.monotonic())

    def remaining_or(self, cap: float) -> float:
        """Seconds left capped at ``cap`` (the per-step timeout a call would have
        used standalone): nested waits use ``min(step_timeout, whole_budget)``."""
        remaining = self.remaining()
        return cap if remaining is None else min(cap, remaining)

    def require(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(f"deadline expired before {what}")

    async def wait_for(self, awaitable: Awaitable[T], cap: Optional[float] = None) -> T:
        """``asyncio.wait_for`` bounded by this budget (and optionally ``cap``).
        Raises :class:`DeadlineExceeded` if the budget is already spent."""
        remaining = self.remaining()
        if remaining is None:
            timeout = cap
        else:
            if remaining <= 0.0:
                # the awaitable may be a coroutine that was never scheduled: close
                # it instead of leaking a "never awaited" warning
                if asyncio.iscoroutine(awaitable):
                    awaitable.close()
                raise DeadlineExceeded("deadline expired before wait")
            timeout = remaining if cap is None else min(cap, remaining)
        try:
            return await asyncio.wait_for(awaitable, timeout=timeout)
        except asyncio.TimeoutError:
            if self.expired:
                raise DeadlineExceeded("deadline expired during wait") from None
            raise

    def __repr__(self) -> str:
        remaining = self.remaining()
        return f"Deadline(remaining={'inf' if remaining is None else f'{remaining:.3f}s'})"


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter, attempt caps, and retryable-exception
    predicates.

    :param max_attempts: total attempts including the first; None = unlimited
        (bound it with a ``deadline`` instead)
    :param base_delay: backoff before the first retry
    :param backoff: multiplier per subsequent retry (1.0 = constant interval)
    :param max_delay: ceiling on any single sleep
    :param jitter: ``"full"`` — sleep U(0, d) (best for thundering herds);
        ``"equal"`` — sleep d/2 + U(0, d/2); ``"none"`` — sleep exactly d
    :param retry_on: exception types worth retrying (``CancelledError`` never is)
    :param retry_if: extra predicate over the exception; both must pass
    :param name: when set, each retry increments
        ``hivemind_resilience_retries_total{site=name}``
    """

    max_attempts: Optional[int] = 3
    base_delay: float = 0.1
    backoff: float = 2.0
    max_delay: float = 10.0
    jitter: str = "full"
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    retry_if: Optional[Callable[[BaseException], bool]] = None
    name: Optional[str] = None

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, asyncio.CancelledError):
            return False
        if not isinstance(exc, self.retry_on):
            return False
        return self.retry_if is None or bool(self.retry_if(exc))

    def delay(self, retry_index: int, rng: Optional[random.Random] = None) -> float:
        """The sleep before retry number ``retry_index`` (0-based)."""
        raw = min(self.base_delay * (self.backoff ** retry_index), self.max_delay)
        rand = (rng.random() if rng is not None else random.random())
        if self.jitter == "full":
            return raw * rand
        if self.jitter == "equal":
            return raw / 2.0 + raw / 2.0 * rand
        return raw

    def _account_retry(self, retry_index: int = 0, exc: Optional[BaseException] = None) -> None:
        if self.name is not None:
            _RETRIES.inc(site=self.name)
        span = _current_span()
        if span is not None:  # the retried operation's span shows each attempt
            span.add_event(
                "retry",
                site=self.name or "anonymous",
                attempt=retry_index + 1,
                error=type(exc).__name__ if exc is not None else "",
            )

    async def execute(
        self,
        fn: Callable[[], Awaitable[T]],
        *,
        deadline: Optional[Deadline] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        rng: Optional[random.Random] = None,
    ) -> T:
        """Run ``fn`` (a zero-arg async callable), retrying per this policy.
        ``on_retry(retry_index, exc)`` runs before each backoff sleep (the hook
        for re-resolution / cache invalidation between attempts)."""
        retry_index = 0
        while True:
            try:
                return await fn()
            except BaseException as e:
                if not self.is_retryable(e):
                    raise
                if self.max_attempts is not None and retry_index + 1 >= self.max_attempts:
                    raise
                if deadline is not None and deadline.expired:
                    raise
                self._account_retry(retry_index, e)
                if on_retry is not None:
                    on_retry(retry_index, e)
                sleep = self.delay(retry_index, rng)
                if deadline is not None:
                    sleep = deadline.remaining_or(sleep)
                await asyncio.sleep(sleep)
                retry_index += 1

    def execute_sync(
        self,
        fn: Callable[[], T],
        *,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> T:
        """Blocking-world twin of :meth:`execute` (the MoE client's pure_callback
        bodies run on executor threads, not the event loop)."""
        retry_index = 0
        while True:
            try:
                return fn()
            except BaseException as e:
                if not self.is_retryable(e):
                    raise
                if self.max_attempts is not None and retry_index + 1 >= self.max_attempts:
                    raise
                self._account_retry(retry_index, e)
                if on_retry is not None:
                    on_retry(retry_index, e)
                sleep(self.delay(retry_index, rng))
                retry_index += 1
