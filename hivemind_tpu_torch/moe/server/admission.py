"""Fair-share admission (the port's copy of hivemind_tpu/moe/server/admission.py):
per-client token buckets in front of the bounded TaskPool queues.

A pool sheds when its queue is full, but one greedy tenant can fill the queue and
starve everyone before that backstop fires. Client ids are attributed on every
request (the ``serving.request`` span's ``client``, stamped by the
ConnectionHandler from the P2P context), so admission can be fair-share: each
client draws request cost from its own token bucket; a client past its budget is
shed with the same typed answer as a queue shed. The error type rides the mux
ERROR frame, :func:`~hivemind_tpu_torch.telemetry.serving.is_overload_error`
recognizes it on the caller, and the client's breakers and scorecards react as
they do to a pool shed, while every other client keeps flowing.

:class:`ClientOverBudgetError` subclasses
:class:`~hivemind_tpu_torch.moe.server.task_pool.ServerOverloadedError`, so every
"is this a shed?" isinstance check holds server-side too.

Cost model: one token per sample (the leading batch dim; decode steps also count
positions), so a hot client cannot dodge its budget by batching harder. The
bucket refills at ``rate_per_s`` with a burst ceiling of ``burst`` tokens.
Admission is opt-in: off unless the handler is given a rate.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from hivemind_tpu_torch.moe.server.task_pool import ServerOverloadedError
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ADMISSION_SHEDS = _TELEMETRY.counter(
    "hivemind_moe_admission_shed_total",
    "requests shed by fair-share admission (a client over its own token budget; "
    "typed ClientOverBudgetError — other clients keep flowing)",
    ("kind",),
)
_ADMISSION_CLIENTS = _TELEMETRY.gauge(
    "hivemind_moe_admission_clients",
    "client token buckets currently tracked by fair-share admission",
)


class ClientOverBudgetError(ServerOverloadedError):
    """THIS client exhausted its fair-share token budget: the request was shed
    before touching any queue (it provably never executed — clients may fail
    over to another replica). Other clients are unaffected."""


class FairShareAdmission:
    """Per-client token buckets. Thread-safe; bucket count is bounded — client
    ids are remote-controlled, so an identity-cycling peer must not grow this
    map without bound (oldest-refilled buckets evicted; eviction only ever
    FORGIVES, granting a fresh burst, so cycling identities past the cap is
    equivalent to the admission layer being off for the attacker, never a way
    to starve honest clients)."""

    def __init__(
        self,
        rate_per_s: float,
        burst: Optional[float] = None,
        max_clients: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ):
        assert rate_per_s > 0, "use admission=None to disable fair-share admission"
        self.rate_per_s = float(rate_per_s)
        # default burst: two seconds of budget — enough to absorb a prefill
        # spike without letting a silent client bank minutes of credit
        self.burst = float(burst) if burst is not None else max(2.0 * rate_per_s, 1.0)
        self.max_clients = max_clients
        self._clock = clock
        self._lock = threading.Lock()
        # client -> [tokens, last_refill]; OrderedDict for LRU-ish eviction
        self._buckets: "OrderedDict[str, list]" = OrderedDict()

    def admit(self, client: str, cost: float = 1.0, kind: str = "request") -> None:
        """Draw ``cost`` tokens from ``client``'s bucket or raise the typed
        :class:`ClientOverBudgetError` shed."""
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                while len(self._buckets) >= self.max_clients:
                    self._buckets.popitem(last=False)
                bucket = self._buckets[client] = [self.burst, now]
                _ADMISSION_CLIENTS.set(len(self._buckets))
            tokens, last = bucket
            tokens = min(tokens + (now - last) * self.rate_per_s, self.burst)
            bucket[1] = now
            if tokens < cost:
                bucket[0] = tokens
                self._buckets.move_to_end(client)
                _ADMISSION_SHEDS.inc(kind=kind)
                if cost > self.burst:
                    # a full bucket can never hold this much: no amount of
                    # waiting admits the request, so retrying is a silent
                    # starvation loop. Say so loudly — the classic trigger is a
                    # mid-session failover re-prefill (one draw of the WHOLE
                    # retained history) against a burst sized for single steps.
                    logger.warning(
                        f"admission: client {client} requested {cost:g} tokens but the "
                        f"burst ceiling is {self.burst:g} — permanently inadmissible at "
                        f"this budget; raise the burst to at least the largest single "
                        f"request (e.g. a failover re-prefill's full history)"
                    )
                    raise ClientOverBudgetError(
                        f"client {client} request costs {cost:g} tokens, over the burst "
                        f"ceiling {self.burst:g}: never admissible at this budget "
                        f"(rate {self.rate_per_s:g}/s); raise burst or shrink the request"
                    )
                raise ClientOverBudgetError(
                    f"client {client} is over its fair-share budget "
                    f"({cost:g} tokens requested, {tokens:.2f} available, "
                    f"rate {self.rate_per_s:g}/s burst {self.burst:g}); request shed"
                )
            bucket[0] = tokens - cost
            self._buckets.move_to_end(client)
