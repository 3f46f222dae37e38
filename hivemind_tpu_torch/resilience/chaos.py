"""First-class deterministic fault injection (the port's copy of
hivemind_tpu/resilience/chaos.py).

Fault injection used to exist only as test-local subclasses
(``FaultyAllReduceRunner`` / ``FaultyAverager``); this module makes it a
subsystem: production code carries **named injection points** that are free
when disabled (one attribute check) and, when armed, consult a seeded schedule
— no wall-clock randomness, so a failing chaos run replays exactly.

Named injection points (the call sites pass ``scope=<local peer id or expert
uid>`` so multi-peer-in-one-process tests can fault exactly one peer):

==========================  ====================================================
point                       where it fires
==========================  ====================================================
``p2p.unary.send``          client side, before a unary request leaves
``p2p.unary.recv``          client side, after a unary response arrives
``p2p.stream.send``         client side, before each streamed request message
``p2p.stream.recv``         client side, after each streamed response message
``dht.rpc_ping``            before an outbound DHT ping
``dht.rpc_store``           before an outbound DHT store
``dht.rpc_find``            before an outbound DHT find
``allreduce.setup``         before constructing a round's AllReduceRunner
``allreduce.load``          sender side, per tensor part streamed to a reducer
``allreduce.reduce``        reducer side, per delta returned to a sender
``moe.forward``             per expert forward RPC (scope = expert uid)
``moe.backward``            per expert backward RPC (scope = expert uid)
``state.download.send``     donor side, per state-sync message (scope = donor id)
``state.download.recv``     receiver side, per state-sync message (scope = donor id)
==========================  ====================================================

Actions: ``drop`` (raises :class:`ChaosDrop`, a ``ConnectionError`` — looks
like the network ate it), ``delay`` (sleeps ``delay`` seconds), ``abort``
(raises :class:`ChaosAbort`, a ``RuntimeError`` — looks like a peer crash or
software fault), ``corrupt_payload`` (deterministically flips bytes in the
payload when the point carries one), ``throttle`` (sleeps
``len(payload) / rate`` — a simulated bandwidth-limited WAN link; no-op at
points that carry no payload).

Activation: programmatically (``CHAOS.add_rule(...)`` / ``CHAOS.configure``)
or via ``HIVEMIND_CHAOS`` at import, e.g.::

    HIVEMIND_CHAOS="seed=7;dht.rpc_find:drop:prob=0.2;allreduce.load:delay:delay=0.5:prob=0.1"

Grammar: ``spec = segment (";" segment)*``; a segment is either ``seed=<int>``
or ``<point>:<action>[:key=value]...`` with keys ``prob`` (default 1.0),
``delay`` (seconds, default 0.1), ``rate`` (throttle bandwidth in bytes/s,
default 125e6 ≈ 1 Gbps), ``after`` (skip the first N matching calls),
``times`` (max injections), ``scope`` (substring matched against the call
site's scope). A point may end in ``*`` for prefix matching (``p2p.*``).

Directional link scoping: a rule whose scope starts with ``link:``
matches only call sites that identify a directed link, ``scope=link:<src>-><dst>``
— the JAX package's in-process swarm simulator tags every simulated RPC
this way. Each side is a peer id pattern with ``*`` wildcards
(``fnmatch``-style), so ``link:*->QmBob*`` throttles everything flowing INTO
one peer while ``link:QmAli*->QmBob*`` faults exactly one direction of one
link. Non-link rules keep substring semantics; because a link scope string
contains both endpoint ids, a plain ``scope=<peer_b58>`` rule matches both
directions of that peer's simulated links — the existing 14-point catalog
composes with per-link schedules unchanged.
"""

from __future__ import annotations

import asyncio
import os
import random
import zlib
from fnmatch import fnmatchcase
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import current_span as _current_span
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CHAOS_INJECTIONS = _TELEMETRY.counter(
    "hivemind_chaos_injections_total", "faults injected by the chaos engine", ("point", "action")
)

INJECTION_POINTS = (
    "p2p.unary.send", "p2p.unary.recv", "p2p.stream.send", "p2p.stream.recv",
    "dht.rpc_ping", "dht.rpc_store", "dht.rpc_find",
    "allreduce.setup", "allreduce.load", "allreduce.reduce",
    "moe.forward", "moe.backward",
    "state.download.send", "state.download.recv",
)

ACTIONS = ("drop", "delay", "abort", "corrupt_payload", "throttle")


class ChaosError(Exception):
    """Base for engine-raised faults (never raised unless chaos is armed)."""


class ChaosDrop(ChaosError, ConnectionError):
    """Injected message loss: call sites see an ordinary ConnectionError."""


class ChaosAbort(ChaosError, RuntimeError):
    """Injected crash/software fault: an unexpected RuntimeError."""


@dataclass
class ChaosRule:
    point: str
    action: str
    prob: float = 1.0
    delay: float = 0.1
    rate: float = 125e6  # throttle bandwidth, bytes/s (default ≈ 1 Gbps)
    after: int = 0
    times: Optional[int] = None
    scope: Optional[str] = None
    rng: random.Random = field(default_factory=random.Random, repr=False)
    calls: int = 0
    hits: int = 0

    def matches(self, point: str, scope: Optional[str]) -> bool:
        if self.point.endswith("*"):
            if not point.startswith(self.point[:-1]):
                return False
        elif point != self.point:
            return False
        if self.scope is not None:
            if scope is None:
                return False
            if self.scope.startswith("link:"):
                return _match_link_scope(self.scope, scope)
            if self.scope not in scope:
                return False
        return True

    def decide(self) -> bool:
        """One deterministic injection decision. Counters make ``after``/``times``
        schedules reproducible; the rule-local rng makes ``prob`` reproducible."""
        index = self.calls
        self.calls += 1
        if index < self.after:
            return False
        if self.times is not None and self.hits >= self.times:
            return False
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return False
        self.hits += 1
        return True


def _match_link_scope(rule_scope: str, call_scope: str) -> bool:
    """``link:<src_pat>-><dst_pat>`` vs a call site's ``link:<src>-><dst>``.
    Patterns use ``*`` wildcards per side; a call site that carries no link
    identity never matches a link-scoped rule."""
    if not call_scope.startswith("link:"):
        return False
    src_pat, arrow, dst_pat = rule_scope[len("link:"):].partition("->")
    src, call_arrow, dst = call_scope[len("link:"):].partition("->")
    if not arrow or not call_arrow:
        return False
    return fnmatchcase(src, src_pat) and fnmatchcase(dst, dst_pat)


def _rule_seed(seed: int, index: int, point: str, action: str) -> int:
    return zlib.crc32(f"{seed}|{index}|{point}|{action}".encode())


class ChaosEngine:
    """The process-wide fault injector. ``enabled`` is False with no rules, so
    instrumented call sites cost one attribute read in production."""

    def __init__(self, seed: int = 0):
        self._rules: List[ChaosRule] = []
        self._seed = seed
        self.enabled = False

    # ------------------------------------------------------------------ config

    def add_rule(
        self,
        point: str,
        action: str,
        *,
        prob: float = 1.0,
        delay: float = 0.1,
        rate: float = 125e6,
        after: int = 0,
        times: Optional[int] = None,
        scope: Optional[str] = None,
    ) -> ChaosRule:
        assert action in ACTIONS, f"unknown chaos action {action!r} (choose from {ACTIONS})"
        if not point.endswith("*") and point not in INJECTION_POINTS:
            logger.warning(f"chaos rule targets unknown injection point {point!r}")
        rule = ChaosRule(
            point=point, action=action, prob=prob, delay=delay, rate=rate, after=after,
            times=times, scope=scope,
            rng=random.Random(_rule_seed(self._seed, len(self._rules), point, action)),
        )
        self._rules.append(rule)
        self.enabled = True
        return rule

    def configure(self, spec: str, seed: Optional[int] = None) -> None:
        """Parse the ``HIVEMIND_CHAOS`` grammar (see module docstring) into rules.
        Clears existing rules first."""
        self.clear()
        segments = [segment.strip() for segment in spec.split(";") if segment.strip()]
        # the seed segment applies to every rule regardless of position
        for segment in segments:
            if segment.startswith("seed="):
                seed = int(segment[len("seed="):])
        if seed is not None:
            self._seed = seed
        for segment in segments:
            if segment.startswith("seed="):
                continue
            raw = segment.split(":")
            if len(raw) < 2:
                raise ValueError(f"bad chaos segment {segment!r}: need <point>:<action>")
            point, action = raw[0], raw[1]
            # a value may itself contain ":" (scope=link:<src>-><dst>): a part
            # with no "=" re-joins the key=value field it was split off from
            fields: List[str] = []
            for part in raw[2:]:
                if "=" in part or not fields:
                    fields.append(part)
                else:
                    fields[-1] = f"{fields[-1]}:{part}"
            kwargs: Dict[str, object] = {}
            for kv in fields:
                key, _, value = kv.partition("=")
                if key in ("prob", "delay", "rate"):
                    kwargs[key] = float(value)
                elif key in ("after", "times"):
                    kwargs[key] = int(value)
                elif key == "scope":
                    kwargs[key] = value
                else:
                    raise ValueError(f"unknown chaos rule key {key!r} in {segment!r}")
            self.add_rule(point, action, **kwargs)

    def configure_from_env(self, environ=os.environ) -> None:
        spec = environ.get("HIVEMIND_CHAOS")
        if spec:
            self.configure(spec)
            logger.warning(f"HIVEMIND_CHAOS armed: {len(self._rules)} fault rule(s) active")

    def remove_rule(self, rule: ChaosRule) -> None:
        """Retire one rule (e.g. a scenario-scoped fault) leaving the rest armed."""
        self._rules.remove(rule)
        self.enabled = bool(self._rules)

    def clear(self) -> None:
        self._rules = []
        self.enabled = False

    def reseed(self, seed: int) -> None:
        """Set the seed for ALL rules — existing ones get fresh rngs and reset
        counters, so reseed-then-replay is deterministic regardless of whether
        rules were added before or after the call."""
        self._seed = seed
        for index, rule in enumerate(self._rules):
            rule.rng = random.Random(_rule_seed(seed, index, rule.point, rule.action))
            rule.calls = rule.hits = 0

    @property
    def rules(self) -> Tuple[ChaosRule, ...]:
        return tuple(self._rules)

    def stats(self) -> Dict[str, int]:
        """Injections performed so far, keyed ``point:action``."""
        out: Dict[str, int] = {}
        for rule in self._rules:
            key = f"{rule.point}:{rule.action}"
            out[key] = out.get(key, 0) + rule.hits
        return out

    # ------------------------------------------------------------------ injection

    async def inject(self, point: str, payload=None, scope: Optional[str] = None):
        """Consult the schedule at one injection point. Returns the (possibly
        corrupted) payload; may sleep; may raise ChaosDrop / ChaosAbort."""
        for rule in self._rules:
            if not rule.matches(point, scope) or not rule.decide():
                continue
            _CHAOS_INJECTIONS.inc(point=point, action=rule.action)
            # the injected fault becomes visible IN the trace at the exact
            # operation it hit: the active span carries a chaos.<action> event
            span = _current_span()
            if span is not None:
                span.add_event(f"chaos.{rule.action}", point=point)
            if rule.action == "drop":
                raise ChaosDrop(f"chaos: dropped at {point}")
            if rule.action == "abort":
                raise ChaosAbort(f"chaos: aborted at {point}")
            if rule.action == "delay":
                await asyncio.sleep(rule.delay)
            elif rule.action == "throttle":
                # simulated bandwidth-limited link: pay the payload's wire time.
                # Rules on the same link serialize naturally (the call site
                # awaits inline), distinct links throttle independently.
                try:
                    size = len(payload) if payload is not None else 0
                except TypeError:
                    size = 0
                if size and rule.rate > 0:
                    await asyncio.sleep(size / rule.rate)
            elif rule.action == "corrupt_payload":
                payload = self._corrupt(payload, rule.rng)
        return payload

    @staticmethod
    def _corrupt(payload, rng: random.Random):
        # memoryview included: the mux delivers zero-copy views of wire frames
        if isinstance(payload, (bytes, bytearray, memoryview)) and len(payload):
            corrupted = bytearray(payload)
            for _ in range(max(1, len(corrupted) // 256)):
                corrupted[rng.randrange(len(corrupted))] ^= 0xFF
            return bytes(corrupted)
        return payload  # point carries no byte payload: corruption is a no-op


CHAOS = ChaosEngine()
CHAOS.configure_from_env()
