"""Serving-path attribution (the port of hivemind_tpu/telemetry/serving.py): the
serving ledger and the client-side expert scorecards.

The training path already has deep attribution (metrics, traces, the round
ledger) — this module gives the *serving* path the same treatment. Two sides:

- **Server** — :class:`ServingLedger` (process-wide :data:`SERVING_LEDGER`, a
  sibling of :class:`~hivemind_tpu_torch.telemetry.ledger.RoundLedger`) subscribes to
  finished spans (:func:`~hivemind_tpu_torch.telemetry.tracing.add_span_listener`)
  and assembles **one record per expert request** from the ``serving.request``
  span the :class:`~hivemind_tpu_torch.moe.server.connection_handler.ConnectionHandler`
  opens around every ``rpc_forward`` / ``rpc_backward`` / ``rpc_decode`` (and
  their streaming variants). The record decomposes the request into
  **queue-wait / batch-assembly / device-compute / serialize** phases (the
  TaskPool stamps the first three onto the span, the handler stamps the
  fourth), carries the batch occupancy its device batch ran at (samples ÷
  ``max_batch_size``), and
  names the calling client. Because the handler span joins the remote caller's
  trace via the existing cross-peer propagation, the record's ``trace`` id is
  the *caller's* trace — ``hivemind-top`` can name which expert on which peer
  ate a slow request's time.
- **Client** — :class:`ExpertScorecards` (process-wide :data:`SCORECARDS`)
  accrues per-expert outcome cards from every
  :meth:`~hivemind_tpu_torch.moe.client.expert.RemoteExpert._call`: success rate,
  latency quantiles, timeouts, and **sheds** (the server's typed
  ``ServerOverloadedError`` load-shed answer, recognized across the RPC
  boundary by :func:`is_overload_error` and fed into the existing
  ``EXPERT_BREAKERS``).

Both views ride the DHT peer snapshot (``serving`` key, size-budgeted like the
round ledger) and are served raw at ``GET /serving`` on the MetricsExporter.
Cost discipline matches the round ledger: the span listener is one name check
per finished span; per-request work is a few dict ops under one lock; nothing
serializes off the export path.
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.ledger import _percentile
from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.telemetry.tracing import Span, add_span_listener, current_span, wall_time
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the span name the ConnectionHandler opens per expert request; the ONLY name
# this ledger reacts to (everything else is one failed string compare)
SERVING_SPAN = "serving.request"

# the server's typed load-shed errors travel as "<TypeName>: <msg>" inside
# P2PHandlerError text (mux ERROR frames carry type name + message), so the
# client recognizes a shed without importing the server module. Two kinds:
# the pool's bounded-queue shed, and the fair-share admission shed (a
# subclass — one hot client over its token budget while others keep flowing)
OVERLOAD_ERROR_NAME = "ServerOverloadedError"
OVERLOAD_ERROR_NAMES = (OVERLOAD_ERROR_NAME, "ClientOverBudgetError")

# phase attributes the TaskPool / handler stamp onto the serving span
_PHASE_FIELDS = ("queue_wait_s", "assembly_s", "compute_s", "serialize_s")

# registry families the summary reads for the saturation columns (absent
# families — a layer that never loaded — contribute nothing)
_SATURATION_GAUGES = {
    "queue_depth": "hivemind_moe_pool_queue_depth",
    "queue_age_s": "hivemind_moe_queue_age_seconds",
    "decode_sessions": "hivemind_moe_decode_sessions",
    "decode_session_occupancy": "hivemind_moe_decode_session_occupancy",
    "runtime_utilization": "hivemind_moe_runtime_utilization",
}
_SATURATION_COUNTERS = {
    "sheds": "hivemind_moe_shed_total",
    "decode_evictions": "hivemind_moe_decode_session_evictions_total",
    "decode_resets": "hivemind_moe_decode_session_resets_total",
    "wire_bytes_sent": "hivemind_moe_bytes_sent_total",
    "wire_bytes_received": "hivemind_moe_bytes_received_total",
}

# serving-path wire accounting: serialized expert RPC payload bytes
# by the role this process played — "client" = RemoteExpert callers here,
# "server" = the ConnectionHandler. The compressed-RPC win (fp16 activations ≈
# half the fp32 wire bytes) is read directly off these.
WIRE_BYTES_SENT = REGISTRY.counter(
    "hivemind_moe_bytes_sent_total",
    "expert RPC payload bytes sent on the serving path",
    ("direction",),
)
WIRE_BYTES_RECEIVED = REGISTRY.counter(
    "hivemind_moe_bytes_received_total",
    "expert RPC payload bytes received on the serving path",
    ("direction",),
)

# replica robustness accounting: hedges fired when an in-flight
# request crossed the expert's scorecard p95, who won the race, and failovers
# onto another replica after a shed / connection loss. Client-side counters
# (this process as the caller), cataloged in docs/observability.md.
HEDGES = REGISTRY.counter(
    "hivemind_moe_hedge_total",
    "hedged expert requests by outcome (fired / primary_won / hedge_won)",
    ("outcome",),
)
REPLICA_FAILOVERS = REGISTRY.counter(
    "hivemind_moe_replica_failover_total",
    "expert calls retried on another replica after a typed shed or connection loss",
    ("kind",),
)


def is_overload_error(error: BaseException) -> bool:
    """True when ``error`` is (or wraps, across the RPC boundary) one of the
    server's typed load-shed answers. String-matched so the client side needs
    no import of the server module and a P2PHandlerError re-raise still
    classifies."""
    text = f"{type(error).__name__}: {error}"
    return any(name in text for name in OVERLOAD_ERROR_NAMES)


def accrue_span_phase(key: str, seconds: float) -> None:
    """Add ``seconds`` onto the active serving span's phase attribute. A span
    chain runs several pools/steps sequentially, so phases ACCUMULATE per
    request (TaskPool stamps queue_wait/assembly/compute, the handler stamps
    serialize — this module owns the phase-field vocabulary)."""
    span = current_span()
    if span is not None:
        previous = (span.attributes or {}).get(key, 0.0)
        span.set(key, round(float(previous) + seconds, 6))


def _quantiles(values: List[float]) -> Dict[str, float]:
    return {
        "mean": round(sum(values) / len(values), 6),
        "p50": round(_percentile(values, 0.5), 6),
        "p95": round(_percentile(values, 0.95), 6),
    }


class _ExpertStats:
    __slots__ = ("requests", "errors", "sheds", "total_s", "durations")

    def __init__(self, window: int):
        self.requests = 0
        self.errors = 0
        self.sheds = 0
        self.total_s = 0.0
        self.durations: "deque[float]" = deque(maxlen=window)


class ServingLedger:
    """See module docstring. One process-wide instance (:data:`SERVING_LEDGER`)
    is fed by the span listener; tests may build private instances and call
    :meth:`on_span` directly."""

    def __init__(
        self,
        capacity: int = 256,
        expert_window: int = 128,
        max_experts: int = 256,
        max_clients: int = 256,
        slowest_capacity: int = 8,
        registry: MetricsRegistry = REGISTRY,
        scorecards: Optional["ExpertScorecards"] = None,
    ):
        self._lock = threading.Lock()
        self._registry = registry
        # injected like the registry: an exporter bound to a private ledger
        # must not leak the process-global scorecards (None = the global)
        self._scorecards = scorecards
        self._expert_window = expert_window
        self._max_experts = max_experts
        self._max_clients = max_clients
        self._records: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        # the N slowest requests ever seen since clear(), slowest first — the
        # exemplars the dashboard shows next to the quantiles
        self._slowest: List[Dict[str, Any]] = []
        self._slowest_capacity = slowest_capacity
        self._experts: Dict[str, _ExpertStats] = {}
        self._clients: Dict[str, Dict[str, float]] = {}
        self._request_index = 0
        self._totals = {"requests": 0, "errors": 0, "sheds": 0}
        # record listeners (the black-box spool subscribes): called with
        # ("serving", copied record) OUTSIDE the lock — file I/O must not
        # serialize the serving hot path
        self._record_listeners: List = []

    def add_record_listener(self, listener) -> None:
        if listener not in self._record_listeners:
            self._record_listeners.append(listener)

    def remove_record_listener(self, listener) -> None:
        try:
            self._record_listeners.remove(listener)
        except ValueError:
            pass

    # ------------------------------------------------------------------ feeding

    def on_span(self, span: Span) -> None:
        """Span listener: one name compare per finished span; record assembly
        only for serving.request spans."""
        if span.name != SERVING_SPAN:
            return
        attrs = span.attributes or {}
        error_type: Optional[str] = None
        for _when, event_name, event_attrs in span.events or ():
            if event_name == "error":
                error_type = str((event_attrs or {}).get("type", "error"))
        record: Dict[str, Any] = {
            "expert": str(attrs.get("expert", "?")),
            "kind": str(attrs.get("kind", "?")),
            "client": str(attrs.get("client", "?")),
            "peer": str(attrs.get("peer", "?")),
            "total_s": round(span.duration, 6),
            "trace": f"{span.trace_id:016x}",
        }
        for field in _PHASE_FIELDS:
            value = attrs.get(field)
            if value is not None:
                record[field] = round(float(value), 6)
        for field in ("batch", "occupancy", "pool", "span_len"):
            if field in attrs:
                record[field] = attrs[field]
        if error_type is not None:
            record["error"] = error_type
        with self._lock:
            self._request_index += 1
            record["request"] = self._request_index
            record["time"] = round(wall_time(), 3)
            self._records.append(record)
            self._totals["requests"] += 1
            stats = self._expert_stats(record["expert"])
            stats.requests += 1
            stats.total_s = round(stats.total_s + record["total_s"], 6)
            stats.durations.append(record["total_s"])
            if error_type is not None:
                self._totals["errors"] += 1
                stats.errors += 1
                if error_type in OVERLOAD_ERROR_NAMES:
                    self._totals["sheds"] += 1
                    stats.sheds += 1
            client = self._client_stats(record["client"])
            client["requests"] += 1
            client["total_s"] = round(client["total_s"] + record["total_s"], 6)
            if error_type is not None:
                client["errors"] += 1
            # slowest-request exemplars: a sorted top-N, cheap at N=8
            if (
                len(self._slowest) < self._slowest_capacity
                or record["total_s"] > self._slowest[-1]["total_s"]
            ):
                self._slowest.append(dict(record))
                self._slowest.sort(key=lambda r: -r["total_s"])
                del self._slowest[self._slowest_capacity:]
            published = dict(record) if self._record_listeners else None
        if published is not None:
            for listener in self._record_listeners:
                try:
                    listener("serving", published)
                except Exception as e:  # pragma: no cover - listeners stay harmless
                    logger.debug(f"serving record listener failed: {e!r}")

    def _expert_stats(self, uid: str) -> _ExpertStats:
        stats = self._experts.get(uid)
        if stats is None:
            if len(self._experts) >= self._max_experts:
                # uid cardinality is server-controlled but bound it anyway
                self._experts.pop(next(iter(self._experts)), None)
            stats = self._experts[uid] = _ExpertStats(self._expert_window)
        return stats

    def _client_stats(self, client: str) -> Dict[str, float]:
        stats = self._clients.get(client)
        if stats is None:
            if len(self._clients) >= self._max_clients:
                # client ids are REMOTE-controlled: a peer cycling identities
                # must not grow this dict without bound
                self._clients.pop(next(iter(self._clients)), None)
            stats = self._clients[client] = {"requests": 0, "errors": 0, "total_s": 0.0}
        return stats

    def _gauge_values(self, metric_name: str) -> Dict[str, float]:
        metric = self._registry.get(metric_name)
        if metric is None:
            return {}
        out = {}
        for key, child in metric.series():
            out[",".join(key) or "_"] = round(child.value, 6)  # type: ignore[union-attr]
        return out

    def _counter_total(self, metric_name: str) -> float:
        metric = self._registry.get(metric_name)
        if metric is None:
            return 0.0
        return round(sum(child.value for _k, child in metric.series()), 6)  # type: ignore[union-attr]

    # ------------------------------------------------------------------ reading

    def records(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self._records)
        if limit:
            records = records[-limit:]
        return [dict(record) for record in records]

    def expert_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-expert latency quantiles + counters, busiest expert first."""
        with self._lock:
            items = [
                (uid, stats.requests, stats.errors, stats.sheds, stats.total_s,
                 list(stats.durations))
                for uid, stats in self._experts.items()
            ]
        out: Dict[str, Dict[str, Any]] = {}
        for uid, requests, errors, sheds, total_s, durations in sorted(
            items, key=lambda item: -item[1]
        ):
            entry: Dict[str, Any] = {"requests": requests, "total_s": round(total_s, 6)}
            if errors:
                entry["errors"] = errors
            if sheds:
                entry["sheds"] = sheds
            if durations:
                entry.update({f"{k}_s": v for k, v in _quantiles(durations).items()})
            out[uid] = entry
        return out

    def client_stats(self, limit: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = sorted(
                ((client, dict(stats)) for client, stats in self._clients.items()),
                key=lambda kv: -kv[1]["requests"],
            )
        return dict(items[:limit] if limit else items)

    def slowest(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            slowest = [dict(record) for record in self._slowest]
        return slowest[:limit] if limit else slowest

    def saturation(self) -> Dict[str, Any]:
        """The live saturation view read from the registry (queue depth/age per
        pool, decode-session occupancy, runtime utilization, shed totals) — the
        levers the records explain."""
        # refresh depth/age at READ time: a fully stalled server neither
        # submits nor drains, so event-driven sampling alone would report the
        # pre-stall age forever (lazy module lookup — telemetry must never
        # force a moe import, and sampling must never fail a scrape)
        task_pool = sys.modules.get("hivemind_tpu_torch.moe.server.task_pool")
        if task_pool is not None:
            try:
                task_pool.sample_all_pool_gauges()
            except Exception as e:  # pragma: no cover - best effort
                logger.debug(f"pool gauge refresh failed: {e!r}")
        out: Dict[str, Any] = {}
        for field, metric_name in _SATURATION_GAUGES.items():
            values = self._gauge_values(metric_name)
            if values:
                out[field] = values
        for field, metric_name in _SATURATION_COUNTERS.items():
            total = self._counter_total(metric_name)
            if total:
                out[field] = total
        return out

    def summary(self) -> Dict[str, Any]:
        """Compact rollup for BENCH artifacts and the dashboard header: request
        and shed counts, per-phase quantiles, batch occupancy, per-expert
        p50/p95 — a serving regression's artifact then says WHERE the
        regression lives (queue? device? serialize? one expert?)."""
        records = self.records()
        with self._lock:
            out: Dict[str, Any] = dict(self._totals)
        phases: Dict[str, Any] = {}
        for field in ("total_s",) + _PHASE_FIELDS:
            values = [r[field] for r in records if field in r]
            if values:
                phases[field] = _quantiles(values)
        if phases:
            out["phases"] = phases
        occupancies = [r["occupancy"] for r in records if "occupancy" in r]
        if occupancies:
            out["batch_occupancy"] = _quantiles([float(o) for o in occupancies])
        experts = self.expert_stats()
        if experts:
            out["experts"] = experts
        saturation = self.saturation()
        if saturation:
            out["saturation"] = saturation
        return out

    def snapshot(
        self, max_experts: int = 8, max_clients: int = 5, max_slowest: int = 3
    ) -> Dict[str, Any]:
        """The compact view that rides the DHT peer snapshot: totals, busiest
        experts, top clients, slowest exemplars, and the live saturation
        gauges. Size-budgeted by monitor._shrink_to_fit."""
        out: Dict[str, Any] = {}
        with self._lock:
            totals = dict(self._totals)
        if not totals["requests"]:
            return out
        out["totals"] = totals
        experts = self.expert_stats()
        if experts:
            out["experts"] = dict(list(experts.items())[:max_experts])
        clients = self.client_stats(limit=max_clients)
        if clients:
            out["clients"] = clients
        slowest = self.slowest(limit=max_slowest)
        if slowest:
            out["slowest"] = slowest
        saturation = self.saturation()
        if saturation:
            out["saturation"] = saturation
        return out

    def export(self) -> Dict[str, Any]:
        """Everything, raw — the ``GET /serving`` response body (plus the
        paired client-side scorecards, so one endpoint answers both roles)."""
        scorecards = self._scorecards if self._scorecards is not None else SCORECARDS
        return {
            "records": self.records(),
            "experts": self.expert_stats(),
            "clients": self.client_stats(),
            "slowest": self.slowest(),
            "summary": self.summary(),
            "scorecards": scorecards.export(),
        }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._slowest.clear()
            self._experts.clear()
            self._clients.clear()
            self._request_index = 0
            self._totals = {"requests": 0, "errors": 0, "sheds": 0}

    def __len__(self) -> int:
        return len(self._records)


# ------------------------------------------------------------------ client side


class ExpertScorecards:
    """Per-expert outcome cards accrued by the CLIENT (RemoteExpert._call and
    the call_many fan-out): success rate, latency quantiles, timeouts, sheds.
    These are the client's view of the swarm's serving quality — they ride the
    DHT snapshot so the operator sees which experts are slow or shedding from
    the *caller's* side, not just the server's."""

    def __init__(self, max_experts: int = 256, window: int = 128, max_replicas: int = 8):
        self._lock = threading.Lock()
        self._max_experts = max_experts
        self._window = window
        self._max_replicas = max_replicas  # per-card replica sub-entries (bounded)
        self._cards: Dict[str, Dict[str, Any]] = {}

    def record(
        self,
        uid: str,
        seconds: float,
        ok: bool,
        kind: str = "forward",
        error: Optional[BaseException] = None,
    ) -> None:
        """Classify one RPC outcome: ok / shed / timeout / failure. Cancelled
        calls count as timeouts (the fan-out cancels exactly the stragglers it
        abandoned at a deadline)."""
        import asyncio

        outcome = "ok"
        if not ok:
            if error is not None and is_overload_error(error):
                outcome = "sheds"
            elif isinstance(error, (asyncio.TimeoutError, asyncio.CancelledError)):
                outcome = "timeouts"
            else:
                outcome = "failures"
        with self._lock:
            card = self._card(uid)
            card["requests"] += 1
            card["kinds"][kind] = card["kinds"].get(kind, 0) + 1
            if outcome == "ok":
                card["ok"] += 1
                card["durations"].append(seconds)
            else:
                card[outcome] += 1
                card["last_error"] = f"{type(error).__name__}: {error}"[:200] if error else outcome

    # ------------------------------------------------------------ replica level

    def _card(self, uid: str) -> Dict[str, Any]:
        card = self._cards.get(uid)
        if card is None:
            if len(self._cards) >= self._max_experts:
                self._cards.pop(next(iter(self._cards)), None)
            card = self._cards[uid] = {
                "requests": 0, "ok": 0, "failures": 0, "timeouts": 0, "sheds": 0,
                "durations": deque(maxlen=self._window), "kinds": {},
            }
        return card

    def record_replica(self, uid: str, replica: str, seconds: float, ok: bool,
                       shed: bool = False) -> None:
        """One per-replica attempt outcome: feeds the latency view
        :meth:`replica_latency` that RemoteExpert load-balances and hedges by.
        Attempt-level — the uid-level :meth:`record` still fires exactly once
        per logical call, so existing totals keep their meaning. A hedge's
        cancelled loser is never recorded here (no outcome happened)."""
        with self._lock:
            stats = self._replica_stats(self._card(uid), replica)
            stats["requests"] += 1
            if ok:
                stats["ok"] += 1
                stats["durations"].append(seconds)
            elif shed:
                stats["sheds"] += 1
            else:
                stats["failures"] += 1

    def _replica_stats(self, card: Dict[str, Any], replica: str) -> Dict[str, Any]:
        replicas = card.setdefault("replicas", {})
        stats = replicas.get(replica)
        if stats is None:
            if len(replicas) >= self._max_replicas:
                replicas.pop(next(iter(replicas)), None)
            stats = replicas[replica] = {
                "requests": 0, "ok": 0, "failures": 0, "sheds": 0,
                "durations": deque(maxlen=self._window),
            }
        return stats

    def note_hedge_loss(self, uid: str, replica: str, elapsed: float) -> None:
        """The hedge's cancelled loser: NOT a failure, NOT a breaker strike —
        but ``elapsed`` is a real censored observation ("this replica took at
        least this long"), appended to the replica's latency window so a
        consistently-hanging replica drifts down the routing order instead of
        winning the next pick on stale fast quantiles."""
        with self._lock:
            stats = self._replica_stats(self._card(uid), replica)
            stats["durations"].append(elapsed)
            stats["hedge_losses"] = stats.get("hedge_losses", 0) + 1

    def replica_latency(self, uid: str, replica: str, quantile: float = 0.95
                        ) -> Optional[float]:
        """The replica's observed latency quantile — falls back to the expert's
        uid-level window when this replica is cold; None when both are cold
        (a cold expert fires no hedge and keeps its seeded initial choice)."""
        with self._lock:
            card = self._cards.get(uid)
            if card is None:
                return None
            stats = (card.get("replicas") or {}).get(replica)
            durations = list(stats["durations"]) if stats and stats["durations"] else None
            if durations is None:
                durations = list(card["durations"]) or None
        if durations is None:
            return None
        return _percentile(durations, quantile)

    def replica_health(self, uid: str, replica: str) -> Tuple[float, float]:
        """``(mean_latency_or_inf, failure_rate)`` for replica ordering: cold
        replicas sort last among known ones (inf latency) so the seeded rng
        breaks the tie, and a shedding/failing replica ranks after a clean one."""
        with self._lock:
            card = self._cards.get(uid)
            stats = ((card or {}).get("replicas") or {}).get(replica)
            if not stats:
                return float("inf"), 0.0
            durations = list(stats["durations"])
            requests = max(stats["requests"], 1)
            bad = stats["failures"] + stats["sheds"]
        mean = sum(durations) / len(durations) if durations else float("inf")
        return mean, bad / requests

    def card(self, uid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            card = self._cards.get(uid)
            return self._render(uid, card) if card is not None else None

    @staticmethod
    def _render(uid: str, card: Dict[str, Any]) -> Dict[str, Any]:
        out = {
            k: v for k, v in card.items() if k not in ("durations", "kinds", "replicas")
        }
        out["success_rate"] = round(card["ok"] / max(card["requests"], 1), 4)
        durations = list(card["durations"])
        if durations:
            out.update({f"{k}_s": v for k, v in _quantiles(durations).items()})
        out["kinds"] = dict(card["kinds"])
        replicas = card.get("replicas")
        if replicas:
            rendered = {}
            for peer, stats in replicas.items():
                entry = {k: v for k, v in stats.items() if k != "durations"}
                replica_durations = list(stats["durations"])
                if replica_durations:
                    entry.update(
                        {f"{k}_s": v for k, v in _quantiles(replica_durations).items()}
                    )
                rendered[peer] = entry
            out["replicas"] = rendered
        return out

    def snapshot(self, limit: int = 16) -> Dict[str, Dict[str, Any]]:
        """Busiest experts first, compact (DHT snapshot / hivemind-top)."""
        with self._lock:
            items = sorted(self._cards.items(), key=lambda kv: -kv[1]["requests"])[:limit]
            return {uid: self._render(uid, card) for uid, card in items}

    def export(self) -> Dict[str, Dict[str, Any]]:
        return self.snapshot(limit=10**9)

    def clear(self) -> None:
        with self._lock:
            self._cards.clear()

    def __len__(self) -> int:
        return len(self._cards)


# ------------------------------------------------------------------ board data


def collect_swarm_serving(records: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-peer snapshots' ``serving`` sections into structured board
    data — the ONE parser behind both serving renderers (``hivemind-top
    --serving`` and ``SwarmMonitor.render_serving_board``), so a snapshot
    schema change cannot make the two boards silently disagree.

    Returns ``{"experts": [(peer, uid, stats)], "saturation": [(peer, entry)],
    "degraded_scorecards": [(peer, uid, card)], "slowest": [(total_s, peer,
    record)] (slowest first), "malformed": [peer]}``. Snapshots are
    DHT-supplied: a malformed (buggy/version-skewed/hostile) peer lands in
    ``malformed``, never in an exception."""
    experts: List[Tuple[str, str, Dict[str, Any]]] = []
    saturation: List[Tuple[str, Dict[str, float]]] = []
    degraded: List[Tuple[str, str, Dict[str, Any]]] = []
    slowest: List[Tuple[float, str, Dict[str, Any]]] = []
    malformed: List[str] = []
    for peer, snapshot in sorted(records.items(), key=lambda kv: str(kv[0])):
        serving = snapshot.get("serving") if isinstance(snapshot, dict) else None
        if serving is None:
            continue  # peer simply reports no serving section
        if not isinstance(serving, dict):
            malformed.append(str(peer))  # present but unparseable: flag, don't hide
            continue
        # remember list lengths so a mid-parse failure rolls this peer's
        # partial rows back — a malformed peer must appear ONCE, in malformed,
        # not twice with half its data
        marks = (len(experts), len(saturation), len(degraded), len(slowest))
        try:
            for uid, stats in (serving.get("experts") or {}).items():
                p95 = stats.get("p95_s")
                experts.append((str(peer), str(uid), {
                    "requests": float(stats.get("requests", 0) or 0),
                    "p95_s": float(p95) if isinstance(p95, (int, float)) else None,
                    "sheds": int(stats.get("sheds", 0) or 0),
                }))
            sat = serving.get("saturation") or {}
            entry: Dict[str, float] = {}
            depth = sat.get("queue_depth") or {}
            if depth:
                entry["queue_depth_max"] = max(float(v) for v in depth.values())
            age = sat.get("queue_age_s") or {}
            if age:
                oldest = max(float(v) for v in age.values())
                if oldest > 0:
                    entry["queue_age_max_s"] = oldest
            for field, source in (
                ("runtime_utilization", "runtime_utilization"),
                ("decode_session_occupancy", "decode_session_occupancy"),
            ):
                values = list((sat.get(source) or {}).values())
                if values:
                    entry[field] = float(values[0])
            for field in ("wire_bytes_sent", "wire_bytes_received"):
                if sat.get(field):
                    entry[field] = float(sat[field])
            if sat.get("sheds"):
                entry["sheds"] = float(sat["sheds"])
            if entry:
                saturation.append((str(peer), entry))
            for uid, card in (serving.get("scorecards") or {}).items():
                rate = float(card.get("success_rate", 1.0) or 0.0)
                if rate < 1.0 or card.get("sheds") or card.get("timeouts"):
                    degraded.append((str(peer), str(uid), dict(card)))
            for record in serving.get("slowest") or ():
                slowest.append(
                    (float(record.get("total_s", 0.0) or 0.0), str(peer), dict(record))
                )
        except (TypeError, ValueError, AttributeError) as e:
            logger.debug(f"malformed serving section from {peer!r}: {e!r}")
            del experts[marks[0]:], saturation[marks[1]:], degraded[marks[2]:], slowest[marks[3]:]
            malformed.append(str(peer))
    slowest.sort(key=lambda item: -item[0])
    return {
        "experts": experts,
        "saturation": saturation,
        "degraded_scorecards": degraded,
        "slowest": slowest,
        "malformed": malformed,
    }


def format_slowest_phases(record: Dict[str, Any]) -> str:
    """``queue_wait=180.0ms compute=28.0ms …`` from one slowest-request record
    (shared by both renderers)."""
    return " ".join(
        f"{name[:-2]}={float(record[name]) * 1e3:.1f}ms"
        for name in ("queue_wait_s", "assembly_s", "compute_s", "serialize_s")
        if isinstance(record.get(name), (int, float))
    )


def format_saturation_parts(entry: Dict[str, float], red: str = "", reset: str = "") -> List[str]:
    """One peer's saturation summary as phrase parts — the ONE wording both
    renderers print, so the boards cannot drift apart."""
    parts: List[str] = []
    if "queue_depth_max" in entry:
        parts.append(f"queue depth max {entry['queue_depth_max']:g}")
    if "queue_age_max_s" in entry:
        parts.append(f"oldest task {entry['queue_age_max_s']:.2f}s")
    if "runtime_utilization" in entry:
        parts.append(f"runtime util {entry['runtime_utilization']:.0%}")
    if "decode_session_occupancy" in entry:
        parts.append(f"decode sessions {entry['decode_session_occupancy']:.0%} full")
    if "wire_bytes_sent" in entry or "wire_bytes_received" in entry:
        parts.append(
            f"wire {entry.get('wire_bytes_sent', 0.0) / 1e6:.1f}MB out"
            f" / {entry.get('wire_bytes_received', 0.0) / 1e6:.1f}MB in"
        )
    if "sheds" in entry:
        parts.append(f"{red}SHEDS {entry['sheds']:g}{reset}")
    return parts


def format_scorecard_line(
    peer: str, uid: str, card: Dict[str, Any], peer_width: int = 14, uid_width: int = 22
) -> str:
    """One degraded client-side scorecard line (shared by both renderers)."""
    return (
        f"{peer[:peer_width]:<{peer_width}} sees {uid[:uid_width]:<{uid_width}} "
        f"ok={float(card.get('success_rate', 0.0) or 0.0):.0%} "
        f"timeouts={card.get('timeouts', 0)} sheds={card.get('sheds', 0)} "
        f"fails={card.get('failures', 0)}"
    )


def format_slowest_line(
    total_s: float, peer: str, record: Dict[str, Any],
    peer_width: int = 14, uid_width: int = 22,
) -> str:
    """One slowest-request exemplar line with its phase decomposition (shared
    by both renderers)."""
    phases = format_slowest_phases(record)
    return (
        f"{total_s * 1e3:8.1f}ms {str(record.get('expert'))[:uid_width]:<{uid_width}} "
        f"@ {peer[:peer_width]} kind={record.get('kind')} "
        f"client={str(record.get('client'))[:peer_width]}"
        + (f"  [{phases}]" if phases else "")
    )


SERVING_LEDGER = ServingLedger()
SCORECARDS = ExpertScorecards()
add_span_listener(SERVING_LEDGER.on_span)
