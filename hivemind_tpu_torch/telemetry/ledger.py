"""Per-round performance attribution: the round ledger.

Metrics answer "how much", traces answer "why was THIS operation
slow" — this module answers the operator's question in between: *where did
epoch N's wall time go, and which peer caused it*. A :class:`RoundLedger`
assembles **one structured record per averaging round** (and one per optimizer
epoch transition) from signals that already exist:

- **span boundaries** — it subscribes to finished spans
  (:func:`~hivemind_tpu_torch.telemetry.tracing.add_span_listener`) and folds
  ``averaging.matchmaking`` / ``allreduce.local_reduce`` /
  ``allreduce.peer_exchange`` / ``allreduce.round`` into per-round phase
  durations, keyed by the round span's id so concurrent averagers (grad +
  state) cannot cross-contaminate;
- **registry counters** — bytes in/out, retries, sender bans, breaker trips,
  chaos injections and state-sync bytes are read as deltas at round close, so
  each record carries the traffic and resilience activity of its window;
- **per-peer attribution** — the slowest ``peer_exchange`` partner of each
  round is named in the record and accumulated into a per-peer *straggler
  score* (times-slowest count + excess seconds over the round's median
  exchange), the paper's one-slow-peer-taxes-everyone failure mode made
  directly readable.

Records are bounded rings (fixed memory, oldest evicted), ride the existing
DHT peer snapshot compact and size-budgeted like span summaries
(monitor.py), and are served raw at ``GET /ledger`` on the MetricsExporter.
Cost discipline: the listener does a dict lookup per finished span and a few
dict ops per *round* — nothing runs per tensor part, and nothing serializes
off the export path.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.telemetry.tracing import Span, add_span_listener, wall_anchor, wall_time
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# counter families whose per-round deltas ride each record (absent families — a
# layer that never loaded — simply contribute nothing)
_DELTA_COUNTERS = {
    "bytes_sent": "hivemind_averaging_bytes_sent_total",
    "bytes_received": "hivemind_averaging_bytes_received_total",
    "retries": "hivemind_resilience_retries_total",
    "banned_senders": "hivemind_averaging_banned_senders_total",
    "breaker_trips": "hivemind_breaker_trips_total",
    "chaos_injections": "hivemind_chaos_injections_total",
    "state_sync_bytes": "hivemind_state_sync_bytes_total",
}

# how many open rounds may buffer child phases at once: far above any real
# concurrency (grad + state + powersgd = 3-4), small enough that a leak from
# rounds that never close cannot grow without bound
_MAX_PENDING_ROUNDS = 64

# recently-closed rounds kept addressable for LATE exchange spans. The slowest
# partner's exchange systematically finishes AFTER its round record closes:
# its delta resolves last, which completes the round's output iterator (ending
# the round span) while the exchange task still awaits the stream close — so
# without retro-attachment the ledger would tend to drop exactly the exchange
# it exists to attribute.
_MAX_CLOSED_ROUNDS = 16


def _percentile(values: List[float], fraction: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    index = min(len(ordered) - 1, max(0, math.ceil(fraction * len(ordered)) - 1))
    return ordered[index]


class RoundLedger:
    """See module docstring. One process-wide instance (:data:`LEDGER`) is fed
    by the span listener; tests may build private instances and call
    :meth:`on_span` directly."""

    def __init__(
        self,
        capacity: int = 256,
        epoch_capacity: int = 128,
        registry: MetricsRegistry = REGISTRY,
    ):
        self._lock = threading.Lock()
        self._registry = registry
        self._records: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._epochs: "deque[Dict[str, Any]]" = deque(maxlen=epoch_capacity)
        self._straggler: Dict[str, Dict[str, float]] = {}
        # adaptive link-codec demote/promote decisions, fed by the
        # averager's LinkCodecPolicy — bounded ring, shown in hivemind-top
        self._codec_events: "deque[Dict[str, Any]]" = deque(maxlen=64)
        # open-round buffers keyed by the allreduce.round span id
        self._pending_exchanges: Dict[int, List[Dict[str, Any]]] = {}
        self._pending_local: Dict[int, float] = {}
        # recently-closed rounds (span id -> live record) for late exchanges,
        # plus the straggler-score contribution each record currently holds so
        # a late slower exchange can re-attribute the round
        self._closed_rounds: Dict[int, Dict[str, Any]] = {}
        self._round_contrib: Dict[int, Tuple[str, float]] = {}
        # most recent finished matchmaking per PEER id, consumed by that
        # peer's next round close
        self._last_matchmaking: Dict[str, Dict[str, Any]] = {}
        # delta baselines: empty until the first round SEEDS them (that round
        # reports no counters — attributing bootstrap traffic, e.g. a 2 GB
        # state download, to round 1 would be fiction). clear() re-anchors at
        # clear time, so post-clear round 1 gets a true window.
        self._counter_baseline: Dict[str, float] = {}
        self._round_index = 0
        # per-PEER epoch rolling windows: several optimizers share one process
        # (and this singleton) in tests and soaks, and peer A's transition must
        # not consume peer B's rounds
        self._epoch_window: Dict[str, Dict[str, Any]] = {}
        # record listeners (the black-box spool subscribes): called with
        # ("round"|"epoch", copied record) OUTSIDE the lock — a listener doing
        # file I/O must not serialize the span hot path. A round retro-updated
        # by a late exchange is re-emitted; spool readers keep the last copy
        # per (peer, round).
        self._record_listeners: List = []

    def add_record_listener(self, listener) -> None:
        if listener not in self._record_listeners:
            self._record_listeners.append(listener)

    def remove_record_listener(self, listener) -> None:
        try:
            self._record_listeners.remove(listener)
        except ValueError:
            pass

    def _notify_record(self, kind: str, record: Dict[str, Any]) -> None:
        for listener in self._record_listeners:
            try:
                listener(kind, record)
            except Exception as e:  # pragma: no cover - listeners must stay harmless
                logger.debug(f"ledger record listener failed: {e!r}")

    # ------------------------------------------------------------------ feeding

    def on_span(self, span: Span) -> None:
        """Span listener: cheap name dispatch; everything else is per round."""
        name = span.name
        if name == "allreduce.peer_exchange":
            parent = span.parent_id
            if parent:
                attrs = span.attributes or {}
                info = {
                    "remote": str(attrs.get("remote", "?")),
                    "dur_s": round(span.duration, 6),
                    "events": [n for _t, n, _a in span.events] if span.events else [],
                }
                if attrs.get("codec") is not None:
                    # the negotiated wire tier of this link — rides
                    # the record so demotions are visible per round
                    info["codec"] = str(attrs["codec"])
                updated: Optional[Dict[str, Any]] = None
                with self._lock:
                    if parent in self._closed_rounds:
                        self._attach_late_exchange(parent, info)
                        updated = self._copy_record(self._closed_rounds[parent])
                    else:
                        self._pending_exchanges.setdefault(parent, []).append(info)
                if updated is not None:
                    self._notify_record("round", updated)
        elif name == "allreduce.local_reduce":
            if span.parent_id:
                with self._lock:
                    self._pending_local[span.parent_id] = round(span.duration, 6)
        elif name == "averaging.matchmaking":
            attrs = span.attributes or {}
            with self._lock:
                # keyed by peer id so multi-peer-in-one-process rounds cannot
                # swap waits; two averagers of the SAME peer (grad + state)
                # overlap only in DPU mode, where this stays best-effort
                self._last_matchmaking[str(attrs.get("peer", "?"))] = {
                    "wait_s": round(span.duration, 6),
                    "outcome": attrs.get("outcome"),
                }
        elif name == "allreduce.round":
            self._close_round(span)

    def _counter_total(self, metric_name: str) -> float:
        metric = self._registry.get(metric_name)
        if metric is None:
            return 0.0
        total = 0.0
        for _key, child in metric.series():
            total += child.value  # type: ignore[union-attr]
        return total

    def _close_round(self, span: Span) -> None:
        attrs = span.attributes or {}
        with self._lock:
            exchanges = self._pending_exchanges.pop(span.span_id, [])
            local_reduce = self._pending_local.pop(span.span_id, None)
            matchmaking = self._last_matchmaking.pop(str(attrs.get("peer", "?")), None)
            self._round_index += 1
            record: Dict[str, Any] = {
                "round": self._round_index,
                "time": round(span.start + span.duration + wall_anchor(), 3),
                "peer": str(attrs.get("peer", "?")),
                "group_size": attrs.get("group_size"),
                "rank": attrs.get("rank"),
                "total_s": round(span.duration, 6),
            }
            if matchmaking is not None:
                record["matchmaking_wait_s"] = matchmaking["wait_s"]
                record["matchmaking_outcome"] = matchmaking["outcome"]
            if local_reduce is not None:
                record["local_reduce_s"] = local_reduce
            if exchanges:
                record["exchanges"] = exchanges
                for exchange in exchanges:
                    other = self._score(exchange["remote"])
                    other["total_s"] = round(other["total_s"] + exchange["dur_s"], 6)
                link_codecs = {
                    exchange["remote"]: exchange["codec"]
                    for exchange in exchanges
                    if "codec" in exchange
                }
                if link_codecs:
                    record["link_codecs"] = link_codecs
            events = [n for _t, n, _a in span.events] if span.events else []
            for exchange in exchanges:
                events.extend(exchange["events"])
            if events:
                counts: Dict[str, int] = {}
                for event in events:
                    counts[event] = counts.get(event, 0) + 1
                record["events"] = counts
            # counter deltas since the previous record: this round's window. A
            # metric with no recorded baseline (first round after init/clear)
            # only SEEDS it — attributing process-lifetime totals to round 1
            # would be fiction, not attribution
            counters: Dict[str, float] = {}
            for field, metric_name in _DELTA_COUNTERS.items():
                total = self._counter_total(metric_name)
                baseline = self._counter_baseline.get(metric_name)
                self._counter_baseline[metric_name] = total
                if baseline is None:
                    continue
                delta = total - baseline
                if delta:
                    counters[field] = round(delta, 6)
            if counters:
                record["counters"] = counters
            # the epoch window opens BEFORE attribution runs: _apply_round_
            # attribution only updates an EXISTING window, so a late retro-
            # attribution after record_epoch popped it cannot resurrect the
            # previous epoch's straggler into the next epoch's record
            window = self._peer_epoch_window(record["peer"])
            window["rounds"] += 1
            window["round_s"] += span.duration
            self._apply_round_attribution(span.span_id, record)
            self._records.append(record)
            # the record stays addressable for late exchange spans (see
            # _MAX_CLOSED_ROUNDS): the slowest partner usually lands here
            self._closed_rounds[span.span_id] = record
            while len(self._closed_rounds) > _MAX_CLOSED_ROUNDS:
                oldest = next(iter(self._closed_rounds))
                self._closed_rounds.pop(oldest, None)
                self._round_contrib.pop(oldest, None)
            # prune leaked buffers from rounds that never closed (crashed peers)
            if len(self._pending_exchanges) > _MAX_PENDING_ROUNDS:
                for key in list(self._pending_exchanges)[: -_MAX_PENDING_ROUNDS // 2]:
                    self._pending_exchanges.pop(key, None)
                    self._pending_local.pop(key, None)
            published = self._copy_record(record) if self._record_listeners else None
        if published is not None:
            self._notify_record("round", published)

    def _score(self, remote: str) -> Dict[str, float]:
        return self._straggler.setdefault(
            remote, {"rounds_slowest": 0, "excess_s": 0.0, "total_s": 0.0}
        )

    def _peer_epoch_window(self, peer: str) -> Dict[str, Any]:
        return self._epoch_window.setdefault(
            str(peer),
            {"rounds": 0, "round_s": 0.0, "straggler": None,
             "overlap_sum": 0.0, "overlap_n": 0},
        )

    def note_overlap(self, peer: str, ratio: float) -> None:
        """Stamp a comm round's overlap efficiency (fraction of the
        round's wall time hidden under compute, computed by the device
        StepTimeline) onto this peer's newest round record and accrue it into
        the rolling epoch window, so record_epoch rolls up a per-epoch mean."""
        ratio = float(ratio)
        with self._lock:
            for record in reversed(self._records):
                if record.get("peer") == str(peer):
                    record["overlap_efficiency"] = round(ratio, 4)
                    break
            window = self._peer_epoch_window(str(peer))
            window["overlap_sum"] += ratio
            window["overlap_n"] += 1

    def _apply_round_attribution(self, round_id: int, record: Dict[str, Any]) -> None:
        """(Re)derive slowest/spread from ``record['exchanges']`` and move the
        round's straggler-score contribution to the current slowest partner
        (idempotent per round: a previous attribution is retracted first)."""
        exchanges = record.get("exchanges")
        if not exchanges:
            return
        exchanges.sort(key=lambda e: -e["dur_s"])
        durations = [e["dur_s"] for e in exchanges]
        slowest = exchanges[0]
        record["slowest_peer"] = slowest["remote"]
        record["slowest_s"] = slowest["dur_s"]
        record["exchange_spread_s"] = round(durations[0] - durations[-1], 6)
        excess = (
            max(0.0, slowest["dur_s"] - _percentile(durations, 0.5))
            if len(durations) > 1
            else 0.0
        )
        previous = self._round_contrib.get(round_id)
        if previous is not None:
            prev_remote, prev_excess = previous
            prev_score = self._score(prev_remote)
            prev_score["rounds_slowest"] -= 1
            prev_score["excess_s"] = round(prev_score["excess_s"] - prev_excess, 6)
        score = self._score(slowest["remote"])
        score["rounds_slowest"] += 1
        score["excess_s"] = round(score["excess_s"] + excess, 6)
        self._round_contrib[round_id] = (slowest["remote"], excess)
        window = self._epoch_window.get(str(record.get("peer", "?")))
        if window is not None:  # popped by record_epoch: a late attach must not resurrect it
            window["straggler"] = slowest["remote"]

    def _attach_late_exchange(self, round_id: int, info: Dict[str, Any]) -> None:
        """An exchange span that outlived its round (the slowest one usually
        does — its delta completes the round's output, ending the round span
        while the exchange still awaits the stream close): fold it into the
        already-assembled record and re-attribute the round. Lock held."""
        record = self._closed_rounds[round_id]
        record.setdefault("exchanges", []).append(info)
        if "codec" in info:
            record.setdefault("link_codecs", {})[info["remote"]] = info["codec"]
        score = self._score(info["remote"])
        score["total_s"] = round(score["total_s"] + info["dur_s"], 6)
        if info["events"]:
            counts = record.setdefault("events", {})
            for event in info["events"]:
                counts[event] = counts.get(event, 0) + 1
        self._apply_round_attribution(round_id, record)

    def record_codec_event(self, peer: str, action: str, tier: Optional[str] = None) -> None:
        """One adaptive link-codec decision (demote/promote, from the averager's
        straggler policy): who, what, and to which tier."""
        with self._lock:
            self._codec_events.append(
                {
                    "time": round(wall_time(), 3),
                    "peer": str(peer),
                    "action": str(action),
                    "tier": tier,
                }
            )

    def codec_events(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            events = list(self._codec_events)
            if limit:
                events = events[-limit:]
            return [dict(event) for event in events]

    def record_epoch(
        self,
        epoch: int,
        peer: str = "?",
        averaged_ok: Optional[bool] = None,
        num_peers: Optional[int] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        """One epoch-transition record (called by the optimizer): carries the
        averaging rounds that happened since the previous transition, so the
        per-epoch swarm timeline can attribute epoch wall time to rounds and
        rounds to peers."""
        with self._lock:
            # consume THIS peer's rolling window only (see _epoch_window)
            window = self._epoch_window.pop(str(peer), None) or {
                "rounds": 0, "round_s": 0.0, "straggler": None,
                "overlap_sum": 0.0, "overlap_n": 0,
            }
            entry: Dict[str, Any] = {
                "epoch": int(epoch),
                "peer": str(peer),
                "time": round(wall_time(), 3),
                "rounds": window["rounds"],
                "round_s": round(window["round_s"], 6),
            }
            if window.get("overlap_n"):
                entry["overlap_efficiency"] = round(
                    window["overlap_sum"] / window["overlap_n"], 4
                )
            if averaged_ok is not None:
                entry["averaged_ok"] = bool(averaged_ok)
            if num_peers is not None:
                entry["num_peers"] = int(num_peers)
            if window["straggler"] is not None:
                entry["straggler"] = window["straggler"]
            entry.update(extra)
            self._epochs.append(entry)
        self._notify_record("epoch", dict(entry))
        return dict(entry)

    # ------------------------------------------------------------------ reading

    @staticmethod
    def _copy_record(record: Dict[str, Any]) -> Dict[str, Any]:
        """Records stay LIVE after publication (_attach_late_exchange mutates
        them under the lock), so every read hands out copies deep enough that
        a concurrent retro-attachment cannot change a dict/list mid-serialize."""
        out = dict(record)
        if "exchanges" in out:
            out["exchanges"] = [dict(exchange) for exchange in out["exchanges"]]
        for nested in ("events", "counters", "link_codecs"):
            if nested in out:
                out[nested] = dict(out[nested])
        return out

    def records(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self._records)
            if limit:
                records = records[-limit:]
            return [self._copy_record(record) for record in records]

    def epochs(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            epochs = list(self._epochs)
            if limit:
                epochs = epochs[-limit:]
            return [dict(entry) for entry in epochs]

    def straggler_scores(self, limit: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Per-peer straggler scores, worst first (by times-slowest, then excess)."""
        with self._lock:
            items = sorted(
                ((peer, dict(score)) for peer, score in self._straggler.items()),
                # peer name breaks ties: without it, tied peers rank by dict
                # insertion order — i.e. span completion order — and a limited
                # listing's MEMBERSHIP would vary run to run (the sim hashes
                # these summaries into its determinism digest)
                key=lambda kv: (-kv[1]["rounds_slowest"], -kv[1]["excess_s"], kv[0]),
            )
        return dict(items[:limit] if limit else items)

    def summary(self) -> Dict[str, Any]:
        """Compact rollup for BENCH artifacts and the dashboard header: round
        count plus mean/p95 of each phase — a perf regression's artifact then
        says WHERE the regression lives, not just the headline number."""
        records = self.records()
        out: Dict[str, Any] = {"rounds": len(records), "epochs": len(self._epochs)}
        for field in ("total_s", "matchmaking_wait_s", "local_reduce_s", "slowest_s"):
            values = [r[field] for r in records if field in r]
            if values:
                out[field] = {
                    "mean": round(sum(values) / len(values), 6),
                    "p95": round(_percentile(values, 0.95), 6),
                }
        stragglers = self.straggler_scores(limit=5)
        if stragglers:
            out["stragglers"] = stragglers
        return out

    def snapshot(self, max_records: int = 8, max_stragglers: int = 5) -> Dict[str, Any]:
        """The compact view that rides the DHT peer snapshot: most recent
        records without their full exchange lists, top straggler scores, and
        recent epoch transitions. Size-budgeted by monitor._shrink_to_fit."""
        records = []
        for record in self.records(limit=max_records):
            compact = {k: v for k, v in record.items() if k != "exchanges"}
            records.append(compact)
        out: Dict[str, Any] = {}
        if records:
            out["records"] = records
        stragglers = self.straggler_scores(limit=max_stragglers)
        if stragglers:
            out["stragglers"] = stragglers
        epochs = self.epochs(limit=max_records)
        if epochs:
            out["epochs"] = epochs
        codec_events = self.codec_events(limit=max_stragglers)
        if codec_events:
            out["codec_events"] = codec_events
        return out

    def export(self) -> Dict[str, Any]:
        """Everything, raw — the ``GET /ledger`` response body."""
        return {
            "records": self.records(),
            "epochs": self.epochs(),
            "straggler_scores": self.straggler_scores(),
            "codec_events": self.codec_events(),
            "summary": self.summary(),
        }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._epochs.clear()
            self._straggler.clear()
            self._codec_events.clear()
            self._pending_exchanges.clear()
            self._pending_local.clear()
            self._closed_rounds.clear()
            self._round_contrib.clear()
            self._last_matchmaking.clear()
            # re-anchor the delta baselines NOW: registry counters are
            # monotonic and survive a ledger clear, and the first post-clear
            # record must cover its own window, not everything since import
            self._counter_baseline = {
                metric_name: self._counter_total(metric_name)
                for metric_name in _DELTA_COUNTERS.values()
            }
            self._round_index = 0
            self._epoch_window.clear()

    def __len__(self) -> int:
        return len(self._records)


LEDGER = RoundLedger()
add_span_listener(LEDGER.on_span)
