"""Swarm-wide telemetry (the port of hivemind_tpu/telemetry/monitor.py): publish
each peer's snapshot to the DHT, and aggregate all peers' snapshots into one view.

Per-peer side, :class:`TelemetryPublisher`: a daemon thread stores a compact
snapshot of the process-wide registry (and optional caller extras) under ``{key}``
/ subkey ``peer_id`` on a timer, so one DHT read answers "where did the time go"
for the whole swarm.

Monitor side, :func:`fetch_swarm_telemetry` + :func:`aggregate_swarm_view` and
the :class:`SwarmMonitor` wrapper with its four renders (report, serving board,
epoch timeline, cross-peer span timeline).

Snapshots are plain dicts stored through the DHT's msgpack, byte-compatible with
the JAX package's, so a port monitor reads JAX peers and the reverse.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

DEFAULT_TELEMETRY_KEY = "hivemind_telemetry"
# the default TelemetryPublisher cadence, and how many missed publishes make a
# peer STALE (shared by every renderer, so they agree about staleness)
DEFAULT_PUBLISH_INTERVAL = 30.0
STALE_AFTER_FACTOR = 3.0

# a snapshot must stay a small DHT record: drop histogram series first, then
# whole metrics, before giving up on the publish
_MAX_SNAPSHOT_BYTES = 48 * 1024


def build_peer_snapshot(
    registry: MetricsRegistry = REGISTRY, extras: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """One peer's compact telemetry record (msgpack/JSON-able). Besides the
    metric snapshot it carries the peer's *health* — tripped breaker boards and
    the last few slow spans — plus recent span summaries, so the swarm monitor
    can show which peers are degraded and reconstruct a cross-peer timeline
    without scraping every peer's ``/trace`` endpoint."""
    # lazy import: telemetry must stay importable before resilience (which
    # itself imports this package for its metrics)
    from hivemind_tpu_torch.resilience import all_board_states
    from hivemind_tpu_torch.telemetry.ledger import LEDGER
    from hivemind_tpu_torch.telemetry.tracing import RECORDER
    from hivemind_tpu_torch.telemetry.watchdog import watchdog_summary

    snapshot: Dict[str, Any] = {
        "time": get_dht_time(),
        "metrics": registry.snapshot(),
    }
    breakers = all_board_states()
    if breakers:
        snapshot["breakers"] = breakers
    slow = RECORDER.slow_spans()
    if slow:
        snapshot["slow_spans"] = [span.summary() for span in slow[-5:]]
    recent = RECORDER.summaries(limit=30)
    if recent:
        snapshot["recent_spans"] = recent
    # per-round attribution: recent records + straggler scores +
    # epoch transitions ride the snapshot so ONE DHT read answers "which peer
    # is taxing the swarm" without scraping anyone's /ledger
    ledger = LEDGER.snapshot()
    if ledger:
        snapshot["ledger"] = ledger
    # serving attribution: per-expert serving stats + saturation on
    # the server side, expert scorecards on the client side — hivemind-top's
    # --serving board renders entirely from this section
    from hivemind_tpu_torch.telemetry.serving import SCORECARDS, SERVING_LEDGER

    serving = SERVING_LEDGER.snapshot()
    scorecards = SCORECARDS.snapshot()
    if scorecards:
        serving["scorecards"] = scorecards
    if serving:
        snapshot["serving"] = serving
    watchdog = watchdog_summary()
    if watchdog.get("loops"):
        snapshot["watchdog"] = watchdog
    # device-side observability: compile counts / card memory / transfer /
    # overlap ride the snapshot; empty dict when the process never touched a card
    from hivemind_tpu_torch.telemetry.device import device_snapshot

    device = device_snapshot()
    if device:
        snapshot["device"] = device
    if extras:
        snapshot.update(extras)
    return snapshot


def _shrink_to_fit(snapshot: Dict[str, Any], max_bytes: int = _MAX_SNAPSHOT_BYTES) -> Dict[str, Any]:
    from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

    if len(MSGPackSerializer.dumps(snapshot)) <= max_bytes:
        return snapshot
    # span summaries are nice-to-have context; the health + counter core wins.
    # Ledger records shrink before they drop: straggler scores are the most
    # load-bearing part of the attribution layer, so they go last
    ledger = snapshot.get("ledger")
    if isinstance(ledger, dict) and "records" in ledger:
        shrunk_ledger = {k: v for k, v in ledger.items() if k != "records"}
        candidate = {**snapshot, "ledger": shrunk_ledger, "truncated": True}
        if len(MSGPackSerializer.dumps(candidate)) <= max_bytes:
            return candidate
        snapshot = candidate
    # serving records shrink before they drop: the per-expert stats + totals
    # are the board's load-bearing part, the slowest exemplars are context
    serving = snapshot.get("serving")
    if isinstance(serving, dict) and ("slowest" in serving or "clients" in serving):
        shrunk_serving = {k: v for k, v in serving.items() if k not in ("slowest", "clients")}
        candidate = {**snapshot, "serving": shrunk_serving, "truncated": True}
        if len(MSGPackSerializer.dumps(candidate)) <= max_bytes:
            return candidate
        snapshot = candidate
    # device section shrinks before it drops: headline compile/memory/overlap
    # numbers survive as a compact dict, per-site/per-device detail goes
    device = snapshot.get("device")
    if isinstance(device, dict) and device:
        from hivemind_tpu_torch.telemetry.device import compact_device_snapshot

        compacted = compact_device_snapshot(device)
        if compacted != device:
            candidate = {**snapshot, "device": compacted, "truncated": True}
            if len(MSGPackSerializer.dumps(candidate)) <= max_bytes:
                return candidate
            snapshot = candidate
    # span summaries are nice-to-have context: they go first
    for optional_key in ("recent_spans", "slow_spans"):
        if optional_key in snapshot:
            snapshot = {k: v for k, v in snapshot.items() if k != optional_key}
            snapshot["truncated"] = True
            if len(MSGPackSerializer.dumps(snapshot)) <= max_bytes:
                return snapshot
    metrics = dict(snapshot.get("metrics", {}))
    # per-label series are the bulk; the swarm view only ever aggregates a
    # family's totals, so COMPACT the largest families to one summed series
    # BEFORE dropping the attribution sections — a label explosion must cost
    # label detail (recoverable swarm-wide), not the ledger/serving records
    # (irreplaceable)
    by_size = sorted(metrics, key=lambda name: -len(str(metrics[name])))
    for name in by_size:
        metrics[name] = _compact_family(metrics[name])
        shrunk = {**snapshot, "metrics": metrics, "truncated": True}
        if len(MSGPackSerializer.dumps(shrunk)) <= max_bytes:
            return shrunk
    snapshot = {**snapshot, "metrics": metrics}
    # the (already compacted) device section drops before serving/ledger: its
    # headline numbers are re-derivable from metrics, attribution records aren't
    for optional_key in ("device", "serving", "ledger"):
        if optional_key in snapshot:
            snapshot = {k: v for k, v in snapshot.items() if k != optional_key}
            snapshot["truncated"] = True
            if len(MSGPackSerializer.dumps(snapshot)) <= max_bytes:
                return snapshot
    # still too big (pathological family count): drop largest families outright
    for name in sorted(metrics, key=lambda name: -len(str(metrics[name]))):
        metrics.pop(name)
        shrunk = {**snapshot, "metrics": metrics, "truncated": True}
        if len(MSGPackSerializer.dumps(shrunk)) <= max_bytes:
            return shrunk
    return {**snapshot, "metrics": {}, "truncated": True}


def _compact_family(family: Dict[str, Any]) -> Dict[str, Any]:
    """Collapse a family's per-label series into one aggregate series (same shape
    the aggregator consumes, so totals survive label-free)."""
    series = family.get("series") or {}
    if len(series) <= 1:
        return family
    if family.get("type") == "histogram":
        merged: Dict[str, float] = {"count": 0.0, "sum": 0.0}
        for value in series.values():
            if isinstance(value, dict):
                merged["count"] += float(value.get("count", 0))
                merged["sum"] = round(merged["sum"] + float(value.get("sum", 0.0)), 6)
        return {**family, "series": {"": merged}, "compacted": True}
    total = 0.0
    for value in series.values():
        if not isinstance(value, dict):
            total += float(value)
    return {**family, "series": {"": round(total, 6)}, "compacted": True}


class TelemetryPublisher:
    """Periodically store this peer's snapshot in the DHT (one subkey per peer).

    :param dht: the peer's :class:`~hivemind_tpu_torch.dht.DHT`
    :param key: DHT key to publish under; swarm members must agree on it
        (convention: ``f"{run_id}_telemetry"`` for training runs)
    :param interval: seconds between publishes
    :param extras_fn: zero-arg callable merged into every snapshot (e.g.
        ``lambda: {"step_profiler": profiler.summary()}``)
    """

    def __init__(
        self,
        dht,
        key: str = DEFAULT_TELEMETRY_KEY,
        *,
        interval: float = 30.0,
        registry: MetricsRegistry = REGISTRY,
        extras_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        start: bool = True,
    ):
        self.dht = dht
        self.key = key
        self.interval = interval
        self.registry = registry
        self.extras_fn = extras_fn
        self.last_published: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="telemetry-publisher", daemon=True
        )
        self._thread.start()

    def publish_once(self) -> bool:
        """Build + store one snapshot now (also used by the timer thread)."""
        extras: Dict[str, Any] = {}
        if self.extras_fn is not None:
            try:
                extras = dict(self.extras_fn())
            except Exception as e:
                logger.debug(f"telemetry extras_fn failed: {e!r}")
        extras.setdefault("peer_id", str(self.dht.peer_id))
        snapshot = _shrink_to_fit(build_peer_snapshot(self.registry, extras))
        try:
            ok = self.dht.store(
                self.key,
                value=snapshot,
                subkey=self.dht.peer_id.to_bytes(),
                expiration_time=get_dht_time() + max(self.interval * 3, 60.0),
            )
        except Exception as e:
            logger.debug(f"telemetry publish failed: {e!r}")
            return False
        if ok:
            self.last_published = snapshot
        return bool(ok)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.publish_once()

    def shutdown(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)


# ------------------------------------------------------------------ monitor side


def fetch_swarm_telemetry(dht, key: str = DEFAULT_TELEMETRY_KEY) -> Dict[str, Dict[str, Any]]:
    """All peers' live snapshots: ``{peer_id_str: snapshot_dict}``."""
    response = dht.get(key, latest=True)
    records: Dict[str, Dict[str, Any]] = {}
    if response is None or not isinstance(response.value, dict):
        return records
    for subkey, entry in response.value.items():
        snapshot = entry.value if hasattr(entry, "value") else entry
        if not isinstance(snapshot, dict):
            continue
        peer = snapshot.get("peer_id")
        if not isinstance(peer, str):
            peer = subkey.hex() if isinstance(subkey, bytes) else str(subkey)
        records[peer] = snapshot
    return records


def aggregate_swarm_view(records: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Collapse per-peer snapshots into the swarm-wide view: counter/gauge totals
    per metric (counters/histogram-counts sum; gauges also carry min/max so a
    straggler epoch is visible), plus a per-peer health summary."""
    totals: Dict[str, Dict[str, Any]] = {}
    peers: Dict[str, Dict[str, Any]] = {}
    now = get_dht_time()
    for peer, snapshot in records.items():
        # snapshots are DHT-supplied: a malformed (buggy/version-skewed/hostile)
        # peer contributes an error marker, never a crashed aggregation
        try:
            age = round(max(now - float(snapshot.get("time", now)), 0.0), 1)
        except (TypeError, ValueError):
            age = -1.0  # unparseable timestamp
        peers[peer] = {
            "age_s": age,
            # recent_spans feed render_timeline, not the per-peer health line
            **{k: v for k, v in snapshot.items() if k not in ("metrics", "time", "peer_id", "recent_spans")},
        }
        metrics = snapshot.get("metrics")
        if not isinstance(metrics, dict):
            if metrics is not None:
                peers[peer]["malformed"] = True
            continue
        for name, family in metrics.items():
            if not isinstance(family, dict):
                continue
            ftype = family.get("type", "untyped")
            agg = totals.setdefault(name, {"type": ftype, "total": 0.0, "peers": 0})
            agg["peers"] += 1
            series = family.get("series")
            for _label, value in (series.items() if isinstance(series, dict) else ()):
                try:
                    if isinstance(value, dict):  # histogram: count/sum
                        agg["total"] += float(value.get("count", 0))
                        agg["sum"] = round(agg.get("sum", 0.0) + float(value.get("sum", 0.0)), 6)
                    else:
                        agg["total"] += float(value)
                        if ftype == "gauge":
                            agg["min"] = min(agg.get("min", float(value)), float(value))
                            agg["max"] = max(agg.get("max", float(value)), float(value))
                except (TypeError, ValueError):
                    peers[peer]["malformed"] = True
    for agg in totals.values():
        agg["total"] = round(agg["total"], 6)
    return {"num_peers": len(records), "metrics": totals, "peers": peers}


class SwarmMonitor:
    """Fetch + aggregate on demand, optionally appending each view to a sink (any
    object with ``log(dict)``)."""

    # the swarm's agreed TelemetryPublisher cadence: a peer whose snapshot age
    # exceeds STALE_AFTER_FACTOR x this is flagged STALE (it stopped publishing
    # — crashed, wedged, or partitioned — even if its last numbers look
    # healthy). A class default so render-only monitors (tests build them
    # without __init__) work.
    publish_interval: float = DEFAULT_PUBLISH_INTERVAL

    def __init__(
        self,
        dht,
        key: str = DEFAULT_TELEMETRY_KEY,
        sink=None,
        publish_interval: float = DEFAULT_PUBLISH_INTERVAL,
    ):
        self.dht = dht
        self.key = key
        self.sink = sink
        self.publish_interval = publish_interval

    def poll(self) -> Dict[str, Any]:
        view = aggregate_swarm_view(fetch_swarm_telemetry(self.dht, self.key))
        view["time"] = round(time.time(), 3)
        if self.sink is not None:
            try:
                self.sink.log({"swarm_telemetry": view})
            except Exception as e:
                logger.debug(f"telemetry sink write failed: {e!r}")
        return view

    def render_report(self, view: Optional[Dict[str, Any]] = None) -> str:
        """Human-readable one-screen summary for log lines / CLIs. Peers whose
        snapshot carries tripped breakers or slow spans are flagged DEGRADED —
        the "which peer is the problem" line, not just its counters."""
        view = view if view is not None else self.poll()
        lines = [f"swarm telemetry: {view['num_peers']} peers"]
        for name, agg in sorted(view.get("metrics", {}).items()):
            extra = ""
            if "sum" in agg:
                extra = f", sum={agg['sum']:.3f}s"
            if "min" in agg and agg.get("min") != agg.get("max"):
                extra += f", min={agg['min']}, max={agg['max']}"
            lines.append(f"  {name} [{agg['type']}] total={agg['total']}{extra} ({agg['peers']} peers)")
        # recovery-path emergencies (docs/state_recovery.md): either of these
        # growing means the swarm is quietly diverging — a peer claimed epochs
        # it never trained, or adopted state no digest ever blessed
        for name, what in (
            ("hivemind_optimizer_epoch_adopted_without_state_total", "epoch(s) adopted WITHOUT state"),
            ("hivemind_state_sync_unverified_adoptions_total", "unverified (manifest-less) state adoption(s)"),
        ):
            agg = view.get("metrics", {}).get(name)
            if agg and agg.get("total"):
                lines.append(f"  RECOVERY ALERT: {agg['total']:g} {what} across the swarm")
        stale_after = STALE_AFTER_FACTOR * self.publish_interval
        for peer, health in sorted(view.get("peers", {}).items()):
            breakers = health.get("breakers") or {}
            slow = health.get("slow_spans") or []
            ledger = health.get("ledger") or {}
            watchdog = health.get("watchdog") or {}
            marker = " DEGRADED" if breakers or slow else ""
            if float(health.get("age_s", 0.0)) > stale_after:
                # stopped publishing: crashed, wedged, or partitioned — its
                # numbers below are a snapshot of the PAST, not the present
                marker = " STALE" + marker
            printable = {
                k: v for k, v in health.items() if k not in ("ledger", "watchdog", "serving")
            }
            lines.append(f"  peer {peer[:16]}…:{marker} {printable}")
            for board, state in sorted(breakers.items()):
                lines.append(f"    breaker {board}: {state.get('num_tripped', 0)} tripped {state.get('tripped')}")
            for span in slow:
                lines.append(
                    f"    slow span {span.get('name')}: {span.get('dur_ms')}ms events={span.get('events', [])}"
                )
            if watchdog.get("stalls"):
                lines.append(
                    f"    WATCHDOG: {watchdog['stalls']} event-loop stall(s), "
                    f"max lag {watchdog.get('max_lag_s', 0.0)}s — this peer's loop blocked; "
                    f"it is NOT a network straggler"
                )
            for victim, score in list((ledger.get("stragglers") or {}).items())[:3]:
                lines.append(
                    f"    straggler seen: {str(victim)[:16]} slowest in "
                    f"{score.get('rounds_slowest', 0)} round(s), +{score.get('excess_s', 0.0)}s excess"
                )
        serving_board = self.render_serving_board(view)
        if serving_board:
            lines.append(serving_board)
        timeline = self.render_epoch_timeline(view)
        if timeline:
            lines.append(timeline)
        return "\n".join(lines)

    def render_serving_board(self, view: Optional[Dict[str, Any]] = None) -> str:
        """The serving board: per-expert request counts / p95 / sheds
        merged across every peer's serving section, the saturation gauges
        (queue depth/age, session occupancy, shed totals), degraded client-side
        scorecards, and the slowest-request exemplars — which expert on which
        peer is eating serving time, as one screen (parsed by
        ``telemetry.serving.collect_swarm_serving``)."""
        from hivemind_tpu_torch.telemetry.serving import (
            collect_swarm_serving,
            format_saturation_parts,
            format_scorecard_line,
            format_slowest_line,
        )

        view = view if view is not None else self.poll()
        data = collect_swarm_serving(view.get("peers") or {})
        if not any(data[key] for key in ("experts", "saturation", "degraded_scorecards", "slowest", "malformed")):
            return ""
        lines = ["  serving board (expert @ peer / requests / p95 / sheds):"]
        for peer, uid, stats in data["experts"][:16]:
            p95 = stats["p95_s"]
            lines.append(
                f"    {uid[:24]:<24} @ {peer[:12]:<12} {stats['requests']:>6.0f} req "
                f"p95={f'{p95 * 1e3:.1f}ms' if p95 is not None else '-':>9}"
                + (f"  SHED x{stats['sheds']}" if stats["sheds"] else "")
            )
        for peer in data["malformed"]:
            lines.append(f"    {peer[:16]:<16} <malformed serving section>")
        if data["saturation"]:
            lines.append("  serving saturation:")
            lines.extend(
                f"    {peer[:16]:<16} {', '.join(format_saturation_parts(entry))}"
                for peer, entry in data["saturation"]
            )
        if data["degraded_scorecards"]:
            lines.append("  degraded expert scorecards (client view):")
            lines.extend(
                "    " + format_scorecard_line(peer, uid, card)
                for peer, uid, card in data["degraded_scorecards"][:8]
            )
        if data["slowest"]:
            lines.append("  slowest requests:")
            lines.extend(
                "    " + format_slowest_line(total_s, peer, record)
                for total_s, peer, record in data["slowest"][:5]
            )
        return "\n".join(lines)

    def render_epoch_timeline(self, view: Optional[Dict[str, Any]] = None) -> str:
        """Per-epoch swarm timeline with straggler attribution: every
        peer's ledger epoch records, grouped by epoch — one line per peer per
        epoch showing rounds run, averaging seconds spent, and which partner was
        slowest. This is "where did epoch N's wall time go" as one screen."""
        view = view if view is not None else self.poll()
        by_epoch: Dict[int, list] = {}
        for peer, health in (view.get("peers") or {}).items():
            for entry in (health.get("ledger") or {}).get("epochs") or ():
                # snapshots are DHT-supplied: one malformed (buggy/stale/hostile)
                # peer must not crash every operator's report
                if isinstance(entry, dict) and isinstance(entry.get("epoch"), (int, float)):
                    by_epoch.setdefault(int(entry["epoch"]), []).append((peer, entry))
        if not by_epoch:
            return ""
        lines = ["  epoch timeline (rounds / averaging seconds / slowest partner):"]
        for epoch in sorted(by_epoch)[-8:]:
            lines.append(f"    epoch {epoch}:")
            for peer, entry in sorted(by_epoch[epoch], key=lambda kv: kv[0]):
                try:
                    rounds = int(entry.get("rounds", 0) or 0)
                    round_s = float(entry.get("round_s", 0.0) or 0.0)
                except (TypeError, ValueError):
                    lines.append(f"      {str(peer)[:16]:<16} <malformed ledger entry>")
                    continue
                straggler = entry.get("straggler")
                attribution = f" slowest={str(straggler)[:16]}" if straggler else ""
                averaged = entry.get("averaged_ok")
                outcome = "" if averaged is None else (" ok" if averaged else " DEGRADED_TO_LOCAL")
                lines.append(
                    f"      {str(peer)[:16]:<16} {rounds} round(s) "
                    f"{round_s:.3f}s{attribution}{outcome}"
                )
        return "\n".join(lines)

    def render_timeline(self, records: Optional[Dict[str, Dict[str, Any]]] = None) -> str:
        """Cross-peer timeline: pull every peer's recent span summaries from the
        DHT, group them by trace, and print each trace's spans in start order —
        one line per span, labeled with the owning peer. This is how "why was
        THIS round slow" reads without collecting per-peer /trace dumps."""
        records = records if records is not None else fetch_swarm_telemetry(self.dht, self.key)
        by_trace: Dict[str, list] = {}
        for peer, snapshot in records.items():
            for span in snapshot.get("recent_spans") or ():
                if isinstance(span, dict) and span.get("trace"):
                    by_trace.setdefault(span["trace"], []).append((peer, span))
        lines = [f"swarm timeline: {len(by_trace)} traces from {len(records)} peers"]
        # most recently started traces first; spans within a trace in time order
        def trace_start(spans):
            return min(float(s.get("start", 0.0)) for _p, s in spans)

        for trace_id, spans in sorted(by_trace.items(), key=lambda kv: -trace_start(kv[1])):
            spans.sort(key=lambda item: float(item[1].get("start", 0.0)))
            origin = float(spans[0][1].get("start", 0.0))
            lines.append(f"trace {trace_id}:")
            for peer, span in spans:
                offset_ms = (float(span.get("start", 0.0)) - origin) * 1e3
                events = f" !{','.join(span['events'])}" if span.get("events") else ""
                lines.append(
                    f"  +{offset_ms:8.1f}ms {peer[:12]:<12} {span.get('name')}"
                    f" ({span.get('dur_ms')}ms){events}"
                )
        return "\n".join(lines)
