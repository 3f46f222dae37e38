"""Swarm-wide telemetry (the port of hivemind_tpu/telemetry/monitor.py): one
peer's compact snapshot, its shrinking to a DHT record's budget, and the
aggregation of all peers' snapshots into one view.

The DHT-facing half of the JAX module — ``TelemetryPublisher``,
``fetch_swarm_telemetry`` and ``SwarmMonitor`` — takes a DHT and comes with the
port's DHT. The snapshot and the aggregation are plain dicts, byte-compatible
with the JAX package's, so a torch peer and a JAX peer read each other's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from hivemind_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

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
