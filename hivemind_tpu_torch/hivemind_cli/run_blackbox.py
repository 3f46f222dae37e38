"""``hivemind-tpu-torch-blackbox``: cross-peer post-mortem over black-box spools
(the port of hivemind_tpu/hivemind_cli/run_blackbox.py; the spool is a wire format
both packages share, so either tool reads either package's spools).

Each peer's :class:`~hivemind_tpu_torch.telemetry.blackbox.BlackBox` leaves a
crash-durable spool directory behind; this tool reads N of them and rebuilds
what the swarm was doing when it died:

- **merge** — one cross-peer timeline: frames joined on trace id, per-peer
  wall-anchor skew corrected so a child span can never start before the
  remote parent that caused it (the spool headers' anchor/drift estimates
  bound the residual);
- **chrome export** (``--format chrome``) — the merged spans as Chrome
  trace-event JSON, one pid row per peer; opens directly in Perfetto;
- **post-mortem** (``--victim``) — the victim's final ledger round and its
  last in-flight span (a ``span_start`` frame with no matching finish: the
  operation the peer died inside), which the churn soak's
  ``postmortem_reconstructed`` verdict requires;
- **--last N** — focus every output on the final N seconds before the
  victim's (or the swarm's) last recorded frame.

Run it::

    hivemind-tpu-torch-blackbox run/blackbox/peer* --victim <peer_id> --last 30
    hivemind-tpu-torch-blackbox run/blackbox/peer* --format chrome --out dead_swarm.json

``hivemind-tpu-torch-top --from-spool`` renders the same spools as a dashboard frame.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.blackbox import read_spool
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# skew refinement passes: each pass propagates causality constraints one
# cross-peer hop further; real swarm graphs settle in two or three
_SKEW_PASSES = 4


def load_spools(directories: List[Path]) -> Dict[str, Dict[str, Any]]:
    """Read each spool dir into ``{peer: {"frames", "stats", "header"}}``.
    The peer name comes from the newest segment header (falling back to the
    directory name for headerless/empty spools)."""
    spools: Dict[str, Dict[str, Any]] = {}
    for directory in directories:
        frames, stats = read_spool(directory)
        header: Optional[Dict[str, Any]] = None
        for frame in frames:
            if frame["k"] == "header":
                header = frame["d"]
        peer = str((header or {}).get("peer") or Path(directory).name)
        spools[peer] = {"frames": frames, "stats": stats, "header": header}
    return spools


def _span_frames(frames: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [f for f in frames if f["k"] in ("span", "span_start") and isinstance(f["d"], dict)]


def estimate_skew(spools: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """Per-peer clock offsets (seconds to ADD to a peer's timestamps) from
    causality: a span whose parent lives on another peer cannot start before
    that parent did — cross-peer RPC propagation guarantees the ordering, so
    any negative child-minus-parent gap measures wall-anchor skew. Best
    effort: peers with no cross-peer spans keep offset 0."""
    # newest observation per span id wins (span frames repeat: start + finish)
    owner: Dict[str, Tuple[str, float]] = {}
    for peer, spool in spools.items():
        for frame in _span_frames(spool["frames"]):
            data = frame["d"]
            if "span" in data and "start" in data:
                owner[data["span"]] = (peer, float(data["start"]))
    offsets = {peer: 0.0 for peer in spools}
    for _ in range(_SKEW_PASSES):
        moved = False
        for peer, spool in spools.items():
            for frame in _span_frames(spool["frames"]):
                data = frame["d"]
                parent = data.get("parent")
                if parent is None or "start" not in data:
                    continue
                parent_owner = owner.get(parent)
                if parent_owner is None or parent_owner[0] == peer:
                    continue
                parent_peer, parent_start = parent_owner
                gap = (float(data["start"]) + offsets[peer]) - (
                    parent_start + offsets[parent_peer]
                )
                if gap < 0:
                    offsets[peer] = round(offsets[peer] - gap, 6)
                    moved = True
        if not moved:
            break
    return offsets


def merge_timeline(
    spools: Dict[str, Dict[str, Any]],
    offsets: Optional[Dict[str, float]] = None,
    last_s: Optional[float] = None,
    victim: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """All peers' frames as one time-sorted list of ``{"t", "peer", "k",
    "d"}`` with skew-corrected timestamps. ``last_s`` keeps only the final
    window, anchored at the victim's last frame when given (the moment of
    death), else the swarm-wide newest frame."""
    offsets = offsets if offsets is not None else estimate_skew(spools)
    merged: List[Dict[str, Any]] = []
    for peer, spool in spools.items():
        shift = offsets.get(peer, 0.0)
        for frame in spool["frames"]:
            merged.append(
                {"t": round(float(frame["t"]) + shift, 6), "peer": peer,
                 "k": frame["k"], "d": frame["d"]}
            )
    merged.sort(key=lambda f: f["t"])
    if last_s is not None and merged:
        if victim is not None:
            victim_times = [f["t"] for f in merged if f["peer"] == victim]
            horizon = max(victim_times) if victim_times else merged[-1]["t"]
        else:
            horizon = merged[-1]["t"]
        merged = [f for f in merged if horizon - last_s <= f["t"] <= horizon]
    return merged


def reconstruct_final_round(
    frames: List[Dict[str, Any]], stats: Optional[Dict[str, int]] = None
) -> Dict[str, Any]:
    """One dead peer's last moments from its spool: the final ledger round
    (the newest copy wins — rounds re-emitted by late-exchange retro-
    attribution supersede earlier ones), the last FINISHED span, and the last
    IN-FLIGHT span (started, never finished: the operation it died inside)."""
    final_round: Optional[Dict[str, Any]] = None
    last_epoch: Optional[Dict[str, Any]] = None
    finished: Dict[str, Dict[str, Any]] = {}
    starts: List[Tuple[float, Dict[str, Any]]] = []
    last_finished: Optional[Dict[str, Any]] = None
    device = _aggregate_device_frames(frames)
    for frame in frames:
        kind, data = frame["k"], frame["d"]
        if kind == "ledger_round":
            if final_round is None or data.get("round", 0) >= final_round.get("round", 0):
                final_round = data
        elif kind == "ledger_epoch":
            last_epoch = data
        elif kind == "span":
            finished[data.get("span", "")] = data
            last_finished = data
        elif kind == "span_start":
            starts.append((float(frame["t"]), data))
    in_flight = [data for _t, data in starts if data.get("span") not in finished]
    out: Dict[str, Any] = {
        "reconstructed": final_round is not None and bool(in_flight or last_finished),
        "final_round": final_round,
        "last_span": last_finished,
        "last_in_flight": in_flight[-1] if in_flight else None,
        "open_spans": len(in_flight),
    }
    if last_epoch is not None:
        out["last_epoch"] = last_epoch
    if device:
        # the victim's last device-side state — its final compile
        # and HBM sample are part of "what was it doing when it died"
        out["device"] = device
    if stats is not None:
        out["reader_stats"] = dict(stats)
    return out


def _aggregate_device_frames(frames: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``device`` frames rolled into one snapshot-shaped section: per-site
    compile counts (recomputed by replay), the newest memory sample, storm /
    leak counts, and the last overlap record. Empty dict when the spool holds
    no device telemetry (older spools stay readable)."""
    # sites carry {"count": ...} dicts — the SAME shape as the live
    # device_snapshot(), so hivemind-top's device board renders either
    sites: Dict[str, Dict[str, int]] = {}
    out: Dict[str, Any] = {}
    storms = leaks = 0
    last_compile = last_memory = None
    ratios: List[float] = []
    for frame in frames:
        if frame["k"] != "device" or not isinstance(frame["d"], dict):
            continue
        data = frame["d"]
        kind = data.get("kind")
        if kind == "compile":
            # each frame carries the site's running count: the last one wins
            sites[str(data.get("site"))] = {"count": int(data.get("count", 0))}
            last_compile = data
        elif kind == "storm":
            storms += 1
        elif kind == "memory":
            last_memory = data
        elif kind == "leak":
            leaks += 1
        elif kind == "overlap":
            ratios.append(float(data.get("overlap_ratio", 0.0)))
    if sites:
        out["compiles"] = {
            "total": sum(site["count"] for site in sites.values()),
            "sites": sites,
            "storms": storms,
            "last": last_compile,
        }
        out["last_compile"] = last_compile
    if last_memory is not None:
        out["memory"] = {k: v for k, v in last_memory.items() if k != "kind"}
    if leaks:
        out["leaks_suspected"] = leaks
    if ratios:
        out["overlap"] = {
            "rounds": len(ratios),
            "last": ratios[-1],
            "mean": round(sum(ratios) / len(ratios), 4),
        }
    return out


def render_spool_chrome_trace(merged: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merged span frames as Chrome trace-event JSON (Perfetto): one pid row
    per peer, finished spans as complete events, still-open spans as instants
    flagged ``in_flight`` — on a dead peer's row, the instant at the end IS
    the crash site. Comm/compute spans land on fixed named lanes per peer
    (mirroring ``tracing.export_chrome_trace``) so the overlap the
    StepTimeline scores is visible as two stacked rows."""
    from hivemind_tpu_torch.telemetry.device import span_lane

    lane_tids = {"compute": 1, "comm": 2}
    peers: Dict[str, int] = {}
    lanes_used: set = set()
    events: List[Dict[str, Any]] = []
    finished_ids = {
        f["d"].get("span") for f in merged if f["k"] == "span" and isinstance(f["d"], dict)
    }
    for frame in merged:
        if frame["k"] not in ("span", "span_start") or not isinstance(frame["d"], dict):
            continue
        data = frame["d"]
        pid = peers.get(frame["peer"])
        if pid is None:
            pid = peers[frame["peer"]] = len(peers) + 1
        args = {k: v for k, v in (data.get("attrs") or {}).items()}
        args["trace_id"] = data.get("trace")
        args["span_id"] = data.get("span")
        if data.get("parent"):
            args["parent_id"] = data["parent"]
        lane = span_lane(str(data.get("name") or ""))
        if lane is not None:
            tid = lane_tids[lane]
            args["lane"] = lane
            lanes_used.add((pid, lane))
        else:
            tid = 3
        if frame["k"] == "span":
            events.append(
                {"name": data.get("name"), "cat": "span", "ph": "X",
                 "ts": round(float(data.get("start", frame["t"])) * 1e6, 3),
                 "dur": round(max(float(data.get("dur_s", 0.0)) * 1e6, 0.001), 3),
                 "pid": pid, "tid": tid, "args": args}
            )
        elif data.get("span") not in finished_ids:
            args["in_flight"] = True
            events.append(
                {"name": data.get("name"), "cat": "span", "ph": "i", "s": "p",
                 "ts": round(float(data.get("start", frame["t"])) * 1e6, 3),
                 "pid": pid, "tid": tid, "args": args}
            )
    for peer, pid in peers.items():
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"peer {peer}"}}
        )
    for pid, lane in sorted(lanes_used):
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid,
             "tid": lane_tids[lane], "args": {"name": lane}}
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spool_snapshot(spool: Dict[str, Any]) -> Dict[str, Any]:
    """One peer's spool rendered as the snapshot shape ``hivemind-top``'s
    render_frame consumes — the bridge behind ``hivemind-top --from-spool``
    (a dashboard over a dead swarm). Straggler scores are recomputed from the
    spooled round records, so attribution survives the crash too."""
    frames = spool["frames"]
    snapshot: Dict[str, Any] = {}
    rounds: Dict[Any, Dict[str, Any]] = {}
    stragglers: Dict[str, Dict[str, float]] = {}
    slow: List[Dict[str, Any]] = []
    last_t = 0.0
    for frame in frames:
        kind, data = frame["k"], frame["d"]
        last_t = max(last_t, float(frame["t"]))
        if kind == "metrics" and isinstance(data, dict):
            snapshot["metrics"] = data.get("metrics") or {}
        elif kind == "ledger_round" and isinstance(data, dict):
            rounds[data.get("round")] = data  # newest re-emission wins
        elif kind == "span" and isinstance(data, dict) and "dur_s" in data:
            slow.append(data)
    for record in rounds.values():
        slowest = record.get("slowest_peer")
        if not slowest:
            continue
        score = stragglers.setdefault(
            str(slowest), {"rounds_slowest": 0, "excess_s": 0.0, "total_s": 0.0}
        )
        score["rounds_slowest"] += 1
        durations = sorted(
            (float(e["dur_s"]) for e in record.get("exchanges") or () if "dur_s" in e),
            reverse=True,
        )
        if len(durations) > 1:
            median = durations[len(durations) // 2]
            score["excess_s"] = round(
                score["excess_s"] + max(0.0, durations[0] - median), 6
            )
    slow.sort(key=lambda d: -float(d.get("dur_s", 0.0)))
    snapshot["time"] = last_t
    ledger: Dict[str, Any] = {}
    if rounds:
        ledger["records"] = [
            {k: v for k, v in record.items() if k != "exchanges"}
            for _key, record in sorted(rounds.items(), key=lambda kv: kv[1].get("round", 0))
        ]
    if stragglers:
        ledger["stragglers"] = stragglers
    if ledger:
        snapshot["ledger"] = ledger
    if slow:
        snapshot["slow_spans"] = [
            {"name": d.get("name"), "dur_ms": round(float(d["dur_s"]) * 1e3, 3),
             "events": [e[1] for e in d.get("events") or ()]}
            for d in slow[:3]
        ]
    device = _aggregate_device_frames(frames)
    if device:
        # same shape as the live snapshot's device section — hivemind-top's
        # device board renders a dead peer exactly like a live one
        snapshot["device"] = device
    return snapshot


def _text_report(
    spools: Dict[str, Dict[str, Any]],
    offsets: Dict[str, float],
    merged: List[Dict[str, Any]],
    victim: Optional[str],
) -> str:
    lines = [f"merged {len(merged)} frame(s) from {len(spools)} spool(s)"]
    for peer, spool in sorted(spools.items()):
        stats = spool["stats"]
        clock = (spool["header"] or {}).get("clock", "?")
        lines.append(
            f"  {peer[:24]:<24} {stats['frames']:>6} frames / {stats['segments']} segment(s), "
            f"clock={clock}, skew={offsets.get(peer, 0.0):+.3f}s"
            + (f", torn_tail={stats['torn_tail']}" if stats["torn_tail"] else "")
            + (f", corrupt={stats['corrupt']}" if stats["corrupt"] else "")
        )
    targets = [victim] if victim else sorted(spools)
    for peer in targets:
        if peer not in spools:
            lines.append(f"  victim {peer!r}: no such spool")
            continue
        post = reconstruct_final_round(spools[peer]["frames"], spools[peer]["stats"])
        final_round = post["final_round"] or {}
        lines.append(f"post-mortem {peer}:")
        lines.append(
            f"  final round: #{final_round.get('round', '?')} "
            f"group_size={final_round.get('group_size')} total={final_round.get('total_s')}s "
            f"slowest={final_round.get('slowest_peer')}"
            if post["final_round"]
            else "  final round: <none spooled>"
        )
        in_flight = post["last_in_flight"]
        if in_flight is not None:
            lines.append(
                f"  last in-flight span: {in_flight.get('name')} "
                f"(trace {in_flight.get('trace')}, started {in_flight.get('start')}) "
                f"— died inside this operation"
            )
        elif post["last_span"] is not None:
            lines.append(f"  last finished span: {post['last_span'].get('name')}")
        device = post.get("device") or {}
        compiles = device.get("compiles")
        if compiles:
            last_compile = device.get("last_compile") or {}
            lines.append(
                f"  device: {compiles.get('total', 0)} compile(s), "
                f"{compiles.get('storms', 0)} storm(s); last compile at site "
                f"{last_compile.get('site')!r}"
            )
        memory = device.get("memory")
        if memory:
            lines.append(
                f"  device memory at death: {memory.get('total_bytes', 0)} live bytes "
                f"across {memory.get('buffers', 0)} buffer(s)"
                + (f", leaks suspected: {device['leaks_suspected']}"
                   if device.get("leaks_suspected") else "")
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("spools", nargs="+", type=Path,
                        help="black-box spool directories, one per peer")
    parser.add_argument("--victim", default=None,
                        help="focus the post-mortem (and --last window) on this peer")
    parser.add_argument("--last", type=float, default=None, metavar="N",
                        help="keep only the final N seconds before the victim's "
                             "(or swarm's) last recorded frame")
    parser.add_argument("--format", choices=("text", "json", "chrome"), default="text",
                        help="text post-mortem, merged-timeline JSON, or Chrome "
                             "trace-event JSON for Perfetto")
    parser.add_argument("--out", type=Path, default=None,
                        help="write the report here instead of stdout")
    args = parser.parse_args(argv)

    missing = [str(d) for d in args.spools if not Path(d).is_dir()]
    if missing:
        parser.error(f"not a spool directory: {', '.join(missing)}")
    spools = load_spools(args.spools)
    offsets = estimate_skew(spools)
    merged = merge_timeline(spools, offsets, last_s=args.last, victim=args.victim)

    if args.format == "chrome":
        report = json.dumps(render_spool_chrome_trace(merged))
    elif args.format == "json":
        victims = [args.victim] if args.victim else sorted(spools)
        report = json.dumps(
            {
                "peers": {
                    peer: {"stats": spool["stats"], "header": spool["header"],
                           "skew_s": offsets.get(peer, 0.0)}
                    for peer, spool in spools.items()
                },
                "postmortem": {
                    peer: reconstruct_final_round(spools[peer]["frames"])
                    for peer in victims if peer in spools
                },
                "timeline": merged,
            },
            default=str,
        )
    else:
        report = _text_report(spools, offsets, merged, args.victim)

    if args.out is not None:
        args.out.write_text(report + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
