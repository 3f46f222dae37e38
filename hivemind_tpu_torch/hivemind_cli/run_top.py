"""``hivemind-tpu-torch-top``: a live terminal dashboard over the swarm's telemetry
(the port of hivemind_tpu/hivemind_cli/run_top.py; it reads the snapshots either
package publishes). One screen, refreshed in place, answering the operator's
standing questions without Prometheus or Perfetto:

- **per-peer vitals** — epoch, samples/s (frame-to-frame delta), event-loop
  lag and stall count, tripped breakers, snapshot age (peers whose snapshot
  age exceeds 3x the publish interval are flagged ``STALE``);
- **straggler table** — per-peer straggler scores merged across every peer's
  round ledger: which partner was slowest, how often, and how many excess
  seconds it cost the swarm;
- **recent alerts** — watchdog stalls (with the blocking frame), recovery
  emergencies, slow spans, degraded rounds;
- **serving board** (``--serving``) — per-expert QPS (frame-to-frame
  request delta), p95 latency and sheds merged across every peer's serving
  section, per-peer saturation (queue depth, runtime utilization, decode
  session occupancy), degraded client-side scorecards, and the slowest-request
  exemplars with their queue/assembly/compute/serialize decomposition;
- **device board** (``--device``) — per-peer jit compiles (count,
  storms, compile-seconds), HBM residency (live/peak bytes, buffer count),
  host<->device transfer totals, and the comm/compute overlap efficiency from
  the step timeline, plus the swarm's hottest compile sites. Recompile storms
  and suspected HBM leaks surface as alerts.

Everything renders from the DHT-published snapshots (`--key` must match the
swarm's ``TelemetryPublisher`` key), so the dashboard is a pure *reader*: it
joins the DHT, polls, and draws — it cannot perturb the run it watches.

Run it::

    hivemind-tpu-torch-top --initial_peers /ip4/.../tcp/.../p2p/... --key myrun_telemetry

``--frames 1 --no-ansi`` renders one plain frame and exits (scripts, tests).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.monitor import DEFAULT_PUBLISH_INTERVAL, STALE_AFTER_FACTOR
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CLEAR = "\x1b[2J\x1b[H"
_BOLD, _RED, _YELLOW, _DIM, _RESET = "\x1b[1m", "\x1b[31m", "\x1b[33m", "\x1b[2m", "\x1b[0m"


def _metric_total(snapshot: Dict[str, Any], name: str, field: str = "count") -> Optional[float]:
    """Sum of one metric family's series in a peer snapshot (gauges/counters sum
    their values; histograms sum ``field`` — 'count' or 'sum')."""
    family = (snapshot.get("metrics") or {}).get(name)
    if not isinstance(family, dict):
        return None
    total = 0.0
    for value in (family.get("series") or {}).values():
        if isinstance(value, dict):
            total += float(value.get(field, 0.0))
        else:
            total += float(value)
    return total


def _loop_lag_ms(snapshot: Dict[str, Any]) -> Optional[float]:
    count = _metric_total(snapshot, "hivemind_event_loop_lag_seconds", "count")
    total = _metric_total(snapshot, "hivemind_event_loop_lag_seconds", "sum")
    if not count:
        return None
    return (total or 0.0) / count * 1e3


def render_frame(
    records: Dict[str, Dict[str, Any]],
    *,
    publish_interval: float = DEFAULT_PUBLISH_INTERVAL,
    prev_samples: Optional[Dict[str, Tuple[float, float]]] = None,
    now: Optional[float] = None,
    ansi: bool = True,
) -> Tuple[str, Dict[str, Tuple[float, float]]]:
    """One dashboard frame from the swarm's snapshots. Pure: no DHT, no IO.

    ``prev_samples`` maps peer -> (samples_gauge, frame_time) from the previous
    frame; returns the updated map so the caller can thread it through for the
    samples/s column. Plain text with ``ansi=False`` (tests, piping)."""
    now = now if now is not None else time.time()
    bold = _BOLD if ansi else ""
    red = _RED if ansi else ""
    yellow = _YELLOW if ansi else ""
    dim = _DIM if ansi else ""
    reset = _RESET if ansi else ""
    samples_state: Dict[str, Tuple[float, float]] = {}
    stale_after = STALE_AFTER_FACTOR * publish_interval

    lines: List[str] = []
    lines.append(
        f"{bold}hivemind-top{reset} — {len(records)} peer(s), "
        f"{time.strftime('%H:%M:%S', time.localtime(now))} "
        f"{dim}(snapshot age > {stale_after:.0f}s = STALE){reset}"
    )
    header = (
        f"{'peer':<18} {'age':>5} {'epoch':>6} {'smp/s':>8} {'lag ms':>7} "
        f"{'stalls':>6} {'brk':>4} {'rounds':>6}  flags"
    )
    lines.append(bold + header + reset)

    alerts: List[str] = []
    straggler_board: Dict[str, Dict[str, float]] = {}
    link_tiers: Dict[str, str] = {}  # victim -> last-reported wire tier

    def _render_peer(peer: str, snapshot: Dict[str, Any]) -> None:
        age = max(now - float(snapshot.get("time", now)), 0.0)
        epoch = _metric_total(snapshot, "hivemind_optim_local_epoch")
        samples = _metric_total(snapshot, "hivemind_optim_local_samples_accumulated")
        rate = None
        if samples is not None:
            samples_state[peer] = (samples, now)
            if prev_samples and peer in prev_samples:
                prev_value, prev_time = prev_samples[peer]
                if now > prev_time:
                    # accumulators reset each epoch: a negative delta is an
                    # epoch boundary, not negative throughput
                    rate = max(samples - prev_value, 0.0) / (now - prev_time)
        lag_ms = _loop_lag_ms(snapshot)
        watchdog = snapshot.get("watchdog") or {}
        stalls = int(watchdog.get("stalls", _metric_total(snapshot, "hivemind_event_loop_stalls_total") or 0))
        breakers = snapshot.get("breakers") or {}
        num_tripped = sum(int(b.get("num_tripped", 0)) for b in breakers.values() if isinstance(b, dict))
        ledger = snapshot.get("ledger") or {}
        rounds = len(ledger.get("records") or ())

        flags: List[str] = []
        if age > stale_after:
            flags.append(f"{red}STALE{reset}")
        if stalls:
            flags.append(f"{red}LOOP-STALLED{reset}")
        if num_tripped:
            flags.append(f"{yellow}BREAKERS{reset}")
        if snapshot.get("slow_spans"):
            flags.append(f"{yellow}SLOW-SPANS{reset}")
        if snapshot.get("truncated"):
            flags.append(f"{dim}truncated{reset}")

        lines.append(
            f"{peer[:18]:<18} {age:>4.0f}s "
            f"{(f'{epoch:.0f}' if epoch is not None else '-'):>6} "
            f"{(f'{rate:.1f}' if rate is not None else '-'):>8} "
            f"{(f'{lag_ms:.2f}' if lag_ms is not None else '-'):>7} "
            f"{stalls:>6} {num_tripped:>4} {rounds:>6}  {' '.join(flags)}"
        )

        for victim, score in (ledger.get("stragglers") or {}).items():
            board = straggler_board.setdefault(
                str(victim), {"rounds_slowest": 0, "excess_s": 0.0, "reporters": 0}
            )
            board["rounds_slowest"] += int(score.get("rounds_slowest", 0))
            board["excess_s"] = round(board["excess_s"] + float(score.get("excess_s", 0.0)), 3)
            board["reporters"] += 1

        # per-link negotiated wire tiers (records are oldest→newest: latest wins)
        # and demote/promote decisions from the adaptive codec policy
        for record in ledger.get("records") or ():
            codecs = record.get("link_codecs") if isinstance(record, dict) else None
            if isinstance(codecs, dict):
                for victim, tier in codecs.items():
                    link_tiers[str(victim)] = str(tier)
        for event in ledger.get("codec_events") or ():
            if isinstance(event, dict):
                alerts.append(
                    f"{yellow}codec{reset} {peer[:16]}: {event.get('action')} "
                    f"{str(event.get('peer'))[:16]} -> {event.get('tier') or 'default'}"
                )

        if stalls and watchdog.get("last_stall"):
            last = watchdog["last_stall"]
            alerts.append(
                f"{red}stall{reset} {peer[:16]}: loop blocked "
                f"{last.get('blocked_s_at_capture', '?')}s at {last.get('frame', '')}"
                if "frame" in last
                else f"{red}stall{reset} {peer[:16]}: {stalls} event-loop stall(s), "
                f"max lag {watchdog.get('max_lag_s', '?')}s"
            )
        for span in (snapshot.get("slow_spans") or ())[:2]:
            alerts.append(
                f"{yellow}slow{reset} {peer[:16]}: {span.get('name')} "
                f"{span.get('dur_ms')}ms {span.get('events', [])}"
            )
        for board_name, state in sorted(breakers.items()):
            if isinstance(state, dict) and state.get("num_tripped"):
                alerts.append(
                    f"{yellow}breaker{reset} {peer[:16]}: {board_name} open against {state.get('tripped')}"
                )
        for metric_name, what in (
            ("hivemind_optimizer_epoch_adopted_without_state_total", "epoch adopted WITHOUT state"),
            ("hivemind_state_sync_unverified_adoptions_total", "unverified state adoption"),
        ):
            value = _metric_total(snapshot, metric_name)
            if value:
                alerts.append(f"{red}recovery{reset} {peer[:16]}: {value:g} {what}")

    for peer, snapshot in sorted(records.items(), key=lambda kv: str(kv[0])):
        # snapshots are DHT-supplied: one malformed (buggy, version-skewed,
        # hostile) peer gets a flagged row, never a dead dashboard
        try:
            _render_peer(str(peer), snapshot if isinstance(snapshot, dict) else {})
        except Exception as e:
            logger.debug(f"malformed snapshot from {peer!r}: {e!r}")
            lines.append(f"{str(peer)[:18]:<18} {red}<malformed snapshot>{reset}")

    if straggler_board:
        lines.append("")
        lines.append(f"{bold}stragglers (merged from every peer's round ledger){reset}")
        ranked = sorted(
            straggler_board.items(),
            key=lambda kv: (-kv[1]["rounds_slowest"], -kv[1]["excess_s"]),
        )
        for victim, score in ranked[:8]:
            tier = link_tiers.get(victim)
            lines.append(
                f"  {victim[:18]:<18} slowest in {score['rounds_slowest']:>4} round(s), "
                f"+{score['excess_s']:.3f}s excess, reported by {score['reporters']} peer(s)"
                + (f", link @{tier}" if tier else "")
            )

    if alerts:
        lines.append("")
        lines.append(f"{bold}recent alerts{reset}")
        lines.extend(f"  {alert}" for alert in alerts[-12:])

    text = "\n".join(lines)
    if ansi:
        text = _CLEAR + text
    return text, samples_state


def render_serving_board(
    records: Dict[str, Dict[str, Any]],
    *,
    prev_requests: Optional[Dict[Tuple[str, str], Tuple[float, float]]] = None,
    now: Optional[float] = None,
    ansi: bool = True,
) -> Tuple[str, Dict[Tuple[str, str], Tuple[float, float]]]:
    """The ``--serving`` board. Pure: no DHT, no IO. Parsing lives
    in ``telemetry.serving.collect_swarm_serving`` (shared with
    ``SwarmMonitor.render_serving_board``); only the formatting is here.

    ``prev_requests`` maps (peer, expert) -> (request_count, frame_time) from
    the previous frame; returned updated so the caller can thread it through
    for the QPS column (same pattern as ``prev_samples`` in render_frame)."""
    from hivemind_tpu_torch.telemetry.serving import (
        collect_swarm_serving,
        format_saturation_parts,
        format_scorecard_line,
        format_slowest_line,
    )

    now = now if now is not None else time.time()
    bold = _BOLD if ansi else ""
    red = _RED if ansi else ""
    reset = _RESET if ansi else ""
    data = collect_swarm_serving(records)
    request_state: Dict[Tuple[str, str], Tuple[float, float]] = {}

    lines: List[str] = [f"{bold}serving board{reset} — per-expert requests / QPS / p95 / sheds"]
    header = f"{'expert':<24} {'peer':<14} {'req':>7} {'qps':>6} {'p95 ms':>8} {'shed':>5}"
    lines.append(bold + header + reset)
    rows: List[str] = []
    for peer, uid, stats in data["experts"]:
        requests = stats["requests"]
        request_state[(peer, uid)] = (requests, now)
        qps = None
        if prev_requests and (peer, uid) in prev_requests:
            prev_count, prev_time = prev_requests[(peer, uid)]
            if now > prev_time:
                qps = max(requests - prev_count, 0.0) / (now - prev_time)
        p95 = stats["p95_s"]
        sheds = stats["sheds"]
        # pad BEFORE colorizing: escape codes inside a width spec eat the
        # padding and misalign exactly the rows the operator cares about
        shed_field = f"{sheds:>5}"
        rows.append(
            f"{uid[:24]:<24} {peer[:14]:<14} {requests:>7.0f} "
            f"{(f'{qps:.1f}' if qps is not None else '-'):>6} "
            f"{(f'{p95 * 1e3:.1f}' if p95 is not None else '-'):>8} "
            + (f"{red}{shed_field}{reset}" if sheds else shed_field)
        )
    malformed_rows = [
        f"{peer[:24]:<24} {red}<malformed serving section>{reset}"
        for peer in data["malformed"]
    ]

    saturation_rows = [
        f"  {peer[:16]:<16} {', '.join(format_saturation_parts(entry, red=red, reset=reset))}"
        for peer, entry in data["saturation"]
    ]

    if not rows and not malformed_rows and not saturation_rows:
        lines.append("  (no serving traffic reported by any peer)")
    lines.extend(rows[:20])
    lines.extend(malformed_rows)  # never capped away: a broken peer must show
    if saturation_rows:
        lines.append(f"{bold}saturation{reset}")
        lines.extend(saturation_rows)
    if data["degraded_scorecards"]:
        lines.append(f"{bold}degraded scorecards (client view){reset}")
        lines.extend(
            "  " + format_scorecard_line(peer, uid, card)
            for peer, uid, card in data["degraded_scorecards"][:8]
        )
    if data["slowest"]:
        lines.append(f"{bold}slowest requests (queue/assembly/compute/serialize){reset}")
        lines.extend(
            "  " + format_slowest_line(total_s, peer, record)
            for total_s, peer, record in data["slowest"][:5]
        )
    return "\n".join(lines), request_state


def _mib(nbytes: Any) -> str:
    try:
        return f"{float(nbytes) / 2**20:.1f}"
    except (TypeError, ValueError):
        return "-"


def render_device_board(records: Dict[str, Dict[str, Any]], *, ansi: bool = True) -> str:
    """The ``--device`` board. Pure: no DHT, no IO. Renders each
    peer's ``device`` snapshot section — live DHT snapshots and ``--from-spool``
    replays emit the same shape, so dead peers render like live ones."""
    bold = _BOLD if ansi else ""
    red = _RED if ansi else ""
    reset = _RESET if ansi else ""

    lines: List[str] = [f"{bold}device board{reset} — jit compiles / HBM / transfers / overlap"]
    header = (
        f"{'peer':<18} {'compiles':>8} {'storms':>6} {'jit s':>7} {'HBM MiB':>8} "
        f"{'peak MiB':>9} {'bufs':>5} {'h2d MiB':>8} {'d2h MiB':>8} {'ovl %':>6}"
    )
    lines.append(bold + header + reset)
    rows: List[str] = []
    alerts: List[str] = []
    site_board: Dict[str, List[float]] = {}  # site -> [count, seconds]

    for peer, snapshot in sorted(records.items(), key=lambda kv: str(kv[0])):
        device = snapshot.get("device") if isinstance(snapshot, dict) else None
        if not isinstance(device, dict) or not device:
            continue
        # snapshots are DHT/spool-supplied: a malformed device section gets a
        # flagged row, never a dead board (same contract as render_frame)
        try:
            compiles = device.get("compiles") or {}
            total = int(compiles.get("total") or 0)
            storms = int(compiles.get("storms") or 0)
            seconds = float(compiles.get("seconds") or 0.0)
            memory = device.get("memory") or {}
            peak = max(
                (int(entry.get("peak_bytes") or 0) for entry in (memory.get("devices") or {}).values()),
                default=None,
            )
            transfers = device.get("transfer_bytes") or {}
            overlap = device.get("overlap") or {}
            mean_overlap = overlap.get("mean")

            storm_field = f"{storms:>6}"
            rows.append(
                f"{str(peer)[:18]:<18} {total:>8} "
                + (f"{red}{storm_field}{reset}" if storms else storm_field)
                + f" {seconds:>7.2f} {_mib(memory.get('total_bytes')):>8} "
                f"{(_mib(peak) if peak is not None else '-'):>9} "
                f"{(memory.get('buffers') if memory.get('buffers') is not None else '-'):>5} "
                f"{_mib(transfers.get('host_to_device')):>8} "
                f"{_mib(transfers.get('device_to_host')):>8} "
                f"{(f'{mean_overlap * 100:.1f}' if mean_overlap is not None else '-'):>6}"
            )
            for site, stats in (compiles.get("sites") or {}).items():
                entry = site_board.setdefault(str(site), [0, 0.0])
                entry[0] += int((stats or {}).get("count") or 0)
                entry[1] += float((stats or {}).get("seconds") or 0.0)
            if storms:
                last = compiles.get("last") or {}
                alerts.append(
                    f"{red}recompile-storm{reset} {str(peer)[:16]}: {storms} storm(s), "
                    f"last compile at {last.get('site', '?')}"
                )
            if device.get("leaks_suspected"):
                alerts.append(
                    f"{red}hbm-leak{reset} {str(peer)[:16]}: "
                    f"{device['leaks_suspected']} suspected leak episode(s)"
                )
        except Exception as e:
            logger.debug(f"malformed device section from {peer!r}: {e!r}")
            rows.append(f"{str(peer)[:18]:<18} {red}<malformed device section>{reset}")

    if not rows:
        lines.append("  (no device telemetry reported by any peer)")
    lines.extend(rows[:20])
    if site_board:
        ranked = sorted(site_board.items(), key=lambda kv: (-kv[1][0], kv[0]))
        lines.append(f"{bold}hot compile sites (merged across peers){reset}")
        lines.extend(
            f"  {site[:40]:<40} x{int(count):>4}  {seconds:>7.2f}s"
            for site, (count, seconds) in ranked[:6]
        )
    if alerts:
        lines.append(f"{bold}device alerts{reset}")
        lines.extend(f"  {alert}" for alert in alerts[-8:])
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--initial_peers", nargs="*", default=[],
                        help="multiaddrs of swarm members to read telemetry from")
    parser.add_argument("--key", default=None,
                        help="the swarm's telemetry DHT key (default: hivemind_telemetry)")
    parser.add_argument("--interval", type=float, default=5.0, help="refresh period, seconds")
    parser.add_argument("--publish_interval", type=float, default=DEFAULT_PUBLISH_INTERVAL,
                        help="the swarm's TelemetryPublisher cadence; snapshots older "
                             f"than {STALE_AFTER_FACTOR:g}x this are flagged STALE")
    parser.add_argument("--frames", type=int, default=0,
                        help="render this many frames then exit (0 = run until ^C)")
    parser.add_argument("--no-ansi", action="store_true", dest="no_ansi",
                        help="plain text frames, no screen clearing (piping / CI)")
    parser.add_argument("--serving", action="store_true",
                        help="append the serving board: per-expert QPS/p95/sheds, "
                             "saturation, scorecards, slowest-request exemplars")
    parser.add_argument("--device", action="store_true",
                        help="append the device board: jit compiles/storms, HBM "
                             "live/peak bytes, host<->device transfer totals, "
                             "comm/compute overlap efficiency")
    parser.add_argument("--from-spool", nargs="+", default=None, dest="from_spool",
                        metavar="DIR",
                        help="replay mode for dead swarms: render one frame from "
                             "black-box spool directories (no DHT) and exit")
    args = parser.parse_args(argv)

    if args.from_spool:
        # post-mortem replay: the dashboard over spools a dead
        # swarm left behind — a pure reader of the on-disk frames
        from pathlib import Path

        from hivemind_tpu_torch.hivemind_cli.run_blackbox import load_spools, spool_snapshot

        spools = load_spools([Path(d) for d in args.from_spool])
        records = {peer: spool_snapshot(spool) for peer, spool in spools.items()}
        newest = max(
            (snapshot.get("time", 0.0) for snapshot in records.values()), default=0.0
        )
        frame, _ = render_frame(
            records,
            publish_interval=args.publish_interval,
            now=newest or None,
            ansi=not args.no_ansi,
        )
        # post-mortems are one frame with no space pressure: always show the
        # victim's device state (last compiles / HBM at death) when spooled
        if args.device or any(
            isinstance(s, dict) and s.get("device") for s in records.values()
        ):
            frame = f"{frame}\n\n{render_device_board(records, ansi=not args.no_ansi)}"
        print(frame, flush=True)
        return

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.telemetry.monitor import DEFAULT_TELEMETRY_KEY, fetch_swarm_telemetry

    key = args.key or DEFAULT_TELEMETRY_KEY
    dht = DHT(initial_peers=args.initial_peers, start=True)
    prev_samples: Dict[str, Tuple[float, float]] = {}
    prev_requests: Dict[Tuple[str, str], Tuple[float, float]] = {}
    rendered = 0
    try:
        while True:
            try:
                records = fetch_swarm_telemetry(dht, key)
            except Exception as e:
                logger.warning(f"telemetry fetch failed: {e!r}")
                records = {}
            frame, prev_samples = render_frame(
                records,
                publish_interval=args.publish_interval,
                prev_samples=prev_samples,
                ansi=not args.no_ansi,
            )
            if args.serving:
                board, prev_requests = render_serving_board(
                    records, prev_requests=prev_requests, ansi=not args.no_ansi
                )
                frame = f"{frame}\n\n{board}"
            if args.device:
                frame = f"{frame}\n\n{render_device_board(records, ansi=not args.no_ansi)}"
            print(frame, flush=True)
            rendered += 1
            if args.frames and rendered >= args.frames:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        dht.shutdown()


if __name__ == "__main__":
    main()
