"""Run a standalone DHT node (the port of hivemind_tpu/hivemind_cli/run_dht.py; the
reference's hivemind/hivemind_cli/run_dht.py): the bootstrap and health-monitor
entry point that servers and clients join with ``--initial_peers``. The node
holds no tensor and needs no card.

    python -m hivemind_tpu_torch.hivemind_cli.run_dht --listen_host 127.0.0.1

It logs ``to join this swarm: --initial_peers <multiaddr>`` and runs until
interrupted (SIGINT)."""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Run a hivemind_tpu_torch DHT bootstrap node")
    parser.add_argument("--initial_peers", nargs="*", default=[], help="multiaddrs of existing peers")
    parser.add_argument("--listen_host", default="0.0.0.0")
    parser.add_argument("--listen_port", type=int, default=0)
    parser.add_argument("--announce_host", default=None, help="externally visible host")
    parser.add_argument("--identity_path", default=None, help="persistent identity file")
    parser.add_argument("--refresh_period", type=float, default=30.0, help="health report interval")
    parser.add_argument("--max_connections", type=int, default=0,
                        help="connection-manager high water (0 = unlimited): idle "
                             "LRU connections close past it, bounding fds at scale")
    parser.add_argument("--metrics-port", "--metrics_port", type=int, default=None, dest="metrics_port",
                        help="serve Prometheus text exposition at http://<metrics_host>:PORT/metrics (0 = auto-pick)")
    parser.add_argument("--metrics_host", default="127.0.0.1",
                        help="bind host of the metrics endpoint (0.0.0.0 for remote scrapers)")
    parser.add_argument("--telemetry_key", default=None,
                        help="publish this peer's telemetry snapshot to the DHT under this key "
                             "every --refresh_period seconds")
    parser.add_argument("--blackbox_dir", default=None,
                        help="crash-durable flight-recorder spool directory: finished spans, ledger "
                             "records and metric snapshots are appended as msgpack frames")
    parser.add_argument("--no_device_telemetry", action="store_false", dest="device_telemetry",
                        help="disable device-side observability (compile tracking, memory sampling "
                             "on the watchdog tick, transfer counters); on by default, and a no-op "
                             "on a host without a card")
    args = parser.parse_args(argv)

    dht = DHT(
        initial_peers=args.initial_peers,
        start=True,
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        announce_host=args.announce_host,
        identity_path=args.identity_path,
        max_connections=args.max_connections,
    )
    for maddr in dht.get_visible_maddrs():
        logger.info(f"listening: {maddr}")
    logger.info(f"to join this swarm: --initial_peers {dht.get_visible_maddrs()[0]}")

    blackbox = None
    if args.blackbox_dir:
        from hivemind_tpu_torch.telemetry.blackbox import arm_blackbox

        blackbox = arm_blackbox(args.blackbox_dir, peer=str(dht.peer_id))
        logger.info(f"black-box recorder armed: spooling to {args.blackbox_dir}")

    if args.device_telemetry:
        from hivemind_tpu_torch.telemetry.device import arm_device_telemetry

        arm_device_telemetry()

    # the DHT armed the event-loop watchdog on its loop; stay loud if the kill
    # switch (HIVEMIND_WATCHDOG=0) disabled it
    from hivemind_tpu_torch.telemetry import ensure_watchdog
    from hivemind_tpu_torch.utils.loop import get_loop_runner

    if ensure_watchdog(get_loop_runner().loop) is None:
        logger.warning("event-loop watchdog disabled (HIVEMIND_WATCHDOG=0): stalls will be silent")

    exporter = publisher = None
    if args.metrics_port is not None:
        from hivemind_tpu_torch.telemetry import MetricsExporter

        exporter = MetricsExporter(port=args.metrics_port, host=args.metrics_host)
    if args.telemetry_key:
        from hivemind_tpu_torch.telemetry import TelemetryPublisher

        publisher = TelemetryPublisher(dht, args.telemetry_key, interval=args.refresh_period)

    try:
        while True:
            time.sleep(args.refresh_period)
            # health heartbeat (reference run_dht.py:14-24): table and storage sizes, a live get
            protocol = dht.node.protocol
            started = time.perf_counter()
            dht.get(f"heartbeat_{dht.peer_id}")
            logger.info(f"health: {len(protocol.routing_table)} peers in routing table, "
                        f"{len(protocol.storage)} keys stored, get latency "
                        f"{(time.perf_counter() - started) * 1000:.1f}ms")
    except KeyboardInterrupt:
        logger.info("shutting down")
        if publisher is not None:
            publisher.shutdown()
        if exporter is not None:
            exporter.shutdown()
        if blackbox is not None:
            from hivemind_tpu_torch.telemetry.blackbox import disarm_blackbox

            disarm_blackbox()
        if args.device_telemetry:
            from hivemind_tpu_torch.telemetry.device import disarm_device_telemetry

            disarm_device_telemetry()
        dht.shutdown()


if __name__ == "__main__":
    main()
