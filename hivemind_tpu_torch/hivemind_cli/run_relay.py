"""Run the relay daemon and advertise it in the swarm's DHT (the port of
hivemind_tpu/hivemind_cli/run_relay.py): the relay operator's side of zero-config
auto-relay. The daemon is the port's ``native/hm_relayd.cpp``, built from source
by ``ops/_build_relayd.py``; discovery rides ``p2p/autorelay.py``.

    python -m hivemind_tpu_torch.hivemind_cli.run_relay \\
        --initial_peers /ip4/…/tcp/…/p2p/Qm… \\
        --relay_port 34000 --announce_host 203.0.113.7

NATed peers then find this relay through ``AutoRelay.create(p2p, dht)`` with no
relay configuration. The arguments are the JAX entry point's except ``--platform``,
which picks a JAX backend: the relay needs no card. It logs ``relay daemon up on
port <n> (identity <hex>, pid <pid>)`` once the daemon announced itself, and refuses to
advertise a daemon that announced no identity (no libcrypto: peers could not pin
it). The daemon's own diagnostics go to this process's stderr, and it dies with
this process. SIGINT stops both."""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional, Sequence

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

BANNER_TIMEOUT_S = 10.0


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Run and advertise a relay daemon")
    parser.add_argument("--initial_peers", nargs="*", default=[],
                        help="DHT bootstrap addrs (empty: starts a fresh swarm)")
    parser.add_argument("--relay_port", type=int, default=0, help="0 = ephemeral")
    parser.add_argument("--announce_host", default=None,
                        help="the relay endpoint advertised to the swarm (REQUIRED for real deployments; "
                             "defaults to loopback for local testing only)")
    parser.add_argument("--identity_path", default="relay.key", help="persistent relay Ed25519 identity file")
    parser.add_argument("--advertise_period", type=float, default=300.0,
                        help="re-advertise at this period (records expire at 2x)")
    args = parser.parse_args(argv)

    if args.announce_host is None:
        args.announce_host = "127.0.0.1"
        logger.warning("no --announce_host given: advertising LOOPBACK (127.0.0.1) — fine for local testing, "
                       "useless to any peer on another machine")

    from hivemind_tpu_torch.ops._build_relayd import SOURCE, build_relayd
    from hivemind_tpu_torch.p2p.native_transport import banner_port, die_with_parent, read_daemon_banner

    binary, error = build_relayd()
    if binary is None:
        raise RuntimeError(f"relay daemon unavailable ({SOURCE}): {error}")

    daemon = subprocess.Popen([str(binary), str(args.relay_port), args.identity_path],
                              stdout=subprocess.PIPE, preexec_fn=die_with_parent())
    dht = None
    try:
        # the daemon prints exactly two startup lines in one flush; anything else is an
        # error: a crypto-capable relay advertised without its identity would downgrade
        # every NATed peer to unpinned registration
        banner = read_daemon_banner(daemon, timeout=BANNER_TIMEOUT_S)
        if banner is None:
            returncode = daemon.poll()
            raise RuntimeError(f"the relay daemon did not announce its two startup lines within {BANNER_TIMEOUT_S:.0f} s"
                               + (f" (exit {returncode}; its stderr is above)" if returncode is not None else ""))
        first_line, identity_line = banner
        try:
            port = banner_port(first_line)
        except ValueError:
            raise RuntimeError(f"unexpected relay daemon output: {first_line!r}") from None
        if identity_line.startswith("relay identity "):
            pubkey_hex = identity_line.rsplit(" ", 1)[-1]
            logger.info(f"relay daemon up on port {port} (identity {pubkey_hex}, pid {daemon.pid})")
        elif identity_line == "relay encryption unavailable":
            pubkey_hex = ""
            logger.warning(f"relay daemon up on port {port} WITHOUT an identity (no libcrypto): peers cannot pin it "
                           f"and refuse encrypted-control registration")
        else:
            raise RuntimeError(f"unexpected relay daemon output: {identity_line!r}")

        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.p2p.autorelay import advertise_relay

        dht = DHT(initial_peers=args.initial_peers, start=True)
        for maddr in dht.get_visible_maddrs():
            logger.info(f"swarm members can bootstrap via: --initial_peers {maddr}")
        while True:
            if daemon.poll() is not None:
                raise RuntimeError(f"relay daemon exited with code {daemon.returncode}")
            stored = advertise_relay(dht, args.announce_host, port, pubkey_hex, ttl=args.advertise_period * 2)
            logger.info(f"advertised {args.announce_host}:{port} in the DHT (stored={stored}); "
                        f"next refresh in {args.advertise_period:.0f}s")
            time.sleep(args.advertise_period)
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        daemon.kill()
        daemon.wait()
        daemon.stdout.close()
        if dht is not None:
            dht.shutdown()


if __name__ == "__main__":
    main()
