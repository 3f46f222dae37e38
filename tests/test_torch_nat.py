"""The port's NAT traversal (``hivemind_tpu_torch/p2p/nat.py``, ``RelayClient.whoami``)
against the JAX package's: each case of ``tests/test_nat.py`` on the port's daemon
and peers (the relay's observed endpoint, the AutoNAT-style dial-back with its probe
cap, the DCUtR-style hole punch that upgrades a relayed connection), and a JAX peer
probing its reachability through a port peer's ``nat.check``. Every scenario has its
own time bound; every daemon is reaped before its test ends."""

from __future__ import annotations

import asyncio

from torch_relay_support import add_echo, bounded, call_echo, no_daemon_left, relay_daemon  # noqa: F401 (fixtures)

from hivemind_tpu.p2p import NATTraversal as JaxNATTraversal
from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu_torch.p2p import NATTraversal, P2P
from hivemind_tpu_torch.p2p.nat import MAX_PROBE_ADDRS
from hivemind_tpu_torch.p2p.relay import RelayClient


@bounded(20)
async def test_relay_whoami(relay_daemon):
    p2p = await P2P.create()
    try:
        host, port = await RelayClient(p2p, "127.0.0.1", relay_daemon.port).whoami()
        assert host == "127.0.0.1" and 0 < port < 65536
    finally:
        await p2p.shutdown()


@bounded(40)
async def test_reachability_probe():
    alice, bob = await P2P.create(), await P2P.create()
    try:
        await NATTraversal(bob).register_handlers()
        await alice.connect(bob.get_visible_maddrs()[0])
        nat_alice = NATTraversal(alice)
        # our real listener is reachable from bob
        assert await nat_alice.check_reachability(bob.peer_id) == [str(m) for m in alice.get_visible_maddrs()]
        # a dead port is reported unreachable
        dead = f"/ip4/127.0.0.1/tcp/1/p2p/{alice.peer_id.to_base58()}"
        reachable = await nat_alice.check_reachability(bob.peer_id, maddrs=[alice.get_visible_maddrs()[0], dead])
        assert dead not in reachable and len(reachable) == 1
        # the prober dials at most MAX_PROBE_ADDRS addresses, and skips what TCP cannot reach
        live = str(alice.get_visible_maddrs()[0])
        unix = f"/unix/tmp/nat.sock/p2p/{alice.peer_id.to_base58()}"
        assert await nat_alice.check_reachability(bob.peer_id, maddrs=[unix] + [live] * (MAX_PROBE_ADDRS + 2)) == (
            [live] * (MAX_PROBE_ADDRS - 1))
    finally:
        await alice.shutdown()
        await bob.shutdown()


@bounded(40)
async def test_hole_punch_upgrades_relayed_connection(relay_daemon):
    """Two peers talk only through the relay; hole punching swaps in a direct
    connection that keeps serving RPCs, and the superseded circuit closes after its grace."""
    server, client = await P2P.create(), await P2P.create()
    try:
        await add_echo(server, "double", lambda n: n * 2)
        server_nat, client_nat = NATTraversal(server), NATTraversal(client)
        await server_nat.register_handlers()
        await client_nat.register_handlers()
        server_relay = await RelayClient.create(server, "127.0.0.1", relay_daemon.port)
        await RelayClient(client, "127.0.0.1", relay_daemon.port).dial(server.peer_id)
        relayed_conn = client._connections[server.peer_id]
        assert relayed_conn.is_relayed
        assert await call_echo(client, server.peer_id, "double", 5) == 10

        # punch: both sides dial direct; the map entry must change connections
        assert await client_nat.hole_punch(server.peer_id)
        await asyncio.sleep(0.2)
        direct_conn = client._connections[server.peer_id]
        assert direct_conn is not relayed_conn and not direct_conn.is_closed
        assert not getattr(direct_conn, "is_relayed", False)
        assert await call_echo(client, server.peer_id, "double", 8) == 16
        assert any(task.get_name() == "p2p.close_after_grace" for task in client._bg_tasks)
        await server_relay.close()
        for nat in (server_nat, client_nat):
            await nat.close()
        assert "nat.check" not in server._handlers and not server_nat._punches
    finally:
        await client.shutdown()
        await server.shutdown()


@bounded(40)
async def test_a_jax_peer_probes_its_reachability_through_a_port_peer():
    """``nat.check`` speaks the JAX package's messages: a JAX peer's dial-back probe
    through a port peer reports its live listener and not a dead port."""
    ours, theirs = await P2P.create(), await JaxP2P.create()
    nat = NATTraversal(ours)
    try:
        await nat.register_handlers()
        our_id = JaxPeerID(ours.peer_id.to_bytes())
        assert await theirs.connect(str(ours.get_visible_maddrs()[0])) == our_id
        live = str(theirs.get_visible_maddrs()[0])
        dead = f"/ip4/127.0.0.1/tcp/1/p2p/{theirs.peer_id.to_base58()}"
        assert await JaxNATTraversal(theirs).check_reachability(our_id, maddrs=[live, dead]) == [live]
    finally:
        await nat.close()
        await theirs.shutdown()
        await ours.shutdown()
