"""The port's auto-relay (``hivemind_tpu_torch/p2p/autorelay.py``) against the JAX
package's: each case of ``tests/test_autorelay.py`` on the port's daemon, DHT and
peers (relay records, a NATed peer with no relay configuration made dialable by id,
a dead relay replaced by maintenance); the records' bytes equal in both packages; a
JAX client resolving a NATed port peer by id through the circuits the port
published; and the hygiene of ``AutoRelay.close()``: no task it spawned stays on the
loop, and nothing of it draws from the process-global ``random`` stream after it
(a task that did would move other tests' seeded simulations). Every scenario has its
own time bound; every daemon is reaped before its test ends."""

from __future__ import annotations

import asyncio
import concurrent.futures
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

from torch_relay_support import (  # noqa: F401 (fixtures)
    add_echo,
    bounded,
    call_echo,
    no_daemon_left,
    relay_daemon,
    running_daemon,
)

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.dht.routing import DHTID as JaxDHTID
from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import AutoRelay as JaxAutoRelay
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.p2p import autorelay as jax_autorelay
from hivemind_tpu.proto import test_pb2 as jax_test_pb2
from hivemind_tpu.utils.serializer import MSGPackSerializer as JaxMSGPackSerializer
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.dht.routing import DHTID
from hivemind_tpu_torch.p2p import P2P, AutoRelay, advertise_relay
from hivemind_tpu_torch.p2p import autorelay
from hivemind_tpu_torch.p2p.autorelay import RELAY_DHT_KEY, RELAYED_PEER_PREFIX, _parse_relay_records
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

REPO = Path(__file__).resolve().parent.parent


def dead_port() -> int:
    """A port nothing listens on: a NATed peer's unforwarded mapping."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@bounded(40)
async def test_advertise_and_parse_relay_records(relay_daemon):
    dht = DHT(start=True)
    try:
        assert advertise_relay(dht, "127.0.0.1", relay_daemon.port, relay_daemon.pubkey_hex)
        record = dht.get(RELAY_DHT_KEY, latest=True)
        assert ("127.0.0.1", relay_daemon.port, relay_daemon.pubkey_hex) in _parse_relay_records(record)
        assert _parse_relay_records(None) == []
    finally:
        dht.shutdown()


class RecordingDHT:
    """Takes ``store`` calls and answers them at once, so both packages' records can be
    compared field by field."""

    def __init__(self):
        self.stored = []

    def store(self, key, value, expiration_time, subkey=None, return_future=False):
        self.stored.append(dict(key=key, subkey=subkey, value=value, expiration_time=expiration_time))
        if return_future:
            future = concurrent.futures.Future()
            future.set_result(True)
            return future
        return True


def test_relay_and_circuit_records_are_the_jax_packages_bytes():
    """``advertise_relay`` and the published circuits store the same key, subkey and
    value in both packages, and the same msgpack bytes: a JAX peer and a port peer
    read each other's relays and circuits."""
    records = {}
    for name, module, serializer, dhtid in (("port", autorelay, MSGPackSerializer, DHTID),
                                            ("jax", jax_autorelay, JaxMSGPackSerializer, JaxDHTID)):
        dht = RecordingDHT()
        assert module.advertise_relay(dht, "203.0.113.7", 34000, "ab" * 32, ttl=60.0)
        stored = dht.stored[0]
        records[name] = (stored["key"], serializer.dumps(stored["subkey"]), serializer.dumps(stored["value"]),
                         dhtid.generate(source=stored["key"]).to_bytes())
        circuits = [{"endpoint": "203.0.113.7:34000", "pubkey": "ab" * 32}, {"endpoint": "198.51.100.2:1", "pubkey": ""}]
        records[name] += (serializer.dumps(circuits), module.RELAYED_PEER_PREFIX, module.RELAY_DHT_KEY)
    assert records["port"] == records["jax"]
    assert records["port"][:3] == (RELAY_DHT_KEY, MSGPackSerializer.dumps("203.0.113.7:34000"),
                                   MSGPackSerializer.dumps("ab" * 32))


@bounded(55)
async def test_natted_peer_zero_config_becomes_dialable(relay_daemon):
    """A NATed peer with no relay configuration diagnoses itself through the AutoNAT
    dial-back, finds the relay advertised in the DHT, registers and publishes its
    circuits; a fresh client that knows only its peer id reaches it through the relay."""
    boot = DHT(start=True)
    maddrs = [str(m) for m in boot.get_visible_maddrs()]
    public_dht = DHT(initial_peers=maddrs, start=True)
    natted_dht = DHT(initial_peers=maddrs, start=True)
    nodes, autos = [], []
    try:
        # the relay operator advertises the daemon: the only place its coordinates exist here
        assert advertise_relay(boot, "127.0.0.1", relay_daemon.port, relay_daemon.pubkey_hex)
        public = await P2P.create()
        nodes.append(public)
        autos.append(await AutoRelay.create(public, public_dht))
        assert not autos[-1].natted and not autos[-1].relay_clients  # nobody to probe through: reachable

        natted = await P2P.create(announce_port=dead_port(), dial_timeout=1.0)
        nodes.append(natted)
        await add_echo(natted, "echo", lambda n: n + 1)
        await natted.connect(public.get_visible_maddrs()[0])  # outbound works behind NAT
        natted_auto = await AutoRelay.create(natted, natted_dht, probe_via=public.peer_id)
        autos.append(natted_auto)
        assert natted_auto.natted and natted_auto.relay_clients, "the NATed peer did not register at any relay"
        assert set(natted_auto.relay_clients) == {("127.0.0.1", relay_daemon.port)}
        published = natted_dht.get(RELAYED_PEER_PREFIX + natted.peer_id.to_base58(), latest=True)
        assert published is not None and published.value == [
            {"endpoint": f"127.0.0.1:{relay_daemon.port}", "pubkey": relay_daemon.pubkey_hex}]

        client = await P2P.create(dial_timeout=1.0)
        nodes.append(client)
        autos.append(await AutoRelay.create(client, public_dht))
        assert await call_echo(client, natted.peer_id, "echo", 41) == 42
        assert client._connections[natted.peer_id].is_relayed  # the resolver's circuit
        assert await call_echo(client, natted.peer_id, "echo", 99) == 100  # the same relayed connection
    finally:
        for auto in reversed(autos):
            await auto.close()
        for node in reversed(nodes):
            await node.shutdown()
        for dht in (public_dht, natted_dht, boot):
            dht.shutdown()


@bounded(55)
async def test_maintenance_replaces_dead_relay(relay_daemon):
    """The relay a NATed peer registered at dies: a maintenance pass finds the dropped
    control line and re-registers at another advertised relay, republishing circuits."""
    with running_daemon() as victim:
        dht = DHT(start=True)
        natted = auto = None
        try:
            assert advertise_relay(dht, "127.0.0.1", victim.port, victim.pubkey_hex)
            natted = await P2P.create(dial_timeout=1.0)
            auto = await AutoRelay.create(natted, dht, max_relays=1, force_relay=True)
            assert set(auto.relay_clients) == {("127.0.0.1", victim.port)}

            # the registered relay dies; the survivor is advertised in its place
            victim.process.kill()
            victim.process.wait()
            assert advertise_relay(dht, "127.0.0.1", relay_daemon.port, relay_daemon.pubkey_hex)
            deadline = asyncio.get_running_loop().time() + 30
            while asyncio.get_running_loop().time() < deadline:
                await auto._maintenance_once()
                if ("127.0.0.1", relay_daemon.port) in auto.relay_clients:
                    break
                await asyncio.sleep(0.2)
            assert set(auto.relay_clients) == {("127.0.0.1", relay_daemon.port)}, auto.relay_clients
            published = dht.get(RELAYED_PEER_PREFIX + natted.peer_id.to_base58(), latest=True)
            assert f"127.0.0.1:{relay_daemon.port}" in {circuit["endpoint"] for circuit in published.value}
        finally:
            if auto is not None:
                await auto.close()
            if natted is not None:
                await natted.shutdown()
            dht.shutdown()


@bounded(55)
async def test_a_jax_client_resolves_a_natted_port_peer_by_id(relay_daemon):
    """One swarm of port and JAX DHT peers: a NATed port peer registers at the port's
    relay through its AutoRelay and publishes its circuits; a JAX client that knows
    only its peer id finds the ``hivemind:relayed:`` record the port stored, dials
    through the relay with its own RelayClient and calls the port peer."""
    boot = DHT(start=True)
    maddrs = [str(m) for m in boot.get_visible_maddrs()]
    natted_dht = DHT(initial_peers=maddrs, start=True)
    jax_dht = JaxDHT(initial_peers=maddrs, start=True)
    natted = jax_client = natted_auto = jax_auto = None
    try:
        assert advertise_relay(boot, "127.0.0.1", relay_daemon.port, relay_daemon.pubkey_hex)
        natted = await P2P.create(announce_port=dead_port(), dial_timeout=1.0)
        await add_echo(natted, "echo", lambda n: n * 7)
        natted_auto = await AutoRelay.create(natted, natted_dht, force_relay=True)
        assert natted_auto.relay_clients

        jax_client = await JaxP2P.create(dial_timeout=1.0)
        jax_auto = await JaxAutoRelay.create(jax_client, jax_dht)
        target = JaxPeerID(natted.peer_id.to_bytes())
        response = await jax_client.call_protobuf_handler(target, "echo", jax_test_pb2.TestRequest(number=6),
                                                          jax_test_pb2.TestResponse)
        assert response.number == 42
        assert jax_client._connections[target].is_relayed
    finally:
        for auto in (jax_auto, natted_auto):
            if auto is not None:
                await auto.close()
        for node in (jax_client, natted):
            if node is not None:
                await node.shutdown()
        jax_dht.shutdown()
        natted_dht.shutdown()
        boot.shutdown()


# the hygiene scenario, in a process of its own: nothing else there draws from the global
# random stream, so a draw after close() can only be the AutoRelay's
_CLOSE_HYGIENE = textwrap.dedent("""
    import asyncio, concurrent.futures, random, subprocess, sys
    from hivemind_tpu_torch.ops._build_relayd import build_relayd
    from hivemind_tpu_torch.p2p import P2P, AutoRelay
    from hivemind_tpu_torch.p2p.autorelay import RELAY_DHT_KEY
    from hivemind_tpu_torch.p2p.native_transport import banner_port, read_daemon_banner
    from hivemind_tpu_torch.proto import test_pb2
    from hivemind_tpu_torch.utils.timed_storage import ValueWithExpiration, get_dht_time

    class MemoryDHT:
        # the DHT calls AutoRelay makes, answered from a dict: no routing refresh draws here
        def __init__(self):
            self.records = {}

        def _done(self, value):
            future = concurrent.futures.Future()
            future.set_result(value)
            return future

        def store(self, key, value, expiration_time, subkey=None, return_future=False):
            if subkey is None:
                self.records[key] = ValueWithExpiration(value, expiration_time)
            else:
                entry = self.records.setdefault(key, ValueWithExpiration({}, expiration_time))
                entry.value[subkey] = ValueWithExpiration(value, expiration_time)
            return self._done(True) if return_future else True

        def get(self, key, latest=False, return_future=False):
            return self._done(self.records.get(key)) if return_future else self.records.get(key)

    OURS = ("autorelay.", "relay.", "nat.")

    async def main():
        binary, error = build_relayd()
        assert binary is not None, error
        daemon = subprocess.Popen([str(binary), "0"], stdout=subprocess.PIPE)
        try:
            first, identity = read_daemon_banner(daemon, 10.0)
            dht = MemoryDHT()
            dht.store(RELAY_DHT_KEY, identity.rsplit(" ", 1)[-1], get_dht_time() + 600, subkey=f"127.0.0.1:{banner_port(first)}")
            server, client = await P2P.create(), await P2P.create(dial_timeout=1.0)

            async def echo(request, context):
                return test_pb2.TestResponse(number=request.number + 1)

            await server.add_protobuf_handler("echo", echo, test_pb2.TestRequest)
            server_auto = await AutoRelay.create(server, dht, force_relay=True)
            client_auto = await AutoRelay.create(client, dht)
            # a call by id: the client's resolver dials through the relay and starts a hole
            # punch, whose request starts a punch dial on the server
            response = await client.call_protobuf_handler(server.peer_id, "echo", test_pb2.TestRequest(number=1),
                                                          test_pb2.TestResponse)
            assert response.number == 2
            spawned = [t for t in asyncio.all_tasks() if t.get_name().startswith(OURS) and not t.done()]
            assert any(t.get_name() == "autorelay.maintenance_loop" for t in spawned), spawned
            state = random.getstate()
            await client_auto.close()
            await server_auto.close()
            left = [t.get_name() for t in asyncio.all_tasks() if t.get_name().startswith(OURS) and not t.done()]
            assert not left, left
            assert all(t.done() for t in spawned), [t.get_name() for t in spawned if not t.done()]
            await asyncio.sleep(0.5)
            assert random.getstate() == state, "the global random stream moved after close()"
            assert client._peer_resolver is None and "nat.check" not in server._handlers
            await client.shutdown()
            await server.shutdown()
        finally:
            daemon.kill()
            daemon.wait()
        print("closed clean")

    asyncio.run(asyncio.wait_for(main(), 40))
""")


def test_close_leaves_no_task_and_no_random_draw():
    """After ``AutoRelay.close()`` no task that it spawned (the maintenance loop, the
    hole-punch upgrade, its relay clients' control lines, the NAT handlers' punch dials)
    remains on the loop, and ``random.getstate()`` is unchanged across the close and a
    further 0.5 s."""
    result = subprocess.run([sys.executable, "-c", _CLOSE_HYGIENE], cwd=REPO, capture_output=True, text=True,
                            timeout=50)
    assert result.returncode == 0 and "closed clean" in result.stdout, result.stderr[-3000:]


def test_run_relay_builds_runs_and_advertises_the_daemon(tmp_path):
    """The operator's entry point: ``python -m hivemind_tpu_torch.hivemind_cli.run_relay``
    builds and starts the port's daemon, logs its identity, advertises it in the DHT
    (a JAX peer of the same swarm reads the record), and stops it on SIGINT."""
    boot = DHT(start=True)
    log_path = tmp_path / "run_relay.log"
    process = None
    try:
        with open(log_path, "w") as out:
            process = subprocess.Popen(
                [sys.executable, "-m", "hivemind_tpu_torch.hivemind_cli.run_relay", "--initial_peers",
                 *[str(m) for m in boot.get_visible_maddrs()], "--identity_path", str(tmp_path / "relay.key")],
                cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        deadline, found = time.monotonic() + 50, None
        while time.monotonic() < deadline and found is None and process.poll() is None:
            time.sleep(0.1)
            found = re.search(r"relay daemon up on port (\d+) \(identity ([0-9a-f]{64}), pid (\d+)\)"
                              r"(?s:.*)stored=True", log_path.read_text())
        assert found, log_path.read_text()[-2000:]
        port, identity, pid = int(found.group(1)), found.group(2), int(found.group(3))
        assert (tmp_path / "relay.key").stat().st_mode & 0o777 == 0o600
        jax_dht = JaxDHT(initial_peers=[str(m) for m in boot.get_visible_maddrs()], start=True)
        try:
            assert ("127.0.0.1", port, identity) in jax_autorelay._parse_relay_records(
                jax_dht.get(jax_autorelay.RELAY_DHT_KEY, latest=True))
        finally:
            jax_dht.shutdown()
        process.send_signal(signal.SIGINT)
        assert process.wait(30) == 0
        assert not Path(f"/proc/{pid}").exists(), "run_relay's daemon outlived it"
        assert "Traceback" not in log_path.read_text()
    finally:
        if process is not None and process.poll() is None:
            process.kill()
            process.wait()
        boot.shutdown()
