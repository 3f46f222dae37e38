"""The port's relay (``hivemind_tpu_torch/p2p/relay.py`` and its daemon
``native/hm_relayd.cpp``) against the JAX package's: each case of
``tests/test_relay.py``'s relay half, on the port's daemon and client, and a JAX P2P
and a port P2P calling each other through the port's daemon. Every daemon is this
test's own and is reaped before it ends; every scenario has its own time bound."""

from __future__ import annotations

import asyncio
import base64
import os

import pytest
from torch_relay_support import (  # noqa: F401 (fixtures)
    add_echo,
    bounded,
    call_echo,
    no_daemon_left,
    relay_daemon,
    running_daemon,
)

from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.p2p.relay import RelayClient as JaxRelayClient
from hivemind_tpu.proto import test_pb2 as jax_test_pb2
from hivemind_tpu_torch.p2p import P2P, PeerID
from hivemind_tpu_torch.p2p.relay import (
    RelayChannel,
    RelayClient,
    _recv_frame,
    _send_frame,
    open_relay_channel,
    register_control,
)
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey


async def _raw_conn(port):
    return await asyncio.open_connection("127.0.0.1", port)


@bounded(30)
async def test_relayed_rpc_end_to_end(relay_daemon):
    # a "firewalled" peer: registers at the relay, never shares its direct address
    server, client = await P2P.create(), await P2P.create()
    try:
        await add_echo(server, "triple", lambda n: n * 3)
        server_relay = await RelayClient.create(server, "127.0.0.1", relay_daemon.port)
        assert await RelayClient(client, "127.0.0.1", relay_daemon.port).dial(server.peer_id) == server.peer_id
        assert client._connections[server.peer_id].is_relayed
        assert await call_echo(client, server.peer_id, "triple", 14) == 42
        # a second call reuses the spliced connection
        assert await call_echo(client, server.peer_id, "triple", 100) == 300
        await server_relay.close()
    finally:
        await client.shutdown()
        await server.shutdown()


@bounded(20)
async def test_relay_dial_unknown_peer(relay_daemon):
    client = await P2P.create()
    try:
        ghost = PeerID.from_private_key(Ed25519PrivateKey())
        with pytest.raises(ConnectionError):
            await RelayClient(client, "127.0.0.1", relay_daemon.port).dial(ghost)
    finally:
        await client.shutdown()


@bounded(20)
async def test_relay_register_requires_key_proof(relay_daemon):
    """Registration is authenticated: the daemon challenges every REGISTER and only an
    Ed25519 signature from the key the peer_id hashes is accepted. An attacker without
    the key cannot register the victim's id; the owner can re-register and evicts its
    own stale control line."""
    port = relay_daemon.port
    victim = Ed25519PrivateKey()
    victim_id = PeerID.from_private_key(victim).to_bytes()

    r1, w1 = await _raw_conn(port)
    assert await register_control(RelayChannel(r1, w1), victim_id, victim) == b"O"

    # the attacker presents the victim's (public) key, whose hash matches, but signs with its own
    attacker = Ed25519PrivateKey()
    r2, w2 = await _raw_conn(port)
    await _send_frame(w2, b"R" + victim_id)
    challenge_frame = await _recv_frame(r2)
    assert challenge_frame[:1] == b"C" and len(challenge_frame) == 33  # libcrypto is here: authenticated
    message = b"hivemind-relay-register:" + challenge_frame[1:] + victim_id
    await _send_frame(w2, b"P" + victim.get_public_key().to_bytes() + base64.b64decode(attacker.sign(message)))
    assert await _recv_frame(r2) == b"E"
    w2.close()

    # a key whose hash does not match the claimed peer_id is refused, even with a valid signature
    r3, w3 = await _raw_conn(port)
    await _send_frame(w3, b"R" + victim_id)
    challenge_frame = await _recv_frame(r3)
    message = b"hivemind-relay-register:" + challenge_frame[1:] + victim_id
    await _send_frame(w3, b"P" + attacker.get_public_key().to_bytes() + base64.b64decode(attacker.sign(message)))
    assert await _recv_frame(r3) == b"E"
    w3.close()

    # the owner reclaims: a second registration with a valid proof evicts line 1
    r4, w4 = await _raw_conn(port)
    assert await register_control(RelayChannel(r4, w4), victim_id, victim) == b"O"
    assert await r1.read(100) == b""  # the daemon closed the old control line
    w4.close()
    w1.close()


@bounded(30)
async def test_relay_encrypted_control_channel(relay_daemon):
    """The 'H' handshake gives an AEAD control channel bound to the relay's Ed25519
    identity: registration and a relayed RPC work through it, a wrong pinned identity
    is refused before any control op, and trust on first use pins the identity."""
    port = relay_daemon.port
    channel = await open_relay_channel("127.0.0.1", port)
    assert channel.encrypted and channel.relay_pubkey.hex() == relay_daemon.pubkey_hex
    relay_identity = channel.relay_pubkey
    channel.close()

    with pytest.raises(ConnectionError, match="identity mismatch"):
        await open_relay_channel("127.0.0.1", port, relay_pubkey=b"\x42" * 32)

    server, client = await P2P.create(), await P2P.create()
    try:
        await add_echo(server, "negate", lambda n: -n)
        server_relay = await RelayClient.create(server, "127.0.0.1", port, relay_pubkey=relay_identity)
        assert server_relay._control.encrypted
        client_relay = RelayClient(client, "127.0.0.1", port)
        await client_relay.dial(server.peer_id)
        assert client_relay.relay_pubkey == relay_identity  # pinned by the dial
        assert await call_echo(client, server.peer_id, "negate", 7) == -7
        await server_relay.close()
    finally:
        await client.shutdown()
        await server.shutdown()


@bounded(30)
async def test_p2p_create_relays_kwarg(relay_daemon):
    """P2P.create(relays=[...]) registers at the relay on startup: a peer started this
    way is dialable through the relay with no direct address exchange. The pinned form
    registers too, and a wrong pin is logged, not raised."""
    port = relay_daemon.port
    server = await P2P.create(relays=[f"127.0.0.1:{port}", f"{'42' * 32}@127.0.0.1:{port}"])
    pinned = await P2P.create(relays=[f"{relay_daemon.pubkey_hex}@127.0.0.1:{port}"])
    client = await P2P.create()
    try:
        assert len(server._relays) == len(pinned._relays) == 1
        assert server._relays[0].registered and pinned._relays[0].registered
        for peer, name, fn in ((server, "half", lambda n: n // 2), (pinned, "third", lambda n: n // 3)):
            await add_echo(peer, name, fn)
            await RelayClient(client, "127.0.0.1", port).dial(peer.peer_id)
        assert await call_echo(client, server.peer_id, "half", 84) == 42
        assert await call_echo(client, pinned.peer_id, "third", 126) == 42
    finally:
        for peer in (client, pinned, server):
            await peer.shutdown()
    assert not server._relays and not pinned._relays  # shutdown closed them


def test_relay_identity_persists_across_restarts(tmp_path):
    """With an identity file, the daemon announces the same Ed25519 identity after a
    restart, so client pins keep working."""
    identity_file = tmp_path / "relay.key"

    def start_and_read_identity() -> str:
        with running_daemon("0", str(identity_file)) as daemon:
            assert daemon.pubkey_hex, "the daemon announced no identity"
            return daemon.pubkey_hex

    first = start_and_read_identity()
    assert identity_file.exists() and len(identity_file.read_bytes()) == 32
    assert (identity_file.stat().st_mode & 0o777) == 0o600
    assert start_and_read_identity() == first


@bounded(20)
async def test_relay_reregister_different_id_no_stale_route(relay_daemon):
    """One control line re-registering under a new peer_id drops the route to its old
    id: a later DIAL for the old id gets a clean refusal, and the daemon routes the new one."""
    port = relay_daemon.port
    key_a, key_b = Ed25519PrivateKey(), Ed25519PrivateKey()
    id_a, id_b = PeerID.from_private_key(key_a).to_bytes(), PeerID.from_private_key(key_b).to_bytes()

    r1, w1 = await _raw_conn(port)
    assert await register_control(RelayChannel(r1, w1), id_a, key_a) == b"O"
    assert await register_control(RelayChannel(r1, w1), id_b, key_b) == b"O"  # the same line, a new id

    rd, wd = await _raw_conn(port)
    await _send_frame(wd, b"D" + os.urandom(16) + id_a)
    try:
        refusal = await _recv_frame(rd)
    except asyncio.IncompleteReadError:
        refusal = b"E"  # an abrupt close is also a refusal, not a crash
    assert refusal == b"E"
    wd.close()

    rd2, wd2 = await _raw_conn(port)
    await _send_frame(wd2, b"D" + os.urandom(16) + id_b)
    assert (await _recv_frame(r1))[:1] == b"I"
    for writer in (w1, wd2):
        writer.close()
    assert relay_daemon.process.poll() is None


@bounded(40)
async def test_relay_backpressure_bounds_memory(relay_daemon):
    """Fast sender, slow receiver: the daemon pauses reading instead of buffering at
    line rate; its memory stays bounded and every byte still arrives once the receiver
    drains. The daemon's RSS is read from this test's own child, by its pid."""
    port = relay_daemon.port
    total = 32 * 1024 * 1024
    server_key = Ed25519PrivateKey()
    peer_id = PeerID.from_private_key(server_key).to_bytes()

    rs, ws = await _raw_conn(port)
    assert await register_control(RelayChannel(rs, ws), peer_id, server_key) == b"O"
    rd, wd = await _raw_conn(port)
    await _send_frame(wd, b"D" + os.urandom(16) + peer_id)
    incoming = await _recv_frame(rs)
    assert incoming[:1] == b"I"
    ra, wa = await _raw_conn(port)
    await _send_frame(wa, b"A" + incoming[1:17])
    assert await _recv_frame(ra) == b"O"
    assert await _recv_frame(rd) == b"O"

    def daemon_rss_kib() -> int:
        with open(f"/proc/{relay_daemon.process.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1])
        return 0

    async def blast():
        chunk = b"x" * (1 << 20)
        for _ in range(total // len(chunk)):
            wd.write(chunk)
            await wd.drain()
        wd.write_eof()

    sender = asyncio.create_task(blast())
    try:
        await asyncio.sleep(2.0)  # the receiver idles: pressure builds up
        mid_rss = daemon_rss_kib()
        # with working backpressure the daemon holds ~512 KiB (its high water) plus one
        # read of slack for this pair; a broken pause holds ~30 MiB within 2 s on loopback
        assert mid_rss < 12 * 1024, f"daemon ballooned to {mid_rss} KiB while the receiver stalled"
        received = 0
        while True:
            data = await ra.read(1 << 16)
            if not data:
                break
            received += len(data)
        await sender
    finally:
        sender.cancel()
        await asyncio.gather(sender, return_exceptions=True)
    assert received == total
    for writer in (ws, wd, wa):
        writer.close()


def test_plaintext_control_refused_by_default():
    """A daemon that does not complete the encrypted handshake is refused unless the
    caller opts out with allow_plaintext=True; a pinned identity refuses even then."""

    async def scenario():
        async def legacy_daemon(reader, writer):
            await reader.read(64)  # a pre-crypto daemon closes on the unknown handshake frame
            writer.close()

        server = await asyncio.start_server(legacy_daemon, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        with pytest.raises(ConnectionError, match="refused by default"):
            await open_relay_channel("127.0.0.1", port)
        channel = await open_relay_channel("127.0.0.1", port, allow_plaintext=True)
        assert not channel.encrypted
        channel.close()
        with pytest.raises(ConnectionError, match="pinned identity"):
            await open_relay_channel("127.0.0.1", port, relay_pubkey=b"\x11" * 32, allow_plaintext=True)
        server.close()
        await server.wait_closed()

    asyncio.run(asyncio.wait_for(scenario(), 20))


@bounded(40)
async def test_jax_and_port_peers_call_each_other_through_the_ports_daemon(relay_daemon):
    """Either package's relay client works with the port's daemon: a port peer and a
    JAX peer each register at it, and each dials the other through it by peer id
    (converted by bytes) and calls a test.proto handler."""
    port = relay_daemon.port
    ours, theirs = await P2P.create(), await JaxP2P.create()
    try:
        await add_echo(ours, "port.double", lambda n: 2 * n)

        async def jax_negate(request, context):
            return jax_test_pb2.TestResponse(number=-request.number)

        await theirs.add_protobuf_handler("jax.negate", jax_negate, jax_test_pb2.TestRequest)
        our_relay = await RelayClient.create(ours, "127.0.0.1", port, relay_pubkey=relay_daemon.pubkey_hex)
        their_relay = await JaxRelayClient.create(theirs, "127.0.0.1", port, relay_pubkey=relay_daemon.pubkey_hex)
        assert our_relay._control.encrypted and their_relay._control.encrypted

        # the JAX peer dials the port peer through the port's daemon
        our_id_there = JaxPeerID(ours.peer_id.to_bytes())
        assert await JaxRelayClient(theirs, "127.0.0.1", port).dial(our_id_there) == our_id_there
        response = await theirs.call_protobuf_handler(our_id_there, "port.double", jax_test_pb2.TestRequest(number=-21),
                                                       jax_test_pb2.TestResponse)
        assert response.number == -42
        # and the port peer dials the JAX peer through it (on a connection of its own: the
        # JAX peer's dial left an accepted one, which a dial would reuse)
        their_id_here = PeerID(theirs.peer_id.to_bytes())
        await ours.disconnect(their_id_here)
        assert await RelayClient(ours, "127.0.0.1", port).dial(their_id_here) == their_id_here
        assert ours._connections[their_id_here].is_relayed
        assert await call_echo(ours, their_id_here, "jax.negate", 5) == -5
        await our_relay.close()
        await their_relay.close()
    finally:
        await ours.shutdown()
        await theirs.shutdown()


@bounded(30)
async def test_generate_identity_list_peers_and_disconnect(tmp_path):
    """The P2P calls the relay tier uses: ``generate_identity`` writes a 0600 Ed25519 key
    that a P2P then takes (the JAX package reads it as the same peer), ``list_peers``
    names the connected peers and ``disconnect`` drops one."""
    path = tmp_path / "identity.key"
    P2P.generate_identity(str(path))
    assert (path.stat().st_mode & 0o777) == 0o600 and len(path.read_bytes()) == 32
    (tmp_path / "copy.key").write_bytes(path.read_bytes())  # the file itself stays locked by its P2P
    ours, other = await P2P.create(identity_path=str(path)), await P2P.create()
    theirs = await JaxP2P.create(identity_path=str(tmp_path / "copy.key"))
    try:
        assert theirs.peer_id.to_bytes() == ours.peer_id.to_bytes()
        assert await ours.list_peers() == []
        await ours.connect(other.get_visible_maddrs()[0])
        assert await ours.list_peers() == [other.peer_id]
        await ours.disconnect(other.peer_id)
        assert await ours.list_peers() == []
        await ours.disconnect(other.peer_id)  # a peer not connected: nothing to do
    finally:
        for node in (theirs, other, ours):
            await node.shutdown()
