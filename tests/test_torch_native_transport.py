"""The port's native transport (``hivemind_tpu_torch/p2p/native_transport.py``, the
data-plane proxy of ``native/hm_relayd.cpp``, ``P2P.create(data_proxy_*=...,
inbound_data_proxy=True, native_transport=True)``) against the JAX package's: each
case of ``tests/test_relay.py``'s data-plane half on the port's daemon, a JAX peer
dialing a port peer whose listener the daemon owns, and the two hygiene rules of the
port's daemon: no path it builds or runs contains ``relay_daemon`` (other tests search
the process list for that name), and no test leaves a daemon child behind.

g++ is on this machine, so the native transport must engage here: a P2P that fell
back to the asyncio data plane fails these tests, never skips them."""

from __future__ import annotations

import asyncio
import os
import struct
import subprocess
import threading
import time

import numpy as np
from torch_relay_support import (  # noqa: F401 (fixtures)
    add_echo,
    bounded,
    call_echo,
    daemon_children,
    no_daemon_left,
    relay_daemon,
    running_daemon,
    start_daemon,
    stop_daemon,
)

from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.proto import test_pb2 as jax_test_pb2
from hivemind_tpu_torch.compression import serialize_tensor, split_tensor_for_streaming
from hivemind_tpu_torch.ops import _build, _build_relayd
from hivemind_tpu_torch.p2p import P2P
from hivemind_tpu_torch.proto import runtime_pb2

FORBIDDEN_NAME = "relay_daemon"


@bounded(40)
async def test_data_plane_proxy_dial(relay_daemon):
    """A client dials through the local daemon's 'X' mode: the daemon terminates the
    channel AEAD in C++ (Python ships plaintext frames over loopback), and unary and
    multi-megabyte streaming RPCs work bit for bit against an ordinary server."""
    server, client = await P2P.create(), await P2P.create(data_proxy_port=relay_daemon.port)
    try:
        await add_echo(server, "echo", lambda n: n + 1)
        await client.connect(server.get_visible_maddrs()[0])
        assert client._proxied_dials == 1
        for i in (0, 7, 123456, -5):
            assert await call_echo(client, server.peer_id, "echo", i) == i + 1

        received = []

        async def sink(requests, context):
            parts = []
            async for message in requests:
                parts.extend(bytes(tensor.buffer) for tensor in message.tensors)
            received.append(b"".join(parts))
            yield runtime_pb2.ExpertResponse()

        await server.add_protobuf_handler("sink", sink, runtime_pb2.ExpertRequest, stream_input=True,
                                          stream_output=True)
        payload = serialize_tensor(np.random.RandomState(0).randn(1_500_000).astype(np.float32))

        async def requests():
            for chunk in split_tensor_for_streaming(payload, 256 * 1024):
                yield runtime_pb2.ExpertRequest(uid="b", tensors=[chunk])

        async for _response in client.iterate_protobuf_handler(server.peer_id, "sink", requests(),
                                                               runtime_pb2.ExpertResponse):
            pass
        assert received == [bytes(payload.buffer)]
    finally:
        await client.shutdown()
        await server.shutdown()


@bounded(30)
async def test_data_plane_proxy_over_unix_socket(tmp_path):
    """The proxy hop over the daemon's AF_UNIX listener: the socket file is 0600 (the
    same-user trust boundary for the 'K' key handoff), and dials through it carry RPCs."""
    socket_path = str(tmp_path / "proxy.sock")
    with running_daemon("0", "", socket_path):
        assert (os.stat(socket_path).st_mode & 0o777) == 0o600, oct(os.stat(socket_path).st_mode)
        server, client = await P2P.create(), await P2P.create(data_proxy_path=socket_path)
        try:
            await add_echo(server, "echo", lambda n: n + 1)
            await client.connect(server.get_visible_maddrs()[0])
            assert await call_echo(client, server.peer_id, "echo", 41) == 42
            assert client._proxied_dials >= 1  # the dial rode the daemon (a refusal would fall back silently)
        finally:
            await client.shutdown()
            await server.shutdown()


@bounded(30)
async def test_inbound_data_plane_proxy(relay_daemon):
    """The daemon owns the server's public listener ('Y') and terminates the inbound
    direction's AEAD too: a client dials the advertised, daemon-owned port and RPCs
    work, while the server's loop sees plaintext frames on loopback."""
    server = await P2P.create(data_proxy_port=relay_daemon.port, inbound_data_proxy=True)
    client = await P2P.create(data_proxy_port=relay_daemon.port)
    try:
        assert server._inbound_proxy_active, "inbound proxy registration failed"
        await add_echo(server, "echo", lambda n: n * 2)
        maddr = server.get_visible_maddrs()[0]
        assert maddr.port != server._listen_port  # the daemon's public listener, not the loopback bind
        await client.connect(maddr)
        for i in (3, 999):
            assert await call_echo(client, server.peer_id, "echo", i) == i * 2
        assert client._proxied_dials >= 1
    finally:
        await client.shutdown()
        await server.shutdown()


@bounded(40)
async def test_native_transport_zero_config():
    """P2P.create(native_transport=True): a private daemon spawns on a 0600 unix
    socket, the public listener moves into it ('Y'), outbound dials ride 'X', and
    shutdown reaps the child. The daemon must engage here (g++ is present)."""
    server = await P2P.create(native_transport=True)
    client = None
    try:
        assert server._native_daemon is not None, "the native transport fell back to asyncio"
        client = await P2P.create(native_transport=True)
        assert client._native_daemon is not None, "the native transport fell back to asyncio"
        for node in (server, client):
            assert node._native_daemon.alive and node._inbound_proxy_active
            assert (os.stat(node._native_daemon.unix_path).st_mode & 0o777) == 0o600
        await add_echo(server, "echo", lambda n: n + 100)
        await client.connect(server.get_visible_maddrs()[0])
        assert await call_echo(client, server.peer_id, "echo", 1) == 101
        assert client._proxied_dials >= 1  # the dial rode the client's own daemon
    finally:
        daemons = [node._native_daemon.process for node in (server, client) if node is not None and node._native_daemon]
        if client is not None:
            await client.shutdown()
        await server.shutdown()
    assert daemons and all(process.poll() is not None for process in daemons), "a daemon child outlived shutdown"


@bounded(40)
async def test_a_jax_peer_calls_a_port_peer_behind_its_native_daemon():
    """The C++ AEAD speaks the JAX package's channel: a plain JAX P2P dials the port
    server's daemon-owned listener and calls it, and the port server calls back over
    the same connection."""
    server = await P2P.create(native_transport=True)
    jax_client = await JaxP2P.create()
    try:
        assert server._native_daemon is not None and server._inbound_proxy_active
        await add_echo(server, "port.echo", lambda n: n - 1)

        async def jax_echo(request, context):
            return jax_test_pb2.TestResponse(number=request.number * 10)

        await jax_client.add_protobuf_handler("jax.echo", jax_echo, jax_test_pb2.TestRequest)
        server_id = await jax_client.connect(str(server.get_visible_maddrs()[0]))
        assert server_id == JaxPeerID(server.peer_id.to_bytes())
        response = await jax_client.call_protobuf_handler(server_id, "port.echo", jax_test_pb2.TestRequest(number=-41),
                                                          jax_test_pb2.TestResponse)
        assert response.number == -42
        from hivemind_tpu_torch.p2p import PeerID

        assert await call_echo(server, PeerID(jax_client.peer_id.to_bytes()), "jax.echo", 4) == 40
    finally:
        await jax_client.shutdown()
        await server.shutdown()


@bounded(50)
async def test_inbound_proxy_daemon_death_falls_back_to_direct_listening():
    """If the daemon dies after 'Y' registration its public listener vanishes: the peer
    notices (the EOF watchdog on the control connection), falls back to a direct
    listener and re-announces, instead of advertising a dead port."""
    daemon = start_daemon()
    server = client = None
    try:
        server = await P2P.create(data_proxy_port=daemon.port, inbound_data_proxy=True)
        assert server._inbound_proxy_active
        dead_public_port = server.get_visible_maddrs()[0].port
        stop_daemon(daemon.process)
        deadline = time.monotonic() + 20
        while server._inbound_proxy_active and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        assert not server._inbound_proxy_active, "the daemon's death was never detected"
        maddr = server.get_visible_maddrs()[0]
        assert maddr.port != dead_public_port  # re-announced the direct port
        await add_echo(server, "echo", lambda n: n - 1)
        client = await P2P.create()
        await client.connect(maddr)
        assert await call_echo(client, server.peer_id, "echo", 43) == 42
    finally:
        if client is not None:
            await client.shutdown()
        if server is not None:
            await server.shutdown()
        stop_daemon(daemon.process)


@bounded(40)
async def test_inbound_proxy_survives_malformed_wire_frames(relay_daemon):
    """Adversarial bytes at the daemon-owned public listener (oversized frames, garbage
    ciphertext after a fake hello, raw junk) each kill at most their own pair: a
    well-formed peer still handshakes and calls afterwards."""
    server = await P2P.create(data_proxy_port=relay_daemon.port, inbound_data_proxy=True)
    client = None
    try:
        assert server._inbound_proxy_active
        public_port = server.get_visible_maddrs()[0].port

        # 1) an oversized frame header: the daemon tears the pair down (the server's own
        # hello may arrive first, so drain to EOF)
        reader, writer = await asyncio.open_connection("127.0.0.1", public_port)
        writer.write(struct.pack(">I", (64 << 20)) + b"x" * 64)
        await writer.drain()
        await asyncio.wait_for(reader.read(-1), timeout=10)
        writer.close()

        # 2) a plausible hello frame, then garbage "ciphertext" frames
        reader, writer = await asyncio.open_connection("127.0.0.1", public_port)
        writer.write(struct.pack(">I", 32) + b"h" * 32)
        for _ in range(4):
            writer.write(struct.pack(">I", 64) + b"\x00" * 64)
        await writer.drain()
        await asyncio.sleep(0.5)
        writer.close()

        # 3) raw junk, no framing at all
        reader, writer = await asyncio.open_connection("127.0.0.1", public_port)
        writer.write(b"\xff" * 1024)
        await writer.drain()
        writer.close()

        client = await P2P.create()
        await add_echo(server, "echo", lambda n: n + 7)
        await client.connect(server.get_visible_maddrs()[0])
        assert await call_echo(client, server.peer_id, "echo", 1) == 8
        assert relay_daemon.process.poll() is None
    finally:
        if client is not None:
            await client.shutdown()
        await server.shutdown()


@bounded(40)
async def test_data_plane_proxy_survives_malformed_frames(relay_daemon):
    """Adversarial input to the daemon's proxy parser kills at most the offending pair,
    never the daemon: a bad 'K' frame, an oversized frame and garbage ciphertext each
    get their connection closed, and a well-formed proxied pair still works after."""
    port = relay_daemon.port

    async def frame(writer, payload: bytes):
        writer.write(struct.pack(">I", len(payload)) + payload)
        await writer.drain()

    async def open_proxy_to(target_port: int):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await frame(writer, b"X" + struct.pack(">H", target_port) + b"127.0.0.1")
        (length,) = struct.unpack(">I", await asyncio.wait_for(reader.readexactly(4), timeout=5))
        assert await reader.readexactly(length) == b"O"
        return reader, writer

    sink_conns = []

    async def on_connect(reader, writer):
        sink_conns.append((reader, writer))

    sink = await asyncio.start_server(on_connect, "127.0.0.1", 0)
    sink_port = sink.sockets[0].getsockname()[1]
    try:
        # 1) frame #2 is not a valid 'K': the pair closes (EOF), the daemon survives
        reader, writer = await open_proxy_to(sink_port)
        await frame(writer, b"hello-crosses-raw")
        await frame(writer, b"K" + b"\x00" * 10)  # wrong length
        assert await reader.read(64) == b""
        writer.close()

        # 2) an oversized frame header: the pair closes, the daemon survives
        reader, writer = await open_proxy_to(sink_port)
        writer.write(struct.pack(">I", (64 << 20)))  # 64 MiB, past the proxy's frame limit
        await writer.drain()
        assert await reader.read(64) == b""
        writer.close()

        # 3) after a valid 'K', garbage ciphertext from the remote side kills the pair
        reader, writer = await open_proxy_to(sink_port)
        await frame(writer, b"hello")
        await frame(writer, b"K" + b"\x01" * 32 + b"\x02" * 32 + b"\x00" * 16)
        await asyncio.sleep(0.1)
        sink_reader, sink_writer = sink_conns[-1]
        await sink_reader.readexactly(4 + 5)  # the forwarded raw hello
        sink_writer.write(struct.pack(">I", 5) + b"salut")  # the remote hello crosses raw
        sink_writer.write(struct.pack(">I", 32) + b"\xff" * 32)  # not valid AEAD
        await sink_writer.drain()
        (length,) = struct.unpack(">I", await asyncio.wait_for(reader.readexactly(4), timeout=5))
        assert await reader.readexactly(length) == b"salut"
        assert await reader.read(64) == b""  # the tampered wire frame killed the pair
        writer.close()

        # the daemon is still healthy: a fresh proxied pair forwards bytes raw
        reader, writer = await open_proxy_to(sink_port)
        await frame(writer, b"ping")
        await asyncio.sleep(0.1)
        sink_reader, sink_writer = sink_conns[-1]
        assert await asyncio.wait_for(sink_reader.readexactly(8), timeout=5) == struct.pack(">I", 4) + b"ping"
        writer.close()
        assert relay_daemon.process.poll() is None
    finally:
        for _reader, sink_writer in sink_conns:
            sink_writer.close()
        sink.close()
        await sink.wait_closed()


# ------------------------------------------------------------------ the daemon's hygiene


def test_no_path_the_daemon_build_writes_or_runs_contains_relay_daemon(tmp_path, monkeypatch):
    """A fresh build runs the compiler directly (no make) on ``hm_relayd.cpp`` into the
    build directory, at most once for any number of concurrent callers, and neither
    the source, the binary, the compiler's command line nor the running daemon's
    command line contains ``relay_daemon``: ``pgrep -f relay_daemon`` never finds it."""
    assert FORBIDDEN_NAME not in str(_build_relayd.SOURCE) and _build_relayd.SOURCE.is_file()
    assert _build_relayd.BUILD_DIR == _build.BUILD_DIR  # the gitignored build/hivemind_tpu_torch/
    assert _build.BUILD_DIR.parent.name == "build"
    monkeypatch.setattr(_build_relayd, "BUILD_DIR", tmp_path / "build")
    commands, real_run = [], subprocess.run

    def recording_run(command, *args, **kwargs):
        commands.append([str(part) for part in command])
        return real_run(command, *args, **kwargs)

    monkeypatch.setattr(_build_relayd.subprocess, "run", recording_run)
    results = []
    builders = [threading.Thread(target=lambda: results.append(_build_relayd.build_relayd())) for _ in range(3)]
    for builder in builders:
        builder.start()
    for builder in builders:
        builder.join(120)
    assert not any(builder.is_alive() for builder in builders)
    assert len(commands) == 1, commands  # the lock: built once
    (binary, error), *others = results
    assert binary is not None, error and all(result == (binary, "") for result in others)
    assert binary.parent == tmp_path / "build" and binary.name.startswith("hm_relayd-")
    command = commands[0]
    assert os.path.basename(command[0]) not in ("make", "gmake") and "-ldl" in command and "-O2" in command
    written = sorted(path.name for path in (tmp_path / "build").iterdir())
    assert written == sorted([binary.name, "hm_relayd.lock"]), written  # no temporary file left
    for text in (str(binary), *command):
        assert FORBIDDEN_NAME not in text, text
    with running_daemon() as daemon:
        cmdline = open(f"/proc/{daemon.process.pid}/cmdline", "rb").read().decode()
        assert FORBIDDEN_NAME not in cmdline
        listed = subprocess.run(["pgrep", "-f", FORBIDDEN_NAME], capture_output=True, text=True).stdout.split()
        assert str(daemon.process.pid) not in listed


def test_a_daemon_left_unreaped_is_found():
    """The reaping check itself: a killed daemon that nobody waited for is still this
    process's child (a zombie) and is found; once waited for, it is gone."""
    daemon = start_daemon()
    try:
        assert daemon.process.pid in daemon_children()
        daemon.process.kill()
        deadline = time.monotonic() + 5
        while open(f"/proc/{daemon.process.pid}/stat").read().split(")")[-1].split()[0] != "Z":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert daemon.process.pid in daemon_children()  # dead but not reaped
    finally:
        stop_daemon(daemon.process)
    assert daemon.process.pid not in daemon_children()
