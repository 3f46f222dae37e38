"""The P2P node: listeners, dialing, handler registry, unary + streaming RPC (the
port's copy of hivemind_tpu/p2p/p2p.py, on the same wire).

The transport runs in-process on asyncio: one encrypted multiplexed TCP connection
per peer pair carries all RPCs, unary and streaming. Optionally the data plane runs
through the relay daemon (``native/hm_relayd.cpp``): outbound dials ('X') and the
public listener ('Y') through a local daemon that does the AEAD in C++
(``data_proxy_port``, ``data_proxy_path``, ``inbound_data_proxy``), or a private
daemon spawned for this node (``native_transport=True``). ``relays=`` registers the
node at relay daemons, and a peer resolver (``set_peer_resolver``, installed by
``p2p/autorelay.py``) finds a route when no direct address answers. The environment
variables ``HIVEMIND_TPU_DATA_PROXY_PATH``, ``HIVEMIND_TPU_DATA_PROXY_PORT``,
``HIVEMIND_TPU_NATIVE_TRANSPORT`` and ``HIVEMIND_TPU_INBOUND_DATA_PROXY`` select the
same, under the JAX package's names.
"""

from __future__ import annotations

import asyncio
import os
import socket
import struct
import time
from dataclasses import dataclass
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Type,
    TypeVar,
    Union,
)

from hivemind_tpu_torch.p2p.crypto_channel import HandshakeError, handshake
from hivemind_tpu_torch.p2p.mux import (
    MuxConnection,
    MuxStream,
    RemoteError,
    StreamClosedError,
)
from hivemind_tpu_torch.p2p.peer_id import Multiaddr, PeerID
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.resilience import Deadline
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import finish_span as _finish_span
from hivemind_tpu_torch.telemetry.tracing import start_span as _start_span
from hivemind_tpu_torch.telemetry.tracing import trace as _trace
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.streaming import WireParts

logger = get_logger(__name__)

TRequest = TypeVar("TRequest")
TResponse = TypeVar("TResponse")

# RPC telemetry, under the JAX package's names: per-handler RPC latency, payload
# bytes and failures on both sides of the wire. label `side`: "server" for
# handlers this peer serves, "client" for calls it makes.

_RPC_LATENCY = _TELEMETRY.histogram(
    "hivemind_p2p_rpc_latency_seconds", "wall time of one RPC", ("handler", "side")
)
_RPC_BYTES = _TELEMETRY.counter(
    "hivemind_p2p_rpc_bytes_total", "serialized RPC payload bytes", ("handler", "direction")
)
_RPC_ERRORS = _TELEMETRY.counter(
    "hivemind_p2p_rpc_errors_total", "RPCs that failed", ("handler", "side")
)

from hivemind_tpu_torch.p2p.mux import MAX_MESSAGE_SIZE as DEFAULT_MAX_MSG_SIZE  # noqa: E402 (enforced in MuxStream.send)


class P2PError(RuntimeError):
    pass


class P2PHandlerError(P2PError):
    """Raised on the client when the remote handler failed."""


class PeerNotFoundError(P2PError):
    pass


@dataclass
class P2PContext:
    """Passed to every RPC handler."""

    handle_name: str
    local_id: PeerID
    remote_id: PeerID


@dataclass
class _Handler:
    fn: Callable[..., Any]
    request_type: Optional[Type]
    stream_input: bool
    stream_output: bool


def _parse(message_bytes: bytes, message_type: Optional[Type]):
    if message_type is None or message_type is bytes:
        return message_bytes
    message = message_type()
    message.ParseFromString(message_bytes)
    return message


def _serialize(message):
    # memoryview included: raw handlers may echo the zero-copy wire view back
    if isinstance(message, WireParts):
        return message  # scatter-gather: parts ride uncopied into the frame
    if isinstance(message, (bytes, bytearray, memoryview)):
        return bytes(message)
    return message.SerializeToString()


async def _send_payload(stream, payload) -> int:
    """Send one serialized payload (bytes or WireParts) on a stream; returns the
    byte count for the RPC accounting."""
    if isinstance(payload, WireParts):
        await stream.send(b"", *payload.parts)
        return payload.nbytes
    await stream.send(payload)
    return len(payload)


def _chaos_payload(payload):
    """Chaos corruption operates on materialized bytes; WireParts join only on
    this (test-only) path."""
    return payload.join() if isinstance(payload, WireParts) else payload


class P2P:
    """An in-process peer: listens for encrypted connections, dials peers, and routes
    named handlers. Create with ``await P2P.create(...)``."""

    def __init__(self):
        raise RuntimeError("use `await P2P.create(...)`")

    @classmethod
    async def create(
        cls,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        identity: Optional[Ed25519PrivateKey] = None,
        identity_path: Optional[str] = None,
        announce_host: Optional[str] = None,
        announce_port: Optional[int] = None,
        initial_peers: Sequence[Union[str, Multiaddr]] = (),
        dial_timeout: float = 10.0,
        relays: Sequence[str] = (),
        max_connections: int = 0,
        data_proxy_port: Optional[int] = None,
        data_proxy_path: Optional[str] = None,
        inbound_data_proxy: bool = False,
        native_transport: Optional[bool] = None,
    ) -> "P2P":
        """``relays``: relay daemons to register at on startup. Each spec is
        ``host:port`` or ``<relay_pubkey_hex>@host:port``; the pinned form refuses a
        relay that cannot prove the expected Ed25519 identity over the encrypted
        control channel. Registration makes this peer dialable through the relay;
        failures are logged, not raised, as for ``initial_peers``.

        ``max_connections``: connection-manager high water. 0 disables. Above
        it, idle (stream-less) connections are closed least-recently-used-first
        down to 90% of the cap; a trimmed peer is simply re-dialed on next use.

        ``data_proxy_path`` / ``data_proxy_port``: route outbound dials through a
        local relay daemon's data-plane proxy ('X'), which takes the session keys
        ('K' frame) and seals and opens the wire in C++. The unix socket (created
        0600 by the daemon) confines that key handoff to this user; the loopback TCP
        port carries no peer credential and must not be used on a host shared with
        other users. When both are set, the unix socket wins.
        ``inbound_data_proxy``: the daemon also owns this node's public listener
        ('Y') and forwards each wire connection to a loopback listener here; falls
        back to listening directly if the daemon refuses.
        ``native_transport``: spawn a private daemon for this node on a 0600 unix
        socket and route both directions through it (None: the environment
        decides). Without a C++ toolchain it warns and stays on asyncio."""
        self = object.__new__(cls)
        self._identity_lock_fd: Optional[int] = None
        if identity is None:
            if identity_path is not None:
                identity, self._identity_lock_fd = cls._load_or_create_identity(identity_path)
            else:
                identity = Ed25519PrivateKey()
        self.identity = identity
        self.peer_id = PeerID.from_private_key(identity)
        self._handlers: Dict[str, _Handler] = {}
        self._connections: Dict[PeerID, MuxConnection] = {}
        self._all_connections: Set[MuxConnection] = set()  # incl. duplicate-race losers
        self._dial_locks: Dict[PeerID, asyncio.Lock] = {}
        self._peerstore: Dict[PeerID, Set[Multiaddr]] = {}
        self._dial_timeout = dial_timeout
        if data_proxy_path is None:
            data_proxy_path = os.environ.get("HIVEMIND_TPU_DATA_PROXY_PATH") or None
        if data_proxy_port is None:
            env_port = os.environ.get("HIVEMIND_TPU_DATA_PROXY_PORT")
            data_proxy_port = int(env_port) if env_port else None
        self._native_daemon = None
        if native_transport is None:  # None: the environment decides; an explicit False wins over it
            native_transport = os.environ.get("HIVEMIND_TPU_NATIVE_TRANSPORT", "0") == "1"
        if native_transport and data_proxy_path is None and data_proxy_port is None:
            from hivemind_tpu_torch.p2p.native_transport import spawn_native_transport

            # the spawn may build the daemon (seconds): keep the loop live. If this
            # coroutine is cancelled mid-spawn, the executor thread still finishes: its
            # daemon is reaped from a done callback, so no orphan outlives the cancellation
            spawn_future = asyncio.get_running_loop().run_in_executor(None, spawn_native_transport)
            try:
                self._native_daemon = await asyncio.shield(spawn_future)
            except asyncio.CancelledError:
                def _reap(future):
                    if not future.cancelled() and future.exception() is None and future.result() is not None:
                        future.result().shutdown()

                spawn_future.add_done_callback(_reap)
                raise
            if self._native_daemon is not None:
                data_proxy_path = self._native_daemon.unix_path
                inbound_data_proxy = True
        self._data_proxy_path = data_proxy_path or None
        self._data_proxy_port = data_proxy_port or None
        self._proxied_dials = 0  # outbound dials that rode the daemon
        if not inbound_data_proxy:
            inbound_data_proxy = os.environ.get("HIVEMIND_TPU_INBOUND_DATA_PROXY", "0") == "1"
        self._inbound_proxy_requested = bool(inbound_data_proxy) and (
            self._data_proxy_port is not None or self._data_proxy_path is not None
        )
        self._inbound_proxy_active = False
        self._inbound_proxy_writer: Optional[asyncio.StreamWriter] = None
        self._announce_port_from_proxy = False
        self._bg_tasks: Set[asyncio.Task] = set()  # strong refs: the loop holds tasks weakly
        self._alive_refs = 1  # P2P.replicate: shared instance refcount
        self._peer_resolver = None  # an optional async route lookup when no address answers (auto-relay)
        self._max_connections = max_connections
        self._shutting_down = False
        self._relays: list = []  # RelayClients registered through `relays`
        self._listen_host = listen_host
        self._announce_host = announce_host or listen_host
        # NATed or port-forwarded deployments: the externally visible port can differ
        # from the bound one (or be closed entirely: AutoNAT then diagnoses it)
        self._announce_port = announce_port

        self._server = None
        self._requested_listen_port = listen_port
        try:
            if self._inbound_proxy_requested:
                # bind loopback only: the public listener belongs to the daemon
                self._server = await asyncio.start_server(self._on_inbound_connection, "127.0.0.1", 0)
                local_port = self._server.sockets[0].getsockname()[1]
                public_port = await self._register_inbound_proxy(listen_port, local_port)
                if public_port is not None:
                    self._inbound_proxy_active = True
                    self._listen_port = local_port
                    if self._announce_port is None:
                        self._announce_port = public_port
                        self._announce_port_from_proxy = True
                    logger.debug(f"P2P {self.peer_id} behind the daemon's inbound proxy: "
                                 f"public :{public_port} -> loopback :{local_port}")
                else:
                    logger.warning("inbound data-plane proxy registration failed; falling back to direct listening")
                    self._server.close()
                    await self._start_direct_server()
            else:
                await self._start_direct_server()
            logger.debug(f"P2P {self.peer_id} listening on {listen_host}:{self._listen_port}")

            for maddr in initial_peers:
                maddr = Multiaddr.parse(maddr) if isinstance(maddr, str) else maddr
                try:
                    await self.connect(maddr)
                except Exception as e:
                    logger.warning(f"could not reach initial peer {maddr}: {e}")

            for relay_spec in relays:
                from hivemind_tpu_torch.p2p.relay import RelayClient

                pubkey, _, hostport = relay_spec.rpartition("@")
                relay_host, _, relay_port = hostport.rpartition(":")
                try:
                    self._relays.append(
                        await RelayClient.create(self, relay_host, int(relay_port), relay_pubkey=pubkey or None)
                    )
                except Exception as e:
                    logger.warning(f"could not register at relay {relay_spec}: {e}")
        except BaseException:
            # any failure mid-create must not leak the listener, peer connections
            # already established, the daemon, or the identity flock ("taken")
            if self._server is not None:
                self._server.close()
            for relay in self._relays:
                try:
                    await asyncio.shield(relay.close())
                except BaseException:
                    pass
            for conn in list(self._all_connections):
                try:
                    await asyncio.shield(conn.close())
                except BaseException:
                    pass  # best-effort: cancellation must not strand later closes
            if self._identity_lock_fd is not None:
                os.close(self._identity_lock_fd)
            if self._native_daemon is not None:
                self._native_daemon.shutdown()
            raise
        return self

    # ------------------------------------------------------------------ identity

    class IdentityTakenError(RuntimeError):
        """Another live process already uses this identity file."""

    @classmethod
    def generate_identity(cls, identity_path: str) -> None:
        """Write a fresh Ed25519 identity file (0600)."""
        key = Ed25519PrivateKey()
        fd = os.open(identity_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key.to_bytes())

    @staticmethod
    def _load_or_create_identity(identity_path: str):
        """Open-or-create the identity file, flock it for this P2P's lifetime, then
        read (or first-write) the key through the SAME descriptor.

        Two peers sharing one identity make the swarm misroute to whichever
        connected last; single-host collisions (two servers started with the same
        identity path) are caught deterministically by an OS file lock, released
        automatically if the process dies.
        Locking BEFORE writing means two simultaneous first-time creates cannot
        truncate each other's key; a pre-provisioned read-only key file (e.g. a
        mounted secret) is opened read-only — flock works on those descriptors too.

        :returns: (identity, locked fd)"""
        import fcntl

        try:
            fd = os.open(identity_path, os.O_RDWR | os.O_CREAT, 0o600)
        except PermissionError:
            fd = os.open(identity_path, os.O_RDONLY)  # read-only provisioned key
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            os.close(fd)
            raise P2P.IdentityTakenError(
                f"identity file {identity_path!r} is locked by another live process; "
                f"two peers must not share one identity"
            )
        except OSError:
            os.close(fd)  # e.g. ENOLCK on lockless network mounts: NOT a duplicate peer
            raise
        try:
            existing = os.pread(fd, 4096, 0)
            if existing:
                return Ed25519PrivateKey.from_bytes(existing), fd
            identity = Ed25519PrivateKey()
            os.pwrite(fd, identity.to_bytes(), 0)
            return identity, fd
        except BaseException:
            os.close(fd)
            raise

    async def replicate(self) -> "P2P":
        """Another handle on this node: in-process, components share this
        instance, and it shuts down when the last handle does."""
        self._alive_refs += 1
        return self

    def get_visible_maddrs(self, latest: bool = False) -> List[Multiaddr]:
        port = self._announce_port if self._announce_port is not None else self._listen_port
        return [Multiaddr(self._announce_host, port, self.peer_id)]

    @property
    def listen_port(self) -> int:
        return self._listen_port

    # ------------------------------------------------------------------ connections

    async def _start_direct_server(self) -> None:
        """Bind the ordinary public listener (at create, after a refused proxy
        registration, and after the daemon's death)."""
        self._server = await asyncio.start_server(
            self._on_inbound_connection, self._listen_host, self._requested_listen_port
        )
        self._listen_port = self._server.sockets[0].getsockname()[1]

    async def _open_daemon_connection(self):
        """One framed connection to the local proxy daemon (the unix socket wins)."""
        if self._data_proxy_path is not None:
            return await asyncio.open_unix_connection(self._data_proxy_path)
        return await asyncio.open_connection("127.0.0.1", self._data_proxy_port)

    async def _register_inbound_proxy(self, public_port: int, local_port: int) -> Optional[int]:
        """Ask the daemon to own our public listener ('Y' frame) and forward wire
        connections to ``local_port``; returns the actual public port, or None on
        refusal. The control connection stays open: the daemon ties the listener's
        lifetime to it."""
        writer = None
        registered = failed = False
        budget = Deadline(self._dial_timeout)  # one budget for the whole registration
        try:
            reader, writer = await budget.wait_for(self._open_daemon_connection())
            request = b"Y" + struct.pack(">HH", public_port, local_port)
            writer.write(struct.pack(">I", len(request)) + request)
            await writer.drain()
            (length,) = struct.unpack(">I", await budget.wait_for(reader.readexactly(4)))
            response = await budget.wait_for(reader.readexactly(length))
            if len(response) == 3 and response[0:1] == b"O":
                self._inbound_proxy_writer = writer
                registered = True
                # a daemon crash otherwise leaves this node announcing a dead port, while
                # outbound dials keep working and mask the loss
                watchdog = spawn(self._watch_inbound_proxy(reader), name="p2p.inbound_proxy_watchdog")
                self._bg_tasks.add(watchdog)
                watchdog.add_done_callback(self._bg_tasks.discard)
                return struct.unpack(">H", response[1:3])[0]
            # a well-formed reply other than 'O' is a refusal, not an error
        except (ConnectionError, OSError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
            failed = True
            logger.debug(f"inbound proxy registration failed: {e!r}")
        finally:
            # a registration that did not become the control connection always closes its
            # writer; only failures mid-handshake count as errors (refusals and
            # cancellations are expected outcomes)
            if writer is not None and not registered:
                if failed:
                    _RPC_ERRORS.inc(handler="_register_inbound_proxy", side="client")
                writer.close()
        return None

    async def _watch_inbound_proxy(self, reader: asyncio.StreamReader) -> None:
        """EOF on the 'Y' control connection means the daemon (and our public
        listener) died: fall back to listening directly and re-announce, loudly."""
        try:
            while await reader.read(4096):
                pass  # the daemon sends nothing after 'O'
        except (ConnectionError, OSError):
            pass
        if self._shutting_down or not self._inbound_proxy_active:
            return
        logger.warning("the data-plane proxy daemon died and its public listener with it; "
                       "falling back to a direct listener and re-announcing")
        self._inbound_proxy_active = False
        self._inbound_proxy_writer = None
        if self._announce_port_from_proxy:
            self._announce_port = None
            self._announce_port_from_proxy = False
        old_server = self._server
        try:
            await self._start_direct_server()
        except OSError as e:
            logger.error(f"direct-listener fallback failed: {e!r}; this peer is undialable")
            return
        if old_server is not None:
            old_server.close()  # in-flight loopback connections finish on their transports
        logger.warning(f"now listening directly on {self._listen_host}:{self._listen_port}")

    async def _on_inbound_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self._shutting_down:
            writer.close()
            return
        try:
            channel, extras = await handshake(
                reader, writer, self.identity, is_initiator=False,
                announced_addrs=self.get_visible_maddrs(),
                # behind the daemon's listener every inbound connection is a proxy's
                # local leg: hand it the session keys and go plaintext here
                proxy_upgrade=self._inbound_proxy_active,
            )
        except (HandshakeError, asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            logger.debug(f"inbound handshake failed: {e!r}")
            writer.close()
            return
        peer_id = PeerID.from_public_key(Ed25519PublicKey.from_bytes(extras["static"]))
        if self._shutting_down:
            # a dial that completed its handshake mid-shutdown:
            # an untracked live connection here would park Server.wait_closed forever
            channel.close()
            return
        self._register_peer_addrs(peer_id, extras.get("addrs", ()))
        self._prune_dead_connections()
        conn = MuxConnection(channel, peer_id, is_initiator=False, on_inbound_stream=self._route_stream)
        existing = self._connections.get(peer_id)
        if existing is None or existing.is_closed:
            self._connections[peer_id] = conn  # replace stale connections with the live one
        # duplicate-race losers still serve the dialer's streams, and must be tracked
        # so shutdown() can close them
        self._all_connections.add(conn)
        conn.start()
        await self._trim_connections(protect=conn)

    async def _trim_connections(self, protect: Optional[MuxConnection] = None) -> None:
        """Connection manager (see ``create``): close idle LRU connections past the
        high water mark. Never touches connections with live streams, nor relayed
        circuits (their route may not be re-dialable without the relay client that
        made them)."""
        if not self._max_connections:
            return
        self._prune_dead_connections()  # dead entries must not count toward the marks
        if len(self._all_connections) <= self._max_connections:
            return
        low_water = max(int(self._max_connections * 0.9), 1)
        idle = sorted(
            (
                conn
                for conn in self._all_connections
                if conn is not protect
                and not conn.is_closed
                and conn.num_streams == 0
                and not getattr(conn, "is_relayed", False)
            ),
            key=lambda conn: conn.last_used,
        )
        for conn in idle:
            if len(self._all_connections) <= low_water:
                break
            await conn.close()
            self._all_connections.discard(conn)  # lint: single-writer — guarded `is conn` del + idempotent discard
            if self._connections.get(conn.peer_id) is conn:
                del self._connections[conn.peer_id]  # lint: single-writer — guarded `is conn` del + idempotent discard

    def _register_peer_addrs(self, peer_id: PeerID, addrs) -> None:
        store = self._peerstore.setdefault(peer_id, set())
        for addr in addrs:
            try:
                store.add(Multiaddr.parse(addr) if isinstance(addr, str) else addr)
            except ValueError:
                continue

    def add_peer_addr(self, peer_id: PeerID, maddr: Union[str, Multiaddr]) -> None:
        self._register_peer_addrs(peer_id, [maddr])

    async def connect(self, maddr: Union[str, Multiaddr]) -> PeerID:
        """Dial an address; returns the authenticated PeerID behind it."""
        maddr = Multiaddr.parse(maddr) if isinstance(maddr, str) else maddr
        conn = await self._dial(maddr, expected_peer=maddr.peer_id)
        return conn.peer_id

    _DIALABLE_PROTOS = frozenset({"ip4", "ip6", "dns", "dns4", "dns6"})

    async def _dial(
        self, maddr: Multiaddr, expected_peer: Optional[PeerID], replace_existing: bool = False
    ) -> MuxConnection:
        """Dial one address. With ``replace_existing`` a live connection to the same
        peer is superseded for future streams (a hole punch's direct path replaces the
        relayed one; streams in flight finish on the old connection)."""
        if maddr.host_proto not in self._DIALABLE_PROTOS:
            # peer-announced unix/onion3 addresses parse (codec parity) but the
            # TCP transport cannot reach them: fail instantly, so an attacker
            # announcing them cannot burn a dial timeout per reconnect attempt
            raise ConnectionError(f"no transport for {maddr.host_proto!r} address {maddr}")
        via_proxy = self._data_proxy_port is not None or self._data_proxy_path is not None
        if via_proxy:
            try:
                reader, writer = await asyncio.wait_for(
                    self._open_proxied_connection(maddr.host, maddr.port), timeout=self._dial_timeout
                )
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                # the proxy is an optimization, not a reachability requirement: an
                # address a plain socket reaches is still dialed
                logger.debug(f"data-plane proxy dial to {maddr.host}:{maddr.port} failed ({e!r}); dialing directly")
                via_proxy = False
        if not via_proxy:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(maddr.host, maddr.port), timeout=self._dial_timeout
            )
        try:
            channel, extras = await handshake(
                reader, writer, self.identity, is_initiator=True, announced_addrs=self.get_visible_maddrs(),
                proxy_upgrade=via_proxy,
            )
        except BaseException:
            writer.close()
            raise
        peer_id = PeerID.from_public_key(Ed25519PublicKey.from_bytes(extras["static"]))
        if expected_peer is not None and peer_id != expected_peer:
            channel.close()
            raise HandshakeError(f"dialed {expected_peer} but found {peer_id}")
        self._register_peer_addrs(peer_id, [maddr.with_peer_id(peer_id)])
        self._register_peer_addrs(peer_id, extras.get("addrs", ()))
        existing = self._connections.get(peer_id)
        if existing is not None and not existing.is_closed:
            if not replace_existing:
                channel.close()
                return existing
            # the superseded (e.g. relayed) connection: streams in flight finish, then it
            # closes, or every punch would leak a socket on both ends and a spliced pair
            # on the relay
            self._close_after_grace(existing)
        conn = MuxConnection(channel, peer_id, is_initiator=True, on_inbound_stream=self._route_stream)
        self._connections[peer_id] = conn
        self._all_connections.add(conn)
        conn.start()
        await self._trim_connections(protect=conn)
        return conn

    async def _open_proxied_connection(self, host: str, port: int):
        """Open an outbound connection through the local data-plane proxy: 'X'
        <port><host> to the daemon, wait for 'O'; the stream then behaves like a
        direct socket (the daemon forwards, and takes over the AEAD at the
        handshake's 'K' frame)."""
        try:
            socket.inet_aton(host)
        except OSError:
            # the daemon's 'X' takes IPv4 literals only: resolve a dns or ip6 host here
            infos = await asyncio.get_running_loop().getaddrinfo(
                host, port, family=socket.AF_INET, type=socket.SOCK_STREAM
            )
            if not infos:
                raise ConnectionError(f"no IPv4 address for {host!r} (the data-plane proxy is IPv4-only)")
            host = infos[0][4][0]
        reader, writer = await self._open_daemon_connection()
        request = b"X" + struct.pack(">H", port) + host.encode()
        writer.write(struct.pack(">I", len(request)) + request)
        await writer.drain()
        (length,) = struct.unpack(">I", await reader.readexactly(4))
        response = await reader.readexactly(length)
        if response != b"O":
            writer.close()
            raise ConnectionError(f"data-plane proxy could not reach {host}:{port} (reply {response!r})")
        self._proxied_dials += 1
        return reader, writer

    def _close_after_grace(self, conn: MuxConnection, grace: float = 30.0) -> None:
        """Close a superseded connection once streams in flight have had time to
        finish."""

        async def _close():
            await asyncio.sleep(grace)
            await conn.close()

        task = spawn(_close(), name="p2p.close_after_grace")
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _prune_dead_connections(self) -> None:
        dead = [c for c in self._all_connections if c.is_closed]
        for conn in dead:
            self._all_connections.discard(conn)
            if self._connections.get(conn.peer_id) is conn:
                del self._connections[conn.peer_id]

    async def _get_connection(self, peer_id: PeerID) -> MuxConnection:
        self._prune_dead_connections()
        conn = self._connections.get(peer_id)
        if conn is not None and not conn.is_closed:
            return conn
        lock = self._dial_locks.setdefault(peer_id, asyncio.Lock())
        async with lock:
            conn = self._connections.get(peer_id)
            if conn is not None and not conn.is_closed:
                return conn
            last_error: Optional[Exception] = None
            for maddr in sorted(self._peerstore.get(peer_id, ()), key=str):
                try:
                    return await self._dial(maddr, expected_peer=peer_id)
                except Exception as e:
                    last_error = e
            if self._peer_resolver is not None:
                # no direct route: ask the installed resolver (auto-relay finds the
                # target's published circuits in the DHT and dials through a relay)
                try:
                    conn = await self._peer_resolver(peer_id)
                except Exception as e:
                    conn = None
                    last_error = e
                if conn is not None and not conn.is_closed:
                    return conn
            raise PeerNotFoundError(f"no reachable address for {peer_id}") from last_error

    def set_peer_resolver(self, resolver) -> None:
        """Install an async ``fn(peer_id) -> Optional[MuxConnection]`` used when no
        direct address works. Pass None to remove it."""
        self._peer_resolver = resolver

    # ------------------------------------------------------------------ handlers

    async def add_protobuf_handler(
        self,
        name: str,
        handler: Callable[..., Any],
        request_type: Optional[Type] = None,
        *,
        stream_input: bool = False,
        stream_output: bool = False,
    ) -> None:
        """Register a named handler. Unary: ``async fn(request, context) -> response``.
        Stream input: request is an AsyncIterator. Stream output: fn returns/yields an
        AsyncIterator of responses."""
        if name in self._handlers:
            raise P2PError(f"handler {name!r} is already registered")
        self._handlers[name] = _Handler(handler, request_type, stream_input, stream_output)

    async def remove_protobuf_handler(self, name: str) -> None:
        self._handlers.pop(name, None)

    async def _route_stream(self, stream: MuxStream) -> None:
        handler = self._handlers.get(stream.handler_name)
        if handler is None:
            # fixed label: the name is remote-controlled, and label values live
            # forever — a peer cycling fake names must not grow the registry
            _RPC_ERRORS.inc(handler="<unknown>", side="server")
            await stream.send_error(P2PHandlerError(f"unknown handler {stream.handler_name!r}"))
            await stream.close_send()
            return
        context = P2PContext(stream.handler_name, self.peer_id, stream.peer_id)
        started = time.perf_counter()
        bytes_in = bytes_out = 0
        # the OPEN frame may carry the remote caller's trace context: this
        # handler span then joins the caller's trace as a child, which is what
        # makes a cross-peer timeline reconstructable from per-peer recorders
        handler_trace = _trace(
            f"p2p.handle:{stream.handler_name}",
            remote_context=stream.trace_context,
            peer=str(self.peer_id),
            remote=str(stream.peer_id),
        )
        handler_trace.__enter__()
        try:
            if handler.stream_input:
                async def _counted_stream():
                    nonlocal bytes_in
                    async for message in stream.iter_messages():
                        bytes_in += len(message)
                        yield _parse(message, handler.request_type)

                request: Any = _counted_stream()
            else:
                raw_request = await stream.receive()
                bytes_in += len(raw_request)
                request = _parse(raw_request, handler.request_type)

            if handler.stream_output:
                result = handler.fn(request, context)
                if asyncio.iscoroutine(result):
                    result = await result
                async for response in result:
                    bytes_out += await _send_payload(stream, _serialize(response))
            else:
                response = await handler.fn(request, context)
                bytes_out += await _send_payload(stream, _serialize(response))
            await stream.close_send()
        except StreamClosedError:
            return  # peer reset/vanished mid-call: normal termination for a handler
        except asyncio.CancelledError:
            raise
        except Exception as e:
            _RPC_ERRORS.inc(handler=stream.handler_name, side="server")
            if handler_trace.span is not None:
                handler_trace.span.add_event("error", type=type(e).__name__)
            logger.debug(f"handler {stream.handler_name} failed: {e!r}")
            try:
                await stream.send_error(e)
                await stream.close_send()
            except StreamClosedError:
                pass
        finally:
            handler_trace.__exit__(None, None, None)
            _RPC_LATENCY.observe(time.perf_counter() - started, handler=stream.handler_name, side="server")
            if bytes_in:
                _RPC_BYTES.inc(bytes_in, handler=stream.handler_name, direction="in")
            if bytes_out:
                _RPC_BYTES.inc(bytes_out, handler=stream.handler_name, direction="out")

    # ------------------------------------------------------------------ calls

    async def _open_stream_with_redial(
        self, peer_id: PeerID, name: str, trace_context: Optional[bytes] = None
    ) -> MuxStream:
        """Open a stream, re-dialing once if the cached connection died between
        lookup and use (e.g. the connection manager trimmed it, or the peer
        restarted) — a trimmed idle connection must look like a cache miss, not
        an RPC failure."""
        conn = await self._get_connection(peer_id)
        try:
            return await conn.open_stream(name, trace_context)
        except StreamClosedError:
            conn = await self._get_connection(peer_id)
            return await conn.open_stream(name, trace_context)

    async def call_protobuf_handler(
        self,
        peer_id: PeerID,
        name: str,
        request,
        response_type: Optional[Type] = None,
        *,
        idempotent: bool = False,
    ):
        """Unary call: one request, one response.

        A failure while opening the stream or sending the request provably precedes
        delivery, so it is always retried once on a fresh connection (the LRU trim /
        peer-restart race). A failure while *waiting for the response* does not prove
        the handler never ran — the connection can die after the handler executed but
        before the response arrived — so that retry is gated on ``idempotent``:
        side-effectful calls (rpc_backward, rpc_decode) must fail loudly rather than
        risk double-applying an optimizer step or double-advancing a KV cache.
        """
        payload = _serialize(request)
        started = time.perf_counter()
        # client span: a child of whatever operation issued this RPC; its
        # (trace_id, span_id) ride the OPEN frame so the remote handler span
        # joins the same trace one level down. The with block (not manual
        # enter/exit) so a failed call carries its `error` event.
        with _trace(f"p2p.call:{name}", peer=str(self.peer_id), remote=str(peer_id)) as call_span:
            try:
                if _CHAOS.enabled:  # injection point: drop/delay/corrupt the outbound request
                    payload = await _CHAOS.inject(
                        "p2p.unary.send", payload=_chaos_payload(payload), scope=str(self.peer_id)
                    )
                for attempt in range(2):
                    stream = await self._open_stream_with_redial(
                        peer_id, name, None if call_span is None else call_span.context_bytes()
                    )
                    try:
                        try:
                            payload_len = await _send_payload(stream, payload)
                            await stream.close_send()
                        except StreamClosedError:
                            # the request never left: safe to retry for any RPC
                            if attempt == 0:
                                continue
                            raise P2PHandlerError(f"{name}: connection closed before request was sent") from None
                        try:
                            response = await stream.receive()
                        except RemoteError as e:
                            raise P2PHandlerError(str(e)) from e
                        except StreamClosedError:
                            # nothing was received, but the request WAS sent: the peer may
                            # or may not have processed it. Only retry when the caller
                            # declared the RPC idempotent (reads: rpc_info, DHT ping/find,
                            # or set-semantics writes like rpc_store).
                            if idempotent and attempt == 0 and stream._conn.is_closed:
                                continue
                            raise P2PHandlerError(
                                f"{name}: stream closed before response"
                                + ("" if idempotent else " (not retried: RPC not marked idempotent)")
                            ) from None
                        if _CHAOS.enabled:  # injection point: lose/corrupt the response
                            response = await _CHAOS.inject(
                                "p2p.unary.recv", payload=response, scope=str(self.peer_id)
                            )
                        _RPC_BYTES.inc(payload_len, handler=name, direction="out")
                        _RPC_BYTES.inc(len(response), handler=name, direction="in")
                        return _parse(response, response_type)
                    finally:
                        await stream.reset()
            except asyncio.CancelledError:
                raise
            except BaseException:
                _RPC_ERRORS.inc(handler=name, side="client")
                raise
            finally:
                _RPC_LATENCY.observe(time.perf_counter() - started, handler=name, side="client")

    async def iterate_protobuf_handler(
        self,
        peer_id: PeerID,
        name: str,
        requests,
        response_type: Optional[Type] = None,
    ) -> AsyncIterator:
        """Streaming call: ``requests`` is one message or an async iterator of them;
        yields response messages until the remote closes."""
        # a detached span (start_span, not trace): an async generator's body runs
        # in its consumer's context, so installing a contextvar here would leak
        # the span into the consumer between yields. It still parents to the
        # caller's current span and propagates its context to the remote handler.
        stream_span = _start_span(
            f"p2p.stream:{name}", peer=str(self.peer_id), remote=str(peer_id)
        )
        stream = await self._open_stream_with_redial(
            peer_id, name, None if stream_span is None else stream_span.context_bytes()
        )

        async def _feed():
            nonlocal bytes_out
            try:
                if hasattr(requests, "__aiter__"):
                    async for request in requests:
                        payload = _serialize(request)
                        if _CHAOS.enabled:  # injection point: per streamed request message
                            payload = await _CHAOS.inject(
                                "p2p.stream.send", payload=_chaos_payload(payload), scope=str(self.peer_id)
                            )
                        bytes_out += await _send_payload(stream, payload)
                else:
                    payload = _serialize(requests)
                    if _CHAOS.enabled:
                        payload = await _CHAOS.inject(
                            "p2p.stream.send", payload=_chaos_payload(payload), scope=str(self.peer_id)
                        )
                    bytes_out += await _send_payload(stream, payload)
                await stream.close_send()
            except (StreamClosedError, asyncio.CancelledError):
                pass
            except Exception:
                # the caller's request iterator failed: abort so neither side hangs;
                # the exception is re-raised to the consumer below via feeder.exception()
                await stream.reset()
                raise

        started = time.perf_counter()
        bytes_in = bytes_out = 0
        feeder = asyncio.create_task(_feed())
        try:
            while True:
                try:
                    message = await stream.receive()
                except StreamClosedError:
                    if feeder.done() and not feeder.cancelled() and feeder.exception() is not None:
                        _RPC_ERRORS.inc(handler=name, side="client")
                        raise feeder.exception()
                    return
                except RemoteError as e:
                    _RPC_ERRORS.inc(handler=name, side="client")
                    raise P2PHandlerError(str(e)) from e
                if _CHAOS.enabled:  # injection point: per streamed response message
                    message = await _CHAOS.inject(
                        "p2p.stream.recv", payload=message, scope=str(self.peer_id)
                    )
                bytes_in += len(message)
                yield _parse(message, response_type)
        finally:
            feeder.cancel()
            _finish_span(stream_span)
            _RPC_LATENCY.observe(time.perf_counter() - started, handler=name, side="client")
            if bytes_in:
                _RPC_BYTES.inc(bytes_in, handler=name, direction="in")
            if bytes_out:
                _RPC_BYTES.inc(bytes_out, handler=name, direction="out")
            await stream.reset()

    # ------------------------------------------------------------------ lifecycle

    async def list_peers(self) -> List[PeerID]:
        return [pid for pid, conn in self._connections.items() if not conn.is_closed]

    async def disconnect(self, peer_id: PeerID) -> None:
        conn = self._connections.pop(peer_id, None)
        if conn is not None:
            await conn.close()

    async def shutdown(self) -> None:
        self._alive_refs -= 1
        if self._alive_refs > 0:
            return
        self._shutting_down = True
        self._server.close()
        if self._inbound_proxy_writer is not None:
            # closing the control connection tears down the daemon's public listener
            self._inbound_proxy_writer.close()
            self._inbound_proxy_writer = None
        if self._native_daemon is not None:
            self._native_daemon.shutdown()
            self._native_daemon = None
        for relay in self._relays:
            await relay.close()
        self._relays.clear()
        tasks = list(self._bg_tasks)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        # loop until drained: a connection may land (accepted before server.close, e.g.
        # a peer's hole-punch dial) while earlier closes are awaited
        while self._all_connections:
            for conn in list(self._all_connections):
                await conn.close()
                self._all_connections.discard(conn)  # lint: single-writer — shutdown runs once
        self._connections.clear()
        try:
            # py3.12 wait_closed waits for every server-spawned transport; a peer
            # whose handshake is still mid-flight holds one open, so bound the wait
            await asyncio.wait_for(self._server.wait_closed(), timeout=3.0)
        except Exception:
            pass
        if self._identity_lock_fd is not None:
            os.close(self._identity_lock_fd)  # releases the identity flock
            self._identity_lock_fd = None

    def __repr__(self):
        return f"P2P({self.peer_id}, port={self._listen_port}, handlers={len(self._handlers)})"
