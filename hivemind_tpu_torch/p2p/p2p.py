"""The P2P node: listeners, dialing, handler registry, unary + streaming RPC (the
port's copy of hivemind_tpu/p2p/p2p.py, on the same wire).

The transport runs in-process on asyncio: one encrypted multiplexed TCP connection
per peer pair carries all RPCs, unary and streaming. This copy dials direct TCP
only. Relays, NAT traversal and the native transport daemon (``relays=``,
``native_transport=True``, ``data_proxy_*``, ``inbound_data_proxy``) come with a
later slice of the port, and until then those arguments raise
``NotImplementedError``. No environment variable selects a transport.
"""

from __future__ import annotations

import asyncio
import os
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
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import finish_span as _finish_span
from hivemind_tpu_torch.telemetry.tracing import start_span as _start_span
from hivemind_tpu_torch.telemetry.tracing import trace as _trace
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
        """``max_connections``: connection-manager high water. 0 disables. Above
        it, idle (stream-less) connections are closed least-recently-used-first
        down to 90% of the cap; a trimmed peer is simply re-dialed on next use.

        ``relays``, ``data_proxy_port``, ``data_proxy_path``,
        ``inbound_data_proxy`` and ``native_transport=True`` belong to the relay,
        NAT and native-transport modules, which a later slice of the port brings:
        until then they raise ``NotImplementedError``."""
        later = [name for name, value in (("relays", tuple(relays)), ("data_proxy_port", data_proxy_port),
                                          ("data_proxy_path", data_proxy_path),
                                          ("inbound_data_proxy", inbound_data_proxy),
                                          ("native_transport", native_transport)) if value]
        if later:
            raise NotImplementedError(
                f"P2P.create({', '.join(later)}=...): relays, NAT traversal and the native transport are not "
                f"ported yet (hivemind_tpu_torch/p2p dials direct TCP); they come with the relay/NAT slice"
            )
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
        self._alive_refs = 1  # P2P.replicate: shared instance refcount
        self._max_connections = max_connections
        self._shutting_down = False
        self._listen_host = listen_host
        self._announce_host = announce_host or listen_host
        # port-forwarded deployments: the externally visible port can differ from the bound one
        self._announce_port = announce_port

        self._server = None
        try:
            self._server = await asyncio.start_server(self._on_inbound_connection, listen_host, listen_port)
            self._listen_port = self._server.sockets[0].getsockname()[1]
            logger.debug(f"P2P {self.peer_id} listening on {listen_host}:{self._listen_port}")

            for maddr in initial_peers:
                maddr = Multiaddr.parse(maddr) if isinstance(maddr, str) else maddr
                try:
                    await self.connect(maddr)
                except Exception as e:
                    logger.warning(f"could not reach initial peer {maddr}: {e}")
        except BaseException:
            # any failure mid-create must not leak the listener, peer connections
            # already established, or the identity flock ("taken") for the process
            if self._server is not None:
                self._server.close()
            for conn in list(self._all_connections):
                try:
                    await asyncio.shield(conn.close())
                except BaseException:
                    pass  # best-effort: cancellation must not strand later closes
            if self._identity_lock_fd is not None:
                os.close(self._identity_lock_fd)
            raise
        return self

    # ------------------------------------------------------------------ identity

    class IdentityTakenError(RuntimeError):
        """Another live process already uses this identity file."""

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

    async def _on_inbound_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self._shutting_down:
            writer.close()
            return
        try:
            channel, extras = await handshake(
                reader, writer, self.identity, is_initiator=False,
                announced_addrs=self.get_visible_maddrs(),
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
        high water mark. Never touches connections with live streams."""
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

    async def _dial(self, maddr: Multiaddr, expected_peer: Optional[PeerID]) -> MuxConnection:
        """Dial one address (direct TCP)."""
        if maddr.host_proto not in self._DIALABLE_PROTOS:
            # peer-announced unix/onion3 addresses parse (codec parity) but the
            # TCP transport cannot reach them: fail instantly, so an attacker
            # announcing them cannot burn a dial timeout per reconnect attempt
            raise ConnectionError(f"no transport for {maddr.host_proto!r} address {maddr}")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(maddr.host, maddr.port), timeout=self._dial_timeout
        )
        try:
            channel, extras = await handshake(
                reader, writer, self.identity, is_initiator=True, announced_addrs=self.get_visible_maddrs()
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
            channel.close()
            return existing
        conn = MuxConnection(channel, peer_id, is_initiator=True, on_inbound_stream=self._route_stream)
        self._connections[peer_id] = conn
        self._all_connections.add(conn)
        conn.start()
        await self._trim_connections(protect=conn)
        return conn

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
            raise PeerNotFoundError(f"no reachable address for {peer_id}") from last_error

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

    async def shutdown(self) -> None:
        self._alive_refs -= 1
        if self._alive_refs > 0:
            return
        self._shutting_down = True
        self._server.close()
        # loop until drained: a connection may land (accepted before server.close)
        # while earlier closes are awaited
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
