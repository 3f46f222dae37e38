"""Message-oriented stream multiplexing over one secure channel per peer pair (the
port's copy of hivemind_tpu/p2p/mux.py): lightweight in-process streams over a
single encrypted TCP connection. Frames are whole messages (an RPC message = one
frame).

Mux frame layout (inside the AEAD envelope): [u64 stream_id][u8 flags][payload].
Flags: OPEN (payload = handler name utf-8, optionally followed by NUL + a 16-byte
trace context — handler names never contain NUL), DATA (payload = message), CLOSE
(graceful end-of-stream from that side), RESET (abort), ERROR (payload = msgpack
error info). The trace context (telemetry/tracing.py pack_context) is how a
server-side handler span becomes a child of the remote caller's span; absent
when the caller has no active span, ignored when malformed.
Flow control: per-stream inboxes are unbounded (the read loop never head-of-line-blocks
one stream on another), with a per-connection buffered-bytes cap as the memory backstop
— a peer that overruns it loses the connection, not the process. TCP backpressure plus
eager reads in the RPC layer keep buffers small in practice.
"""

from __future__ import annotations

import asyncio
import struct
import time
from enum import IntFlag
from typing import AsyncIterator, Awaitable, Callable, Dict, Optional, Union

# what receive() yields: bytes for locally-generated items, a zero-copy memoryview
# of the decrypted wire frame for DATA payloads
Message = Union[bytes, memoryview]

from hivemind_tpu_torch.p2p.crypto_channel import SecureChannel
from hivemind_tpu_torch.telemetry.tracing import unpack_context
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

_HEADER = struct.Struct(">QB")

# one RPC message per frame; larger payloads must be chunked by the caller
# (parity: reference DEFAULT_MAX_MSG_SIZE, p2p_daemon_bindings/control.py:36-39)
MAX_MESSAGE_SIZE = 4 * 1024 * 1024


class Flags(IntFlag):
    OPEN = 1
    DATA = 2
    CLOSE = 4
    RESET = 8
    ERROR = 16


class StreamClosedError(ConnectionError):
    """The stream (or its connection) closed before the operation completed."""


class RemoteError(RuntimeError):
    """The remote handler raised an exception; carries its type name and message."""

    def __init__(self, type_name: str, message: str):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.remote_message = message


_EOF = object()


class MuxStream:
    """One bidirectional message stream. ``send``/``receive`` whole byte messages.

    Inboxes are unbounded so the connection read loop never head-of-line-blocks on a
    slow consumer; memory is bounded per connection (``MuxConnection.max_buffered_bytes``)
    — exceeding it kills the whole connection rather than stalling unrelated streams.
    """

    def __init__(self, conn: "MuxConnection", stream_id: int, handler_name: str):
        self._conn = conn
        self.stream_id = stream_id
        self.handler_name = handler_name
        self.trace_context = None  # (trace_id, span_id) from the remote OPEN, if any
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._recv_closed = False
        self._send_closed = False
        self._reset = False
        self._inbox_bytes = 0  # bytes currently debited against the connection cap

    @property
    def peer_id(self):
        return self._conn.peer_id

    async def send(self, message: bytes, *extra: bytes) -> None:
        """Send one message; ``extra`` buffers travel scatter-gather with it as a
        single frame (a spliced protobuf's tensor buffers ride uncopied into the
        AEAD — the serving-path analog of the averaging framing)."""
        if self._send_closed or self._reset:
            raise StreamClosedError(f"stream {self.stream_id} is closed for sending")
        total = len(message) + sum(len(part) for part in extra)
        if total > MAX_MESSAGE_SIZE:
            raise ValueError(
                f"message of {total} bytes exceeds MAX_MESSAGE_SIZE={MAX_MESSAGE_SIZE}; "
                f"split large tensors with utils.streaming.split_for_streaming"
            )
        await self._conn.send_frame(self.stream_id, Flags.DATA, message, *extra)

    async def send_error(self, exc: BaseException) -> None:
        if self._send_closed or self._reset:
            return
        payload = MSGPackSerializer.dumps({"type": type(exc).__name__, "message": str(exc)})
        await self._conn.send_frame(self.stream_id, Flags.ERROR, payload)

    async def close_send(self) -> None:
        """Half-close: no more messages from this side."""
        if not self._send_closed and not self._reset:
            self._send_closed = True
            try:
                await self._conn.send_frame(self.stream_id, Flags.CLOSE, b"")
            except (ConnectionError, StreamClosedError):
                pass

    async def reset(self) -> None:
        if not self._reset:
            self._reset = True
            self._send_closed = True
            try:
                await self._conn.send_frame(self.stream_id, Flags.RESET, b"")
            except (ConnectionError, StreamClosedError):
                pass
            self._push_eof()
            self._conn._forget_stream(self.stream_id)

    async def receive(self) -> Message:
        """Next message (bytes-like: may be a zero-copy memoryview of the wire
        frame); raises StreamClosedError at end-of-stream, RemoteError if the peer's
        handler failed."""
        if self._recv_closed:
            raise StreamClosedError(f"stream {self.stream_id}: receive side closed")
        item = await self._inbox.get()
        if isinstance(item, (bytes, bytearray, memoryview)) and self._inbox_bytes > 0:
            self._inbox_bytes -= len(item)
            self._conn._credit_bytes(len(item))
        if item is _EOF:
            self._recv_closed = True
            raise StreamClosedError(f"stream {self.stream_id} ended")
        if isinstance(item, RemoteError):
            self._recv_closed = True
            raise item
        return item

    async def __aiter__(self) -> AsyncIterator[Message]:
        while True:
            try:
                yield await self.receive()
            except StreamClosedError:
                return

    def iter_messages(self) -> AsyncIterator[Message]:
        return self.__aiter__()

    def _push(self, item) -> None:
        if isinstance(item, (bytes, bytearray, memoryview)):
            self._inbox_bytes += len(item)
        self._inbox.put_nowait(item)  # unbounded: never blocks the read loop

    def _push_eof(self) -> None:
        self._inbox.put_nowait(_EOF)

    def _return_credit(self) -> None:
        """Credit back all undrained inbox bytes (stream reset/forgotten)."""
        if self._inbox_bytes > 0:
            self._conn._credit_bytes(self._inbox_bytes)
            self._inbox_bytes = 0


class MuxConnection:
    """All streams between this node and one peer, over one SecureChannel."""

    def __init__(
        self,
        channel: SecureChannel,
        peer_id,
        is_initiator: bool,
        on_inbound_stream: Callable[[MuxStream], Awaitable[None]],
        max_buffered_bytes: int = 256 * 1024 * 1024,
    ):
        self._channel = channel
        self.peer_id = peer_id
        self._next_stream_id = 1 if is_initiator else 2
        self._streams: Dict[int, MuxStream] = {}
        self._on_inbound_stream = on_inbound_stream
        self._closed = False
        self._read_task: Optional[asyncio.Task] = None
        self._handler_tasks: set = set()
        # stream_id -> running inbound handler task: a peer's RESET cancels the
        # handler mid-compute (a hedged request's losing server must stop working
        # on an answer nobody will read, not just fail its send)
        self._stream_handler_tasks: Dict[int, asyncio.Task] = {}
        self._buffered_bytes = 0
        self._max_buffered_bytes = max_buffered_bytes
        self.last_used = time.monotonic()  # LRU key for the connection manager

    def _credit_bytes(self, nbytes: int) -> None:
        self._buffered_bytes -= nbytes

    def start(self) -> None:
        self._read_task = spawn(self._read_loop(), name="mux.read_loop")

    @property
    def is_closed(self) -> bool:
        return self._closed

    async def open_stream(
        self, handler_name: str, trace_context: Optional[bytes] = None
    ) -> MuxStream:
        if self._closed:
            raise StreamClosedError(f"connection to {self.peer_id} is closed")
        stream_id = self._next_stream_id
        self._next_stream_id += 2
        stream = MuxStream(self, stream_id, handler_name)
        self._streams[stream_id] = stream
        if trace_context is not None:
            await self.send_frame(
                stream_id, Flags.OPEN, handler_name.encode("utf-8"), b"\x00", trace_context
            )
        else:
            await self.send_frame(stream_id, Flags.OPEN, handler_name.encode("utf-8"))
        return stream

    @property
    def num_streams(self) -> int:
        return len(self._streams)

    async def send_frame(self, stream_id: int, flags: Flags, *payload: bytes) -> None:
        """Send one frame; the payload may arrive as several buffers which travel
        scatter-gather all the way into the AEAD (no header+payload concat here)."""
        if self._closed:
            raise StreamClosedError(f"connection to {self.peer_id} is closed")
        self.last_used = time.monotonic()
        try:
            await self._channel.send(_HEADER.pack(stream_id, int(flags)), *payload)
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            await self._shutdown(e)
            raise StreamClosedError(f"connection to {self.peer_id} lost: {e}") from e

    async def _read_loop(self) -> None:
        error: Optional[BaseException] = None
        try:
            while True:
                frame = await self._channel.recv()
                stream_id, flags = _HEADER.unpack_from(frame)
                # zero-copy: DATA payloads ride to their consumer as a view of the
                # decrypted frame instead of re-materializing frame[9:] per message
                payload = memoryview(frame)[_HEADER.size :]
                await self._dispatch(stream_id, Flags(flags), payload)
        except (ConnectionError, OSError, asyncio.IncompleteReadError, EOFError) as e:
            error = e
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.warning(f"connection to {self.peer_id}: read loop failed with {e!r}")
            error = e
        finally:
            await self._shutdown(error)

    async def _dispatch(self, stream_id: int, flags: Flags, payload) -> None:
        # ``payload`` is a memoryview into the decrypted frame; the rare control
        # frames (OPEN/ERROR) materialize it, DATA frames pass the view through
        self.last_used = time.monotonic()
        if flags & Flags.OPEN:
            # a remote OPEN must use the REMOTE side's id parity and a fresh id: a
            # misbehaving peer reusing a local-parity or existing id would silently
            # replace a live stream in _streams, misrouting its responses and
            # orphaning its credit accounting
            if stream_id % 2 == self._next_stream_id % 2 or stream_id in self._streams:
                logger.warning(
                    f"connection to {self.peer_id}: rejecting OPEN with "
                    f"{'local-parity' if stream_id % 2 == self._next_stream_id % 2 else 'duplicate'} "
                    f"stream id {stream_id}"
                )
                await self.send_frame(stream_id, Flags.RESET, b"")
                return
            name_bytes, _nul, trace_raw = bytes(payload).partition(b"\x00")
            handler_name = name_bytes.decode("utf-8", errors="replace")
            stream = MuxStream(self, stream_id, handler_name)
            if trace_raw:
                stream.trace_context = unpack_context(trace_raw)
            self._streams[stream_id] = stream
            task = spawn(self._on_inbound_stream(stream), name="mux.inbound_stream")
            self._handler_tasks.add(task)
            self._stream_handler_tasks[stream_id] = task

            def _forget_handler(finished, *, stream_id=stream_id):
                self._handler_tasks.discard(finished)
                if self._stream_handler_tasks.get(stream_id) is finished:
                    self._stream_handler_tasks.pop(stream_id, None)

            task.add_done_callback(_forget_handler)
            return
        stream = self._streams.get(stream_id)
        if stream is None:
            return  # already reset/forgotten
        if flags & Flags.DATA:
            self._buffered_bytes += len(payload)
            if self._buffered_bytes > self._max_buffered_bytes:
                logger.warning(
                    f"connection to {self.peer_id}: buffered {self._buffered_bytes} bytes "
                    f"exceeds cap; closing connection"
                )
                raise ConnectionError("per-connection buffer cap exceeded")
            stream._push(payload)
        if flags & Flags.ERROR:
            try:
                info = MSGPackSerializer.loads(bytes(payload))
                stream._push(RemoteError(info.get("type", "RemoteError"), info.get("message", "")))
            except Exception:
                stream._push(RemoteError("RemoteError", "malformed error payload"))
        if flags & (Flags.CLOSE | Flags.RESET):
            stream._push_eof()
            if flags & Flags.RESET:
                # peer aborted: local side must stop sending immediately
                stream._reset = True
                stream._send_closed = True
                self._forget_stream(stream_id)
                # ...and stop COMPUTING: a still-running inbound handler for
                # this stream is work nobody will read (a hedge's losing
                # request, an abandoned call). A handler that already finished
                # is no longer in the map — its completed response stands.
                handler_task = self._stream_handler_tasks.pop(stream_id, None)
                if handler_task is not None and not handler_task.done():
                    handler_task.cancel()

    def _forget_stream(self, stream_id: int) -> None:
        stream = self._streams.pop(stream_id, None)
        if stream is not None:
            stream._return_credit()

    async def _shutdown(self, error: Optional[BaseException]) -> None:
        if self._closed:
            return
        self._closed = True
        for stream in list(self._streams.values()):
            stream._push_eof()  # guaranteed: queue is unbounded
            stream._return_credit()
        self._streams.clear()
        self._channel.close()

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
        await self._shutdown(None)
        for task in list(self._handler_tasks):
            task.cancel()
        await self._channel.wait_closed()
