"""Authenticated encrypted channel over a TCP connection (the port's copy of
hivemind_tpu/p2p/crypto_channel.py; the same handshake and frames, so a port
peer and a JAX peer talk to each other).

1. both sides exchange a plaintext hello: {ed25519 static pub, x25519 ephemeral pub,
   sig = Ed25519_sign(transcript_prefix || payload)}, proving static-key possession;
   the hello is msgpack, written by the port's own codec.
2. shared secret = X25519(own ephemeral, peer ephemeral); two ChaCha20-Poly1305 keys
   are derived with HKDF-SHA256 (one per direction), giving forward secrecy.
3. both sides send and check a sealed "confirm" frame (key confirmation); every
   later frame is AEAD-sealed with a per-direction 64-bit counter nonce.

Frame wire format: [u32 big-endian ciphertext length][ciphertext].

The primitives are the libcrypto shim's (``utils/_libcrypto.py``) on every
machine; without libcrypto every handshake raises, naming the library, and
nothing falls back to plaintext. Both directions are pipelined: ``send`` assigns
the nonce and enqueues the seal, a writer task emits ciphertexts strictly in
nonce order, and the reader task prefetches and unseals ahead of ``recv``. Frames
above ``_OFFLOAD_THRESHOLD`` are sealed and opened in a shared thread pool of
``min(4, cpu_count)`` threads (none on a one-core host): ctypes releases the GIL
during each libcrypto call, so k frames use k cores. In-flight frames are bounded
both ways (send semaphore, bounded prefetch queue), so memory stays capped and
TCP backpressure propagates to callers.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

from hivemind_tpu_torch.utils._libcrypto import (
    ChaCha20Poly1305,
    InvalidTag,
    X25519PrivateKey,
    X25519PublicKey,
    hkdf_sha256,
)
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

MAX_FRAME_SIZE = 16 * 1024 * 1024  # hard cap on one encrypted frame
_HANDSHAKE_PREFIX = b"hivemind-tpu-noise-v1:"

# frames at least this large have their AEAD offloaded to the worker pool; smaller
# ones are sealed inline (executor hop costs more than the cipher call)
_OFFLOAD_THRESHOLD = 128 * 1024
_MAX_INFLIGHT_SEND = 16  # per channel; bounds sender memory at 16 frames
_RECV_PREFETCH = 8  # frames unsealed ahead of recv(); bounds receiver memory

_aead_executor: Optional[ThreadPoolExecutor] = None


def _get_aead_executor() -> Optional[ThreadPoolExecutor]:
    """The shared AEAD pool, made at first use (None on a one-core host)."""
    global _aead_executor
    count = os.cpu_count() or 1
    if count <= 1:
        return None
    if _aead_executor is None:
        _aead_executor = ThreadPoolExecutor(max_workers=min(4, count), thread_name_prefix="hmtpu-torch-aead")
    return _aead_executor


class HandshakeError(RuntimeError):
    pass


class SecureChannel:
    """Length-prefixed AEAD frames over an asyncio stream pair. Use ``handshake`` to
    construct. ``send``/``recv`` exchange whole messages (frames)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_key: bytes,
        recv_key: bytes,
        peer_public_key: Ed25519PublicKey,
    ):
        self._reader = reader
        self._writer = writer
        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)
        self._send_counter = 0
        self._recv_counter = 0
        self.peer_public_key = peer_public_key
        # ordered pipelines (see module docstring); tasks start lazily so a channel
        # that fails mid-handshake never spawns them without a closer
        self._send_queue: asyncio.Queue = asyncio.Queue()
        self._send_sem = asyncio.Semaphore(_MAX_INFLIGHT_SEND)
        self._send_error: Optional[BaseException] = None
        self._writer_task: Optional[asyncio.Task] = None
        self._recv_queue: asyncio.Queue = asyncio.Queue(maxsize=_RECV_PREFETCH)
        self._recv_error: Optional[BaseException] = None
        self._recv_stopped = False  # auth failure: no frame past it may be delivered
        self._reader_task: Optional[asyncio.Task] = None
        self._closed = False

    # ------------------------------------------------------------------ send side

    async def send(self, payload: bytes, *extra_buffers: bytes) -> None:
        """Seal and send one frame. The plaintext is the concatenation of all given
        buffers — scatter-gather: callers framing a header in front of a large
        payload pass both instead of concatenating (the AEAD walks the pieces;
        only the ciphertext output is a fresh buffer)."""
        if self._send_error is not None:
            raise self._send_failed()
        total_len = len(payload) + sum(len(buffer) for buffer in extra_buffers)
        # size check BEFORE the counter moves: raising after an increment would
        # desynchronize AEAD nonces and poison the whole connection
        if total_len + 16 > MAX_FRAME_SIZE:  # +16: poly1305 tag
            raise ValueError(f"frame too large: {total_len} > {MAX_FRAME_SIZE - 16}")
        await self._send_sem.acquire()
        if self._send_error is not None:
            self._send_sem.release()
            raise self._send_failed()
        # no await between the counter assignment and the enqueue: nonce order and
        # wire order are decided atomically on the event loop
        nonce = struct.pack("<4xQ", self._send_counter)
        self._send_counter += 1
        executor = _get_aead_executor()
        if executor is not None and total_len >= _OFFLOAD_THRESHOLD:
            sealed = asyncio.get_running_loop().run_in_executor(
                executor, self._seal, nonce, payload, extra_buffers
            )
        else:
            sealed = self._seal(nonce, payload, extra_buffers)
        if self._writer_task is None:
            self._writer_task = spawn(self._writer_loop(), name="crypto_channel.writer_loop")
        self._send_queue.put_nowait(sealed)

    def _seal(self, nonce: bytes, payload: bytes, extra_buffers: Tuple[bytes, ...]) -> bytearray:
        return self._send_aead.encrypt_parts(nonce, (payload, *extra_buffers))

    def _send_failed(self) -> ConnectionError:
        error = self._send_error
        if isinstance(error, (ConnectionError, OSError)):
            return error  # type: ignore[return-value]
        return ConnectionError(f"secure channel send failed: {error!r}")

    def _fail_send(self, error: BaseException) -> None:
        if self._send_error is None:
            self._send_error = error
        # wake every sender parked on the in-flight semaphore
        for _ in range(_MAX_INFLIGHT_SEND):
            self._send_sem.release()

    async def _writer_loop(self) -> None:
        try:
            while True:
                sealed = await self._send_queue.get()
                if sealed is None:
                    return
                ciphertext = (await sealed) if asyncio.isfuture(sealed) else sealed
                header = struct.pack(">I", len(ciphertext))
                if len(ciphertext) >= _OFFLOAD_THRESHOLD:
                    # two writes skip the megabyte-scale header+body concat copy
                    self._writer.write(header)
                    self._writer.write(ciphertext)
                else:
                    self._writer.write(header + ciphertext)
                self._send_sem.release()
                # drain() is a no-op below the transport high-water mark; above it,
                # this is where TCP backpressure propagates: writer blocks → queue
                # fills → the in-flight semaphore parks the senders
                await self._writer.drain()
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            self._fail_send(e)

    # ------------------------------------------------------------------ recv side

    async def recv(self) -> bytes:
        if self._reader_task is None:
            self._reader_task = spawn(self._reader_loop(), name="crypto_channel.reader_loop")
        while True:
            if self._recv_stopped or (self._recv_error is not None and self._recv_queue.empty()):
                raise self._recv_error
            opened = await self._recv_queue.get()
            if opened is None:  # reader loop ended; the stored error says why
                # one sentinel must serve EVERY concurrent recv(): re-enqueue it so
                # a second parked waiter wakes and raises too instead of hanging
                with contextlib.suppress(asyncio.QueueFull):
                    self._recv_queue.put_nowait(None)  # lint: single-writer — sentinel re-enqueue is idempotent
                if self._recv_error is not None:
                    raise self._recv_error
                continue
            try:
                return (await opened) if asyncio.isfuture(opened) else opened
            except HandshakeError:
                # the prefetch queue is FIFO, so frames behind the tampered one sit
                # behind this failure: stop delivery for good (a clean reader death
                # still drains prefetched VALID frames — only auth failure stops)
                self._recv_stopped = True
                raise
            except InvalidTag:
                # defensive: _open_offloaded normally converts + poisons already
                error = HandshakeError("AEAD authentication failed (corrupted or replayed frame)")
                self._recv_stopped = True
                self._poison(error)
                raise error

    def _poison(self, error: BaseException) -> None:
        """Fatal receive-side failure: kill BOTH directions and stop the reader.
        Authentication failure must be fatal regardless of frame size — nonces are
        counters, so if the channel survived one InvalidTag, later frames would
        still authenticate and an on-path attacker could selectively delete a
        frame by corrupting it."""
        if self._recv_error is None:
            self._recv_error = error
        self._fail_send(error)
        if self._reader_task is not None and not self._reader_task.done():
            self._reader_task.cancel()
        if self._writer_task is not None:
            self._send_queue.put_nowait(None)
        with contextlib.suppress(asyncio.QueueFull):
            self._recv_queue.put_nowait(None)

    async def _open_offloaded(self, future: "asyncio.Future[bytes]") -> bytes:
        try:
            return await future
        except InvalidTag:
            error = HandshakeError("AEAD authentication failed (corrupted or replayed frame)")
            self._poison(error)
            raise error from None

    async def _reader_loop(self) -> None:
        error: BaseException
        try:
            while True:
                header = await self._reader.readexactly(4)
                (length,) = struct.unpack(">I", header)
                if length > MAX_FRAME_SIZE:
                    raise HandshakeError(f"oversized frame: {length}")
                ciphertext = await self._reader.readexactly(length)
                nonce = struct.pack("<4xQ", self._recv_counter)
                self._recv_counter += 1  # lint: single-writer — sole reader loop owns the nonce
                executor = _get_aead_executor()
                if executor is not None and length >= _OFFLOAD_THRESHOLD:
                    # wrap the executor future so an InvalidTag poisons the channel
                    # the moment the decrypt finishes — even if recv() never awaits
                    # this particular frame
                    opened = asyncio.ensure_future(
                        self._open_offloaded(
                            asyncio.get_running_loop().run_in_executor(
                                executor, self._recv_aead.decrypt, nonce, ciphertext
                            )
                        )
                    )
                    # mark a never-awaited failure as retrieved (recv may have
                    # already raised on an earlier frame and stopped consuming)
                    opened.add_done_callback(lambda t: t.cancelled() or t.exception())
                else:
                    try:
                        opened = self._recv_aead.decrypt(nonce, ciphertext)
                    except InvalidTag:
                        raise HandshakeError(
                            "AEAD authentication failed (corrupted or replayed frame)"
                        )
                await self._recv_queue.put(opened)  # bounded: backpressures the socket
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            error = e
        if self._recv_error is None:  # don't overwrite an earlier poison error
            self._recv_error = error
        # a dead connection must also stop the writer (it may be parked on its queue)
        self._fail_send(error)
        if self._writer_task is not None:
            self._send_queue.put_nowait(None)
        await self._recv_queue.put(None)  # wake a parked recv()

    # ------------------------------------------------------------------ lifecycle

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fail_send(ConnectionError("secure channel closed"))
        if self._recv_error is None:
            self._recv_error = ConnectionError("secure channel closed")
        for task in (self._writer_task, self._reader_task):
            if task is not None:
                task.cancel()
        with contextlib.suppress(Exception):
            self._recv_queue.put_nowait(None)  # wake a parked recv()
        try:
            self._writer.close()
        except Exception:
            pass

    async def wait_closed(self) -> None:
        try:
            await self._writer.wait_closed()
        except Exception:
            pass


async def _send_plain(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(struct.pack(">I", len(payload)) + payload)
    await writer.drain()


async def _recv_plain(reader: asyncio.StreamReader, max_size: int = 4096) -> bytes:
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    if length > max_size:
        raise HandshakeError(f"oversized handshake frame: {length}")
    return await reader.readexactly(length)


async def handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    identity: Ed25519PrivateKey,
    is_initiator: bool,
    announced_addrs: Optional[list] = None,
    timeout: float = 15.0,
) -> Tuple[SecureChannel, dict]:
    """Perform the mutual-authentication handshake. Returns (channel, peer_hello_extras)
    where extras carries the peer's announced listen addresses."""

    async def _run() -> Tuple[SecureChannel, dict]:
        ephemeral = X25519PrivateKey.generate()
        eph_pub = ephemeral.public_key().public_bytes_raw()
        # the signature covers the ENTIRE hello payload (not just the ephemeral), so a
        # MITM cannot rewrite the announced addresses without failing verification
        static_pub = identity.get_public_key().to_bytes()
        addrs = [str(a) for a in (announced_addrs or [])]
        signed_payload = MSGPackSerializer.dumps([static_pub, eph_pub, addrs, 1])
        hello = {
            "payload": signed_payload,
            "sig": identity.sign(_HANDSHAKE_PREFIX + signed_payload),
        }
        await _send_plain(writer, MSGPackSerializer.dumps(hello))
        peer_hello_outer = MSGPackSerializer.loads(await _recv_plain(reader))

        peer_payload = peer_hello_outer["payload"]
        peer_static_bytes, peer_eph_bytes, peer_addrs, peer_version = MSGPackSerializer.loads(peer_payload)
        peer_static = Ed25519PublicKey.from_bytes(peer_static_bytes)
        if not peer_static.verify(_HANDSHAKE_PREFIX + peer_payload, peer_hello_outer["sig"]):
            raise HandshakeError("peer failed static key proof")
        peer_hello = {"static": peer_static_bytes, "ephemeral": peer_eph_bytes, "addrs": peer_addrs}

        peer_eph = X25519PublicKey.from_public_bytes(peer_hello["ephemeral"])
        shared = ephemeral.exchange(peer_eph)
        okm = hkdf_sha256(shared, 64, salt=b"hivemind-tpu-hs", info=b"channel-keys")
        initiator_key, responder_key = okm[:32], okm[32:]
        send_key, recv_key = (
            (initiator_key, responder_key) if is_initiator else (responder_key, initiator_key)
        )
        channel = SecureChannel(reader, writer, send_key, recv_key, peer_static)
        # key confirmation: proves the peer holds the ephemeral private key, which a
        # replayed hello cannot (helloes alone are replayable — sig covers only the
        # static prefix + own ephemeral). Both sides send first, then verify.
        try:
            await channel.send(b"confirm")
            if await channel.recv() != b"confirm":
                raise HandshakeError("peer failed key confirmation")
        except BaseException:
            channel.close()  # reap the pipeline tasks the confirm exchange started
            raise
        return channel, {"addrs": peer_hello.get("addrs", []), "static": peer_hello["static"]}

    try:
        return await asyncio.wait_for(_run(), timeout=timeout)
    except (ValueError, KeyError, TypeError, IndexError, struct.error) as e:
        # a malformed/hostile hello (bad msgpack, wrong shapes, junk key bytes)
        # must read as a handshake failure the acceptor already handles — not
        # crash the per-connection task with an unretrieved msgpack error
        raise HandshakeError(f"malformed handshake from peer: {e!r}") from e
