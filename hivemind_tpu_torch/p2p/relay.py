"""Client of the relay daemon (the port's copy of hivemind_tpu/p2p/relay.py, on the
same frames; the daemon is ``native/hm_relayd.cpp``): the circuit-relay capability.
A firewalled peer registers over an OUTBOUND connection and becomes dialable as
``/ip4/<relay>/tcp/<port>/p2p-circuit/p2p/<peer>``. The relay splices raw bytes;
the normal end-to-end handshake runs straight through it, so the relay never sees
plaintext.

Control traffic (REGISTER/PROOF/DIAL/ACCEPT/INCOMING/WHOAMI) runs over an encrypted
channel to the relay itself: an 'H' handshake (X25519 ECDH, the relay's Ed25519
identity signature, HKDF-SHA256 keys, ChaCha20-Poly1305 frames) keeps dial tokens
and registration proofs opaque to on-path observers, and pinning the relay's
identity (``relay_pubkey=``) defeats a proxying relay replaying proofs elsewhere.
The primitives are the libcrypto shim's (``utils/_libcrypto.py``)."""

from __future__ import annotations

import asyncio
import base64
import contextlib
import os
import struct
from typing import Optional, Set, Tuple

from hivemind_tpu_torch.p2p.crypto_channel import HandshakeError, handshake
from hivemind_tpu_torch.p2p.mux import MuxConnection
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.utils._libcrypto import (
    ChaCha20Poly1305,
    Ed25519PublicKey as RawEd25519PublicKey,
    InvalidSignature,
    InvalidTag,
    X25519PrivateKey,
    X25519PublicKey,
    hkdf_sha256,
)
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.crypto import Ed25519PublicKey
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_HS_PREFIX = b"hivemind-relay-hs:"


async def _send_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(struct.pack(">I", len(payload)) + payload)
    await writer.drain()


async def _recv_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    return await reader.readexactly(length)


class RelayChannel:
    """Control-frame transport to the relay: sealed (after the 'H' handshake) or
    plaintext (a daemon without libcrypto). ``relay_pubkey`` is the verified relay
    identity (raw 32 bytes) when sealed, else None."""

    def __init__(self, reader, writer, send_key=None, recv_key=None, relay_pubkey=None):
        self.reader, self.writer = reader, writer
        self._send_aead = ChaCha20Poly1305(send_key) if send_key is not None else None
        self._recv_aead = ChaCha20Poly1305(recv_key) if recv_key is not None else None
        self._send_ctr = 0
        self._recv_ctr = 0
        self.relay_pubkey = relay_pubkey

    @property
    def encrypted(self) -> bool:
        return self._send_aead is not None

    async def send_frame(self, payload: bytes) -> None:
        if self._send_aead is not None:
            nonce = struct.pack("<4xQ", self._send_ctr)
            self._send_ctr += 1
            payload = bytes(self._send_aead.encrypt(nonce, payload))
        await _send_frame(self.writer, payload)

    async def recv_frame(self) -> bytes:
        payload = await _recv_frame(self.reader)
        if self._recv_aead is not None:
            nonce = struct.pack("<4xQ", self._recv_ctr)
            self._recv_ctr += 1
            try:
                payload = bytes(self._recv_aead.decrypt(nonce, payload))
            except InvalidTag:
                # a tampered or desynced frame means the channel is dead: surface it as a
                # connection failure, which every caller already handles
                raise ConnectionError("relay control frame failed AEAD authentication") from None
        return payload

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self.writer.close()


# host:port endpoints that EVER completed an encrypted handshake in this process: once
# a relay has proven it does crypto, a later handshake "failure" is treated as an
# active downgrade attempt, not a legacy daemon
_ENCRYPTED_ENDPOINTS: Set[Tuple[str, int]] = set()


async def open_relay_channel(
    host: str, port: int, relay_pubkey: Optional[bytes] = None, allow_plaintext: bool = False,
) -> RelayChannel:
    """Connect and negotiate the encrypted control channel. Encrypted by default: a
    daemon that does not complete the handshake is refused unless the caller opts out
    with ``allow_plaintext=True`` for a legacy daemon, and even then a pinned
    ``relay_pubkey``, or an endpoint that ever completed an encrypted handshake in this
    process, still refuses, so an on-path attacker cannot strip encryption from an
    endpoint known to support it."""
    reader, writer = await asyncio.open_connection(host, port)
    ephemeral = X25519PrivateKey.generate()
    eph_pub = ephemeral.public_key().public_bytes_raw()
    legacy = False
    try:
        await _send_frame(writer, b"H" + eph_pub)
        response = await _recv_frame(reader)
        if response[:1] != b"S" or len(response) != 129:
            legacy = True
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        legacy = True  # a pre-handshake daemon closes on the unknown 'H' frame
    if legacy:
        with contextlib.suppress(Exception):
            writer.close()
        if relay_pubkey is not None:
            raise ConnectionError("relay does not support the encrypted control channel "
                                  "but a pinned identity was required")
        if (host, port) in _ENCRYPTED_ENDPOINTS:
            raise ConnectionError(
                f"relay {host}:{port} previously completed an encrypted handshake but now "
                f"fails it — refusing the plaintext downgrade (possible on-path attacker)"
            )
        if not allow_plaintext:
            raise ConnectionError(
                f"relay {host}:{port} did not complete the encrypted handshake; plaintext "
                f"control is refused by default — pass allow_plaintext=True only for a "
                f"trusted legacy daemon"
            )
        logger.warning(
            f"relay control channel to {host}:{port} is PLAINTEXT (explicitly allowed "
            f"via allow_plaintext=True; the daemon did not complete the encrypted handshake)"
        )
        reader, writer = await asyncio.open_connection(host, port)
        return RelayChannel(reader, writer)

    relay_eph, relay_pub, signature = response[1:33], response[33:65], response[65:129]
    try:
        RawEd25519PublicKey.from_public_bytes(relay_pub).verify(signature, _HS_PREFIX + eph_pub + relay_eph)
    except InvalidSignature:
        writer.close()
        raise ConnectionError("relay failed its identity proof") from None
    if relay_pubkey is not None and relay_pub != relay_pubkey:
        writer.close()
        raise ConnectionError(f"relay identity mismatch: expected {relay_pubkey.hex()}, got {relay_pub.hex()}")
    shared = ephemeral.exchange(X25519PublicKey.from_public_bytes(relay_eph))
    _ENCRYPTED_ENDPOINTS.add((host, port))
    okm = hkdf_sha256(shared, 64, salt=b"hivemind-relay-hs", info=b"control")
    # the client->relay key first, relay->client second (mirrors the daemon)
    return RelayChannel(reader, writer, send_key=okm[:32], recv_key=okm[32:], relay_pubkey=relay_pub)


async def register_control(channel: RelayChannel, peer_id_bytes: bytes, identity) -> bytes:
    """Run the relay REGISTER exchange, answering the daemon's Ed25519 challenge
    ('C' + 32B nonce -> 'P' + raw pubkey + raw signature over
    ``"hivemind-relay-register:" + challenge + peer_id``). Returns the final frame
    ('O' on success). A valid proof also reclaims the peer_id from a stale control
    line: only the key owner can evict a registration."""
    await channel.send_frame(b"R" + peer_id_bytes)
    response = await channel.recv_frame()
    if response[:1] == b"C":
        challenge = response[1:]
        message = b"hivemind-relay-register:" + challenge + peer_id_bytes
        signature = base64.b64decode(identity.sign(message))  # sign() returns base64
        pubkey = identity.get_public_key().to_bytes()
        await channel.send_frame(b"P" + pubkey + signature)
        response = await channel.recv_frame()
    return response


class RelayClient:
    """Attach a P2P node to a relay daemon.

    ``await RelayClient.create(p2p, host, port)`` registers the node; incoming relayed
    dials are accepted and served like direct connections. ``dial(peer_id)`` connects
    to a registered peer through the relay. ``close()`` cancels and awaits every task
    the client started."""

    def __init__(self, p2p, host: str, port: int, relay_pubkey: Optional[bytes] = None,
                 allow_plaintext: bool = False):
        self.p2p = p2p
        self.host, self.port = host, port
        if isinstance(relay_pubkey, str):
            relay_pubkey = bytes.fromhex(relay_pubkey)
        self.relay_pubkey = relay_pubkey  # optional pinned relay identity
        self.allow_plaintext = allow_plaintext  # opt-out of the encrypted default
        self._control: Optional[RelayChannel] = None
        self._control_task: Optional[asyncio.Task] = None
        self._accepts: Set[asyncio.Task] = set()  # strong refs: the loop holds tasks weakly

    @classmethod
    async def create(cls, p2p, host: str, port: int, relay_pubkey: Optional[bytes] = None,
                     allow_plaintext: bool = False) -> "RelayClient":
        self = cls(p2p, host, port, relay_pubkey=relay_pubkey, allow_plaintext=allow_plaintext)
        await self._register()
        return self

    async def _open_channel(self) -> RelayChannel:
        channel = await open_relay_channel(self.host, self.port, self.relay_pubkey,
                                           allow_plaintext=self.allow_plaintext)
        if channel.encrypted and self.relay_pubkey is None:
            # trust on first use: every later control connection of this client must
            # reach the same relay
            self.relay_pubkey = channel.relay_pubkey
        return channel

    async def _register(self) -> None:
        channel = await self._open_channel()
        try:
            response = await register_control(channel, self.p2p.peer_id.to_bytes(), self.p2p.identity)
        except BaseException:
            channel.close()
            raise
        if response != b"O":
            channel.close()
            raise ConnectionError(f"relay refused registration: {response!r}")
        self._control = channel
        self._control_task = spawn(self._control_loop(channel), name="relay.control_loop")
        mode = "encrypted" if channel.encrypted else "plaintext"
        logger.info(f"registered at relay {self.host}:{self.port} as {self.p2p.peer_id} ({mode} control)")

    @property
    def registered(self) -> bool:
        """The control line is up: the relay can notify this peer of incoming dials."""
        return self._control_task is not None and not self._control_task.done()

    async def _control_loop(self, channel: RelayChannel) -> None:
        """Wait for INCOMING notifications and accept each relayed dial."""
        try:
            while True:
                frame = await channel.recv_frame()
                if frame[:1] == b"I" and len(frame) >= 17:
                    task = spawn(self._accept(frame[1:17]), name="relay.accept")
                    self._accepts.add(task)
                    task.add_done_callback(self._accepts.discard)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            logger.warning(f"relay control line lost: {e!r}")

    async def _accept(self, token: bytes) -> None:
        try:
            channel = await self._open_channel()
            await channel.send_frame(b"A" + token)
            response = await channel.recv_frame()
            if response != b"O":
                channel.close()
                return
            # from here the socket is a transparent pipe to the dialer: the normal inbound
            # path (handshake as responder, then mux)
            await self.p2p._on_inbound_connection(channel.reader, channel.writer)
        except Exception as e:
            logger.warning(f"relayed accept failed: {e!r}")

    async def dial(self, target: PeerID) -> PeerID:
        """Connect to a relay-registered peer; returns its authenticated PeerID and
        installs the connection in the P2P node like any direct dial."""
        channel = await self._open_channel()
        token = os.urandom(16)
        await channel.send_frame(b"D" + token + target.to_bytes())
        try:
            response = await channel.recv_frame()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            # the daemon may close right after its error frame; either way: no route
            channel.close()
            raise ConnectionError(f"relay could not reach {target}") from None
        if response != b"O":
            channel.close()
            raise ConnectionError(f"relay could not reach {target}: {response!r}")
        reader, writer = channel.reader, channel.writer  # a raw pipe from here on
        try:
            noise_channel, extras = await handshake(
                reader, writer, self.p2p.identity, is_initiator=True, announced_addrs=self.p2p.get_visible_maddrs(),
            )
        except BaseException:
            writer.close()
            raise
        peer_id = PeerID.from_public_key(Ed25519PublicKey.from_bytes(extras["static"]))
        if peer_id != target:
            noise_channel.close()
            raise HandshakeError(f"dialed {target} via relay but found {peer_id}")
        conn = MuxConnection(noise_channel, peer_id, is_initiator=True, on_inbound_stream=self.p2p._route_stream)
        # circuits are exempt from connection-manager trimming (the plain dial path cannot
        # re-establish them), but they still trigger a trim, so relay-heavy nodes keep the
        # fd bound through their direct connections
        conn.is_relayed = True
        existing = self.p2p._connections.get(peer_id)
        if existing is None or existing.is_closed:
            self.p2p._connections[peer_id] = conn
        self.p2p._all_connections.add(conn)
        conn.start()
        await self.p2p._trim_connections(protect=conn)
        return peer_id

    async def whoami(self) -> Tuple[str, int]:
        """The relay's view of our public endpoint (the STUN-style observed address):
        what a NATed peer advertises for hole punching."""
        channel = await self._open_channel()
        try:
            await channel.send_frame(b"W")
            response = await channel.recv_frame()
            if not response.startswith(b"O"):
                raise ConnectionError(f"relay whoami failed: {response!r}")
            host, port = response[1:].decode().rsplit(":", 1)
            return host, int(port)
        finally:
            channel.close()

    async def close(self) -> None:
        tasks = [task for task in (self._control_task, *self._accepts) if task is not None]
        for task in tasks:
            task.cancel()
        if self._control is not None:
            self._control.close()
        await asyncio.gather(*tasks, return_exceptions=True)
