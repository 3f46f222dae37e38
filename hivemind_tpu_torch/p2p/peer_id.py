"""Peer identity and addressing (the port's copy of hivemind_tpu/p2p/peer_id.py).

A PeerID is a multihash of the node's Ed25519 public key, rendered in base58:
``base58(0x12 0x20 || sha256(pubkey))`` (the shape of a libp2p CIDv0), so the same
key gives the same PeerID bytes and string in both packages.
Addresses are a minimal multiaddr dialect: ``/ip4/<host>/tcp/<port>[/p2p/<peer_id>]``.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(_B58_ALPHABET)}


def base58_encode(data: bytes) -> str:
    num = int.from_bytes(data, "big")
    out = []
    while num:
        num, rem = divmod(num, 58)
        out.append(_B58_ALPHABET[rem])
    pad = 0
    for byte in data:
        if byte == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def base58_decode(text: str) -> bytes:
    num = 0
    for char in text:
        try:
            num = num * 58 + _B58_INDEX[char]
        except KeyError:
            raise ValueError(f"invalid base58 character {char!r}") from None
    raw = num.to_bytes((num.bit_length() + 7) // 8, "big")
    pad = 0
    for char in text:
        if char == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


_MULTIHASH_SHA256 = b"\x12\x20"  # sha2-256, 32 bytes


class PeerID:
    """An opaque, hashable, orderable node identity."""

    __slots__ = ("_bytes", "_b58")

    def __init__(self, peer_id_bytes: bytes):
        self._bytes = bytes(peer_id_bytes)
        self._b58 = base58_encode(self._bytes)

    @classmethod
    def from_public_key(cls, public_key: Ed25519PublicKey) -> "PeerID":
        digest = hashlib.sha256(public_key.to_bytes()).digest()
        return cls(_MULTIHASH_SHA256 + digest)

    @classmethod
    def from_private_key(cls, private_key: Ed25519PrivateKey) -> "PeerID":
        return cls.from_public_key(private_key.get_public_key())

    @classmethod
    def from_base58(cls, b58: str) -> "PeerID":
        return cls(base58_decode(b58))

    def to_bytes(self) -> bytes:
        return self._bytes

    def to_base58(self) -> str:
        return self._b58

    def __repr__(self) -> str:
        return f"<PeerID {self._b58[:12]}…>" if len(self._b58) > 12 else f"<PeerID {self._b58}>"

    def __str__(self) -> str:
        return self._b58

    def __eq__(self, other) -> bool:
        return isinstance(other, PeerID) and self._bytes == other._bytes

    def __lt__(self, other: "PeerID") -> bool:
        return self._bytes < other._bytes

    def __hash__(self) -> int:
        return hash(self._bytes)

    def xor_distance(self, other: "PeerID") -> int:
        return int.from_bytes(hashlib.sha256(self._bytes).digest(), "big") ^ int.from_bytes(
            hashlib.sha256(other._bytes).digest(), "big"
        )


class Multiaddr:
    """Minimal multiaddr: /<host_proto>/<host>/tcp/<port>[/p2p/<peer_id>] with
    host_proto one of ip4/ip6/dns/dns4/dns6 — plus the reference's vendored
    codec extras (hivemind/utils/multiaddr/): ``/unix/<path>`` (the path
    consumes the remainder, go-multiaddr semantics) and
    ``/onion3/<56-char-base32>:<port>``. Codec parity only: the TCP transport
    dials ip/dns addresses; unix/onion3 addresses round-trip through configs
    and DHT records."""

    __slots__ = ("host", "port", "peer_id", "host_proto")

    def __init__(self, host: str, port: int, peer_id: Optional[PeerID] = None, host_proto: str = "ip4"):
        self.host = host
        self.port = int(port)
        self.peer_id = peer_id
        self.host_proto = host_proto

    @classmethod
    def parse(cls, text: str) -> "Multiaddr":
        parts = [p for p in str(text).split("/") if p]
        host = port = None
        peer_id = None
        host_proto = "ip4"
        i = 0
        while i < len(parts):
            proto = parts[i]
            if i + 1 >= len(parts):
                raise ValueError(f"multiaddr {text!r}: protocol {proto!r} is missing its value")
            value = parts[i + 1]
            try:
                if proto in ("ip4", "ip6", "dns4", "dns6", "dns"):
                    host, host_proto = value, proto
                elif proto == "tcp":
                    port = int(value)
                elif proto == "p2p":
                    peer_id = PeerID.from_base58(value)
                elif proto == "unix":
                    # the path consumes the remainder (go-multiaddr semantics) —
                    # except a trailing /p2p/<id>, which stays the peer identity
                    # so with_peer_id round-trips through str/parse
                    rest = parts[i + 1:]
                    if len(rest) >= 2 and rest[-2] == "p2p":
                        # only a REAL sha2-256 multihash identity strips the
                        # tail: base58 alone is not enough (a path like
                        # /var/run/p2p/sock has an all-base58 last segment and
                        # must stay a path)
                        try:
                            candidate = PeerID.from_base58(rest[-1])
                            raw = candidate.to_bytes()
                            if len(raw) == 34 and raw[0] == 0x12 and raw[1] == 0x20:
                                peer_id = candidate
                                rest = rest[:-2]
                        except Exception:
                            pass
                    host, host_proto = "/" + "/".join(rest), "unix"
                    return cls(host, 0, peer_id, host_proto)
                elif proto == "onion3":
                    addr, sep, onion_port = value.partition(":")
                    if not sep or len(addr) != 56:
                        raise ValueError(
                            f"onion3 address must be <56-char-base32>:<port>, got {value!r}"
                        )
                    host, host_proto, port = addr, "onion3", int(onion_port)
                else:
                    raise ValueError(f"unsupported multiaddr protocol {proto!r} in {text!r}")
            except ValueError:
                raise
            except Exception as e:
                raise ValueError(f"malformed multiaddr {text!r}: {e}") from e
            i += 2
        if host is None or port is None:
            raise ValueError(f"multiaddr {text!r} must contain a host and tcp port")
        return cls(host, port, peer_id, host_proto)

    def with_peer_id(self, peer_id: PeerID) -> "Multiaddr":
        return Multiaddr(self.host, self.port, peer_id, self.host_proto)

    @property
    def endpoint(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def __str__(self) -> str:
        if self.host_proto == "unix":
            base = f"/unix{self.host}"
        elif self.host_proto == "onion3":
            base = f"/onion3/{self.host}:{self.port}"
        else:
            base = f"/{self.host_proto}/{self.host}/tcp/{self.port}"
        if self.peer_id is not None:
            base += f"/p2p/{self.peer_id.to_base58()}"
        return base

    def __repr__(self) -> str:
        return f"Multiaddr({self})"

    def __eq__(self, other) -> bool:
        # host_proto matters: /onion3/<x>:9443 and /dns/<x>/tcp/9443 share host
        # and port but are DIFFERENT addresses (peerstores are Set[Multiaddr])
        return (
            isinstance(other, Multiaddr)
            and self.host == other.host
            and self.port == other.port
            and self.peer_id == other.peer_id
            and self.host_proto == other.host_proto
        )

    def __hash__(self) -> int:
        return hash((self.host, self.port, self.peer_id, self.host_proto))
