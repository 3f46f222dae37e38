"""The transport (the port of hivemind_tpu/p2p/ without relays, NAT traversal and
the native daemon): peer identity, the encrypted channel, stream multiplexing, the
P2P node and reflection-based servicers, on the JAX package's wire."""

from hivemind_tpu_torch.p2p.crypto_channel import HandshakeError
from hivemind_tpu_torch.p2p.mux import RemoteError, StreamClosedError
from hivemind_tpu_torch.p2p.p2p import (
    DEFAULT_MAX_MSG_SIZE,
    P2P,
    P2PContext,
    P2PError,
    P2PHandlerError,
    PeerNotFoundError,
)
from hivemind_tpu_torch.p2p.peer_id import Multiaddr, PeerID
from hivemind_tpu_torch.p2p.servicer import ServicerBase, StubBase
