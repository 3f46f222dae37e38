"""NAT traversal: reachability probing and hole punching (the port's copy of
hivemind_tpu/p2p/nat.py, on the same handlers and messages).

- :class:`NATTraversal` registers two P2P handlers:

  * ``nat.check``: AutoNAT-style dial-back. A peer asks us to TCP-dial its
    advertised addresses and report which ones are reachable from the outside.
  * ``nat.punch``: DCUtR-style coordination. Two peers that can already exchange
    messages (e.g. through a relay) swap their direct endpoints and dial each other
    at once; whichever direction lands first becomes the direct connection and
    replaces the relayed one for future streams.

- :meth:`RelayClient.whoami` (``relay.py``) supplies the STUN-style observed
  endpoint a NATed peer advertises for punching.

Security note: real AutoNAT dials back only addresses that share the requester's
observed IP, so a prober cannot be used to scan third parties. The transport does
not expose per-connection remote addresses to handlers, so ``nat.check`` instead
probes at most ``MAX_PROBE_ADDRS`` addresses (the JAX package's cap) and never
keeps a connection open past the TCP handshake."""

from __future__ import annotations

import asyncio
from typing import List, Optional, Sequence, Set

from hivemind_tpu_torch.p2p.peer_id import Multiaddr, PeerID
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

MAX_PROBE_ADDRS = 4
PROBE_TIMEOUT = 3.0
# control RPCs ride a (possibly relayed) path to a peer that then dials N addresses at
# PROBE_TIMEOUT each: generous, but never infinite
CONTROL_RPC_TIMEOUT = 15.0
PUNCH_TIMEOUT = 10.0
HANDLERS = ("nat.check", "nat.punch")


class NATTraversal:
    """Attach reachability and hole punching to a P2P node. ``close()`` removes the
    handlers and cancels and awaits the punch dials they started."""

    def __init__(self, p2p):
        self.p2p = p2p
        self._punches: Set[asyncio.Task] = set()  # strong refs: the loop holds tasks weakly

    async def register_handlers(self) -> None:
        await self.p2p.add_protobuf_handler("nat.check", self._rpc_check)
        await self.p2p.add_protobuf_handler("nat.punch", self._rpc_punch)

    async def close(self) -> None:
        for name in HANDLERS:
            await self.p2p.remove_protobuf_handler(name)
        tasks = list(self._punches)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    # ------------------------------------------------------------------ reachability

    async def _rpc_check(self, request: bytes, context) -> bytes:
        addrs = MSGPackSerializer.loads(request)[:MAX_PROBE_ADDRS]
        reachable = []
        for addr in addrs:
            try:
                maddr = Multiaddr.parse(addr)
                if maddr.host_proto not in self.p2p._DIALABLE_PROTOS:
                    continue  # unix and onion3 addresses parse but cannot be probed over TCP
                _reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(maddr.host, maddr.port), timeout=PROBE_TIMEOUT
                )
                writer.close()
                reachable.append(addr)
            except Exception:
                continue
        return MSGPackSerializer.dumps(reachable)

    async def check_reachability(self, via: PeerID, maddrs: Optional[Sequence] = None) -> List[str]:
        """Ask ``via`` to dial our addresses back; returns the publicly reachable
        subset. An empty result on a working path means we are NATed and should
        register at a relay."""
        maddrs = maddrs if maddrs is not None else self.p2p.get_visible_maddrs()
        request = MSGPackSerializer.dumps([str(m) for m in maddrs])
        response = await asyncio.wait_for(
            self.p2p.call_protobuf_handler(via, "nat.check", request, idempotent=True), timeout=CONTROL_RPC_TIMEOUT,
        )
        return list(MSGPackSerializer.loads(response))

    # ------------------------------------------------------------------ hole punching

    async def _rpc_punch(self, request: bytes, context) -> bytes:
        """The passive side: reply with our direct endpoints and start dialing the
        initiator's at once (TCP simultaneous open under real NATs)."""
        their_addrs = [Multiaddr.parse(a) for a in MSGPackSerializer.loads(request)]
        task = spawn(self._punch_dial(context.remote_id, their_addrs), name="nat.punch_dial")
        self._punches.add(task)
        task.add_done_callback(self._punches.discard)
        return MSGPackSerializer.dumps([str(m) for m in self.p2p.get_visible_maddrs()])

    async def _punch_dial(self, peer_id: PeerID, addrs: Sequence[Multiaddr]) -> bool:
        for maddr in addrs:
            try:
                await asyncio.wait_for(
                    self.p2p._dial(maddr.with_peer_id(peer_id), expected_peer=peer_id, replace_existing=True),
                    timeout=PUNCH_TIMEOUT,
                )
                return True
            except Exception as e:
                logger.debug(f"punch dial to {maddr} failed: {e!r}")
        return False

    async def hole_punch(self, peer_id: PeerID, direct_addrs: Optional[Sequence] = None) -> bool:
        """Coordinate a direct connection with a peer we can already message (through
        a relay): exchange endpoints over the existing path, then both sides dial.
        Returns True if a direct connection was established from our side (the peer's
        dial may land first; either way the connection map is upgraded)."""
        ours = direct_addrs if direct_addrs is not None else self.p2p.get_visible_maddrs()
        request = MSGPackSerializer.dumps([str(m) for m in ours])
        # the handler's dial replaces the connection, so a retry after an ambiguous loss
        # is safe, and this call races connection churn by construction
        response = await asyncio.wait_for(
            self.p2p.call_protobuf_handler(peer_id, "nat.punch", request, idempotent=True),
            timeout=CONTROL_RPC_TIMEOUT,
        )
        their_addrs = [Multiaddr.parse(a) for a in MSGPackSerializer.loads(response)]
        return await self._punch_dial(peer_id, their_addrs)
