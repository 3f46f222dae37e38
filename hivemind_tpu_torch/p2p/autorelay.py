"""Auto-relay through the DHT (the port's copy of hivemind_tpu/p2p/autorelay.py, on
the same DHT keys and record bytes, so a JAX peer and a port peer find each other's
relays and circuits): a peer behind NAT finds public relays in the swarm without any
operator-curated relay list.

Protocol:

- **Advertising** (`advertise_relay`): whoever operates a relay daemon
  (``native/hm_relayd.cpp``, run by ``hivemind_cli/run_relay.py``) publishes it under
  the DHT key ``hivemind:relays``: subkey ``host:port``, value the relay's Ed25519
  identity hex (printed by the daemon at startup). Records expire, so dead relays
  age out.
- **Self-diagnosis** (`AutoRelay.create`): the peer asks a connected peer to dial
  back its announced addresses (``nat.check``, the AutoNAT dial-back of
  ``p2p/nat.py``). If none is reachable, it is NATed.
- **Registration**: a NATed peer fetches the relay list, shuffles it, and registers
  (`RelayClient`) at up to ``max_relays`` of them, pinning each relay's advertised
  identity, so a swarm member cannot advertise a MITM relay for an endpoint it does
  not control. It then publishes its circuits under ``hivemind:relayed:<peer_id>``
  so dialers can find them.
- **Resolution**: every `AutoRelay` installs a peer resolver on its `P2P` node:
  when a direct dial finds no route, the resolver looks up the target's published
  circuits and dials through one of its relays. With `NATTraversal`'s DCUtR-style
  hole punch (registered here too), the relayed connection is upgraded to a direct
  one when the NAT allows.
- **Maintenance**: a background task re-publishes records at half their TTL and
  re-registers when a relay's control line drops, replacing dead relays with fresh
  picks from the DHT.

``close()`` undoes ``create``: it cancels and awaits every task the instance
started (the maintenance loop, each hole-punch upgrade, the relay clients' and the
NAT handlers' tasks), removes the resolver and the NAT handlers, and closes the
relay clients. The shuffles and the probe's pick draw from the process-global
``random`` stream, as the JAX package's do; after ``close()`` nothing of this
instance draws from it.
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Optional, Set, Tuple

from hivemind_tpu_torch.p2p.nat import NATTraversal
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.p2p.relay import RelayClient
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

RELAY_DHT_KEY = "hivemind:relays"
RELAYED_PEER_PREFIX = "hivemind:relayed:"
DEFAULT_TTL = 600.0


def advertise_relay(dht, host: str, port: int, pubkey_hex: str = "", ttl: float = DEFAULT_TTL) -> bool:
    """Publish a relay daemon's endpoint to the swarm (run by the relay's operator,
    next to the daemon process). Returns True when the record stored."""
    return bool(dht.store(RELAY_DHT_KEY, subkey=f"{host}:{port}", value=pubkey_hex,
                          expiration_time=get_dht_time() + ttl))


def _parse_relay_records(record) -> List[Tuple[str, int, str]]:
    """[(host, port, pubkey_hex)] of a ``hivemind:relays`` DHT record."""
    if record is None or not isinstance(record.value, dict):
        return []
    relays = []
    for endpoint, item in record.value.items():
        try:
            if isinstance(endpoint, bytes):
                endpoint = endpoint.decode()
            host, _, port = str(endpoint).rpartition(":")
            relays.append((host, int(port), str(item.value or "")))
        except (ValueError, AttributeError):
            continue
    return relays


class AutoRelay:
    """See the module docstring.

    :param p2p: this node's transport
    :param dht: this node's DHT (relay discovery and circuit publication)
    :param max_relays: how many relays a NATed peer registers at
    :param probe_via: the peer to run the AutoNAT dial-back through; by default any
        connected peer. With no peers and no ``force_relay``, the node assumes it is
        reachable (nothing to diagnose with: AutoNAT's "unknown")
    :param force_relay: skip the probe and register regardless
    :param ttl: lifetime of the published DHT records; refreshed at half-life
    """

    def __init__(self, p2p, dht, *, max_relays: int = 2, ttl: float = DEFAULT_TTL, allow_plaintext: bool = False):
        self.p2p = p2p
        self.dht = dht
        self.max_relays = max_relays
        self.ttl = ttl
        # opt-out of the encrypted-control default: only True accepts relays advertised
        # without an identity (daemons without libcrypto)
        self.allow_plaintext = allow_plaintext
        self.nat = NATTraversal(p2p)
        self.relay_clients: Dict[Tuple[str, int], RelayClient] = {}
        self._maintenance_task: Optional[asyncio.Task] = None
        self._bg_tasks: Set[asyncio.Task] = set()  # strong refs: the loop holds tasks weakly
        self._natted = False
        self._probe_via: Optional[PeerID] = None
        self._closed = False

    @classmethod
    async def create(
        cls,
        p2p,
        dht,
        *,
        max_relays: int = 2,
        probe_via: Optional[PeerID] = None,
        force_relay: bool = False,
        ttl: float = DEFAULT_TTL,
        allow_plaintext: bool = False,
    ) -> "AutoRelay":
        self = cls(p2p, dht, max_relays=max_relays, ttl=ttl, allow_plaintext=allow_plaintext)
        self._probe_via = probe_via
        await self.nat.register_handlers()  # serve nat.check and nat.punch for others
        p2p.set_peer_resolver(self._resolve_and_dial)
        try:
            self._natted = force_relay or not await self._probe_reachable(probe_via)
            if self._natted:
                await self._ensure_registrations()
                if not self.relay_clients:
                    logger.warning("NATed but no advertised relay accepted registration")
        except BaseException:
            await self.close()
            raise
        self._maintenance_task = spawn(self._maintenance_loop(), name="autorelay.maintenance_loop")
        return self

    @property
    def natted(self) -> bool:
        """The last diagnosis: no announced address of this node answered a dial-back."""
        return self._natted

    # ------------------------------------------------------------------ diagnosis

    async def _probe_reachable(self, probe_via: Optional[PeerID]) -> bool:
        """AutoNAT dial-back; True when at least one announced address is reachable.
        With nobody to probe through, True (unknown is not private)."""
        if probe_via is None:
            peers = await self.p2p.list_peers()
            if not peers:
                return True
            probe_via = random.choice(peers)
        try:
            return bool(await self.nat.check_reachability(probe_via))
        except Exception as e:
            logger.debug(f"reachability probe via {probe_via} failed: {e!r}")
            return True

    # ------------------------------------------------------------------ registration

    async def _ensure_registrations(self) -> None:
        """Register at up to ``max_relays`` advertised relays and publish circuits."""
        candidates = await asyncio.wrap_future(self.dht.get(RELAY_DHT_KEY, latest=True, return_future=True))
        relays = _parse_relay_records(candidates)
        random.shuffle(relays)
        for host, port, pubkey_hex in relays:
            if len(self.relay_clients) >= self.max_relays:
                break
            if (host, port) in self.relay_clients:
                continue
            try:
                client = await RelayClient.create(
                    self.p2p, host, port, relay_pubkey=pubkey_hex or None,
                    # encrypted by default: a relay advertised with an identity can never be
                    # downgraded (the pin refuses), one advertised without only under the opt-out
                    allow_plaintext=self.allow_plaintext and not pubkey_hex,
                )
                self.relay_clients[(host, port)] = client
            except Exception as e:
                logger.debug(f"auto-relay registration at {host}:{port} failed: {e!r}")
        if self.relay_clients:
            await self._publish_circuits()

    async def _publish_circuits(self) -> None:
        circuits = [
            {"endpoint": f"{host}:{port}", "pubkey": client.relay_pubkey.hex() if client.relay_pubkey else ""}
            for (host, port), client in self.relay_clients.items()
        ]
        stored = await asyncio.wrap_future(self.dht.store(
            RELAYED_PEER_PREFIX + self.p2p.peer_id.to_base58(), value=circuits,
            expiration_time=get_dht_time() + self.ttl, return_future=True,
        ))
        if stored:
            logger.info(f"published {len(circuits)} relay circuit(s) for {self.p2p.peer_id}")

    # ------------------------------------------------------------------ resolution

    async def _resolve_and_dial(self, peer_id: PeerID):
        """The peer resolver installed on the P2P node: find the target's published
        circuits and dial through one of its relays. Returns a live MuxConnection or
        None (the caller then raises its usual PeerNotFoundError)."""
        record = await asyncio.wrap_future(
            self.dht.get(RELAYED_PEER_PREFIX + peer_id.to_base58(), latest=True, return_future=True)
        )
        if record is None or not isinstance(record.value, list):
            return None
        circuits = list(record.value)
        random.shuffle(circuits)
        for circuit in circuits:
            try:
                host, _, port = str(circuit.get("endpoint", "")).rpartition(":")
                pubkey = circuit.get("pubkey") or None
                client = RelayClient(self.p2p, host, int(port), relay_pubkey=pubkey,
                                     allow_plaintext=self.allow_plaintext and not pubkey)
                await client.dial(peer_id)
                conn = self.p2p._connections.get(peer_id)
                if conn is not None and not conn.is_closed:
                    if not self._closed:
                        # an opportunistic DCUtR upgrade: swap endpoints through the fresh
                        # relayed path and race direct dials; a failure keeps the circuit
                        task = spawn(self._try_upgrade(peer_id), name="autorelay.try_upgrade")
                        self._bg_tasks.add(task)
                        task.add_done_callback(self._bg_tasks.discard)
                    return conn
            except Exception as e:
                logger.debug(f"relayed dial to {peer_id} via {circuit} failed: {e!r}")
        return None

    async def _try_upgrade(self, peer_id: PeerID) -> None:
        try:
            await self.nat.hole_punch(peer_id)
        except Exception as e:
            logger.debug(f"hole punch with {peer_id} failed: {e!r}")

    # ------------------------------------------------------------------ maintenance

    async def _maintenance_once(self) -> None:
        """One maintenance pass: re-probe the NAT status while not relayed (a peer that
        diagnosed itself before it had anyone to probe through must register once
        evidence of being NATed appears), drop registrations whose control line died,
        and re-register and re-publish."""
        if not self._natted:
            self._natted = not await self._probe_reachable(self._probe_via)
        if self._natted:
            dead = [key for key, client in self.relay_clients.items() if not client.registered]
            for key in dead:
                await self.relay_clients.pop(key).close()
            await self._ensure_registrations()

    async def _maintenance_loop(self) -> None:
        interval = max(self.ttl / 2.0, 5.0)
        while not self._closed:
            await asyncio.sleep(interval)
            try:
                await self._maintenance_once()
            except Exception as e:
                logger.warning(f"auto-relay maintenance failed: {e!r}")

    async def close(self) -> None:
        self._closed = True
        # bound methods are made per access, so compare with == ((func, instance)), not `is`
        if getattr(self.p2p, "_peer_resolver", None) == self._resolve_and_dial:
            self.p2p.set_peer_resolver(None)
        tasks = [task for task in (self._maintenance_task, *self._bg_tasks) if task is not None]
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await self.nat.close()
        for client in self.relay_clients.values():
            await client.close()
        self.relay_clients.clear()
