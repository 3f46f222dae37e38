"""The three DHT RPCs, ping / store / find, with routing-table upkeep and key
handoff (the port's copy of hivemind_tpu/dht/protocol.py). The servicer's handler
names (``DHTProtocol.rpc_ping`` ...) and messages are the JAX package's, so a port
node and a JAX node call each other."""

from __future__ import annotations

import time
from typing import Collection, Dict, List, Optional, Sequence, Tuple, Union

from hivemind_tpu_torch.dht.routing import (
    BinaryDHTValue,
    DHTID,
    PeerInfo,
    RoutingTable,
    Subkey,
)
from hivemind_tpu_torch.dht.storage import DHTLocalStorage, DictionaryDHTValue
from hivemind_tpu_torch.dht.validation import DHTRecord, RecordValidatorBase
from hivemind_tpu_torch.p2p import P2P, P2PContext, P2PError, PeerID, ServicerBase
from hivemind_tpu_torch.proto import dht_pb2
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import (
    MAX_DHT_TIME_DISCREPANCY_SECONDS,
    DHTExpiration,
    ValueWithExpiration,
    get_dht_time,
)

logger = get_logger(__name__)

# per-RPC outbound latency and failures, and the live routing-table size of this node,
# under the JAX package's metric names
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY

_DHT_RPC_LATENCY = _TELEMETRY.histogram(
    "hivemind_dht_rpc_latency_seconds", "outbound DHT RPC wall time", ("rpc",)
)
_DHT_RPC_FAILURES = _TELEMETRY.counter(
    "hivemind_dht_rpc_failures_total", "outbound DHT RPCs that returned no reply", ("rpc",)
)
_DHT_ROUTING_TABLE_SIZE = _TELEMETRY.gauge(
    "hivemind_dht_routing_table_size", "peers currently in this node's routing table"
)

# sentinel subkey meaning "this value is not a dictionary entry"
IS_REGULAR_VALUE = b""


class DHTProtocol(ServicerBase):
    """One per DHTNode. Every request and response carries the sender's NodeInfo and
    updates the receiver's routing table; new routing-table entries trigger handoff
    of local keys that are closer to the newcomer."""

    # ping/find are reads; store has set semantics (storing the same record twice
    # yields the same state), so all three are safe to retry on an ambiguous
    # connection loss (see the idempotency gate of P2P.call_protobuf_handler)
    _idempotent_rpcs = frozenset({"rpc_ping", "rpc_find", "rpc_store"})

    @classmethod
    async def create(
        cls,
        p2p: P2P,
        node_id: DHTID,
        bucket_size: int,
        cache_size: Optional[int],
        client_mode: bool,
        record_validator: Optional[RecordValidatorBase] = None,
        wait_timeout: float = 3.0,
    ) -> "DHTProtocol":
        self = object.__new__(cls)
        self.p2p = p2p
        self.node_id = node_id
        self.bucket_size = bucket_size
        self.wait_timeout = wait_timeout
        self.client_mode = client_mode
        self.record_validator = record_validator
        self.storage = DHTLocalStorage()
        self.cache = DHTLocalStorage(maxsize=cache_size)
        self.routing_table = RoutingTable(node_id, bucket_size)
        self.node_info = dht_pb2.NodeInfo(node_id=node_id.to_bytes())
        self._handoff_tasks: set = set()
        if not client_mode:
            await self.add_p2p_handlers(p2p)
        return self

    def __init__(self):
        raise RuntimeError("use `await DHTProtocol.create(...)`")

    async def shutdown(self) -> None:
        if not self.client_mode:
            await self.remove_p2p_handlers(self.p2p)
        for task in list(self._handoff_tasks):
            task.cancel()

    def _make_node_info(self) -> dht_pb2.NodeInfo:
        if self.client_mode:
            # client-mode peers are unreachable: announce nothing so receivers never
            # register them in routing tables
            return dht_pb2.NodeInfo()
        return dht_pb2.NodeInfo(
            node_id=self.node_id.to_bytes(),
            maddrs=[str(m) for m in self.p2p.get_visible_maddrs()],
        )

    # ------------------------------------------------------------------ ping

    async def call_ping(
        self, peer: PeerID, validate: bool = False, strict: bool = True
    ) -> Optional[DHTID]:
        """Ping a peer; registers it in the routing table. Returns its node id, or
        None if unreachable. ``validate``: also check clock skew."""
        started = time.perf_counter()
        try:
            if _CHAOS.enabled:  # injection point: lose/delay the whole ping
                await _CHAOS.inject("dht.rpc_ping", scope=str(self.p2p.peer_id))
            stub = self.get_stub(self.p2p, peer)
            response = await stub.rpc_ping(
                dht_pb2.PingRequest(peer=self._make_node_info(), validate=validate),
                timeout=self.wait_timeout,
            )
        except Exception as e:
            _DHT_RPC_FAILURES.inc(rpc="ping")
            logger.debug(f"ping to {peer} failed: {e!r}")
            return None
        _DHT_RPC_LATENCY.observe(time.perf_counter() - started, rpc="ping")
        peer_node_id = DHTID.from_bytes(response.peer.node_id)
        self.update_routing_table(peer_node_id, peer, response.peer.maddrs, responded=True)
        if validate:
            skew = abs(response.dht_time - get_dht_time())
            if skew > MAX_DHT_TIME_DISCREPANCY_SECONDS:
                message = f"clock skew with {peer} is {skew:.2f}s (max {MAX_DHT_TIME_DISCREPANCY_SECONDS}s)"
                if strict:
                    raise P2PError(message)
                logger.warning(message)
        return peer_node_id

    async def rpc_ping(self, request: dht_pb2.PingRequest, context: P2PContext) -> dht_pb2.PingResponse:
        self._register_sender(request.peer, context)
        return dht_pb2.PingResponse(
            peer=self._make_node_info(), dht_time=get_dht_time(), available=bool(request.peer.maddrs)
        )

    # ------------------------------------------------------------------ store

    async def call_store(
        self,
        peer: PeerID,
        keys: Sequence[DHTID],
        values: Sequence[Union[BinaryDHTValue, DictionaryDHTValue]],
        expiration_time: Union[DHTExpiration, Sequence[DHTExpiration]],
        subkeys: Optional[Sequence[Optional[Subkey]]] = None,
        in_cache: Optional[Union[bool, Sequence[bool]]] = None,
    ) -> Optional[List[bool]]:
        """Ask a peer to store the given records; dictionaries are decomposed into
        per-subkey stores. Returns per-record success flags or None if unreachable."""
        if isinstance(expiration_time, (int, float)):
            expiration_time = [expiration_time] * len(keys)
        if subkeys is None:
            subkeys = [None] * len(keys)
        if in_cache is None:
            in_cache = False
        if isinstance(in_cache, bool):
            in_cache = [in_cache] * len(keys)

        flat_keys, flat_subkeys, flat_values, flat_expirations, flat_in_cache = [], [], [], [], []
        for key, value, subkey, expiration, cached in zip(keys, values, subkeys, expiration_time, in_cache):
            if isinstance(value, DictionaryDHTValue):
                assert subkey is None, "cannot store a dictionary under a subkey"
                for inner_subkey, (inner_value, inner_expiration) in value.items():
                    flat_keys.append(key.to_bytes())
                    flat_subkeys.append(MSGPackSerializer.dumps(inner_subkey))
                    flat_values.append(inner_value)
                    flat_expirations.append(inner_expiration)
                    flat_in_cache.append(cached)
            else:
                flat_keys.append(key.to_bytes())
                flat_subkeys.append(IS_REGULAR_VALUE if subkey is None else MSGPackSerializer.dumps(subkey))
                flat_values.append(value)
                flat_expirations.append(expiration)
                flat_in_cache.append(cached)
        started = time.perf_counter()
        try:
            if _CHAOS.enabled:  # injection point: lose/delay the whole store
                await _CHAOS.inject("dht.rpc_store", scope=str(self.p2p.peer_id))
            stub = self.get_stub(self.p2p, peer)
            response = await stub.rpc_store(
                dht_pb2.StoreRequest(
                    keys=flat_keys,
                    subkeys=flat_subkeys,
                    values=flat_values,
                    expiration_time=flat_expirations,
                    in_cache=flat_in_cache,
                    peer=self._make_node_info(),
                ),
                timeout=self.wait_timeout,
            )
            _DHT_RPC_LATENCY.observe(time.perf_counter() - started, rpc="store")
            if response.peer.node_id:
                self.update_routing_table(
                    DHTID.from_bytes(response.peer.node_id), peer, response.peer.maddrs, responded=True
                )
            return list(response.store_ok)
        except Exception as e:
            _DHT_RPC_FAILURES.inc(rpc="store")
            logger.debug(f"store to {peer} failed: {e!r}")
            return None

    async def rpc_store(self, request: dht_pb2.StoreRequest, context: P2PContext) -> dht_pb2.StoreResponse:
        self._register_sender(request.peer, context)
        if not len(request.keys) == len(request.subkeys) == len(request.values) == len(request.expiration_time) \
                == len(request.in_cache):
            raise ValueError("a store request's keys, subkeys, values, expirations and in_cache flags differ in length")
        response = dht_pb2.StoreResponse(peer=self._make_node_info())
        for key, subkey, value, expiration, in_cache in zip(
            request.keys, request.subkeys, request.values, request.expiration_time, request.in_cache
        ):
            response.store_ok.append(
                self._store_record(DHTID.from_bytes(key), subkey, value, expiration, in_cache)
            )
        return response

    def _store_record(
        self, key_id: DHTID, subkey: bytes, value: bytes, expiration: DHTExpiration, in_cache: bool
    ) -> bool:
        if expiration < get_dht_time():
            return False
        if self.record_validator is not None:
            record = DHTRecord(key_id.to_bytes(), subkey, value, expiration)
            if not self.record_validator.validate(record):
                return False
        storage = self.cache if in_cache else self.storage
        if subkey == IS_REGULAR_VALUE:
            return storage.store(key_id, value, expiration)
        return storage.store_subkey(key_id, MSGPackSerializer.loads(subkey), value, expiration)

    # ------------------------------------------------------------------ find

    async def call_find(
        self, peer: PeerID, keys: Collection[DHTID]
    ) -> Optional[
        Dict[
            DHTID,
            Tuple[
                Optional[ValueWithExpiration[Union[BinaryDHTValue, DictionaryDHTValue]]],
                Dict[DHTID, PeerInfo],
            ],
        ]
    ]:
        """Ask a peer for values and/or its nearest neighbors for each key."""
        keys = list(keys)
        started = time.perf_counter()
        try:
            if _CHAOS.enabled:  # injection point: lose/delay the whole find
                await _CHAOS.inject("dht.rpc_find", scope=str(self.p2p.peer_id))
            stub = self.get_stub(self.p2p, peer)
            response = await stub.rpc_find(
                dht_pb2.FindRequest(keys=[k.to_bytes() for k in keys], peer=self._make_node_info()),
                timeout=self.wait_timeout,
            )
            _DHT_RPC_LATENCY.observe(time.perf_counter() - started, rpc="find")
            if response.peer.node_id:
                self.update_routing_table(
                    DHTID.from_bytes(response.peer.node_id), peer, response.peer.maddrs, responded=True
                )
            if len(response.results) != len(keys):
                raise ValueError(f"{len(response.results)} find results for {len(keys)} keys")
            output = {}
            for key_id, result in zip(keys, response.results):
                nearest = {}
                for node_id_bytes, contact in zip(result.nearest_node_ids, result.nearest_contacts):
                    nearest[DHTID.from_bytes(node_id_bytes)] = PeerInfo(
                        PeerID(contact.peer_id), tuple(contact.maddrs)
                    )
                if result.type == dht_pb2.NOT_FOUND:
                    output[key_id] = None, nearest
                elif result.type == dht_pb2.FOUND_REGULAR:
                    output[key_id] = ValueWithExpiration(result.value, result.expiration_time), nearest
                elif result.type == dht_pb2.FOUND_DICTIONARY:
                    loaded = MSGPackSerializer.loads(result.value)
                    dictionary = DictionaryDHTValue()
                    for inner_subkey, (inner_value, inner_expiration) in loaded.items():
                        dictionary.store(inner_subkey, inner_value, inner_expiration)
                    output[key_id] = ValueWithExpiration(dictionary, result.expiration_time), nearest
                else:
                    logger.warning(f"unknown find result type {result.type}")
                    output[key_id] = None, nearest
            return output
        except Exception as e:
            _DHT_RPC_FAILURES.inc(rpc="find")
            logger.debug(f"find to {peer} failed: {e!r}")
            return None

    async def rpc_find(self, request: dht_pb2.FindRequest, context: P2PContext) -> dht_pb2.FindResponse:
        self._register_sender(request.peer, context)
        sender_node_id = DHTID.from_bytes(request.peer.node_id) if request.peer.node_id else None
        response = dht_pb2.FindResponse(peer=self._make_node_info())
        for key_bytes in request.keys:
            key_id = DHTID.from_bytes(key_bytes)
            result = dht_pb2.FindResult(type=dht_pb2.NOT_FOUND)
            maybe_item = self.storage.get(key_id)
            cached_item = self.cache.get(key_id)
            if cached_item is not None and (
                maybe_item is None or cached_item.expiration_time > maybe_item.expiration_time
            ):
                maybe_item = cached_item
            if maybe_item is not None:
                if isinstance(maybe_item.value, DictionaryDHTValue):
                    result.type = dht_pb2.FOUND_DICTIONARY
                    result.value = maybe_item.value.packb_as_dict()
                else:
                    result.type = dht_pb2.FOUND_REGULAR
                    result.value = maybe_item.value
                result.expiration_time = maybe_item.expiration_time
            for node_id, info in self.routing_table.get_nearest_neighbors(
                key_id, self.bucket_size, exclude=sender_node_id
            ):
                result.nearest_node_ids.append(node_id.to_bytes())
                result.nearest_contacts.append(
                    dht_pb2.PeerContact(peer_id=info.peer_id.to_bytes(), maddrs=list(info.maddrs))
                )
            response.results.append(result)
        return response

    # ------------------------------------------------------------------ routing upkeep

    def _register_sender(self, peer_info: dht_pb2.NodeInfo, context: P2PContext) -> None:
        if peer_info.node_id:
            self.update_routing_table(
                DHTID.from_bytes(peer_info.node_id), context.remote_id, peer_info.maddrs, responded=True
            )

    def update_routing_table(
        self, node_id: DHTID, peer_id: PeerID, maddrs: Sequence[str], responded: bool
    ) -> None:
        """Register contact success/failure with the routing table; newly-added nodes receive
        local keys that are closer to them than to us."""
        if node_id is None or node_id == self.node_id:
            return
        for maddr in maddrs:
            try:
                self.p2p.add_peer_addr(peer_id, maddr)
            except Exception:
                continue
        if not responded:
            self.routing_table.remove_node(node_id)
            _DHT_ROUTING_TABLE_SIZE.set(len(self.routing_table))
            return
        is_new = node_id not in self.routing_table
        ping_candidate = self.routing_table.add_or_update_node(node_id, PeerInfo(peer_id, tuple(maddrs)))
        _DHT_ROUTING_TABLE_SIZE.set(len(self.routing_table))
        if ping_candidate is not None:
            # bucket full: ping the stalest entry; evict it if dead (Kademlia §4.1)
            task = spawn(self._check_stale_node(*ping_candidate), name="dht.check_stale_node")
            self._handoff_tasks.add(task)
            task.add_done_callback(self._handoff_tasks.discard)
        if is_new and node_id in self.routing_table and self.storage:
            task = spawn(self._handoff_keys(node_id), name="dht.handoff_keys")
            self._handoff_tasks.add(task)
            task.add_done_callback(self._handoff_tasks.discard)

    async def _check_stale_node(self, node_id: DHTID, info: PeerInfo) -> None:
        result = await self.call_ping(info.peer_id, strict=False)
        bucket = self.routing_table.buckets[self.routing_table.get_bucket_index(node_id)]
        bucket.nodes_requested_for_ping.discard(node_id)
        if result is None:
            self.routing_table.remove_node(node_id)

    async def _handoff_keys(self, new_node_id: DHTID) -> None:
        """Replicate to a newcomer every local key that is closer to it than to us."""
        info = self.routing_table.get_info(new_node_id)
        if info is None:
            return
        keys, values, expirations = [], [], []
        with self.storage.freeze():
            for key_id, (value, expiration) in self.storage.items():
                if key_id.xor_distance(new_node_id) < key_id.xor_distance(self.node_id):
                    keys.append(key_id)
                    values.append(value)
                    expirations.append(expiration)
        if keys:
            await self.call_store(info.peer_id, keys, values, expirations)
