"""Kademlia routing primitives: DHTID, k-buckets and the routing table (the port's
copy of hivemind_tpu/dht/routing.py).

IDs are 256-bit SHA-256 of the key's msgpack (``MSGPackSerializer``, byte-identical
to the JAX package's), so a port node and a JAX node place every key at the same id.
"""

from __future__ import annotations

import hashlib
import os
import random
from collections import OrderedDict
from itertools import chain
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

DHTKey = Any
Subkey = Any
BinaryDHTValue = bytes

ID_NBITS = 256
ID_NBYTES = ID_NBITS // 8


class DHTID(int):
    MIN = 0
    MAX = 2**ID_NBITS

    @classmethod
    def generate(cls, source: Optional[Any] = None, nbits: int = ID_NBITS) -> "DHTID":
        """Random id, or the hash of ``source`` (used to map keys into id space)."""
        if source is None:
            return cls(int.from_bytes(os.urandom(ID_NBYTES), "big"))
        if not isinstance(source, bytes):
            source = MSGPackSerializer.dumps(source)
        return cls(int.from_bytes(hashlib.sha256(source).digest(), "big"))

    def xor_distance(self, other: Union[int, Sequence[int]]) -> Union[int, List[int]]:
        if isinstance(other, (list, tuple)):
            return [int(self) ^ int(o) for o in other]
        return int(self) ^ int(other)

    def to_bytes(self) -> bytes:
        return int(self).to_bytes(ID_NBYTES, "big")

    @classmethod
    def from_bytes(cls, data: bytes) -> "DHTID":
        return cls(int.from_bytes(data, "big"))

    def __repr__(self) -> str:
        return f"DHTID({hex(int(self))[:18]}…)"


class PeerInfo(NamedTuple):
    """Contact info kept per routing-table entry: identity + dialable addresses
    (the protocol carries addresses, as no daemon peerstore resolves PeerID → addr)."""

    peer_id: PeerID
    maddrs: Tuple[str, ...]


class KBucket:
    """Nodes with ids in [lower, upper); at most ``size`` live entries plus a
    replacement queue."""

    def __init__(self, lower: int, upper: int, size: int):
        assert lower < upper
        self.lower, self.upper, self.size = lower, upper, size
        self.nodes_to_peers: "OrderedDict[DHTID, PeerInfo]" = OrderedDict()
        self.replacement_nodes: "OrderedDict[DHTID, PeerInfo]" = OrderedDict()
        self.nodes_requested_for_ping: set = set()
        self.last_updated = 0.0

    def has_in_range(self, node_id: DHTID) -> bool:
        return self.lower <= node_id < self.upper

    def add_or_update_node(self, node_id: DHTID, info: PeerInfo) -> bool:
        """Move to fresh end if known, insert if space, else queue as replacement.
        Returns True unless the bucket was full (caller may then try to split)."""
        from hivemind_tpu_torch.utils.timed_storage import get_dht_time

        self.last_updated = get_dht_time()
        if node_id in self.nodes_to_peers:
            self.nodes_to_peers.move_to_end(node_id)
            self.nodes_to_peers[node_id] = info
            return True
        if len(self.nodes_to_peers) < self.size:
            self.nodes_to_peers[node_id] = info
            return True
        if node_id in self.replacement_nodes:
            self.replacement_nodes.move_to_end(node_id)
        self.replacement_nodes[node_id] = info
        return False

    def request_ping_node(self) -> Optional[Tuple[DHTID, PeerInfo]]:
        """The stalest node not already being pinged (liveness check candidate)."""
        for node_id, info in self.nodes_to_peers.items():
            if node_id not in self.nodes_requested_for_ping:
                self.nodes_requested_for_ping.add(node_id)
                return node_id, info
        return None

    def remove_node(self, node_id: DHTID) -> Optional[Tuple[DHTID, PeerInfo]]:
        """Drop a node; promote the oldest replacement into the freed live slot.
        Returns the promoted (id, info) so the owning table can register it."""
        self.nodes_requested_for_ping.discard(node_id)
        promoted = None
        if node_id in self.nodes_to_peers:
            del self.nodes_to_peers[node_id]
            if self.replacement_nodes:
                replacement_id, info = self.replacement_nodes.popitem(last=False)
                self.nodes_to_peers[replacement_id] = info
                promoted = (replacement_id, info)
        self.replacement_nodes.pop(node_id, None)
        return promoted

    def split(self) -> Tuple["KBucket", "KBucket"]:
        midpoint = (self.lower + self.upper) // 2
        left, right = KBucket(self.lower, midpoint, self.size), KBucket(midpoint, self.upper, self.size)
        for node_id, info in chain(self.nodes_to_peers.items(), self.replacement_nodes.items()):
            bucket = left if node_id < midpoint else right
            bucket.add_or_update_node(node_id, info)
        left.last_updated = right.last_updated = self.last_updated
        return left, right

    def __repr__(self) -> str:
        return (
            f"KBucket({hex(self.lower)[:10]}…{hex(self.upper)[:10]}, "
            f"{len(self.nodes_to_peers)} nodes, {len(self.replacement_nodes)} replacements)"
        )


class RoutingTable:
    """All known peers bucketed by xor distance from our node id."""

    def __init__(self, node_id: DHTID, bucket_size: int = 20, depth_modulo: int = 5):
        self.node_id = node_id
        self.bucket_size = bucket_size
        self.depth_modulo = depth_modulo
        self.buckets: List[KBucket] = [KBucket(DHTID.MIN, DHTID.MAX, bucket_size)]
        self.peer_to_uid: Dict[PeerID, DHTID] = {}
        self.uid_to_info: Dict[DHTID, PeerInfo] = {}

    def get_bucket_index(self, node_id: DHTID) -> int:
        lo, hi = 0, len(self.buckets)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.buckets[mid].lower <= node_id:
                lo = mid
            else:
                hi = mid
        return lo

    def add_or_update_node(self, node_id: DHTID, info: PeerInfo) -> Optional[Tuple[DHTID, PeerInfo]]:
        """Register a live contact. Returns a (node_id, info) that should be pinged for
        liveness if the relevant bucket is full (Kademlia §2.2/4.1 eviction check)."""
        if node_id == self.node_id:
            return None
        bucket_index = self.get_bucket_index(node_id)
        bucket = self.buckets[bucket_index]
        store_success = bucket.add_or_update_node(node_id, info)
        if store_success:
            self._register_live(node_id, info)
            return None
        # full bucket: split if it covers our own id (or depth rule), else request ping
        if bucket.has_in_range(self.node_id) or self._bucket_depth(bucket) % self.depth_modulo != 0:
            self.split_bucket(bucket_index)
            return self.add_or_update_node(node_id, info)
        return bucket.request_ping_node()

    def _bucket_depth(self, bucket: KBucket) -> int:
        return ID_NBITS - (bucket.upper - bucket.lower - 1).bit_length()

    def split_bucket(self, index: int) -> None:
        left, right = self.buckets[index].split()
        self.buckets[index : index + 1] = [left, right]
        # replacements may have been promoted into the new buckets' live slots;
        # register every live node so lookups can see them
        for bucket in (left, right):
            for node_id, info in bucket.nodes_to_peers.items():
                self._register_live(node_id, info)

    def _register_live(self, node_id: DHTID, info: PeerInfo) -> None:
        self.peer_to_uid[info.peer_id] = node_id
        self.uid_to_info[node_id] = info

    def remove_node(self, node_id: DHTID) -> None:
        bucket = self.buckets[self.get_bucket_index(node_id)]
        info = self.uid_to_info.pop(node_id, None)
        if info is not None:
            self.peer_to_uid.pop(info.peer_id, None)
        promoted = bucket.remove_node(node_id)
        if promoted is not None:
            self._register_live(*promoted)

    def get_info(self, node_id: DHTID) -> Optional[PeerInfo]:
        return self.uid_to_info.get(node_id)

    def get_nearest_neighbors(
        self, query_id: DHTID, k: int, exclude: Optional[DHTID] = None
    ) -> List[Tuple[DHTID, PeerInfo]]:
        candidates = (
            (query_id.xor_distance(node_id), node_id, info)
            for node_id, info in self.uid_to_info.items()
            if node_id != exclude
        )
        import heapq

        nearest = heapq.nsmallest(k, candidates)
        return [(node_id, info) for _, node_id, info in nearest]

    def __contains__(self, item: Union[DHTID, PeerID]) -> bool:
        if isinstance(item, PeerID):
            return item in self.peer_to_uid
        return item in self.uid_to_info

    def __len__(self) -> int:
        return len(self.uid_to_info)

    def iter_nodes(self) -> Iterator[Tuple[DHTID, PeerInfo]]:
        return iter(list(self.uid_to_info.items()))

    def get_stale_buckets(self, staleness_seconds: float) -> List[KBucket]:
        from hivemind_tpu_torch.utils.timed_storage import get_dht_time

        now = get_dht_time()
        return [b for b in self.buckets if now - b.last_updated > staleness_seconds]

    def sample_refresh_id(self, bucket: KBucket) -> DHTID:
        return DHTID(random.randint(bucket.lower, bucket.upper - 1))

    def __repr__(self) -> str:
        return f"RoutingTable({len(self)} nodes, {len(self.buckets)} buckets)"
