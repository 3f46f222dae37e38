"""DHTNode: one Kademlia participant (the port's copy of hivemind_tpu/dht/node.py).

Implements bootstrap, beam-search get/store over the swarm, sub-key dictionary records,
response caching with refresh-before-expiry, in-flight request reuse, and a failure
blacklist with exponential backoff. Pure asyncio: runs inside whatever loop owns it
(the DHT facade puts it on the port's loop thread, ``utils/loop.py``).
"""

from __future__ import annotations

import asyncio
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import (
    Any,
    Awaitable,
    Collection,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from hivemind_tpu_torch.dht.protocol import DHTProtocol
from hivemind_tpu_torch.dht.routing import BinaryDHTValue, DHTID, DHTKey, PeerInfo, Subkey
from hivemind_tpu_torch.dht.storage import DictionaryDHTValue
from hivemind_tpu_torch.dht.traverse import traverse_dht
from hivemind_tpu_torch.dht.validation import DHTRecord, RecordValidatorBase
from hivemind_tpu_torch.p2p import Multiaddr, P2P
from hivemind_tpu_torch.resilience import BreakerBoard, Deadline
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import (
    DHTExpiration,
    TimedStorage,
    ValueWithExpiration,
    get_dht_time,
)

logger = get_logger(__name__)

DEFAULT_NUM_WORKERS = int(os.getenv("HIVEMIND_TPU_DHT_NUM_WORKERS", "4"))

# whole-operation (beam-search level) store/get latency as seen by DHT users,
# distinct from the per-RPC timings in dht/protocol.py, which measure single peer
# round-trips (the JAX package's metric names)
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import (
    finish_span as _finish_span,
    install_span as _install_span,
    start_span as _start_span,
    trace as _tracing_span,
    uninstall_span as _uninstall_span,
)

_DHT_OP_LATENCY = _TELEMETRY.histogram(
    "hivemind_dht_operation_latency_seconds", "store_many/get_many wall time", ("op",)
)
_DHT_STORE_TRAVERSALS_SAVED = _TELEMETRY.counter(
    "hivemind_dht_store_traversals_saved_total",
    "store_many keys that reused another key's beam search because their local "
    "nearest-neighbor sets coincided (bulk republish path)",
)


class Blacklist(BreakerBoard):
    """Tracks unresponsive peers with exponential backoff, as a parameterization of
    the shared cross-layer :class:`~hivemind_tpu_torch.resilience.BreakerBoard`: one
    failure trips the peer's breaker open for ``base_time`` seconds, re-trips
    escalate by ``backoff_rate``, and a success after the window (the half-open
    probe) closes it. Trip/probe telemetry rides the shared breaker gauges."""

    def __init__(self, base_time: float = 5.0, backoff_rate: float = 2.0, maxsize: int = 10_000):
        super().__init__(
            "dht_blacklist",
            maxsize=maxsize,
            failure_threshold=1,
            recovery_time=base_time,
            backoff_rate=backoff_rate,
            clock=get_dht_time,
        )
        self.base_time, self.backoff_rate = base_time, backoff_rate


@dataclass
class _SearchResult:
    """Best value found for one key during a search, plus where it was/wasn't."""

    binary_value: Optional[Union[BinaryDHTValue, DictionaryDHTValue]] = None
    expiration_time: Optional[DHTExpiration] = None
    source_node_id: Optional[DHTID] = None
    nearest_without_value: List[DHTID] = field(default_factory=list)

    def add_candidate(
        self,
        candidate: Optional[ValueWithExpiration],
        source_node_id: Optional[DHTID],
    ) -> None:
        if candidate is None:
            return
        if isinstance(candidate.value, DictionaryDHTValue) and isinstance(self.binary_value, DictionaryDHTValue):
            # merge dictionaries entry-wise (subkey freshness decides)
            for subkey, (value, expiration) in candidate.value.items():
                self.binary_value.store(subkey, value, expiration)
        elif candidate.expiration_time > (self.expiration_time or -float("inf")):
            self.binary_value = candidate.value
        if candidate.expiration_time > (self.expiration_time or -float("inf")):
            self.expiration_time = candidate.expiration_time
            self.source_node_id = source_node_id


class DHTNode:
    """See module docstring. Create with ``await DHTNode.create(...)``."""

    def __init__(self):
        raise RuntimeError("use `await DHTNode.create(...)`")

    @classmethod
    async def create(
        cls,
        p2p: Optional[P2P] = None,
        node_id: Optional[DHTID] = None,
        initial_peers: Sequence[Union[str, Multiaddr]] = (),
        bucket_size: int = 20,
        num_replicas: int = 5,
        wait_timeout: float = 3.0,
        bootstrap_timeout: Optional[float] = None,
        num_workers: int = DEFAULT_NUM_WORKERS,
        beam_size: Optional[int] = None,
        queries_per_call: int = 3,
        cache_locally: bool = True,
        cache_nearest: int = 1,
        cache_size: int = 10_000,
        cache_on_store: bool = True,
        cache_refresh_before_expiry: float = 5.0,
        reuse_get_requests: bool = True,
        blacklist_time: float = 5.0,
        backoff_rate: float = 2.0,
        client_mode: bool = False,
        record_validator: Optional[RecordValidatorBase] = None,
        validate: bool = False,
        strict: bool = True,
        **p2p_kwargs,
    ) -> "DHTNode":
        self = object.__new__(cls)
        self.node_id = node_id if node_id is not None else DHTID.generate()
        self.num_replicas, self.num_workers = num_replicas, num_workers
        self.beam_size = beam_size if beam_size is not None else bucket_size
        self.queries_per_call = queries_per_call
        self.cache_locally, self.cache_nearest, self.cache_on_store = cache_locally, cache_nearest, cache_on_store
        self.cache_refresh_before_expiry = cache_refresh_before_expiry
        self.reuse_get_requests = reuse_get_requests
        self.blacklist = Blacklist(blacklist_time, backoff_rate)
        self.client_mode = client_mode
        self.record_validator = record_validator
        self._pending_get_requests: Dict[DHTID, List[Tuple[DHTExpiration, asyncio.Future]]] = defaultdict(list)
        self._cache_refresh_queue = TimedStorage[DHTID, DHTExpiration]()
        self._cache_refresh_available = asyncio.Event()
        self._refresh_task: Optional[asyncio.Task] = None
        # post-response background work (cache_nearest replication) that must
        # not outlive the node: cancelled in shutdown()
        self._background: set = set()
        self._owns_p2p = p2p is None

        if p2p is None:
            p2p = await P2P.create(**p2p_kwargs)
        self.p2p = p2p
        self.peer_id = p2p.peer_id
        self.protocol = await DHTProtocol.create(
            p2p, self.node_id, bucket_size, cache_size, client_mode, record_validator, wait_timeout
        )

        if initial_peers:
            initial_peers = [Multiaddr.parse(m) if isinstance(m, str) else m for m in initial_peers]
            # one Deadline budget for the whole bootstrap (resilience/policy.py):
            # stage 2's straggler wait gets whatever stage 1 left over
            bootstrap_budget = Deadline(bootstrap_timeout if bootstrap_timeout is not None else wait_timeout * 10)

            async def _ping_address(maddr: Multiaddr) -> Optional[DHTID]:
                try:
                    peer = await p2p.connect(maddr)
                    return await self.protocol.call_ping(peer, validate=validate, strict=strict)
                except Exception as e:
                    logger.debug(f"bootstrap peer {maddr} unreachable: {e!r}")
                    return None

            # stage 1: ping everyone; require at least one success
            ping_tasks = [asyncio.create_task(_ping_address(m)) for m in initial_peers]
            finished, pending = await asyncio.wait(ping_tasks, return_when=asyncio.FIRST_COMPLETED)
            while pending and not any(t.result() is not None for t in finished if not t.cancelled()):
                extra_finished, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                finished |= extra_finished
            if not any(t.result() is not None for t in finished if not t.cancelled()):
                if pending:
                    await asyncio.gather(*pending, return_exceptions=True)
                if strict and not any(
                    t.result() is not None for t in ping_tasks if t.done() and not t.cancelled()
                ):
                    raise RuntimeError("DHTNode bootstrap failed: none of the initial peers responded")
            # stage 2: wait for stragglers until the deadline
            if pending:
                await asyncio.wait(pending, timeout=bootstrap_budget.remaining())
                for task in pending:
                    task.cancel()
            # stage 3: self-lookup to populate the routing table
            await self.find_nearest_nodes([self.node_id])

        return self

    # ------------------------------------------------------------------ traversal plumbing

    def _make_peer_resolver(self) -> Dict[DHTID, PeerInfo]:
        """Search-local map node_id → contact, seeded from the routing table and
        extended with every nearest-contact learned during traversal."""
        return dict(self.protocol.routing_table.iter_nodes())

    def _register_contacts(self, contacts: Dict[DHTID, PeerInfo]) -> None:
        """Make learned contacts dialable: their addresses must reach the transport
        peerstore before any stub call, since this build has no external daemon
        resolving PeerID → address."""
        for info in contacts.values():
            for maddr in info.maddrs:
                try:
                    self.p2p.add_peer_addr(info.peer_id, maddr)
                except Exception:
                    continue

    def _get_neighbors_fn(
        self,
        node_to_peer: Dict[DHTID, PeerInfo],
        search_results: Optional[Dict[DHTID, _SearchResult]] = None,
        sufficient_expiration: Optional[DHTExpiration] = None,
    ):
        async def get_neighbors(
            peer_node_id: DHTID, queries: Collection[DHTID]
        ) -> Dict[DHTID, Tuple[List[DHTID], bool]]:
            info = node_to_peer.get(peer_node_id)
            if info is None or info.peer_id in self.blacklist or info.peer_id == self.peer_id:
                return {q: ([], False) for q in queries}
            response = await self.protocol.call_find(info.peer_id, queries)
            if response is None:
                self.blacklist.register_failure(info.peer_id)
                return {q: ([], False) for q in queries}
            self.blacklist.register_success(info.peer_id)
            output: Dict[DHTID, Tuple[List[DHTID], bool]] = {}
            for query, (maybe_value, nearest) in response.items():
                node_to_peer.update(nearest)
                self._register_contacts(nearest)
                should_stop = False
                if search_results is not None:
                    state = search_results[query]
                    state.add_candidate(maybe_value, peer_node_id)
                    if maybe_value is None:
                        state.nearest_without_value.append(peer_node_id)
                    if (
                        sufficient_expiration is not None
                        and state.expiration_time is not None
                        and state.expiration_time >= sufficient_expiration
                    ):
                        should_stop = True
                output[query] = (list(nearest.keys()), should_stop)
            return output

        return get_neighbors

    async def find_nearest_nodes(
        self,
        queries: Collection[DHTID],
        k_nearest: Optional[int] = None,
        beam_size: Optional[int] = None,
        exclude_self: bool = False,
    ) -> Dict[DHTID, Dict[DHTID, PeerInfo]]:
        """Beam-search the swarm for each query id; returns nearest node contacts."""
        queries = list(queries)
        k_nearest = k_nearest if k_nearest is not None else self.beam_size
        beam_size = max(beam_size if beam_size is not None else self.beam_size, k_nearest)
        node_to_peer = self._make_peer_resolver()
        # seed each query's beam from its OWN neighborhood (cheap local op); distant
        # queries would otherwise converge from a random region, wasting round-trips
        initial_set = {}
        for query in queries:
            for nid, _info in self.protocol.routing_table.get_nearest_neighbors(query, beam_size):
                initial_set[nid] = None
        initial = list(initial_set)
        if not initial:
            # lone node (or empty table): the only known storage candidate is self
            if exclude_self:
                return {q: {} for q in queries}
            return {q: {self.node_id: PeerInfo(self.peer_id, ())} for q in queries}
        nearest_nodes, _visited = await traverse_dht(
            queries,
            initial,
            beam_size,
            self.num_workers,
            self.queries_per_call,
            self._get_neighbors_fn(node_to_peer),
        )
        output = {}
        for query in queries:
            ranked = nearest_nodes[query]
            if not exclude_self:
                ranked = sorted(set(ranked) | {self.node_id}, key=query.xor_distance)
            output[query] = {
                nid: (node_to_peer[nid] if nid != self.node_id else PeerInfo(self.peer_id, ()))
                for nid in ranked[:k_nearest]
                if nid == self.node_id or nid in node_to_peer
            }
        return output

    # bulk stores below this size keep the classic one-beam-per-key path;
    # grouping only pays when many keys share a neighborhood
    _STORE_GROUPING_MIN_KEYS = 16

    async def _find_nearest_grouped(
        self, key_ids: List[DHTID], k_nearest: int, exclude_self: bool
    ) -> Dict[DHTID, Dict[DHTID, PeerInfo]]:
        """``find_nearest_nodes`` for bulk stores: keys whose local nearest-neighbor
        sets coincide share ONE beam search (run for a representative key with a
        widened beam), and each member re-ranks the shared contact pool by its own
        xor distance. At 10k expert declarations over a 1k-peer swarm the per-key
        traversal is the dominant republish cost; most keys land in one of ~N
        distinct neighborhoods, so this collapses the traversal count from
        O(keys) to O(distinct neighborhoods)."""
        if len(key_ids) < self._STORE_GROUPING_MIN_KEYS:
            return await self.find_nearest_nodes(key_ids, k_nearest=k_nearest, exclude_self=exclude_self)
        # replica placement must stay (near-)exact: divergent replica sets shard
        # subkey dictionaries across extra nodes, and readers that stop at the
        # first fresh value then see PARTIAL dicts (measured: beam-search recall
        # 0.71 vs 1.0 with a naive top-k signature). Three safeguards: keys
        # group only when their local neighborhoods coincide at DOUBLE the
        # replica count, the shared traversal returns that doubled pool for
        # per-member re-ranking, and any member whose OWN routing table knows a
        # node nearer than its chosen k-th replica that the pool lacks (a
        # witness that the pool is inadequate for this key) falls back to an
        # exact traversal.
        pool_size = max(2 * k_nearest, k_nearest + 4)
        groups: Dict[frozenset, List[DHTID]] = {}
        local_nearest: Dict[DHTID, List[DHTID]] = {}
        for key_id in key_ids:
            ordered = [
                node_id
                for node_id, _info in self.protocol.routing_table.get_nearest_neighbors(key_id, pool_size)
            ]
            # kept for the witness check below: its k_nearest-prefix is exactly
            # this scan's head, so each key pays ONE table scan, not two
            local_nearest[key_id] = ordered[:k_nearest]
            groups.setdefault(frozenset(ordered), []).append(key_id)
        if len(groups) > 0.75 * len(key_ids):
            # neighborhoods barely overlap: grouping buys nothing, keep exact placement
            return await self.find_nearest_nodes(key_ids, k_nearest=k_nearest, exclude_self=exclude_self)
        representatives = [members[0] for members in groups.values()]
        rep_nearest = await self.find_nearest_nodes(
            representatives, k_nearest=pool_size, exclude_self=exclude_self
        )
        output: Dict[DHTID, Dict[DHTID, PeerInfo]] = {}
        fallback: List[DHTID] = []
        for members in groups.values():
            pool = rep_nearest[members[0]]
            for key_id in members:
                ranked = sorted(pool, key=key_id.xor_distance)[:k_nearest]
                worst = key_id.xor_distance(ranked[-1]) if ranked else None
                inadequate = worst is None or any(
                    node_id not in pool and key_id.xor_distance(node_id) < worst
                    for node_id in local_nearest[key_id]
                )
                if inadequate and key_id != members[0]:
                    fallback.append(key_id)
                else:
                    output[key_id] = {node_id: pool[node_id] for node_id in ranked}
        if fallback:
            output.update(
                await self.find_nearest_nodes(fallback, k_nearest=k_nearest, exclude_self=exclude_self)
            )
        saved = len(key_ids) - len(representatives) - len(fallback)
        if saved > 0:
            _DHT_STORE_TRAVERSALS_SAVED.inc(saved)
        return output

    # ------------------------------------------------------------------ store

    async def store(
        self, key: DHTKey, value: Any, expiration_time: DHTExpiration, subkey: Optional[Subkey] = None, **kwargs
    ) -> bool:
        result = await self.store_many([key], [value], [expiration_time], subkeys=[subkey], **kwargs)
        return result[(key, subkey) if subkey is not None else key]

    async def store_many(
        self,
        keys: Sequence[DHTKey],
        values: Sequence[Any],
        expiration_time: Union[DHTExpiration, Sequence[DHTExpiration]],
        subkeys: Optional[Sequence[Optional[Subkey]]] = None,
        exclude_self: bool = False,
        await_all_replicas: bool = True,
    ) -> Dict[Any, bool]:
        """Serialize values, find ``num_replicas`` nearest nodes per key (possibly
        including self), and store with per-subkey records + validator signatures."""
        started = time.perf_counter()
        with _tracing_span("dht.store", peer=str(self.protocol.p2p.peer_id), keys=len(keys)):
            return await self._store_many_traced(
                keys, values, expiration_time, subkeys, exclude_self, await_all_replicas, started
            )

    async def _store_many_traced(
        self, keys, values, expiration_time, subkeys, exclude_self, await_all_replicas, started
    ) -> Dict[Any, bool]:
        if isinstance(expiration_time, (int, float)):
            expiration_time = [expiration_time] * len(keys)
        if subkeys is None:
            subkeys = [None] * len(keys)
        assert len(keys) == len(values) == len(expiration_time) == len(subkeys)

        key_ids = [DHTID.generate(source=key) for key in keys]
        prepared: Dict[DHTID, List[Tuple[Optional[Subkey], bytes, DHTExpiration, Any]]] = defaultdict(list)
        for key, key_id, subkey, value, expiration in zip(keys, key_ids, subkeys, values, expiration_time):
            binary_value = MSGPackSerializer.dumps(value)
            if self.record_validator is not None:
                subkey_bytes = MSGPackSerializer.dumps(subkey) if subkey is not None else b""
                record = DHTRecord(key_id.to_bytes(), subkey_bytes, binary_value, expiration)
                binary_value = self.record_validator.sign_value(record)
            result_key = (key, subkey) if subkey is not None else key
            prepared[key_id].append((subkey, binary_value, expiration, result_key))

        nearest = await self._find_nearest_grouped(
            list(prepared.keys()), k_nearest=self.num_replicas, exclude_self=exclude_self or self.client_mode
        )

        output: Dict[Any, bool] = {}

        async def _store_one_key(key_id: DHTID) -> None:
            records = prepared[key_id]
            store_tasks = []
            for node_id, info in nearest[key_id].items():
                if node_id == self.node_id:
                    for subkey, binary_value, expiration, result_key in records:
                        if subkey is None:
                            ok = self.protocol._store_record(key_id, b"", binary_value, expiration, in_cache=False)
                        else:
                            ok = self.protocol._store_record(
                                key_id, MSGPackSerializer.dumps(subkey), binary_value, expiration, in_cache=False
                            )
                        output[result_key] = output.get(result_key, False) or ok
                else:
                    store_tasks.append(
                        asyncio.ensure_future(
                            self.protocol.call_store(
                                info.peer_id,
                                keys=[key_id] * len(records),
                                values=[r[1] for r in records],
                                expiration_time=[r[2] for r in records],
                                subkeys=[r[0] for r in records],
                            )
                        )
                    )

            def _register(reply) -> None:
                if reply is None:
                    return
                for (subkey, _bv, _exp, result_key), ok in zip(records, reply):
                    output[result_key] = output.get(result_key, False) or bool(ok)

            def _all_succeeded() -> bool:
                return all(output.get(r[3], False) for r in records)

            if await_all_replicas:
                for reply in await asyncio.gather(*store_tasks):
                    _register(reply)
            else:
                # return as soon as every record has one replica; stragglers finish
                # in the background (await_all_replicas=False)
                pending = set(store_tasks)
                while pending and not _all_succeeded():
                    done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                    for task in done:
                        _register(task.result())
            for _subkey, _bv, _exp, result_key in records:
                output.setdefault(result_key, False)

        await asyncio.gather(*(_store_one_key(key_id) for key_id in prepared))
        _DHT_OP_LATENCY.observe(time.perf_counter() - started, op="store")
        return output

    # ------------------------------------------------------------------ get

    async def get(self, key: DHTKey, latest: bool = False, **kwargs) -> Optional[ValueWithExpiration]:
        """Find the (freshest, if ``latest``) value for this key; deserialized."""
        result = await self.get_many([key], sufficient_expiration_time=float("inf") if latest else None, **kwargs)
        return result[key]

    async def get_many(
        self,
        keys: Collection[DHTKey],
        sufficient_expiration_time: Optional[DHTExpiration] = None,
        **kwargs,
    ) -> Dict[DHTKey, Optional[ValueWithExpiration]]:
        keys = list(keys)
        key_ids = [DHTID.generate(source=key) for key in keys]
        id_to_key = dict(zip(key_ids, keys))
        results_by_id = await self.get_many_by_id(key_ids, sufficient_expiration_time, **kwargs)
        return {id_to_key[key_id]: result for key_id, result in results_by_id.items()}

    async def get_many_by_id(
        self,
        key_ids: Collection[DHTID],
        sufficient_expiration_time: Optional[DHTExpiration] = None,
        num_workers: Optional[int] = None,
        beam_size: Optional[int] = None,
        return_futures: bool = False,
        _is_refresh: bool = False,
    ) -> Dict[DHTID, Union[Optional[ValueWithExpiration], Awaitable]]:
        """Beam search for each key; a key finishes as soon as a value fresh enough is
        found (sufficient_expiration_time defaults to 'valid now'). With
        ``return_futures``, each value is a future resolved when that key finishes."""
        started = time.perf_counter()
        # manual span install: in futures mode the op outlives this coroutine,
        # so the span is finished from the same done-callback that feeds the
        # latency metric; traversal tasks created below inherit the span
        op_span = _start_span(
            "dht.get", peer=str(self.protocol.p2p.peer_id), keys=len(list(key_ids))
        )
        span_token = _install_span(op_span)
        try:
            return await self._get_many_by_id_traced(
                key_ids, sufficient_expiration_time, num_workers, beam_size,
                return_futures, _is_refresh, started, op_span,
            )
        finally:
            _uninstall_span(span_token)

    async def _get_many_by_id_traced(
        self, key_ids, sufficient_expiration_time, num_workers, beam_size,
        return_futures, _is_refresh, started, op_span,
    ) -> Dict[DHTID, Union[Optional[ValueWithExpiration], Awaitable]]:
        key_ids = list(key_ids)
        if sufficient_expiration_time is None:
            sufficient_expiration_time = get_dht_time()
        beam_size = beam_size if beam_size is not None else self.beam_size
        num_workers = num_workers if num_workers is not None else self.num_workers
        search_results: Dict[DHTID, _SearchResult] = {kid: _SearchResult() for kid in key_ids}
        futures: Dict[DHTID, asyncio.Future] = {kid: asyncio.get_event_loop().create_future() for kid in key_ids}

        # step 0: in-flight request reuse (reuse_get_requests)
        reused: Dict[DHTID, asyncio.Future] = {}
        if self.reuse_get_requests and not _is_refresh:
            for key_id in key_ids:
                for pending_sufficient, pending_future in self._pending_get_requests[key_id]:
                    if pending_sufficient >= sufficient_expiration_time and not pending_future.done():
                        reused[key_id] = pending_future
                        break

        # step 1: local storage / cache
        unfinished: List[DHTID] = []
        for key_id in key_ids:
            if key_id in reused:
                continue
            state = search_results[key_id]
            for storage in (self.protocol.storage, self.protocol.cache):
                maybe = storage.get(key_id)
                if maybe is not None:
                    state.add_candidate(maybe, source_node_id=self.node_id)
            if state.expiration_time is not None and state.expiration_time >= sufficient_expiration_time:
                self._finalize_get(key_id, state, futures[key_id], _is_refresh)
            else:
                unfinished.append(key_id)

        # step 2: network traversal for the rest
        if unfinished:
            for key_id in unfinished:
                self._pending_get_requests[key_id].append((sufficient_expiration_time, futures[key_id]))

            node_to_peer = self._make_peer_resolver()
            initial = [
                nid for nid, _ in self.protocol.routing_table.get_nearest_neighbors(unfinished[0], beam_size)
            ]

            async def found_callback(key_id: DHTID, _nearest: List[DHTID], _visited) -> None:
                self._finalize_get(key_id, search_results[key_id], futures[key_id], _is_refresh)

            if initial:
                traverse_task = asyncio.create_task(
                    traverse_dht(
                        unfinished,
                        initial,
                        beam_size,
                        num_workers,
                        self.queries_per_call,
                        self._get_neighbors_fn(node_to_peer, search_results, sufficient_expiration_time),
                        found_callback=found_callback,
                    )
                )
                # caching policies need the traversal results
                caching_task = spawn(self._apply_caching_policies(traverse_task, unfinished, search_results, node_to_peer), name="dht.apply_caching_policies")
                self._background.add(caching_task)
                caching_task.add_done_callback(self._background.discard)
            else:
                for key_id in unfinished:
                    self._finalize_get(key_id, search_results[key_id], futures[key_id], _is_refresh)

        output: Dict[DHTID, Any] = {}
        for key_id in key_ids:
            future = reused.get(key_id, futures[key_id])
            output[key_id] = future if return_futures else None
        if return_futures:
            # the op finishes when the LAST future resolves — observe from a
            # done-callback so futures-mode gets (the long beam searches) are
            # not invisible to the latency metric
            watcher = asyncio.gather(
                *(reused.get(kid, futures[kid]) for kid in key_ids), return_exceptions=True
            )
            def _observe_get(_w) -> None:
                _DHT_OP_LATENCY.observe(time.perf_counter() - started, op="get")
                _finish_span(op_span)

            watcher.add_done_callback(_observe_get)
            return output
        gathered = await asyncio.gather(*(reused.get(kid, futures[kid]) for kid in key_ids))
        _DHT_OP_LATENCY.observe(time.perf_counter() - started, op="get")
        _finish_span(op_span)
        return dict(zip(key_ids, gathered))

    def _finalize_get(
        self, key_id: DHTID, state: _SearchResult, future: asyncio.Future, is_refresh: bool
    ) -> None:
        if future.done():
            return
        self._pending_get_requests[key_id] = [
            (exp, fut) for exp, fut in self._pending_get_requests[key_id] if fut is not future and not fut.done()
        ]
        if state.binary_value is None:
            future.set_result(None)
            return
        # validate + strip + deserialize
        try:
            if isinstance(state.binary_value, DictionaryDHTValue):
                out_dict = {}
                for subkey, (value, expiration) in state.binary_value.items():
                    stripped = self._validate_and_strip(key_id, subkey, value, expiration)
                    if stripped is not None:
                        out_dict[subkey] = ValueWithExpiration(MSGPackSerializer.loads(stripped), expiration)
                if not out_dict:
                    future.set_result(None)
                    return
                result = ValueWithExpiration(out_dict, state.expiration_time)
            else:
                stripped = self._validate_and_strip(key_id, None, state.binary_value, state.expiration_time)
                if stripped is None:
                    future.set_result(None)
                    return
                result = ValueWithExpiration(MSGPackSerializer.loads(stripped), state.expiration_time)
        except Exception as e:
            logger.warning(f"failed to deserialize value for key {key_id!r}: {e!r}")
            future.set_result(None)
            return
        future.set_result(result)
        # local caching + refresh scheduling (refreshes always re-store, else the
        # refresh traversal would accomplish nothing)
        if (self.cache_locally or is_refresh) and state.source_node_id != self.node_id:
            self.protocol.cache.store(key_id, state.binary_value, state.expiration_time)
        if self.cache_refresh_before_expiry > 0 and key_id in self.protocol.cache:
            self._schedule_cache_refresh(key_id, state.expiration_time)

    def _validate_and_strip(
        self, key_id: DHTID, subkey: Optional[Subkey], value: bytes, expiration: DHTExpiration
    ) -> Optional[bytes]:
        if self.record_validator is None:
            return value
        subkey_bytes = MSGPackSerializer.dumps(subkey) if subkey is not None else b""
        record = DHTRecord(key_id.to_bytes(), subkey_bytes, value, expiration)
        if not self.record_validator.validate(record):
            logger.debug(f"record validation failed for key {key_id!r}")
            return None
        return self.record_validator.strip_value(record)

    async def _apply_caching_policies(
        self,
        traverse_task: asyncio.Task,
        key_ids: List[DHTID],
        search_results: Dict[DHTID, _SearchResult],
        node_to_peer: Dict[DHTID, PeerInfo],
    ) -> None:
        """cache_nearest: replicate found values to the nearest queried node that did
        not have them."""
        try:
            await traverse_task
        except Exception:
            return
        if not self.cache_nearest:
            return
        for key_id in key_ids:
            state = search_results[key_id]
            if state.binary_value is None or isinstance(state.binary_value, DictionaryDHTValue):
                continue
            num_cached = 0
            for node_id in sorted(state.nearest_without_value, key=key_id.xor_distance):
                if num_cached >= self.cache_nearest:
                    break
                info = node_to_peer.get(node_id)
                if info is None:
                    continue
                await self.protocol.call_store(
                    info.peer_id, [key_id], [state.binary_value], state.expiration_time, in_cache=True
                )
                num_cached += 1

    # ------------------------------------------------------------------ cache refresh

    def _schedule_cache_refresh(self, key_id: DHTID, expiration_time: DHTExpiration) -> None:
        if self._refresh_task is None or self._refresh_task.done():
            self._refresh_task = spawn(self._refresh_stale_cache_entries(), name="dht.cache_refresh")
        refresh_time = expiration_time - self.cache_refresh_before_expiry
        self._cache_refresh_queue.store(key_id, expiration_time, refresh_time)
        self._cache_refresh_available.set()

    async def _refresh_stale_cache_entries(self) -> None:
        """Background task: re-fetch cached keys shortly before they expire."""
        while True:
            while not self._cache_refresh_queue:
                self._cache_refresh_available.clear()  # lint: single-writer — sole refresh task
                await self._cache_refresh_available.wait()
            entry = self._cache_refresh_queue.top()
            if entry is None:
                continue
            key_id, (expiration_time, refresh_deadline) = entry[0], (entry[1].value, entry[1].expiration_time)
            wait_time = refresh_deadline - get_dht_time()
            if wait_time > 0:
                try:
                    await asyncio.wait_for(self._cache_refresh_available.wait(), timeout=wait_time)
                    self._cache_refresh_available.clear()
                    continue  # queue changed; re-evaluate the top entry
                except asyncio.TimeoutError:
                    pass
            if key_id in self._cache_refresh_queue:
                del self._cache_refresh_queue[key_id]  # lint: single-writer — sole refresh task
            if key_id not in self.protocol.cache:
                continue
            await self.get_many_by_id(
                [key_id], sufficient_expiration_time=expiration_time + self.cache_refresh_before_expiry,
                _is_refresh=True,
            )

    # ------------------------------------------------------------------ misc

    async def get_visible_maddrs(self, latest: bool = False) -> List[Multiaddr]:
        return self.p2p.get_visible_maddrs(latest)

    async def shutdown(self) -> None:
        if self._refresh_task is not None:
            self._refresh_task.cancel()
        for task in list(self._background):
            task.cancel()
        await self.protocol.shutdown()
        if self._owns_p2p:
            await self.p2p.shutdown()
