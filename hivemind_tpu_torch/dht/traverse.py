"""Concurrent multi-query Kademlia beam search (the port's copy of
hivemind_tpu/dht/traverse.py; pure asyncio).

``traverse_dht`` runs ``num_workers`` cooperative workers over a set of queries.
Each query keeps a candidate heap (unvisited nodes by xor distance) and a nearest
heap (visited nodes). A worker picks the query whose best candidate is relatively
closest, visits that candidate via ``get_neighbors``, batching up to
``queries_per_call`` other queries onto the same RPC, and finishes a query once no
candidate can improve its beam.
"""

from __future__ import annotations

import asyncio
import heapq
from collections import defaultdict
from typing import Awaitable, Callable, Collection, Dict, List, Optional, Set, Tuple

from hivemind_tpu_torch.dht.routing import DHTID

# get_neighbors(peer, queries) -> {query: (neighbor_ids, should_stop)}
GetNeighborsFn = Callable[[DHTID, Collection[DHTID]], Awaitable[Dict[DHTID, Tuple[List[DHTID], bool]]]]


async def simple_traverse_dht(
    query_id: DHTID,
    initial_nodes: Collection[DHTID],
    beam_size: int,
    get_neighbors: GetNeighborsFn,
    visited_nodes: Collection[DHTID] = (),
) -> Tuple[List[DHTID], Set[DHTID]]:
    """Single-query, single-worker reference implementation;
    used in tests as ground truth for the concurrent version."""
    visited_nodes = set(visited_nodes)
    initial_nodes = list(dict.fromkeys(n for n in initial_nodes if n not in visited_nodes))
    candidates = [(query_id.xor_distance(node), node) for node in initial_nodes]
    heapq.heapify(candidates)
    nearest: List[Tuple[int, DHTID]] = [(-d, n) for d, n in candidates]
    heapq.heapify(nearest)
    known = set(initial_nodes)  # beam-membership dedup
    while len(nearest) > beam_size:
        heapq.heappop(nearest)

    while candidates:
        distance, peer = heapq.heappop(candidates)
        if len(nearest) == beam_size and distance > -nearest[0][0]:
            break
        if peer in visited_nodes:
            continue
        visited_nodes.add(peer)
        response = await get_neighbors(peer, [query_id])
        neighbors, should_stop = response.get(query_id, ([], False))
        for neighbor in neighbors:
            if neighbor in visited_nodes or neighbor in known:
                continue
            neighbor_distance = query_id.xor_distance(neighbor)
            if len(nearest) < beam_size or neighbor_distance < -nearest[0][0]:
                known.add(neighbor)
                heapq.heappush(candidates, (neighbor_distance, neighbor))
                heapq.heappush(nearest, (-neighbor_distance, neighbor))
                if len(nearest) > beam_size:
                    heapq.heappop(nearest)
        if should_stop:
            break
    return [node for _, node in sorted((-d, n) for d, n in nearest)], visited_nodes


class _QueryState:
    __slots__ = ("query", "candidates", "nearest", "in_beam", "visited", "finished", "stop_requested")

    def __init__(self, query: DHTID, initial_nodes: Collection[DHTID], visited: Set[DHTID]):
        self.query = query
        self.visited = visited  # shared across queries: global set of called peers
        self.candidates: List[Tuple[int, DHTID]] = [
            (query.xor_distance(node), node) for node in initial_nodes
        ]
        heapq.heapify(self.candidates)
        self.nearest: List[Tuple[int, DHTID]] = [(-d, n) for d, n in self.candidates]
        heapq.heapify(self.nearest)
        self.in_beam: Set[DHTID] = set(node for _, node in self.candidates)
        self.finished = False
        self.stop_requested = False

    def beam_size_now(self) -> int:
        return len(self.nearest)

    def upper_bound(self, beam_size: int) -> int:
        """Max distance within the current beam (or inf if beam not yet full)."""
        if len(self.nearest) < beam_size:
            return 1 << 300
        return -self.nearest[0][0]

    def add_neighbor(self, neighbor: DHTID, beam_size: int) -> None:
        if neighbor in self.in_beam:
            return
        distance = self.query.xor_distance(neighbor)
        if len(self.nearest) < beam_size or distance < -self.nearest[0][0]:
            self.in_beam.add(neighbor)
            heapq.heappush(self.nearest, (-distance, neighbor))
            if len(self.nearest) > beam_size:
                heapq.heappop(self.nearest)
            if neighbor not in self.visited:
                heapq.heappush(self.candidates, (distance, neighbor))

    def pop_best_candidate(self, beam_size: int) -> Optional[DHTID]:
        """Peek the best unvisited candidate that could still improve the beam, or None
        (the caller decides whether None means 'finished' — in-flight RPCs may still
        repopulate candidates)."""
        while self.candidates:
            distance, node = self.candidates[0]
            if node in self.visited:
                heapq.heappop(self.candidates)
                continue
            if distance > self.upper_bound(beam_size):
                return None
            return node
        return None

    def best_distance(self) -> int:
        while self.candidates and self.candidates[0][1] in self.visited:
            heapq.heappop(self.candidates)
        if not self.candidates:
            return 1 << 300
        return self.candidates[0][0]

    def result(self) -> List[DHTID]:
        return [node for _, node in sorted((-d, n) for d, n in self.nearest)]


async def traverse_dht(
    queries: Collection[DHTID],
    initial_nodes: List[DHTID],
    beam_size: int,
    num_workers: int,
    queries_per_call: int,
    get_neighbors: GetNeighborsFn,
    visited_nodes: Optional[Dict[DHTID, Set[DHTID]]] = None,
    found_callback: Optional[Callable[[DHTID, List[DHTID], Set[DHTID]], Awaitable]] = None,
    await_all_tasks: bool = True,
) -> Tuple[Dict[DHTID, List[DHTID]], Dict[DHTID, Set[DHTID]]]:
    """Concurrent beam search for multiple queries.

    :returns: ({query: nearest nodes, closest first}, {query: visited node set})
    """
    queries = list(dict.fromkeys(queries))
    if not queries or not initial_nodes:
        return {q: [] for q in queries}, {q: set(visited_nodes.get(q, ())) if visited_nodes else set() for q in queries}

    per_query_visited: Dict[DHTID, Set[DHTID]] = {
        q: set(visited_nodes.get(q, ())) if visited_nodes else set() for q in queries
    }
    states = {q: _QueryState(q, initial_nodes, per_query_visited[q]) for q in queries}
    active = set(queries)
    callback_tasks: List[asyncio.Task] = []
    search_finished = asyncio.Event()
    wakeup = asyncio.Event()
    in_flight = 0
    in_flight_per_query: Dict[DHTID, int] = defaultdict(int)

    def _finish_query(query: DHTID) -> None:
        state = states[query]
        if query in active:
            active.discard(query)
            state.finished = True
            if found_callback is not None:
                callback_tasks.append(
                    asyncio.create_task(found_callback(query, state.result(), per_query_visited[query]))
                )
        if not active:
            search_finished.set()

    async def worker() -> None:
        nonlocal in_flight
        while active:
            # pick the active query with the relatively closest unvisited candidate;
            # a query with no viable candidate finishes only once none of its RPCs
            # are in flight (an in-flight response may repopulate its heap)
            best_query, best_priority = None, None
            for query in list(active):
                state = states[query]
                if state.finished:
                    continue
                candidate = state.pop_best_candidate(beam_size)
                if candidate is None:
                    if in_flight_per_query[query] == 0:
                        _finish_query(query)
                    continue
                priority = state.best_distance()
                if best_priority is None or priority < best_priority:
                    best_query, best_priority = query, priority
            if best_query is None:
                if in_flight > 0 and active:
                    # someone else's RPC may add candidates; wait for it
                    wakeup.clear()
                    await wakeup.wait()
                    continue
                for query in list(active):
                    _finish_query(query)
                return

            state = states[best_query]
            peer = state.pop_best_candidate(beam_size)
            if peer is None:
                continue
            # batch other queries that still want to visit this peer
            batch = [best_query]
            for query in list(active):
                if len(batch) >= queries_per_call:
                    break
                if query == best_query or states[query].finished:
                    continue
                if peer not in per_query_visited[query]:
                    batch.append(query)
            for query in batch:
                per_query_visited[query].add(peer)
                in_flight_per_query[query] += 1

            in_flight += 1
            try:
                responses = await get_neighbors(peer, batch)
            except Exception:
                responses = {}
            finally:
                in_flight -= 1
                for query in batch:
                    in_flight_per_query[query] -= 1
                wakeup.set()

            for query in batch:
                neighbors, should_stop = responses.get(query, ([], False))
                q_state = states[query]
                for neighbor in neighbors:
                    q_state.add_neighbor(neighbor, beam_size)
                if should_stop:
                    q_state.stop_requested = True
                    _finish_query(query)

    workers = [asyncio.create_task(worker()) for i in range(max(1, num_workers))]
    try:
        await asyncio.wait_for(search_finished.wait(), timeout=None)
    finally:
        for task in workers:
            task.cancel()
        await asyncio.gather(*workers, return_exceptions=True)
    if await_all_tasks and callback_tasks:
        await asyncio.gather(*callback_tasks, return_exceptions=True)

    return {q: states[q].result() for q in queries}, per_query_visited
