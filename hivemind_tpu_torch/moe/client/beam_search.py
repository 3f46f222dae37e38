"""MoEBeamSearcher: find the k best experts on the uid grid by a left-to-right beam
search over the DHT's prefix dictionaries (the port of
hivemind_tpu/moe/client/beam_search.py). The search runs on the DHT's loop
(``DHT.run_coroutine``), serves a whole batch in one pass (prefix fetches are
shared across samples), and caches dead prefixes for ``negative_cache_time``
seconds. Candidates are ranked as the JAX searcher ranks them (``heapq`` on
``(-score, uid)``), so both packages choose the same experts in the same order on
the same DHT and scores."""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe.expert_uid import UID_DELIMITER, ExpertInfo, is_valid_prefix
from hivemind_tpu_torch.moe.server.dht_handler import expert_info_from_entry
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.timed_storage import TimedStorage, get_dht_time


class MoEBeamSearcher:
    """:param uid_prefix: grid name, e.g. 'ffn.' (a trailing delimiter is added)
    :param grid_size: number of indices per grid dimension"""

    def __init__(self, dht: DHT, uid_prefix: str, grid_size: Sequence[int], *, negative_cache_time: float = 30.0):
        if not uid_prefix.endswith(UID_DELIMITER):
            uid_prefix += UID_DELIMITER
        if not is_valid_prefix(uid_prefix):
            raise ValueError(f"invalid prefix {uid_prefix!r}")
        self.dht = dht
        self.uid_prefix = uid_prefix
        self.grid_size = tuple(grid_size)
        self.negative_cache_time = negative_cache_time
        self._negative_cache: TimedStorage[str, bool] = TimedStorage()

    def find_best_experts(self, grid_scores: Sequence[np.ndarray], beam_size: int) -> List[ExpertInfo]:
        """``grid_scores[d][i]`` scores coordinate i of dimension d for ONE sample;
        returns up to ``beam_size`` experts by total score, best first."""
        return self.batch_find_best_experts([np.asarray(s)[None] for s in grid_scores], beam_size)[0]

    def batch_find_best_experts(self, batch_grid_scores: Sequence[np.ndarray], beam_size: int) -> List[List[ExpertInfo]]:
        """``batch_grid_scores[d][b, i]``: each sample's scores; one DHT pass serves
        the whole batch."""
        scores = [np.asarray(dim_scores, np.float32) for dim_scores in batch_grid_scores]
        if len(scores) != len(self.grid_size):
            raise ValueError(f"{len(scores)} score arrays for a grid of {len(self.grid_size)} dimensions")

        async def _search(_dht, node) -> List[List[ExpertInfo]]:
            with _tracing_span("moe.beam_search", peer=str(node.protocol.p2p.peer_id), prefix=self.uid_prefix,
                               beam_size=beam_size):
                return await self._beam_search(node, scores, beam_size)

        return self.dht.run_coroutine(_search)

    async def _beam_search(self, node, scores, beam_size: int) -> List[List[ExpertInfo]]:
        batch_size = scores[0].shape[0]
        # per-sample beams: (negated total score, prefix without its trailing delimiter)
        beams: List[List[Tuple[float, str]]] = [[(0.0, self.uid_prefix.rstrip(UID_DELIMITER))]
                                                for _ in range(batch_size)]
        for dim, dim_scores in enumerate(scores):
            active: Dict[str, None] = {}  # every live prefix across the batch, once
            for beam in beams:
                for _neg_score, prefix in beam:
                    if prefix not in self._negative_cache:
                        active[prefix] = None
            prefix_coords = await self._fetch_prefix_dicts(node, list(active))
            new_beams: List[List[Tuple[float, str]]] = []
            for sample in range(batch_size):
                candidates: List[Tuple[float, str]] = []
                for neg_score, prefix in beams[sample]:
                    for coord in prefix_coords.get(prefix, {}):
                        if 0 <= coord < self.grid_size[dim]:
                            score = -neg_score + float(dim_scores[sample, coord])
                            candidates.append((-score, f"{prefix}{UID_DELIMITER}{coord}"))
                new_beams.append(heapq.nsmallest(beam_size, candidates))
            beams = new_beams

        leaf_uids: Dict[str, None] = {uid: None for beam in beams for _neg, uid in beam}
        uid_to_info = await self._resolve_leaves(node, list(leaf_uids))
        return [[uid_to_info[uid] for _neg, uid in sorted(beam) if uid in uid_to_info] for beam in beams]

    async def _fetch_prefix_dicts(self, node, prefixes: List[str]) -> Dict[str, Dict[int, None]]:
        if not prefixes:
            return {}
        found = await node.get_many(prefixes)
        out: Dict[str, Dict[int, None]] = {}
        for prefix in prefixes:
            entry = found.get(prefix)
            coords: Dict[int, None] = {}
            if entry is not None and isinstance(entry.value, dict):
                coords = {subkey: None for subkey in entry.value if isinstance(subkey, int)}
            if coords:
                out[prefix] = coords
            else:  # a dead prefix: not asked again for a while
                self._negative_cache.store(prefix, True, get_dht_time() + self.negative_cache_time)
        return out

    async def _resolve_leaves(self, node, uids: List[str]) -> Dict[str, ExpertInfo]:
        """uid -> its :class:`ExpertInfo` with the full replica set the record holds
        (a bare peer id, ``peer|compression``, or a subkey dictionary of replicas).
        First-fresh on purpose, as the JAX searcher: this runs on every forward of
        a mixture, and a partial replica dictionary only thins this call's
        balancing, while failover, breakers and the alive mask handle a stale
        entry."""
        if not uids:
            return {}
        found = await node.get_many(uids)
        out = {}
        for uid in uids:
            entry = found.get(uid)
            info = expert_info_from_entry(uid, entry.value) if entry is not None else None
            if info is not None:
                out[uid] = info
        return out
