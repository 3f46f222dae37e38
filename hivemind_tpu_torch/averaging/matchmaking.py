"""Decentralized group formation (the port of hivemind_tpu/averaging/matchmaking.py;
upstream: hivemind/averaging/matchmaking.py).

Every averager looking for a group declares itself in the DHT with an expiration (its
step deadline). Peers always request to join the declared averager with the EARLIEST
expiration below their own — so the join graph is a DAG and the earliest-expiring peer
becomes the leader. A leader assembles its group when full or when its own deadline
arrives; an averager that itself got accepted elsewhere disbands its followers with a
redirect to its new leader (suggested_leader). The documented deadlock (two peers
waiting on each other through a chain) is broken by ``request_timeout`` on the first
response (upstream matchmaking.py:29-35)."""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import time
from typing import AsyncIterator, Dict, Optional, Tuple

from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.averaging.key_manager import GroupKeyManager
from hivemind_tpu_torch.p2p import P2P, P2PContext, P2PHandlerError, PeerID
from hivemind_tpu_torch.proto import averaging_pb2
from hivemind_tpu_torch.resilience import RetryPolicy
from hivemind_tpu_torch.utils.asyncio_utils import anext_safe, cancel_and_wait, spawn
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

logger = get_logger(__name__)

# layer-3 telemetry: how long group formation takes and
# how often it fails — the first place to look when a training round stalls
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span

_MATCHMAKING_WAIT = _TELEMETRY.histogram(
    "hivemind_averaging_matchmaking_seconds",
    "declare-to-outcome wall time of one look_for_group",
    ("outcome",),
)
_MATCHMAKING_ROUNDS = _TELEMETRY.counter(
    "hivemind_averaging_matchmaking_rounds_total", "look_for_group attempts", ("outcome",)
)
_GROUP_SIZE = _TELEMETRY.gauge(
    "hivemind_averaging_group_size", "size of the most recently assembled group"
)


class MatchmakingException(Exception):
    pass


class Matchmaking:
    """One per averager; drives both the follower side (look_for_group →
    request-join) and the leader side (rpc_join_group → assemble)."""

    def __init__(
        self,
        p2p: P2P,
        key_manager: GroupKeyManager,
        get_stub,  # callable(peer_id) -> averager stub (for rpc_join_group)
        *,
        schema_hash: str,
        target_group_size: Optional[int],
        min_group_size: int = 2,
        min_matchmaking_time: float = 5.0,
        request_timeout: float = 3.0,
        client_mode: bool = False,
    ):
        self.p2p = p2p
        self.peer_id = p2p.peer_id
        self.key_manager = key_manager
        self.get_stub = get_stub
        self.schema_hash = schema_hash
        self.target_group_size = target_group_size
        self.min_group_size = min_group_size
        self.min_matchmaking_time = min_matchmaking_time
        self.request_timeout = request_timeout
        self.client_mode = client_mode

        # pacing between leader-candidate polls: request_timeout/2 plus a small
        # full-jitter slice through the shared policy (resilience/policy.py) —
        # the historical U(rt/2, rt/2 + 0.2) desynchronization window, declared
        self._poll_floor = request_timeout / 2
        self._poll_policy = RetryPolicy(
            max_attempts=None,
            base_delay=0.2,
            backoff=1.0,
            jitter="full",
            name="matchmaking_poll",
        )
        self.lock_looking_for_group = asyncio.Lock()
        self.looking_for_group = False
        self.declared_expiration_time: DHTExpiration = -float("inf")
        self.current_leader: Optional[PeerID] = None
        # follower peer_id -> (JoinRequest, outbox queue for BEGIN/DISBAND messages)
        self.current_followers: Dict[PeerID, Tuple[averaging_pb2.JoinRequest, asyncio.Queue]] = {}
        self.data_for_gather: bytes = b""
        self.assembled_group: Optional[GroupInfo] = None
        # wakes the leader's search loop the moment its group assembles: without
        # this, a leader whose group filled early slept out the remainder of its
        # declared window (up to the full min_matchmaking_time), gating every
        # follower's round start on a timer instead of an event (a
        # ~0.7 s/round idle gap on the averaging benchmark)
        self._group_assembled = asyncio.Event()
        self._tried_leaders: set = set()
        self._join_in_progress = False  # excludes full-group assembly while we court a leader
        # adaptive lead time: a fixed min_matchmaking_time collapses
        # under contention (32 peers / 1 s window / one core: declare+fetch storms
        # outlast the window and success drops to 0). Track the declare→group-fill
        # latency (EMA over successful rounds) and back off multiplicatively on
        # window-expired failures, so bare DecentralizedAverager users self-heal
        # without an operator re-sizing the lead time.
        self.fill_latency_ema: Optional[float] = None
        self._lead_backoff = 1.0
        # set once another declared averager (or an inbound join request) has
        # EVER been seen. Backoff applies to EVERY window expiry — under a
        # 32-peer declare storm that unconditional stretch is what lets the
        # swarm converge (gating it on per-window observations regressed the
        # storm case to success 0.48) — but FIRST CONTACT resets it:
        # a peer that started before its swarm may have ratcheted to the cap
        # while alone (harmless: nobody to match with), and must form its first
        # real group at the base lead time, not 30 s later
        self._others_observed = False

    def suggested_lead_time(self) -> float:
        """The effective matchmaking window to use when the caller did not pin a
        scheduled_time: at least ``min_matchmaking_time``, stretched by observed
        fill latency and by failure backoff, capped so a dead swarm cannot push
        retries out indefinitely."""
        observed = 1.25 * self.fill_latency_ema if self.fill_latency_ema is not None else 0.0
        base = max(self.min_matchmaking_time, observed)
        cap = max(8.0 * self.min_matchmaking_time, 30.0)
        return min(base * self._lead_backoff, cap)

    def _record_round_outcome(self, latency: Optional[float]) -> None:
        """latency = declare→assembled seconds on success, None on a window-expired
        failure."""
        if latency is not None:
            self.fill_latency_ema = (
                latency if self.fill_latency_ema is None
                else 0.7 * self.fill_latency_ema + 0.3 * latency
            )
            self._lead_backoff = max(1.0, self._lead_backoff / 2.0)
        else:
            self._lead_backoff = min(self._lead_backoff * 2.0, 16.0)

    def _note_others_observed(self) -> None:
        """First contact with the swarm: discard any solo-era backoff so the
        first REAL group forms at the base lead time (see __init__ notes)."""
        if not self._others_observed:
            self._others_observed = True
            self._lead_backoff = 1.0

    @property
    def is_looking_for_group(self) -> bool:
        return self.looking_for_group

    # ------------------------------------------------------------------ follower side

    async def look_for_group(
        self, *, data_for_gather: bytes, scheduled_time: Optional[DHTExpiration] = None, timeout: Optional[float] = None
    ) -> Optional[GroupInfo]:
        """Search until a group assembles or the deadline passes. Returns None if no
        group could be formed this attempt."""
        if self.lock_looking_for_group.locked():
            logger.debug("another look_for_group is in progress; waiting")
        async with self.lock_looking_for_group:
            self.looking_for_group = True
            self.data_for_gather = data_for_gather
            self.assembled_group = None
            self._group_assembled.clear()
            self._tried_leaders.clear()
            now = get_dht_time()
            self.declared_expiration_time = max(
                scheduled_time if scheduled_time is not None else now + self.min_matchmaking_time,
                now + 1e-2,
            )
            if timeout is not None:
                self.declared_expiration_time = min(self.declared_expiration_time, now + timeout)
            declared_key = self.key_manager.current_key  # rebucketing may change it mid-round
            declare_task = None
            if not self.client_mode:
                # land our own declaration BEFORE searching: peers must be able to
                # find us for the whole window, or near-simultaneous searchers can
                # repeatedly miss each other
                with contextlib.suppress(Exception):
                    await self.key_manager.declare_averager(
                        declared_key, self.peer_id, self.declared_expiration_time
                    )
                declare_task = spawn(self._declare_periodically(declared_key), name="matchmaking.declare_periodically")
            search_started = get_dht_time()
            wait_started = time.perf_counter()  # the metric must survive clock steps
            group = None
            outcome = "error"  # overwritten on a normal return; errors stay visible
            # the with block (not manual enter/exit) so an unexpected exception
            # leaves its `error` event on the span; cleanup runs inside it — the
            # retract/disband time is part of the round's wall time
            with _tracing_span("averaging.matchmaking", peer=str(self.peer_id)) as match_span:
                try:
                    group = await self._search_until_deadline()
                    outcome = "assembled" if group is not None else "expired"
                    self._record_round_outcome(
                        get_dht_time() - search_started if group is not None else None
                    )
                    return group
                except asyncio.CancelledError:
                    outcome = "cancelled"  # control.cancel / shutdown: not an error
                    raise
                finally:
                    if match_span is not None:
                        match_span.set("outcome", outcome)
                        if group is not None:
                            match_span.set("group_size", len(group.peer_ids))
                    _MATCHMAKING_WAIT.observe(time.perf_counter() - wait_started, outcome=outcome)
                    _MATCHMAKING_ROUNDS.inc(outcome=outcome)
                    if group is not None:
                        _GROUP_SIZE.set(len(group.peer_ids))
                    self.looking_for_group = False
                    self.current_leader = None
                    if declare_task is not None:
                        await cancel_and_wait(declare_task)
                        # retract under the key we DECLARED under, not the new
                        # bucket — in the background: a successful round must not
                        # delay its all-reduce behind a DHT store (the storage is
                        # newest-expiration-wins, so a late retract can never
                        # clobber the next round's declaration; until it lands,
                        # join requests get REJECT_NOT_LOOKING_FOR_GROUP)
                        spawn(self._retract_declaration(declared_key), name="matchmaking.retract_declaration")
                    if self.current_followers and self.assembled_group is None:
                        self._disband_followers(suggested_leader=None)

    async def _retract_declaration(self, key: str) -> None:
        with contextlib.suppress(Exception):
            await self.key_manager.declare_averager(
                key, self.peer_id, get_dht_time(), looking_for_group=False
            )

    async def _declare_periodically(self, key: str) -> None:
        # sleep FIRST: look_for_group already stored the initial declaration
        while True:
            remaining = self.declared_expiration_time - get_dht_time()
            if remaining <= 0:
                return
            await asyncio.sleep(max(remaining / 2, 0.5))
            with contextlib.suppress(Exception):
                await self.key_manager.declare_averager(key, self.peer_id, self.declared_expiration_time)

    async def _search_until_deadline(self) -> Optional[GroupInfo]:
        while get_dht_time() < self.declared_expiration_time:
            if self.assembled_group is not None:
                return self.assembled_group  # a full group assembled around us
            leader = await self._find_next_leader()
            if self.assembled_group is not None:
                return self.assembled_group
            if leader is not None:
                group = await self._request_join_group(leader)
                if group is not None:
                    return group
                continue
            remaining = self.declared_expiration_time - get_dht_time()
            if remaining > 0:
                # pacing sleep, interrupted the instant a full group assembles
                # around us — the data path must start at fill time, not when the
                # declared window runs out
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._group_assembled.wait(),
                        timeout=min(remaining, self._poll_floor + self._poll_policy.delay(0)),
                    )
        # the group may have assembled (full-group path) during the final sleep
        if self.assembled_group is not None:
            return self.assembled_group
        # our deadline arrived: we lead whoever joined us (if enough), else give up
        if len(self.current_followers) + 1 >= self.min_group_size:
            return self._leader_assemble_group()
        await self.key_manager.update_key_on_not_enough_peers()
        return None

    async def _find_next_leader(self) -> Optional[PeerID]:
        """The declared averager with the earliest expiration strictly before ours
        (ties broken by peer id) that we haven't already tried this round."""
        try:
            candidates = await self.key_manager.get_averagers(self.key_manager.current_key)
        except Exception as e:
            logger.debug(f"could not fetch potential leaders: {e!r}")
            return None
        now = get_dht_time()
        best: Optional[Tuple[DHTExpiration, PeerID]] = None
        for peer_id, expiration in candidates:
            if peer_id == self.peer_id:
                continue
            self._note_others_observed()
            if peer_id in self._tried_leaders:
                continue
            if expiration <= now or expiration >= self.declared_expiration_time:
                continue  # stale, or they should be joining us instead
            if best is None or (expiration, peer_id) < best:
                best = (expiration, peer_id)
        return best[1] if best is not None else None

    async def _request_join_group(self, leader: PeerID) -> Optional[GroupInfo]:
        """Stream rpc_join_group to a (chain of) leader(s); follows suggested_leader
        redirects (upstream matchmaking.py:178-252)."""
        visited_chain: set = set()
        current: Optional[PeerID] = leader
        while current is not None and current not in visited_chain and get_dht_time() < self.declared_expiration_time:
            visited_chain.add(current)
            self._tried_leaders.add(current)  # lint: single-writer — one matchmaking cycle per averager
            group = None
            suggested = None
            try:
                group, suggested = await self._request_join_one(current)
            except (P2PHandlerError, ConnectionError, asyncio.TimeoutError, OSError) as e:
                logger.debug(f"join request to {current} failed: {e!r}")
            if group is not None:
                return group
            current = suggested
        return None

    async def _request_join_one(self, leader: PeerID):
        stream = None
        self._join_in_progress = True
        try:
            stub = self.get_stub(leader)
            request = averaging_pb2.JoinRequest(
                group_key=self.key_manager.current_key.encode(),
                expiration=self.declared_expiration_time,
                gather=self.data_for_gather,
                client_mode=self.client_mode,
                schema_hash=self.schema_hash,
            )
            stream = stub.rpc_join_group(request).__aiter__()
            first = await asyncio.wait_for(anext_safe(stream), timeout=self.request_timeout)
            if not isinstance(first, averaging_pb2.MessageFromLeader):
                return None, None
            if first.code == averaging_pb2.GROUP_DISBANDED:
                return None, PeerID(first.suggested_leader) if first.suggested_leader else None
            if first.code != averaging_pb2.ACCEPTED:
                logger.debug(f"{leader} rejected us: {averaging_pb2.MessageCode.Name(first.code)}")
                return None, None

            # accepted: we are now a follower — disband our own would-be group
            self.current_leader = leader
            if self.current_followers:
                self._disband_followers(suggested_leader=leader)
            # the leader must answer by (its expiration ≤ ours) + grace
            deadline = self.declared_expiration_time - get_dht_time() + self.request_timeout * 2
            second = await asyncio.wait_for(anext_safe(stream), timeout=max(deadline, self.request_timeout))
            if not isinstance(second, averaging_pb2.MessageFromLeader):
                return None, None
            if second.code == averaging_pb2.BEGIN_ALLREDUCE:
                group = GroupInfo(
                    group_id=second.group_id,
                    peer_ids=tuple(PeerID(pid) for pid in second.ordered_peer_ids),
                    gathered=tuple(second.gathered),
                )
                if self.peer_id not in group:
                    raise MatchmakingException(f"leader {leader} assembled a group without us")
                await self.key_manager.update_key_on_group_assembled(group)
                return group, None
            if second.code == averaging_pb2.GROUP_DISBANDED:
                return None, PeerID(second.suggested_leader) if second.suggested_leader else None
            return None, None
        finally:
            self._join_in_progress = False
            self.current_leader = None
            if stream is not None:
                with contextlib.suppress(Exception):
                    await stream.aclose()

    # ------------------------------------------------------------------ leader side

    async def rpc_join_group(
        self, request: averaging_pb2.JoinRequest, context: P2PContext
    ) -> AsyncIterator[averaging_pb2.MessageFromLeader]:
        """Serve a follower's join request: ACCEPTED now, BEGIN_ALLREDUCE /
        GROUP_DISBANDED later (upstream matchmaking.py:262-332)."""
        reject = self._check_join_request(request, context)
        if reject is not None:
            yield reject
            return
        outbox: asyncio.Queue = asyncio.Queue()
        self._note_others_observed()
        self.current_followers[context.remote_id] = (request, outbox)  # lint: single-writer — each handler owns its follower key
        try:
            yield averaging_pb2.MessageFromLeader(code=averaging_pb2.ACCEPTED)
            if (
                self.target_group_size is not None
                and len(self.current_followers) + 1 >= self.target_group_size
                and self.current_leader is None
                and not self._join_in_progress  # split-brain guard: we may be mid-join
                and self.assembled_group is None
            ):
                self._leader_assemble_group()  # group is full: begin early
            timeout = self.declared_expiration_time - get_dht_time() + self.request_timeout * 2
            try:
                message = await asyncio.wait_for(outbox.get(), timeout=max(timeout, self.request_timeout))
            except asyncio.TimeoutError:
                message = averaging_pb2.MessageFromLeader(code=averaging_pb2.GROUP_DISBANDED)
            yield message
        finally:
            self.current_followers.pop(context.remote_id, None)

    def _check_join_request(
        self, request: averaging_pb2.JoinRequest, context: P2PContext
    ) -> Optional[averaging_pb2.MessageFromLeader]:
        """The nine rejection reasons (upstream matchmaking.py:334-369)."""
        code = None
        suggested = b""
        now = get_dht_time()
        if not self.looking_for_group or self.assembled_group is not None:
            code = averaging_pb2.REJECT_NOT_LOOKING_FOR_GROUP
        elif self.client_mode:
            code = averaging_pb2.REJECT_REQUEST_TO_CLIENT
        elif request.group_key != self.key_manager.current_key.encode():
            code = averaging_pb2.REJECT_WRONG_GROUP_KEY
        elif request.schema_hash != self.schema_hash:
            code = averaging_pb2.PROTOCOL_VIOLATION
        elif self.current_leader is not None:
            code = averaging_pb2.GROUP_DISBANDED
            suggested = self.current_leader.to_bytes()
        elif request.expiration <= now:
            code = averaging_pb2.REJECT_EXPIRED
        elif request.expiration < self.declared_expiration_time:
            # their deadline is earlier: they should lead, not follow
            code = averaging_pb2.REJECT_WRONG_TIME
        elif context.remote_id == self.peer_id or context.remote_id in self.current_followers:
            code = averaging_pb2.REJECT_DUPLICATE_PEER_ID
        elif self.target_group_size is not None and len(self.current_followers) + 1 >= self.target_group_size:
            code = averaging_pb2.REJECT_GROUP_IS_FULL
        if code is None:
            return None
        return averaging_pb2.MessageFromLeader(code=code, suggested_leader=suggested)

    def _leader_assemble_group(self) -> GroupInfo:
        """Assemble self + current followers into a group and notify everyone
        (upstream matchmaking.py:371-406)."""
        group_id = os.urandom(16)
        members = [self.peer_id, *self.current_followers.keys()]
        rng = random.Random(group_id)
        rng.shuffle(members)
        gathered = []
        for member in members:
            if member == self.peer_id:
                gathered.append(self.data_for_gather)
            else:
                gathered.append(self.current_followers[member][0].gather)
        group = GroupInfo(group_id, tuple(members), tuple(gathered))
        self.assembled_group = group
        self._group_assembled.set()  # wake the leader's search loop immediately
        message = averaging_pb2.MessageFromLeader(
            code=averaging_pb2.BEGIN_ALLREDUCE,
            group_id=group_id,
            ordered_peer_ids=[pid.to_bytes() for pid in members],
            gathered=list(gathered),
        )
        for _request, outbox in self.current_followers.values():
            outbox.put_nowait(message)
        spawn(self.key_manager.update_key_on_group_assembled(group), name="matchmaking.update_key_on_group_assembled")
        logger.debug(f"assembled group of {len(members)} (leader={self.peer_id})")
        return group

    def _disband_followers(self, suggested_leader: Optional[PeerID]) -> None:
        message = averaging_pb2.MessageFromLeader(
            code=averaging_pb2.GROUP_DISBANDED,
            suggested_leader=suggested_leader.to_bytes() if suggested_leader else b"",
        )
        for _request, outbox in self.current_followers.values():
            outbox.put_nowait(message)
