"""RemoteExpert: call an expert on another peer as if it were a local module (the
port of hivemind_tpu/moe/client/expert.py, on the same wire).

Autograd: ``__call__`` runs a ``torch.autograd.Function`` whose forward sends host
copies of the inputs through ``forward_np`` and returns the outputs on the
inputs' device, and whose backward sends the saved inputs and the output
gradients through ``backward_np``; the server trains on that call. Payloads above
``MAX_UNARY_PAYLOAD_SIZE`` take the streaming RPCs.

Replica routing: an expert's record is a replica set. Every call picks a replica
by scorecard latency (seeded-random while cold, so fresh clients do not all dial
the first declared server), fails over onto the next replica when the chosen one
sheds (a typed ``ServerOverloadedError``, provably never executed) or proves
unreachable, and hedges the tail: once an idempotent request's in-flight latency
crosses the replica's scorecard p95, a second replica races it and the loser is
cancelled (the RESET frame cancels the losing server's handler mid-compute,
p2p/mux.py). Only completed outcomes feed a scorecard or a breaker, never a
cancelled loser. Per-replica circuit breakers (``uid@peer`` keys on the shared
:data:`EXPERT_BREAKERS` board) gate routing; the uid-level breaker trips only
when the whole call (every usable replica) fails."""

from __future__ import annotations

import asyncio
import random
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hivemind_tpu_torch.compression import (
    CompressionBase,
    deserialize_tensor,
    deserialize_tensor_stream,
    expert_request_parts,
    resolve_activation_codec,
    serialize_tensor,
    split_tensor_for_streaming,
)
from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS
from hivemind_tpu_torch.moe.expert_uid import IDEMPOTENT_CONNECTION_RPCS, ExpertInfo, ReplicaInfo
from hivemind_tpu_torch.p2p import P2P, PeerID
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.resilience.breaker import BreakerBoard
from hivemind_tpu_torch.telemetry.serving import (
    HEDGES,
    REPLICA_FAILOVERS,
    SCORECARDS,
    WIRE_BYTES_RECEIVED,
    WIRE_BYTES_SENT,
    is_overload_error,
)
from hivemind_tpu_torch.utils.asyncio_utils import aiter_with_timeout, run_in_executor
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.loop import get_loop_runner
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

MAX_UNARY_PAYLOAD_SIZE = 2 * 1024 * 1024
_OFF_LOOP_CODEC_BYTES = 256 * 1024  # payloads past this compress/decompress in the executor
# hard ceiling on a single expert RPC (unary round-trip / per streamed message)
# and on the info fetch: a server that stalls mid-call must surface as a replica
# failure the hedging/breaker layer can act on, not wedge the caller forever
EXPERT_RPC_TIMEOUT = 120.0
_INFO_RPC_TIMEOUT = 10.0


# serving wire accounting, this process as the CALLER
_CLIENT_BYTES_SENT = WIRE_BYTES_SENT.labels("client")
_CLIENT_BYTES_RECEIVED = WIRE_BYTES_RECEIVED.labels("client")

# hedging: only side-effect-free RPCs may be raced — a hedged
# rpc_backward could double-step an optimizer, a hedged rpc_decode would
# double-advance a KV session. rpc_forward is inference-only (expert_uid.py).
HEDGEABLE_METHODS = frozenset({"forward"})
# the hedge threshold is the replica's scorecard p95, floored here so a
# microsecond-fast expert cannot turn every call into a double-send storm
HEDGE_MIN_DELAY_S = 0.02

# transport-shaped failure text from across the RPC boundary (P2PHandlerError
# wraps the remote/type text): evidence the REPLICA is gone or no longer hosts
# the expert, which is exactly when another replica should be dialed. Keep the
# snippets NARROW — matching generic text ("KeyError", "connection to") turns
# arbitrary server-side bugs into failover storms that mask the real defect.
# Local transport losses raise ConnectionError subclasses (StreamClosedError
# included) and are covered by the isinstance check below.
_REPLICA_GONE_SNIPPETS = (
    "stream closed before response",       # P2PHandlerError: transport died mid-call
    "connection closed before request",    # P2PHandlerError: transport died pre-send
    "no reachable address",  # PeerNotFoundError: dangling declaration of a dead peer
    "unknown expert",        # remote handler's KeyError: this server stopped hosting it
)


def replica_breaker_key(uid: str, peer_id: PeerID) -> str:
    """Per-replica breaker key on the shared EXPERT_BREAKERS board: one dead
    replica trips ITS key while the uid's other replicas keep serving."""
    return f"{uid}@{peer_id.to_base58()}"


def is_replica_gone_error(error: BaseException) -> bool:
    """Transport loss / expert-not-here answers — safe failover evidence for
    idempotent RPCs (a response may have been computed, never observed)."""
    if isinstance(error, (ConnectionError, OSError, EOFError)):
        return True
    text = str(error)
    return any(snippet in text for snippet in _REPLICA_GONE_SNIPPETS)


def classify_replicas(uid: str, replicas: Sequence[ReplicaInfo], breakers):
    """The ONE replica-health policy — RemoteExpert routing and
    RemoteSequential block selection both rank through here. Returns
    ``(measured, cold, failing, banned)``: measured as
    ``(failure_bucket, mean_latency, replica)`` sorted healthiest-first, cold
    (no attempts yet — callers spread over these seeded-randomly), failing
    (attempts happened and NONE succeeded: known bad until the breaker opens,
    a last resort before banned), and breaker-banned."""
    measured, cold, failing, banned = [], [], [], []
    for replica in replicas:
        if breakers.is_banned(replica_breaker_key(uid, replica.peer_id)):
            banned.append(replica)
            continue
        mean, failure_rate = SCORECARDS.replica_health(uid, replica.peer_id.to_base58())
        if mean == float("inf"):
            # durations record successes only, so inf mean + nonzero failure
            # rate = every attempt failed — that is not "cold"
            (failing if failure_rate > 0 else cold).append(replica)
        else:
            measured.append((round(failure_rate, 1), mean, replica))
    measured.sort(key=lambda entry: (entry[0], entry[1]))
    return measured, cold, failing, banned


class RemoteExpertWorker:
    """Runs the clients' coroutines on the port's shared loop runner."""

    @staticmethod
    def run_coroutine(coro, return_future: bool = False):
        runner = get_loop_runner()
        return runner.run_coroutine(coro, return_future=return_future)


class RemoteExpert:
    """A callable handle to a remote expert; differentiable through autograd."""

    def __init__(self, expert_info: ExpertInfo, p2p: P2P,
                 request_compression: Optional[str] = None,
                 seed: Optional[int] = None, hedging: bool = True):
        self.expert_info = expert_info
        self.p2p = p2p
        self.span: Optional[List[str]] = None  # see _span_metadata
        # wire-dtype override for requests; None = negotiate the server's
        # advertised codec (DHT declaration, else rpc_info; "none" fallback
        # keeps pre-negotiation servers bit-identical)
        self.request_compression = request_compression
        self.hedging = hedging
        # seeded replica choice: deterministic per (client, uid) so a
        # cold swarm of clients spreads across replicas instead of all dialing
        # the first declared record value, yet any one client is reproducible
        if seed is None:
            seed = zlib.crc32(f"{expert_info.uid}|{p2p.peer_id}".encode())
        self._rng = random.Random(seed)
        # decode sessions are sticky to the replica that holds their KV cache
        self._session_replicas: "OrderedDict[str, ReplicaInfo]" = OrderedDict()
        self._max_pinned_sessions = 256
        self._info: Optional[Dict[str, Any]] = None
        self._info_lock = threading.Lock()

    @property
    def uid(self) -> str:
        return self.expert_info.uid

    @property
    def peer_id(self) -> PeerID:
        return self.expert_info.peer_id

    @property
    def replicas(self) -> Tuple[ReplicaInfo, ...]:
        return self.expert_info.replica_set

    def update_info(self, info: ExpertInfo, *, keep_primary: bool = True) -> None:
        """Adopt a fresh resolution (replica set may have changed). With
        ``keep_primary`` (the default, what re-resolution wants) the
        currently-selected primary is KEPT when it is still in the refreshed
        set — resolution's deterministic first-replica choice must not undo an
        answered-replica re-pin (and ping-pong would clear the rpc_info cache
        on every flip). ``keep_primary=False`` forces ``info.peer_id`` as the
        new primary (the answered-replica re-pin itself). The cached schemas
        are invalidated only when the primary actually moves."""
        previous = self.expert_info
        current = next(
            (r for r in info.replica_set if r.peer_id == previous.peer_id), None
        ) if keep_primary else None
        if current is not None:
            info = ExpertInfo(info.uid, current.peer_id, current.compression, info.replicas)
        self.expert_info = info
        if previous.peer_id != info.peer_id:
            with self._info_lock:
                self._info = None

    @property
    def info(self) -> Dict[str, Any]:
        """Forward/output schemas fetched lazily via rpc_info."""
        with self._info_lock:
            if self._info is not None:
                return self._info
        info = RemoteExpertWorker.run_coroutine(self._fetch_info())
        return info

    async def _fetch_info(self) -> Dict[str, Any]:
        """Async twin of :attr:`info` (usable ON the RPC loop — the sync property
        would deadlock there). Tries every replica in routing order — a dead
        primary must not make the expert's schemas unfetchable."""
        with self._info_lock:
            if self._info is not None:
                return self._info
        last_error: Optional[BaseException] = None
        for replica in (self._replica_order() or list(self.replicas)):
            try:
                response = await asyncio.wait_for(
                    self.p2p.call_protobuf_handler(
                        replica.peer_id,
                        "ConnectionHandler.rpc_info",
                        runtime_pb2.ExpertUID(uid=self.uid),
                        runtime_pb2.ExpertInfoResponse,
                        idempotent=True,
                    ),
                    timeout=_INFO_RPC_TIMEOUT,
                )
                break
            except Exception as e:
                last_error = e
        else:
            raise last_error if last_error is not None else RuntimeError(
                f"expert {self.uid}: no replica to fetch info from"
            )
        info = MSGPackSerializer.loads(response.serialized_info)
        with self._info_lock:
            if self._info is None:
                self._info = info
            return self._info

    async def _wire_codec(self, replica: Optional[ReplicaInfo] = None) -> CompressionBase:
        """The negotiated request wire dtype: an explicit
        ``request_compression`` override wins; otherwise the TARGET replica's
        advertised codec — from its DHT declaration when present (zero extra
        round-trips), else from ``rpc_info`` (fetched once, cached with the
        schemas). Servers that advertise nothing get bit-identical NONE."""
        if self.request_compression is not None:
            return resolve_activation_codec(self.request_compression)
        name: Optional[str] = None
        if replica is not None:
            name = replica.compression
        if name is None:
            with self._info_lock:
                if self._info is not None:
                    name = self._info.get("activation_compression") or "none"
        if name is None:
            name = self.expert_info.compression
        if name is None:
            info = await self._fetch_info()
            name = info.get("activation_compression") or "none"
        try:
            return resolve_activation_codec(name)
        except ValueError:
            # a newer server advertising a codec this build lacks: stay correct
            logger.warning(f"expert {self.uid}: unknown advertised compression {name!r}; using none")
            return resolve_activation_codec("none")

    # ------------------------------------------------------------------ routing

    @staticmethod
    def _breakers() -> BreakerBoard:
        return EXPERT_BREAKERS

    def _primary_replica(self) -> ReplicaInfo:
        for replica in self.replicas:
            if replica.peer_id == self.expert_info.peer_id:
                return replica
        return ReplicaInfo(self.expert_info.peer_id, self.expert_info.compression)

    def _replica_order(self) -> List[ReplicaInfo]:
        """Routing order: breaker-admitted replicas first, measured ones sorted
        by scorecard health (failure-rate bucket, then mean latency), cold ones
        (no scorecard data yet) after them in seeded-random order — a cold
        client spreads across the replica set instead of thundering-herding the
        first declared value — then replicas whose EVERY attempt failed (known
        bad beats unknown only as a last resort before the breaker catches up),
        and hard-open replicas last (failover of last resort)."""
        replicas = list(self.replicas)
        if len(replicas) <= 1:
            return replicas
        measured, cold, failing, banned = classify_replicas(
            self.uid, replicas, self._breakers()
        )
        self._rng.shuffle(cold)
        return [replica for _rate, _mean, replica in measured] + cold + failing + banned

    def _route_candidates(
        self, method: str, session: Optional[str], session_reset: bool
    ) -> List[ReplicaInfo]:
        if self.span:
            # span execution is co-location-pinned: the group was computed for
            # THIS primary; other replicas may not host the whole span chain
            # (RemoteSequential owns route-level failover)
            return [self._primary_replica()]
        if method == "decode" and session is not None and not session_reset:
            # continuations are sticky: only the pinned replica holds the cache
            pinned = self._session_replicas.get(session)
            return [pinned if pinned is not None else self._primary_replica()]
        order = self._replica_order()
        return order if order else [self._primary_replica()]

    def _pin_session(self, session: str, replica: ReplicaInfo) -> None:
        sessions = self._session_replicas
        sessions[session] = replica
        sessions.move_to_end(session)
        while len(sessions) > self._max_pinned_sessions:
            sessions.popitem(last=False)

    def _hedge_threshold(self, replica: ReplicaInfo) -> Optional[float]:
        """Seconds of in-flight latency after which a second replica is raced:
        the replica's scorecard p95 (uid-level fallback), floored — None while
        cold (no evidence of what 'slow' means yet → no hedge)."""
        p95 = SCORECARDS.replica_latency(self.uid, replica.peer_id.to_base58())
        if p95 is None:
            return None
        return max(p95, HEDGE_MIN_DELAY_S)

    def _failover_allowed(self, method: str, session_reset: bool, error: BaseException) -> bool:
        """May this failed attempt move to the next replica? A typed shed
        provably never executed (any method). Otherwise only side-effect-free
        attempts fail over, and only on replica-gone evidence: rpc_forward, and
        a decode PREFILL (re-running reset on a fresh replica just seeds its
        session; continuations are sticky and never fail over here)."""
        if isinstance(error, Exception) and is_overload_error(error):
            return True
        if method in HEDGEABLE_METHODS or (method == "decode" and session_reset):
            return isinstance(error, Exception) and is_replica_gone_error(error)
        return False

    def _note_replica_outcome(
        self, replica: ReplicaInfo, started: float, error: Optional[BaseException] = None
    ) -> None:
        """Per-replica bookkeeping for COMPLETED attempts only — a hedge's
        cancelled loser reaches neither this scorecard nor this breaker."""
        key = replica_breaker_key(self.uid, replica.peer_id)
        peer = replica.peer_id.to_base58()
        elapsed = time.perf_counter() - started
        if error is None:
            SCORECARDS.record_replica(self.uid, peer, elapsed, ok=True)
            self._breakers().register_success(key)
        else:
            shed = isinstance(error, Exception) and is_overload_error(error)
            SCORECARDS.record_replica(self.uid, peer, elapsed, ok=False, shed=shed)
            self._breakers().register_failure(key)

    # ------------------------------------------------------------------ raw RPC

    async def _call(
        self, method: str, tensors: Sequence[np.ndarray], metadata: bytes = b"",
        *, session: Optional[str] = None, session_reset: bool = False,
    ) -> List[np.ndarray]:
        """One expert RPC, scorecarded: every outcome — success,
        failure, timeout/cancellation, server shed — lands on this expert's
        per-client scorecard, and a shed additionally feeds the expert's
        circuit breaker (the server said "overloaded", which is exactly the
        evidence the breaker exists to accumulate). Routing across the replica
        set — balancing, failover, hedging — happens INSIDE this choke point,
        so the uid-level card/breaker keep their meaning: one
        logical call, one outcome, and a failure means every usable replica
        failed."""
        started = time.perf_counter()
        try:
            result = await self._call_routed(method, tensors, metadata, session, session_reset)
        except BaseException as e:
            SCORECARDS.record(
                self.uid, time.perf_counter() - started, ok=False, kind=method, error=e
            )
            if isinstance(e, Exception) and is_overload_error(e):
                # feed the shed into the expert's breaker HERE (the one choke
                # point every caller shares); call_many skips its own
                # register_failure for overloads so a shed counts exactly once
                self._breakers().register_failure(self.uid)
            raise
        SCORECARDS.record(self.uid, time.perf_counter() - started, ok=True, kind=method)
        return result

    async def _call_routed(
        self, method: str, tensors: Sequence[np.ndarray], metadata: bytes,
        session: Optional[str], session_reset: bool,
    ) -> List[np.ndarray]:
        """The replica scheduler: launch on the preferred replica; once the
        in-flight latency crosses that replica's scorecard p95 race a hedge on
        the next one (idempotent methods only) and cancel the loser; after a
        typed shed / replica-gone failure, fail over down the order."""
        candidates = self._route_candidates(method, session, session_reset)
        breakers = self._breakers()
        queue: List[ReplicaInfo] = list(candidates)
        in_flight: Dict[asyncio.Task, Tuple[ReplicaInfo, float]] = {}

        def launch() -> Optional[ReplicaInfo]:
            while queue:
                replica = queue.pop(0)
                if len(candidates) > 1 and not breakers.allow(
                    replica_breaker_key(self.uid, replica.peer_id)
                ):
                    continue  # hard-open replica: skipping is not fresh evidence
                task = asyncio.ensure_future(
                    self._call_replica(method, replica, tensors, metadata)
                )
                in_flight[task] = (replica, time.perf_counter())
                return replica
            return None

        primary = launch()
        if primary is None:
            # every replica hard-open: degrade to single-replica behavior — dial
            # the preferred candidate anyway (the uid-level breaker in call_many
            # owns the "skip this expert entirely" decision)
            primary = candidates[0]
            task = asyncio.ensure_future(
                self._call_replica(method, primary, tensors, metadata)
            )
            in_flight[task] = (primary, time.perf_counter())
        hedged = False
        last_error: Optional[BaseException] = None
        try:
            while in_flight:
                timeout = None
                if (
                    self.hedging
                    and not hedged
                    and queue
                    and method in HEDGEABLE_METHODS
                    and len(in_flight) == 1
                ):
                    (replica, attempt_started), = in_flight.values()
                    threshold = self._hedge_threshold(replica)
                    if threshold is not None:
                        timeout = max(
                            threshold - (time.perf_counter() - attempt_started), 0.0
                        )
                done, _pending = await asyncio.wait(
                    set(in_flight), timeout=timeout, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    # the hedge timer fired: race a second replica — the slow
                    # attempt is NOT failed; first answer wins, loser cancelled.
                    # Only a hedge that actually LAUNCHED counts as hedged
                    # (every queued replica may be breaker-banned), else the
                    # win would be recorded as a race that never happened.
                    if launch() is not None:
                        hedged = True
                        HEDGES.labels("fired").inc()
                    continue
                for task in done:
                    replica, attempt_started = in_flight.pop(task)
                    try:
                        result = task.result()
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        last_error = e
                        self._note_replica_outcome(replica, attempt_started, error=e)
                        continue
                    self._note_replica_outcome(replica, attempt_started)
                    if hedged:
                        HEDGES.labels(
                            "primary_won" if replica is primary else "hedge_won"
                        ).inc()
                    for loser, loser_started in in_flight.values():
                        # censored observation, NOT an outcome: the loser took
                        # at least this long (keeps a hanging replica from
                        # winning the next pick on stale fast quantiles)
                        SCORECARDS.note_hedge_loss(
                            self.uid, loser.peer_id.to_base58(),
                            time.perf_counter() - loser_started,
                        )
                    if session is not None:
                        self._pin_session(session, replica)
                    if replica.peer_id != self.expert_info.peer_id:
                        # the replica that ANSWERED is the selected primary now:
                        # route metadata, span pinning and the sticky-session
                        # fallback follow the server that is actually serving,
                        # not a dead peer's dangling declaration
                        self.update_info(ExpertInfo(
                            self.uid, replica.peer_id, replica.compression,
                            self.expert_info.replicas,
                        ), keep_primary=False)
                    return result
                if not in_flight:
                    assert last_error is not None
                    if queue and self._failover_allowed(method, session_reset, last_error):
                        REPLICA_FAILOVERS.labels(method).inc()
                        logger.warning(
                            f"expert {self.uid}: replica failed ({last_error!r}); "
                            f"failing over to the next replica"
                        )
                        if launch() is not None:
                            continue
                    raise last_error
            raise last_error if last_error is not None else RuntimeError(
                f"expert {self.uid}: no replica attempt was launched"
            )
        finally:
            for task in in_flight:
                # hedge losers / outer cancellation: cancelling propagates a
                # RESET through the mux so the losing server stops computing;
                # deliberately NO scorecard/breaker bookkeeping here
                task.cancel()

    async def _call_replica(
        self, method: str, replica: ReplicaInfo,
        tensors: Sequence[np.ndarray], metadata: bytes = b"",
    ) -> List[np.ndarray]:
        codec = await self._wire_codec(replica)
        target_peer = replica.peer_id

        def _serialize_all() -> List[runtime_pb2.Tensor]:
            # astype(copy=False): an fp32 input serializes as a VIEW (the old
            # np.asarray(t, np.float32) spelling forced the same cast but reads
            # as a copy; the explicit copy= keeps the hot-path lint honest); the
            # codec owns any further conversion and must NOT write into
            # caller-owned memory (no allow_inplace here)
            return [
                serialize_tensor(np.asarray(t).astype(np.float32, copy=False), codec)
                for t in tensors
            ]

        # big payloads compress off the shared client loop (the same loop runs
        # the DHT and every concurrent expert fan-out); small ones inline — the
        # executor hop would dominate a 4 KB decode step
        if sum(getattr(t, "nbytes", 0) for t in tensors) >= _OFF_LOOP_CODEC_BYTES:
            serialized = await run_in_executor(_serialize_all)
        else:
            serialized = _serialize_all()
        # unary/stream decision on the fp32-EQUIVALENT size, not the compressed
        # bytes: a NONE server answers an fp16 request with a response ~2x the
        # request, and a unary response must stay under the mux frame cap
        payload = sum(int(np.asarray(t).size) * 4 for t in tensors)
        if payload <= MAX_UNARY_PAYLOAD_SIZE:
            # spliced scatter-gather request: tensor buffers ride to the AEAD
            # uncopied instead of being re-materialized by SerializeToString
            request = expert_request_parts(self.uid, serialized, metadata)
            response = await asyncio.wait_for(
                self.p2p.call_protobuf_handler(
                    target_peer,
                    f"ConnectionHandler.rpc_{method}",
                    request,
                    runtime_pb2.ExpertResponse,
                    idempotent=(f"rpc_{method}" in IDEMPOTENT_CONNECTION_RPCS),
                ),
                timeout=EXPERT_RPC_TIMEOUT,
            )
            # counted AFTER the round-trip: a shed/dead-peer attempt must not
            # drift client-sent above server-received (retries count once, like
            # the server's parsed-request accounting)
            _CLIENT_BYTES_SENT.inc(request.nbytes)
            received = response.ByteSize()
            _CLIENT_BYTES_RECEIVED.inc(received)
            if received >= _OFF_LOOP_CODEC_BYTES:
                return await run_in_executor(_decode_all, response.tensors)
            return _decode_all(response.tensors)
        # streaming path for big payloads (metadata rides the first message)

        async def requests():
            first = True
            for tensor in serialized:
                for chunk in split_tensor_for_streaming(tensor, 2**20):
                    message = runtime_pb2.ExpertRequest(
                        uid=self.uid if first else "", tensors=[chunk],
                        metadata=metadata if first else b"",
                    )
                    _CLIENT_BYTES_SENT.inc(message.ByteSize())
                    yield message
                    first = False

        stream = self.p2p.iterate_protobuf_handler(
            target_peer, f"ConnectionHandler.rpc_{method}_stream", requests(), runtime_pb2.ExpertResponse
        )

        async def parts():
            # per-message deadline: total transfer time is unbounded, but any
            # single inter-message stall past the RPC timeout fails the replica
            async for response in aiter_with_timeout(stream, EXPERT_RPC_TIMEOUT):
                _CLIENT_BYTES_RECEIVED.inc(response.ByteSize())
                yield list(response.tensors)

        # off_loop: this is by definition the multi-MB path, and the client
        # loop is shared with the DHT and every concurrent expert fan-out
        return _host_arrays(await deserialize_tensor_stream(parts(), off_loop=True))

    def forward_np(self, *xs: np.ndarray) -> List[np.ndarray]:
        return RemoteExpertWorker.run_coroutine(
            self._call("forward", list(xs), self._span_metadata())
        )

    def decode_np(
        self, x: np.ndarray, session_id: str, reset: bool = False, span: Optional[list] = None
    ) -> np.ndarray:
        """One KV-cache decode-session step on the serving peer (rpc_decode):
        the prefill call (``reset=True``) seeds the session with the prompt chunk,
        later calls advance one token each — O(context) per token instead of the
        right-padded O(context²) recompute. Sessions are sticky to the peer; a
        continuation on an evicted session raises (restart with ``reset=True``).
        Prefill chunks over the unary cap use the streaming decode RPC.

        :param span: uids of CONSECUTIVE pipeline blocks co-located on this peer
            (first must be this expert's uid): the server chains their session
            steps in one RPC, so a pipeline's per-token round-trips drop from
            #blocks to #servers (Petals serves block spans the same way)."""
        meta = {"session_id": session_id, "reset": reset}
        if span is not None:
            assert span[0] == self.uid, (span, self.uid)
            meta["uids"] = list(span)
        metadata = MSGPackSerializer.dumps(meta)
        [output] = RemoteExpertWorker.run_coroutine(
            self._call("decode", [x], metadata, session=session_id, session_reset=reset)
        )
        return output

    def backward_np(self, *tensors: np.ndarray) -> List[np.ndarray]:
        """``tensors`` = forward inputs followed by one grad per output."""
        return RemoteExpertWorker.run_coroutine(
            self._call("backward", list(tensors), self._span_metadata())
        )

    def _span_metadata(self) -> bytes:
        """Span execution (``self.span``: uids of consecutive co-located blocks,
        first = this uid): forward/backward requests carry the chain so the server
        runs every block of the span in one RPC."""
        if not self.span:
            return b""
        assert self.span[0] == self.uid, (self.span, self.uid)
        return MSGPackSerializer.dumps({"uids": list(self.span)})

    # ------------------------------------------------------------------ torch surface

    def __call__(self, *xs: torch.Tensor):
        """Differentiable remote call on torch tensors (any device); supports
        multi-input and multi-output experts. Returns one tensor for a
        single-output expert, a tuple otherwise, on the first input's device.

        The remote node works on float32 host copies (differentiable copies in
        and out), so autograd runs its backward on the thread that called
        ``backward()``, not on the engine's CUDA thread: a server in the same
        process can then run its own backward on the card while this one waits
        for its RPC."""
        device = xs[0].device
        outputs = _RemoteCall.apply(self, *(x.to("cpu", torch.float32) for x in xs))
        outputs = tuple(out.to(device) for out in outputs)
        return outputs[0] if len(outputs) == 1 else outputs

    def __repr__(self):
        return f"RemoteExpert({self.uid} @ {self.peer_id})"


def _host_arrays(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Decoded CPU tensors as float32 numpy arrays (the JAX client's result type)."""
    return [t.to(torch.float32).numpy() for t in tensors]


def _decode_all(tensors: Sequence[runtime_pb2.Tensor]) -> List[np.ndarray]:
    return _host_arrays([deserialize_tensor(t) for t in tensors])


class _RemoteCall(torch.autograd.Function):
    """The remote expert as an autograd node on float32 CPU tensors: forward
    through ``forward_np``, backward through ``backward_np`` with the saved inputs
    (which steps the server's optimizer, as every backward RPC does)."""

    @staticmethod
    def forward(ctx, expert: RemoteExpert, *xs: torch.Tensor):
        ctx.expert = expert
        ctx.save_for_backward(*xs)
        outputs = expert.forward_np(*(x.detach().numpy() for x in xs))
        return tuple(torch.from_numpy(np.asarray(out, np.float32)) for out in outputs)

    @staticmethod
    def backward(ctx, *grad_outputs: torch.Tensor):
        xs = ctx.saved_tensors
        grads = ctx.expert.backward_np(*(x.detach().numpy() for x in xs),
                                       *(g.detach().to(torch.float32).contiguous().numpy() for g in grad_outputs))
        return (None, *(torch.from_numpy(np.asarray(g, np.float32)) for g in grads))
