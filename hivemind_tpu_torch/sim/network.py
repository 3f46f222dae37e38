"""In-process swarm transport: a seeded WAN link matrix under the RPC seam.

:class:`SimP2P` implements the slice of the :class:`~hivemind_tpu_torch.p2p.P2P`
surface that ``ServicerBase``/``StubBase`` and the DHT/matchmaking/MoE layers
actually touch — ``add_protobuf_handler`` / ``call_protobuf_handler`` /
``iterate_protobuf_handler`` plus identity and addressing — so the *logic*
layers (DHT routing/storage/validation, matchmaking, expert declarations and
beam search, breakers, ledgers) run **unmodified** over an in-process network.
Requests still round-trip through protobuf serialization (each side owns its
message objects, exactly like the wire), but instead of sockets every message
pays a seeded link cost:

- :class:`LinkMatrix` derives per-directed-link delay (with seeded jitter),
  bandwidth and loss from region tags, and severs region pairs on a
  :class:`Partition` schedule;
- faults beyond the baseline geometry come from the **chaos engine** via the
  directional ``scope=link:<src>-><dst>`` rule syntax (resilience/chaos.py) —
  the simulator tags every message with its link, so the existing 14-point
  catalog composes with per-link schedules instead of a parallel fault system.

Run under :class:`~hivemind_tpu_torch.sim.clock.VirtualClockEventLoop`, link waits
cost no wall time and every delivery order is deterministic for a given seed.
"""

from __future__ import annotations

import asyncio
import hashlib
import zlib
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple, Type

from hivemind_tpu_torch.p2p.p2p import P2PContext, P2PHandlerError, _parse, _serialize
from hivemind_tpu_torch.p2p.peer_id import Multiaddr, PeerID
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.streaming import WireParts

logger = get_logger(__name__)

# observability for simulated swarms (docs/observability.md, docs/simulation.md):
# the registry mirrors SimNetwork's deterministic internal counters so live sims
# are scrape-able; scenario summaries read the internal counters, not these.
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY

_SIM_MESSAGES = _TELEMETRY.counter(
    "hivemind_sim_messages_total", "messages carried by the simulated transport", ("kind",)
)
_SIM_BYTES = _TELEMETRY.counter(
    "hivemind_sim_bytes_total", "serialized payload bytes carried by the simulated transport"
)
_SIM_DROPS = _TELEMETRY.counter(
    "hivemind_sim_dropped_total", "messages the simulated network refused or lost", ("cause",)
)
_SIM_PEERS = _TELEMETRY.gauge("hivemind_sim_peers", "live peers in the simulated swarm")
_SIM_VTIME = _TELEMETRY.gauge(
    "hivemind_sim_virtual_time_seconds", "current virtual time of the running simulation"
)
_SIM_PARTITIONS = _TELEMETRY.gauge(
    "hivemind_sim_partitions_active", "partitions currently severing region pairs"
)


@dataclass(frozen=True)
class LinkProfile:
    """Base link geometry for a region pair (before per-link seeded jitter)."""

    delay: float = 0.02  # one-way propagation, seconds
    bandwidth: float = 12.5e6  # bytes/s (default ≈ 100 Mbps)
    loss: float = 0.0  # per-message loss probability
    jitter: float = 0.25  # ± fraction applied to delay, fixed per directed link


@dataclass(frozen=True)
class LinkSpec:
    """Resolved properties of one directed link."""

    delay: float
    bandwidth: float
    loss: float


@dataclass(frozen=True)
class Partition:
    """Severs every link between region sets ``a`` and ``b`` (both directions)
    during ``[start, end)`` seconds of virtual time since network creation."""

    start: float
    end: float
    a: frozenset
    b: frozenset

    @classmethod
    def between(cls, a, b, start: float, end: float) -> "Partition":
        a = frozenset([a] if isinstance(a, str) else a)
        b = frozenset([b] if isinstance(b, str) else b)
        return cls(start=float(start), end=float(end), a=a, b=b)

    def severs(self, region_a: str, region_b: str) -> bool:
        return (region_a in self.a and region_b in self.b) or (
            region_a in self.b and region_b in self.a
        )


_INTRA_DEFAULT = LinkProfile(delay=0.002, bandwidth=125e6, loss=0.0, jitter=0.1)
_INTER_DEFAULT = LinkProfile(delay=0.05, bandwidth=12.5e6, loss=0.0, jitter=0.25)


class LinkMatrix:
    """Seeded per-link WAN properties derived from region geometry.

    :param seed: jitter/loss seed — the same seed reproduces every link exactly
    :param intra: profile for links within one region
    :param inter: profile for links between different regions
    :param overrides: ``{(region_a, region_b): LinkProfile}`` — symmetric lookup
    :param partitions: schedule of :class:`Partition` windows
    """

    def __init__(
        self,
        seed: int = 0,
        intra: LinkProfile = _INTRA_DEFAULT,
        inter: LinkProfile = _INTER_DEFAULT,
        overrides: Optional[Dict[Tuple[str, str], LinkProfile]] = None,
        partitions: Tuple[Partition, ...] = (),
    ):
        self.seed = seed
        self.intra = intra
        self.inter = inter
        self.overrides = dict(overrides or {})
        self.partitions = tuple(partitions)
        self._spec_cache: Dict[Tuple[str, str], LinkSpec] = {}

    def profile(self, region_a: str, region_b: str) -> LinkProfile:
        hit = self.overrides.get((region_a, region_b))
        if hit is None:
            hit = self.overrides.get((region_b, region_a))
        if hit is not None:
            return hit
        return self.intra if region_a == region_b else self.inter

    def spec(self, src_name: str, dst_name: str, src_region: str, dst_region: str) -> LinkSpec:
        key = (src_name, dst_name)
        cached = self._spec_cache.get(key)
        if cached is not None:
            return cached
        profile = self.profile(src_region, dst_region)
        # fixed per-directed-link jitter: crc32 keeps it cheap and seed-stable
        unit = zlib.crc32(f"{self.seed}|{src_name}|{dst_name}".encode()) / 2**32
        delay = profile.delay * (1.0 + profile.jitter * (2.0 * unit - 1.0))
        spec = LinkSpec(delay=max(delay, 0.0), bandwidth=profile.bandwidth, loss=profile.loss)
        self._spec_cache[key] = spec
        return spec

    def partitioned(self, region_a: str, region_b: str, rel_time: float) -> bool:
        for partition in self.partitions:
            if partition.start <= rel_time < partition.end and partition.severs(region_a, region_b):
                return True
        return False

    def partitions_active(self, rel_time: float) -> int:
        return sum(1 for p in self.partitions if p.start <= rel_time < p.end)


@dataclass
class _SimHandler:
    fn: Callable
    request_type: Optional[Type]
    stream_input: bool
    stream_output: bool


def _material(payload) -> bytes:
    """Serialized payload as plain bytes (WireParts joined, memoryview copied)."""
    if isinstance(payload, WireParts):
        return payload.join()
    return bytes(payload)


class SimPeerDeadError(ConnectionError):
    """The target peer has been killed (or never existed)."""


class SimPartitionError(ConnectionError):
    """The link is severed by an active partition."""


class SimLossError(ConnectionError):
    """The message was lost by the link's seeded loss process."""


class SimNetwork:
    """The swarm: peer registry + link matrix + deterministic traffic counters.

    Create peers with :meth:`spawn`; the returned :class:`SimP2P` plugs
    directly into ``DHTNode.create(p2p=...)`` and every ``ServicerBase``.
    """

    def __init__(self, links: Optional[LinkMatrix] = None, seed: int = 0):
        self.seed = seed
        self.links = links if links is not None else LinkMatrix(seed=seed)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = asyncio.get_event_loop()
        self._loop = loop
        self._epoch = loop.time()
        self._peers: Dict[PeerID, "SimP2P"] = {}
        self._by_addr: Dict[Tuple[str, int], PeerID] = {}
        self._busy: Dict[Tuple[PeerID, PeerID], float] = {}
        self._loss_rng: Dict[Tuple[PeerID, PeerID], "_Crc32Stream"] = {}
        self._tasks: set = set()
        self._next_index = 0
        # deterministic counters: scenario summaries read these (the telemetry
        # registry mirrors them but is process-global and wall-time-tainted)
        self.counters: Dict[str, int] = {
            "messages": 0,
            "bytes": 0,
            "dropped_partition": 0,
            "dropped_loss": 0,
            "dropped_dead": 0,
            "handler_errors": 0,
        }

    # ------------------------------------------------------------------ time

    def now(self) -> float:
        return self._loop.time()

    def rel_time(self) -> float:
        """Seconds of virtual time since the network was created."""
        return self._loop.time() - self._epoch

    # ------------------------------------------------------------------ peers

    def spawn(self, name: str, region: str = "default") -> "SimP2P":
        peer = SimP2P(self, name=name, region=region, index=self._next_index)
        self._next_index += 1
        if peer.peer_id in self._peers:
            raise ValueError(f"duplicate sim peer name {name!r} (ids are name-derived)")
        self._peers[peer.peer_id] = peer
        self._by_addr[(peer.maddr.host, peer.maddr.port)] = peer.peer_id
        _SIM_PEERS.set(self.live_peer_count())
        return peer

    def kill(self, peer: "SimP2P") -> None:
        """Crash semantics: the peer stops answering but nothing is cleaned up —
        its DHT declarations dangle exactly like a real dead process's."""
        peer.alive = False
        _SIM_PEERS.set(self.live_peer_count())

    def live_peer_count(self) -> int:
        return sum(1 for p in self._peers.values() if p.alive)

    def get_peer(self, peer_id: PeerID) -> Optional["SimP2P"]:
        return self._peers.get(peer_id)

    def resolve_maddr(self, maddr) -> PeerID:
        maddr = Multiaddr.parse(str(maddr))
        if maddr.peer_id is not None and maddr.peer_id in self._peers:
            return maddr.peer_id
        peer_id = self._by_addr.get((maddr.host, maddr.port))
        if peer_id is None:
            raise SimPeerDeadError(f"no sim peer at {maddr}")
        return peer_id

    async def shutdown(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    # ------------------------------------------------------------------ links

    def _link_spec(self, src: "SimP2P", dst: "SimP2P") -> LinkSpec:
        return self.links.spec(src.name, dst.name, src.region, dst.region)

    def _check_link(self, src: "SimP2P", dst_id: PeerID) -> "SimP2P":
        dst = self._peers.get(dst_id)
        if dst is None or not dst.alive or not src.alive:
            self.counters["dropped_dead"] += 1
            _SIM_DROPS.inc(cause="dead")
            raise SimPeerDeadError(f"sim peer {dst_id} is unreachable (dead)")
        if self.links.partitioned(src.region, dst.region, self.rel_time()):
            self.counters["dropped_partition"] += 1
            _SIM_DROPS.inc(cause="partition")
            raise SimPartitionError(
                f"link {src.name}->{dst.name} severed by partition "
                f"({src.region}|{dst.region})"
            )
        return dst

    def _lost(self, src: "SimP2P", dst: "SimP2P", spec: LinkSpec) -> bool:
        if spec.loss <= 0.0:
            return False
        rng = self._loss_rng.get((src.peer_id, dst.peer_id))
        if rng is None:
            rng = _Crc32Stream(f"{self.seed}|loss|{src.name}|{dst.name}")
            self._loss_rng[(src.peer_id, dst.peer_id)] = rng
        return rng.next_unit() < spec.loss

    async def _transit(self, src: "SimP2P", dst: "SimP2P", nbytes: int, kind: str) -> None:
        """Pay one message's wire time: per-directed-link bandwidth serialization
        plus propagation delay. Raises on seeded loss (after the wire time, so
        rng consumption order == send order == deterministic)."""
        spec = self._link_spec(src, dst)
        now = self.now()
        start = max(now, self._busy.get((src.peer_id, dst.peer_id), now))
        finish = start + (nbytes / spec.bandwidth if spec.bandwidth > 0 else 0.0)
        self._busy[(src.peer_id, dst.peer_id)] = finish
        lost = self._lost(src, dst, spec)
        wait = (finish + spec.delay) - now
        if wait > 0:
            await asyncio.sleep(wait)
        self.counters["messages"] += 1
        self.counters["bytes"] += nbytes
        _SIM_MESSAGES.inc(kind=kind)
        _SIM_BYTES.inc(nbytes)
        _SIM_VTIME.set(self.now())
        _SIM_PARTITIONS.set(self.links.partitions_active(self.rel_time()))
        if lost:
            self.counters["dropped_loss"] += 1
            _SIM_DROPS.inc(cause="loss")
            raise SimLossError(f"message lost on link {src.name}->{dst.name}")
        # delivery-time checks: a message in flight when the link is severed (or
        # the receiver dies) is lost — long-lived streams opened before a
        # partition must NOT keep delivering across it
        if not dst.alive:
            self.counters["dropped_dead"] += 1
            _SIM_DROPS.inc(cause="dead")
            raise SimPeerDeadError(f"sim peer {dst.name} died before delivery")
        if self.links.partitioned(src.region, dst.region, self.rel_time()):
            self.counters["dropped_partition"] += 1
            _SIM_DROPS.inc(cause="partition")
            raise SimPartitionError(
                f"in-flight message lost: link {src.name}->{dst.name} severed"
            )

    def _spawn_task(self, coro) -> asyncio.Task:
        task = self._loop.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    # ------------------------------------------------------------------ unary

    async def unary_call(
        self, src: "SimP2P", dst_id: PeerID, name: str, request, response_type: Optional[Type]
    ):
        payload = _material(_serialize(request))
        scope = f"link:{src.peer_id}->{dst_id}"
        if _CHAOS.enabled:  # composes with scope=link:<src>-><dst> chaos rules
            payload = await _CHAOS.inject("p2p.unary.send", payload=payload, scope=scope)
        dst = self._check_link(src, dst_id)
        future = self._loop.create_future()
        # the handler runs in its OWN task: a caller that times out abandons the
        # future, but the server still executes (and its side effects apply),
        # matching real stream semantics
        self._spawn_task(self._serve_unary(src, dst, name, payload, response_type, future))
        future.add_done_callback(_retrieve_exception)
        return await future

    async def _serve_unary(
        self,
        src: "SimP2P",
        dst: "SimP2P",
        name: str,
        payload: bytes,
        response_type: Optional[Type],
        future: asyncio.Future,
    ) -> None:
        try:
            # _transit raises SimPeerDeadError itself if dst died while the
            # message was in flight, so the handler lookup can trust dst.alive
            await self._transit(src, dst, len(payload), kind="unary")
            handler = dst.handlers.get(name)
            if handler is None:
                raise P2PHandlerError(f"unknown handler {name!r}")
            context = P2PContext(name, dst.peer_id, src.peer_id)
            request = _parse(payload, handler.request_type)
            try:
                response = await handler.fn(request, context)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.counters["handler_errors"] += 1
                raise P2PHandlerError(f"{name} failed on {dst.name}: {e!r}") from e
            rpayload = _material(_serialize(response))
            rscope = f"link:{dst.peer_id}->{src.peer_id}"
            if _CHAOS.enabled:
                rpayload = await _CHAOS.inject("p2p.unary.recv", payload=rpayload, scope=rscope)
            await self._transit(dst, src, len(rpayload), kind="unary")
            if not future.done():
                future.set_result(_parse(rpayload, response_type))
        except asyncio.CancelledError:
            if not future.done():
                future.cancel()
            raise
        except Exception as e:
            if not future.done():
                future.set_exception(e)

    # ------------------------------------------------------------------ streaming

    async def stream_call(
        self, src: "SimP2P", dst_id: PeerID, name: str, requests, response_type: Optional[Type]
    ) -> AsyncIterator:
        """Async generator yielding parsed response messages (SimP2P delegates
        ``iterate_protobuf_handler`` here)."""
        out_queue: asyncio.Queue = asyncio.Queue()
        dst = self._check_link(src, dst_id)
        serve = self._spawn_task(self._serve_stream(src, dst, name, requests, response_type, out_queue))
        try:
            while True:
                kind, item = await out_queue.get()
                if kind == "msg":
                    yield item
                elif kind == "err":
                    raise item
                else:
                    return
        finally:
            # client closed/abandoned the stream: tear down the server handler
            # (its finally blocks run), like a stream reset on the wire
            serve.cancel()

    async def _serve_stream(
        self,
        src: "SimP2P",
        dst: "SimP2P",
        name: str,
        requests,
        response_type: Optional[Type],
        out_queue: asyncio.Queue,
    ) -> None:
        req_queue: asyncio.Queue = asyncio.Queue()
        feeder = self._spawn_task(self._feed_stream(src, dst, requests, req_queue))
        try:
            handler = dst.handlers.get(name)
            if handler is None:
                raise P2PHandlerError(f"unknown handler {name!r}")
            context = P2PContext(name, dst.peer_id, src.peer_id)

            if handler.stream_input:

                async def _request_iter():
                    while True:
                        kind, item = await req_queue.get()
                        if kind == "msg":
                            yield _parse(item, handler.request_type)
                        elif kind == "err":
                            raise item
                        else:
                            return

                request = _request_iter()
            else:
                kind, item = await req_queue.get()
                if kind == "err":
                    raise item
                if kind != "msg":
                    raise P2PHandlerError(f"{name}: request stream ended before a message")
                request = _parse(item, handler.request_type)

            try:
                if handler.stream_output:
                    result = handler.fn(request, context)
                    if asyncio.iscoroutine(result):
                        result = await result
                    async for response in result:
                        await self._ship_response(src, dst, response, response_type, out_queue)
                else:
                    response = await handler.fn(request, context)
                    await self._ship_response(src, dst, response, response_type, out_queue)
            except asyncio.CancelledError:
                raise
            except ConnectionError:
                raise  # transport loss on the response leg: not a handler fault
            except Exception as e:
                self.counters["handler_errors"] += 1
                raise P2PHandlerError(f"{name} failed on {dst.name}: {e!r}") from e
            out_queue.put_nowait(("end", None))
        except asyncio.CancelledError:
            # external teardown (network.shutdown) mid-stream: a consumer still
            # awaiting the queue must not hang forever — the common case (the
            # client itself closed the stream) has no reader, so this is inert
            out_queue.put_nowait(("err", SimPeerDeadError(f"stream {name} torn down")))
            raise
        except Exception as e:
            out_queue.put_nowait(("err", e))
        finally:
            feeder.cancel()

    async def _ship_response(
        self, src: "SimP2P", dst: "SimP2P", response, response_type: Optional[Type], out_queue
    ) -> None:
        rpayload = _material(_serialize(response))
        if _CHAOS.enabled:  # per streamed response message, dst->src direction
            rpayload = await _CHAOS.inject(
                "p2p.stream.recv", payload=rpayload, scope=f"link:{dst.peer_id}->{src.peer_id}"
            )
        await self._transit(dst, src, len(rpayload), kind="stream")
        out_queue.put_nowait(("msg", _parse(rpayload, response_type)))

    async def _feed_stream(self, src: "SimP2P", dst: "SimP2P", requests, req_queue: asyncio.Queue) -> None:
        scope = f"link:{src.peer_id}->{dst.peer_id}"
        try:
            if hasattr(requests, "__aiter__"):
                async for request in requests:
                    payload = _material(_serialize(request))
                    if _CHAOS.enabled:  # per streamed request message
                        payload = await _CHAOS.inject("p2p.stream.send", payload=payload, scope=scope)
                    await self._transit(src, dst, len(payload), kind="stream")
                    req_queue.put_nowait(("msg", payload))
            else:
                payload = _material(_serialize(requests))
                if _CHAOS.enabled:
                    payload = await _CHAOS.inject("p2p.stream.send", payload=payload, scope=scope)
                await self._transit(src, dst, len(payload), kind="stream")
                req_queue.put_nowait(("msg", payload))
            req_queue.put_nowait(("end", None))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            req_queue.put_nowait(("err", e))


class _Crc32Stream:
    """A tiny deterministic unit-interval stream (cheaper and more portable
    across runs than random.Random for per-link loss draws)."""

    __slots__ = ("_state",)

    def __init__(self, key: str):
        self._state = zlib.crc32(key.encode())

    def next_unit(self) -> float:
        self._state = zlib.crc32(self._state.to_bytes(4, "big"))
        return self._state / 2**32


def _retrieve_exception(future: asyncio.Future) -> None:
    # mark abandoned-call exceptions retrieved (the caller may have timed out)
    if not future.cancelled():
        future.exception()


class SimP2P:
    """The transport face one simulated peer presents to the real stack.

    Duck-types the ``P2P`` attributes/methods the DHT, matchmaking and MoE
    layers touch; everything routes through the owning :class:`SimNetwork`.
    """

    def __init__(self, network: SimNetwork, name: str, region: str, index: int):
        self.network = network
        self.name = name
        self.region = region
        self.alive = True
        digest = hashlib.sha256(f"{network.seed}|peer|{name}".encode()).digest()
        self.peer_id = PeerID(b"\x12\x20" + digest)
        host = f"10.{(index >> 16) & 255}.{(index >> 8) & 255}.{index & 255}"
        self.maddr = Multiaddr(host=host, port=4242, peer_id=self.peer_id)
        self.handlers: Dict[str, _SimHandler] = {}

    # ---------------------------------------------------------------- handlers

    async def add_protobuf_handler(
        self,
        name: str,
        handler: Callable,
        request_type: Optional[Type] = None,
        *,
        stream_input: bool = False,
        stream_output: bool = False,
    ) -> None:
        if name in self.handlers:
            raise P2PHandlerError(f"handler {name!r} is already registered")
        self.handlers[name] = _SimHandler(handler, request_type, stream_input, stream_output)

    async def remove_protobuf_handler(self, name: str) -> None:
        self.handlers.pop(name, None)

    # ---------------------------------------------------------------- calls

    async def call_protobuf_handler(
        self,
        peer_id: PeerID,
        name: str,
        request,
        response_type: Optional[Type] = None,
        *,
        idempotent: bool = False,
    ):
        return await self.network.unary_call(self, peer_id, name, request, response_type)

    def iterate_protobuf_handler(
        self, peer_id: PeerID, name: str, requests, response_type: Optional[Type] = None
    ) -> AsyncIterator:
        return self.network.stream_call(self, peer_id, name, requests, response_type)

    # ---------------------------------------------------------------- identity

    def get_visible_maddrs(self, latest: bool = False) -> List[Multiaddr]:
        return [self.maddr]

    def add_peer_addr(self, peer_id: PeerID, maddr) -> None:
        pass  # the network keeps a global registry; learned addresses are a no-op

    async def connect(self, maddr) -> PeerID:
        peer_id = self.network.resolve_maddr(maddr)
        self.network._check_link(self, peer_id)  # dead/partitioned targets refuse the dial
        return peer_id

    async def list_peers(self) -> List[PeerID]:
        return [pid for pid, p in self.network._peers.items() if p.alive and pid != self.peer_id]

    async def disconnect(self, peer_id: PeerID) -> None:
        pass

    async def shutdown(self) -> None:
        self.alive = False
        _SIM_PEERS.set(self.network.live_peer_count())

    def __repr__(self):
        return f"<SimP2P {self.name} region={self.region} {'up' if self.alive else 'DEAD'}>"
