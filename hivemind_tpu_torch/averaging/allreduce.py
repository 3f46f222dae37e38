"""One fault-tolerant butterfly all-reduce round inside a fixed group (the port of
hivemind_tpu/averaging/allreduce.py; upstream: hivemind/averaging/allreduce.py).

Each peer reduces the span of the concatenated vector assigned by the load balancer;
senders stream their parts to every reducer, reducers stream back DELTAS
(averaged − that sender's input — upstream allreduce.py:39: deltas keep precision and
make a dead reducer equivalent to delta 0). Modes (upstream allreduce.py:26-29):
NODE sends + reduces, CLIENT sends only (firewalled/zero-bandwidth), AUX reduces only
(e.g. a CPU helper with no gradients of its own)."""

from __future__ import annotations

import asyncio
import time
from enum import Enum
from typing import AsyncIterator, Dict, Optional, Sequence, Tuple

import numpy as np

from hivemind_tpu_torch.averaging.partition import (
    DEFAULT_PART_SIZE_BYTES,
    AllreduceException,
    TensorPartContainer,
    TensorPartReducer,
    decode_part,
)
from hivemind_tpu_torch.compression import CompressionBase, NoCompression, serialize_tensor
from hivemind_tpu_torch.p2p import P2P, P2PContext, PeerID
from hivemind_tpu_torch.proto import averaging_pb2, runtime_pb2
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.resilience import BreakerBoard
from hivemind_tpu_torch.utils.asyncio_utils import aiter_with_timeout, run_in_executor
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

# layer-3 telemetry: where the all-reduce round's time
# goes (local reduction vs per-peer exchange vs whole round) and which senders
# get banned, by cause
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import (
    finish_span as _finish_span,
    start_span as _start_span,
    trace as _tracing_span,
)

_ALLREDUCE_PHASE = _TELEMETRY.histogram(
    "hivemind_averaging_allreduce_phase_seconds",
    "duration of one all-reduce phase",
    ("phase",),
)
_BANNED_SENDERS = _TELEMETRY.counter(
    "hivemind_averaging_banned_senders_total", "senders banned mid-round", ("cause",)
)
# wire accounting for the averaging data path: serialized
# tensor-part payload bytes crossing this peer's wall in each direction (parts it
# ships + deltas it returns vs parts it receives as a reducer + deltas it gets
# back), and the per-round effective throughput using the same fp32-equivalent
# formula as benchmarks/benchmark_averaging.py — so the bench's headline number
# can be cross-checked against internal accounting
_AVG_BYTES_SENT = _TELEMETRY.counter(
    "hivemind_averaging_bytes_sent_total", "serialized averaging payload bytes sent"
)
_AVG_BYTES_RECEIVED = _TELEMETRY.counter(
    "hivemind_averaging_bytes_received_total", "serialized averaging payload bytes received"
)
_AVG_EFFECTIVE_RATE = _TELEMETRY.gauge(
    "hivemind_averaging_round_effective_bytes_per_second",
    "last successful round's effective rate: 2 * total_elements * 4 bytes / round "
    "seconds (divide by 1e9 for benchmark_averaging's GB/s-per-peer headline)",
)

# largest pre-compression part that still fits one mux message even uncompressed
# (MAX_MESSAGE_SIZE = 4 MiB minus headroom for tensor metadata + frame header)
from hivemind_tpu_torch.p2p.mux import MAX_MESSAGE_SIZE

MAX_PART_SIZE_BYTES = MAX_MESSAGE_SIZE - 2**16


class AveragingMode(Enum):
    NODE = 0
    CLIENT = 1
    AUX = 2


class AllReduceRunner:
    """Runs one allreduce round. The owning averager routes incoming
    ``rpc_aggregate_part`` streams for this group_id to ``handle_aggregate_stream``.

    :param peer_element_counts: reduction span sizes per peer (load balancer output)
    :param get_stub: callable (peer_id) -> stub with .rpc_aggregate_part(stream)
    :param links: negotiated per-link wire codecs (peer_index ->
        :class:`~hivemind_tpu_torch.averaging.wire_codec.WireLink`); absent entries
        fall back to ``compression`` (exact pre-negotiation behavior)
    :param residuals: the averager's error-feedback store (required for links
        with ``error_feedback``; survives the runner — one round borrows it)
    """

    def __init__(
        self,
        *,
        p2p: P2P,
        group_id: bytes,
        tensors: Sequence,
        ordered_peer_ids: Sequence[PeerID],
        peer_element_counts: Sequence[int],
        modes: Sequence[AveragingMode],
        get_stub,
        weight: float = 1.0,
        compression: CompressionBase = NoCompression(),
        part_size_bytes: int = DEFAULT_PART_SIZE_BYTES,
        sender_timeout: float = 30.0,
        reducer_timeout: float = 60.0,
        prefetch: int = 8,
        links: Optional[Dict[int, "WireLink"]] = None,
        residuals=None,
    ):
        self.p2p, self.group_id = p2p, group_id
        # one part travels as ONE mux message: a part whose wire size exceeded
        # MAX_MESSAGE_SIZE would kill the stream mid-round and silently degrade
        # the average. The clamp uses the same formula on every peer, so senders
        # and reducers (which derive part shapes independently) stay in agreement.
        if part_size_bytes > MAX_PART_SIZE_BYTES:
            logger.info(
                f"part_size_bytes={part_size_bytes} exceeds the per-message cap; "
                f"using {MAX_PART_SIZE_BYTES}"
            )
            part_size_bytes = MAX_PART_SIZE_BYTES
        self.ordered_peer_ids = tuple(ordered_peer_ids)
        self.modes = tuple(modes)
        self.peer_element_counts = tuple(peer_element_counts)
        self.get_stub = get_stub
        self.weight = weight
        self.sender_timeout, self.reducer_timeout = sender_timeout, reducer_timeout
        self.my_index = self.ordered_peer_ids.index(p2p.peer_id)
        self.my_mode = self.modes[self.my_index]
        assert len(self.modes) == len(self.ordered_peer_ids) == len(self.peer_element_counts)
        for peer_index, (mode, count) in enumerate(zip(self.modes, self.peer_element_counts)):
            if mode == AveragingMode.CLIENT:
                assert count == 0, "client-mode peers cannot be assigned reduction work"

        self.sender_ranks: Dict[int, int] = {}  # peer_index -> sender rank
        for peer_index, mode in enumerate(self.modes):
            if mode != AveragingMode.AUX:
                self.sender_ranks[peer_index] = len(self.sender_ranks)
        self.num_senders = len(self.sender_ranks)

        self.links = dict(links) if links else {}
        self.residuals = residuals
        if self.residuals is not None and any(link.error_feedback for link in self.links.values()):
            self.residuals.ensure(sum(self.peer_element_counts))
        peer_links = (
            [self.links.get(index) for index in range(len(self.ordered_peer_ids))] if self.links else None
        )
        # prefetch widens the in-flight part window per peer exchange: up to this
        # many parts may sit serialized ahead of the stream writer, keeping the
        # compress → encrypt → send stages concurrently busy
        self.container = TensorPartContainer(
            tensors, peer_element_counts, compression, part_size_bytes, prefetch=prefetch,
            peer_links=peer_links, residuals=residuals,
        ) if self.my_mode != AveragingMode.AUX else None
        my_part_shapes = self._span_part_shapes(self.my_index, part_size_bytes)
        self.reducer = TensorPartReducer(my_part_shapes, self.num_senders)
        self.compression = compression
        self.part_size_bytes = part_size_bytes
        # quantized delta leg: the averaged value of each part is
        # quantized ONCE per lossy tier and the same payload goes to every
        # lossy-link sender; EF touches the "reduce" residual exactly once per
        # part per round. Offsets map part_index -> global stream position.
        self._my_span_start = sum(self.peer_element_counts[: self.my_index])
        self._part_offsets = [0]
        for shape in my_part_shapes:
            self._part_offsets.append(self._part_offsets[-1] + int(np.prod(shape)))
        self._absolute_payloads: Dict[Tuple[int, str], "asyncio.Future"] = {}
        self._absolute_consumed: Dict[Tuple[int, str], int] = {}
        self._reduce_ef_parts: set = set()
        # how many sender streams will consume each cached absolute payload:
        # once all of them have taken a part, its payload is dropped (the cache
        # stays bounded by the in-flight window, not the whole reduced span)
        self._lossy_sender_count = sum(
            1
            for peer_index in self.sender_ranks
            if (lossy_link := self.links.get(peer_index)) is not None and lossy_link.error_feedback
        )
        # sender bans are the degenerate case of the shared cross-layer breaker
        # (resilience/breaker.py): threshold 1, infinite recovery — tripped once,
        # banned for the round's lifetime. `rank in banned_senders` still works.
        self.banned_senders = BreakerBoard(
            "allreduce_senders", failure_threshold=1, recovery_time=float("inf")
        )
        self._sender_last_active: Dict[int, float] = {}
        self._parts_received: Dict[int, int] = {}  # sender rank -> parts accepted
        self._finished = asyncio.Event()
        self._round_span = None  # set by run(); phase spans parent to it

    def _span_part_shapes(self, peer_index: int, part_size_bytes: int) -> list:
        """Part shapes of one peer's reduction span (derivable by every group member
        from the element counts alone — AUX peers have no container). Uses the shared
        partitioning rule so sender splits and reducer expectations cannot drift."""
        from hivemind_tpu_torch.averaging.partition import compute_span_part_sizes

        return [(size,) for size in compute_span_part_sizes(self.peer_element_counts[peer_index], part_size_bytes)]

    # ------------------------------------------------------------------ sending side

    async def run(self) -> AsyncIterator[np.ndarray]:
        """Send parts to all reducers, reduce own span, yield per-tensor deltas
        (AUX mode: reduces only, yields nothing)."""
        round_started = time.perf_counter()
        # detached (run() is a generator — no contextvar install); phase spans
        # below take it as their explicit parent so the trace shows the round
        # decomposed exactly like the _ALLREDUCE_PHASE histogram labels
        self._round_span = _start_span(
            "allreduce.round",
            peer=str(self.p2p.peer_id),
            group_size=len(self.ordered_peer_ids),
            rank=self.my_index,
        )
        communicate_tasks = []
        if self.my_mode != AveragingMode.AUX:
            for peer_index, count in enumerate(self.peer_element_counts):
                if count == 0:
                    continue
                if peer_index == self.my_index:
                    communicate_tasks.append(asyncio.create_task(self._reduce_local_parts()))
                else:
                    communicate_tasks.append(
                        asyncio.create_task(self._communicate_with_peer(peer_index))
                    )
        watchdog = asyncio.create_task(self._sender_watchdog()) if self.peer_element_counts[self.my_index] else None
        try:
            if self.my_mode == AveragingMode.AUX:
                await self._wait_all_parts_reduced()
                return
            assert self.container is not None
            async for delta_tensor in self.container.iterate_output_tensors():
                yield delta_tensor
        finally:
            _finish_span(self._round_span)
            round_elapsed = time.perf_counter() - round_started
            _ALLREDUCE_PHASE.observe(round_elapsed, phase="total")
            if (
                self.my_mode != AveragingMode.AUX
                and self.container is not None
                and round_elapsed > 0
                and self.container._finished.is_set()
                and self.container.failed_size == 0
            ):
                # fp32-equivalent effective rate, same formula as benchmark_averaging
                # — only for rounds that actually moved every byte (a cancelled or
                # degraded round would publish a fictitious rate)
                _AVG_EFFECTIVE_RATE.set(
                    2 * self.container.total_elements * 4 / round_elapsed
                )
            self._finished.set()
            if watchdog is not None:
                watchdog.cancel()
            for task in communicate_tasks:
                if not task.done():
                    task.cancel()
            self.reducer.finalize()

    async def _reduce_local_parts(self) -> None:
        """Loopback: feed own parts into own reducer without serialization."""
        assert self.container is not None
        my_rank = self.sender_ranks[self.my_index]
        phase_started = time.perf_counter()
        with _tracing_span(
            "allreduce.local_reduce", parent=self._round_span, peer=str(self.p2p.peer_id)
        ):
            try:
                for part_index, part in enumerate(self.container.get_raw_input_parts(self.my_index)):
                    self._sender_last_active[my_rank] = get_dht_time()  # lint: single-writer — own rank's key only
                    averaged = await self.reducer.accumulate_part(my_rank, part_index, part, self.weight)
                    self.container.register_processed_part(
                        self.my_index, part_index, averaged - part.astype(np.float32, copy=False)
                    )
            except AllreduceException as e:
                logger.debug(f"local reduction failed: {e}")
                self.container.register_failed_reducer(self.my_index)
            finally:
                _ALLREDUCE_PHASE.observe(time.perf_counter() - phase_started, phase="local_reduce")

    async def _communicate_with_peer(self, peer_index: int) -> None:
        """Stream our parts to one reducer and apply the deltas it returns
        (upstream allreduce.py:201-245)."""
        assert self.container is not None
        peer_id = self.ordered_peer_ids[peer_index]
        phase_started = time.perf_counter()
        with _tracing_span(
            "allreduce.peer_exchange",
            parent=self._round_span,
            peer=str(self.p2p.peer_id),
            remote=str(peer_id),
            codec=self._link_tier(peer_index),
        ) as exchange_span:
            await self._communicate_with_peer_traced(peer_index, peer_id, phase_started, exchange_span)

    async def _communicate_with_peer_traced(self, peer_index, peer_id, phase_started, exchange_span) -> None:
        try:
            stub = self.get_stub(peer_id)

            async def _requests():
                first = True
                async for serialized in self.container.iterate_input_parts_for(peer_index):
                    if _CHAOS.enabled:  # injection point: per part shipped to a reducer
                        payload = serialized.buffer
                        injected = await _CHAOS.inject(
                            "allreduce.load", payload=payload, scope=str(self.p2p.peer_id)
                        )
                        if injected is not payload:
                            serialized.buffer = injected
                    _AVG_BYTES_SENT.inc(serialized.ByteSize())
                    yield averaging_pb2.AveragingData(
                        code=averaging_pb2.PART_DATA,
                        group_id=self.group_id if first else b"",
                        tensor_part=serialized,
                        weight=self.weight,
                    )
                    first = False

            part_index = 0
            stream = stub.rpc_aggregate_part(_requests())
            # outlast the reducer's own laggard recovery: it may take up to
            # reducer_timeout to fail a stalled sender and produce our delta
            per_delta_timeout = self.reducer_timeout + self.sender_timeout
            async for response in aiter_with_timeout(stream, per_delta_timeout):
                if response.code != averaging_pb2.PART_DATA:
                    raise AllreduceException(
                        f"peer {peer_id} replied {averaging_pb2.MessageCode.Name(response.code)}"
                    )
                _AVG_BYTES_RECEIVED.inc(response.tensor_part.ByteSize())
                # decode off the event loop (symmetric to the serialize side) so the
                # loop keeps shoveling frames while numpy unpacks the previous delta
                processed = await run_in_executor(decode_part, response.tensor_part)
                if response.absolute_part:
                    # quantized leg: the payload is the reduced average itself
                    # (quantized once, with the reducer's error feedback); the
                    # delta is recovered against our own input locally
                    self.container.register_processed_absolute(peer_index, part_index, processed)
                else:
                    self.container.register_processed_part(peer_index, part_index, processed)
                part_index += 1
            if part_index < self.container.num_parts_by_peer[peer_index]:
                raise AllreduceException(
                    f"peer {peer_id} closed early: {part_index}/{self.container.num_parts_by_peer[peer_index]} parts"
                )
        except (Exception, asyncio.CancelledError) as e:
            if not isinstance(e, asyncio.CancelledError):
                # swallowed here (the round degrades to local values), so the
                # span must record the failure explicitly — a cancelled task
                # propagates and gets its error event from the with block
                if exchange_span is not None:
                    exchange_span.add_event("error", type=type(e).__name__)
                logger.warning(f"reducer {peer_id} failed: {e!r}; keeping local values for its parts")
                self.container.register_failed_reducer(peer_index)
            else:
                raise
        finally:
            _ALLREDUCE_PHASE.observe(time.perf_counter() - phase_started, phase="peer_exchange")

    # ------------------------------------------------------------------ reducing side

    async def handle_aggregate_stream(
        self,
        first_message: averaging_pb2.AveragingData,
        requests: AsyncIterator[averaging_pb2.AveragingData],
        context: P2PContext,
    ) -> AsyncIterator[averaging_pb2.AveragingData]:
        """Serve one sender's part stream for our reduction span; called by the
        averager's rpc_aggregate_part once the group_id is matched."""
        try:
            sender_peer_index = self.ordered_peer_ids.index(context.remote_id)
        except ValueError:
            yield averaging_pb2.AveragingData(code=averaging_pb2.PROTOCOL_VIOLATION)
            return
        sender_rank = self.sender_ranks.get(sender_peer_index)
        if sender_rank is None or sender_rank in self.banned_senders:
            yield averaging_pb2.AveragingData(code=averaging_pb2.PROTOCOL_VIOLATION)
            return

        # read EAGERLY on a side task: a sender's liveness must be judged by when its
        # parts ARRIVE, not by when the (possibly laggard-blocked) reduction loop gets
        # to them — otherwise one slow sender makes every other sender look stalled
        arrived: asyncio.Queue = asyncio.Queue()

        async def _reader():
            try:
                self._sender_last_active[sender_rank] = get_dht_time()  # lint: single-writer — one reader per sender rank
                self._parts_received[sender_rank] = 1  # lint: single-writer — one reader per sender rank
                await arrived.put(first_message)
                count = 1
                async for message in requests:
                    count += 1
                    self._sender_last_active[sender_rank] = get_dht_time()
                    self._parts_received[sender_rank] = count
                    await arrived.put(message)
            finally:
                await arrived.put(None)

        reader_task = asyncio.create_task(_reader())
        part_index = 0
        try:
            while True:
                message = await arrived.get()
                if message is None:
                    break
                if sender_rank in self.banned_senders:
                    # the watchdog failed this sender; late parts must not leak into
                    # parts that were already averaged without it
                    yield averaging_pb2.AveragingData(code=averaging_pb2.CANCELLED)
                    return
                _AVG_BYTES_RECEIVED.inc(message.tensor_part.ByteSize())
                part = await run_in_executor(decode_part, message.tensor_part)
                if sender_rank in self.banned_senders:
                    # re-check after the executor hop: the watchdog may have failed
                    # this sender while the decode ran, and a late part must not
                    # slip into an average computed without it
                    yield averaging_pb2.AveragingData(code=averaging_pb2.CANCELLED)
                    return
                try:
                    # weight 0.0 is legitimate (zero-weight peers contribute nothing);
                    # senders always set the field explicitly
                    averaged = await asyncio.wait_for(
                        self.reducer.accumulate_part(
                            sender_rank, part_index, part, float(message.weight)
                        ),
                        timeout=self.reducer_timeout,
                    )
                except asyncio.TimeoutError:
                    # failing the laggards may resolve the part right now — the
                    # on-time sender whose wait expired must still get its delta
                    self._fail_laggards(part_index)
                    averaged = self.reducer.result_nowait(part_index)
                    if averaged is None:
                        yield averaging_pb2.AveragingData(code=averaging_pb2.CANCELLED)
                        return
                link = self.links.get(sender_peer_index)
                if link is not None and link.error_feedback and self.residuals is not None:
                    # quantized leg: ship the averaged part itself, quantized
                    # ONCE per tier with reducer-side error feedback — every
                    # lossy sender gets the same bytes, and senders recover
                    # their delta locally (absolute_part)
                    serialized_part = await self._absolute_average(part_index, averaged, link)
                    if _CHAOS.enabled:  # injection point: per delta returned to a sender
                        payload = serialized_part.buffer
                        injected = await _CHAOS.inject(
                            "allreduce.reduce", payload=payload, scope=str(self.p2p.peer_id)
                        )
                        if injected is not payload:
                            # the cached message is shared across senders: only
                            # THIS sender's copy gets the corruption
                            corrupted_part = runtime_pb2.Tensor()
                            corrupted_part.CopyFrom(serialized_part)
                            corrupted_part.buffer = injected
                            serialized_part = corrupted_part
                    _AVG_BYTES_SENT.inc(serialized_part.ByteSize())
                    yield averaging_pb2.AveragingData(
                        code=averaging_pb2.PART_DATA,
                        tensor_part=serialized_part,
                        absolute_part=True,
                    )
                else:
                    delta = averaged - part.astype(np.float32, copy=False)
                    # the delta is a fresh private array: the codec may clip/normalize
                    # it in place instead of allocating another copy
                    serialized_delta = await run_in_executor(
                        serialize_tensor, delta,
                        link.codec if link is not None else self.compression, None, True,
                    )
                    if _CHAOS.enabled:  # injection point: per delta returned to a sender
                        payload = serialized_delta.buffer
                        injected = await _CHAOS.inject(
                            "allreduce.reduce", payload=payload, scope=str(self.p2p.peer_id)
                        )
                        if injected is not payload:
                            serialized_delta.buffer = injected
                    _AVG_BYTES_SENT.inc(serialized_delta.ByteSize())
                    yield averaging_pb2.AveragingData(
                        code=averaging_pb2.PART_DATA,
                        tensor_part=serialized_delta,
                    )
                part_index += 1
        except (ConnectionError, asyncio.CancelledError, GeneratorExit):
            self._ban_sender(sender_rank, "stream interrupted", cause="interrupted")
            raise
        except AllreduceException as e:
            logger.debug(f"aggregate stream from {context.remote_id} failed: {e}")
            self._ban_sender(sender_rank, str(e))
            yield averaging_pb2.AveragingData(code=averaging_pb2.INTERNAL_ERROR)
            return
        except Exception as e:
            # ANY unexpected reducer failure must release this sender's pending
            # parts: without the ban, other parts of our span wait forever for a
            # contribution this stream will never finish (found by the chaos
            # engine's abort injection at allreduce.reduce — the old test-local
            # fault subclasses always surfaced as GeneratorExit and hid this)
            self._ban_sender(sender_rank, f"reducer error: {e!r}", cause="internal_error")
            raise
        finally:
            reader_task.cancel()
        if part_index < len(self.reducer.part_shapes):
            self._ban_sender(
                sender_rank, f"sent only {part_index}/{len(self.reducer.part_shapes)} parts", cause="incomplete"
            )

    def _link_tier(self, peer_index: int) -> str:
        """The wire tier name of one link, for span/ledger attribution."""
        link = self.links.get(peer_index)
        if link is not None:
            return link.tier
        from hivemind_tpu_torch.compression.serialization import codec_name

        return codec_name(self.compression)

    async def _absolute_average(self, part_index: int, averaged: np.ndarray, link) -> runtime_pb2.Tensor:
        """Quantize one averaged part for the lossy delta leg, single-flight per
        (part, tier): concurrent sender streams share the payload, and the EF
        residual update runs exactly once per part per round (a second lossy
        tier in the same group — rare — quantizes the raw average)."""
        key = (part_index, link.tier)
        future = self._absolute_payloads.get(key)
        if future is not None:
            serialized = await asyncio.shield(future)
            self._consume_absolute(key)
            return serialized
        future = asyncio.get_event_loop().create_future()
        self._absolute_payloads[key] = future
        self._absolute_consumed[key] = 0
        apply_feedback = part_index not in self._reduce_ef_parts
        if apply_feedback:
            self._reduce_ef_parts.add(part_index)

        def _quantize() -> runtime_pb2.Tensor:
            if apply_feedback:
                from hivemind_tpu_torch.averaging.residual import compress_with_feedback

                start = self._my_span_start + self._part_offsets[part_index]
                residual = self.residuals.view("reduce", start, start + averaged.size)
                return compress_with_feedback(averaged, link.codec, residual)
            return serialize_tensor(averaged, link.codec)

        try:
            serialized = await run_in_executor(_quantize)
        except BaseException as e:
            future.set_exception(e)
            # a co-waiting stream will consume it; if none does, don't warn
            future.exception()
            raise
        future.set_result(serialized)
        self._consume_absolute(key)
        return serialized

    def _consume_absolute(self, key: Tuple[int, str]) -> None:
        """One lossy sender took this cached payload; drop it once every lossy
        sender has (a banned sender simply leaves its parts cached until the
        round ends — bounded by the original lifetime, not worse)."""
        count = self._absolute_consumed.get(key)
        if count is None:
            return
        self._absolute_consumed[key] = count + 1
        if self._absolute_consumed[key] >= self._lossy_sender_count:
            self._absolute_payloads.pop(key, None)
            self._absolute_consumed.pop(key, None)

    def _ban_sender(self, sender_rank: int, reason: str, cause: str = "error") -> None:
        if sender_rank not in self.banned_senders:
            logger.debug(f"banning sender {sender_rank}: {reason}")
            _BANNED_SENDERS.inc(cause=cause)
            self.banned_senders.register_failure(sender_rank)  # trips permanently
            self.reducer.on_sender_failed(sender_rank)

    def _fail_laggards(self, part_index: int) -> None:
        """A part timed out: fail every sender that has not contributed to it."""
        for rank in self.reducer.pending_senders(part_index):
            self._ban_sender(rank, f"no part {part_index} within reducer_timeout", cause="reducer_timeout")

    async def _sender_watchdog(self) -> None:
        """Fail senders that never open their stream OR stall mid-stream
        (upstream allreduce.py:192-199)."""
        start_time = get_dht_time()
        total_parts = len(self.reducer.part_shapes)
        while not self._finished.is_set():
            await asyncio.sleep(self.sender_timeout / 4)
            now = get_dht_time()
            for peer_index, rank in self.sender_ranks.items():
                if rank in self.banned_senders:
                    continue
                last_active = self._sender_last_active.get(rank)
                reference_time = last_active if last_active is not None else start_time
                unfinished = self._parts_received.get(rank, 0) < total_parts
                if unfinished and now - reference_time > self.sender_timeout:
                    reason = "never started sending" if last_active is None else "stalled mid-stream"
                    self._ban_sender(rank, reason, cause="never_started" if last_active is None else "stalled")

    async def _wait_all_parts_reduced(self) -> None:
        """AUX mode: stay alive until every part of our span is reduced."""
        num_parts = len(self.reducer.part_shapes)
        for part_index in range(num_parts):
            try:
                await self.reducer.wait_part(part_index, timeout=self.reducer_timeout)
            except (asyncio.TimeoutError, AllreduceException):
                self._fail_laggards(part_index)
