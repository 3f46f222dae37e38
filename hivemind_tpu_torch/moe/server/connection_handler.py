"""Expert RPC endpoints (the port of hivemind_tpu/moe/server/connection_handler.py,
on the same wire): one asyncio servicer feeding the task pools and the decode
sessions directly.

Every expert RPC runs inside a ``serving.request`` span, a child of the
``p2p.handle:`` span, which already joined the remote caller's trace, so the
request's phases (queue wait, batch assembly and compute stamped by the
TaskPool, serialize stamped here) land in the caller's trace and in the
process-wide :data:`~hivemind_tpu_torch.telemetry.serving.SERVING_LEDGER`.

- **Wire dtype**: responses are serialized with this server's activation codec
  (default fp16; ``"none"`` is bit-identical), published in ``rpc_info`` so
  clients send requests in the same dtype.
- **Off-loop codecs**: past a small inline threshold, request decoding and
  response encoding run on the shared executor, so multi-MB payloads do not
  stall RPC dispatch; a ~4 KB decode step stays inline, where the executor hop
  would dominate. ``serialize_s`` then includes the executor round trip.
- **Scatter-gather responses**: responses leave as
  :class:`~hivemind_tpu_torch.utils.streaming.WireParts` frames, the tensor
  buffer riding into the AEAD as its own buffer; stream chunks are memoryview
  slices, serialized one tensor at a time.

Results leave the card inside ``ModuleBackend``: the handler serializes host
numpy arrays only.
"""

from __future__ import annotations

import hashlib
import time
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np
import torch

from hivemind_tpu_torch.compression import (
    codec_name,
    deserialize_tensor,
    deserialize_tensor_stream,
    expert_response_parts,
    resolve_activation_codec,
    serialize_tensor,
    split_response_for_wire,
)
from hivemind_tpu_torch.moe.expert_uid import IDEMPOTENT_CONNECTION_RPCS
from hivemind_tpu_torch.moe.server.admission import FairShareAdmission
from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.task_pool import TaskPool
from hivemind_tpu_torch.p2p import P2PContext, ServicerBase
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.telemetry.serving import (
    SERVING_SPAN,
    WIRE_BYTES_RECEIVED,
    WIRE_BYTES_SENT,
    accrue_span_phase,
)
from hivemind_tpu_torch.telemetry.tracing import trace as _trace
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.streaming import WireParts

logger = get_logger(__name__)

_STREAM_CHUNK = 2**20  # 1 MiB chunks inside stream replies

# payloads below this encode/decode inline: the executor hop would dominate a
# ~4 KB decode step (the same threshold as the client's _OFF_LOOP_CODEC_BYTES in
# moe/client/expert.py)
_OFF_LOOP_CODEC_BYTES = 256 * 1024

# cached metric children (one label value per role on this path)
_SERVER_BYTES_SENT = WIRE_BYTES_SENT.labels("server")
_SERVER_BYTES_RECEIVED = WIRE_BYTES_RECEIVED.labels("server")


class ConnectionHandler(ServicerBase):
    # which RPCs may be retried on ambiguous connection loss — shared with the
    # client's direct call sites (expert.py), see expert_uid.py for the rationale
    _idempotent_rpcs = IDEMPOTENT_CONNECTION_RPCS

    def __init__(self, backends: Dict[str, ModuleBackend], decode_max_len: int = 256,
                 decode_max_sessions: int = 64, max_queue_size: int = 1024,
                 activation_compression: str = "float16",
                 client_rate: Optional[float] = None,
                 client_burst: Optional[float] = None):
        self.backends = backends
        self.activation_codec = resolve_activation_codec(activation_compression)
        self.forward_pools: Dict[str, TaskPool] = {}
        self.backward_pools: Dict[str, TaskPool] = {}
        self._max_queue_size = max_queue_size
        self.decode_sessions = DecodeSessionManager(backends, max_len=decode_max_len,
                                                    max_sessions=decode_max_sessions)
        # fair-share admission: per-client token buckets ahead of the bounded
        # queues; one hot tenant sheds at its own budget, typed exactly like a
        # queue shed, while other clients keep flowing. Opt-in (``client_rate``).
        self.admission: Optional[FairShareAdmission] = (
            FairShareAdmission(client_rate, burst=client_burst) if client_rate else None
        )
        for name, backend in backends.items():
            self._register_pools(name, backend)

    def _register_pools(self, name: str, backend: ModuleBackend) -> None:
        self.forward_pools[name] = TaskPool(
            backend.forward, f"{name}_forward", max_batch_size=backend.max_batch_size,
            max_queue_size=self._max_queue_size,
        )
        self.backward_pools[name] = TaskPool(
            backend.backward, f"{name}_backward", max_batch_size=backend.max_batch_size,
            max_queue_size=self._max_queue_size,
        )

    def add_backend(self, uid: str, backend: ModuleBackend) -> List[TaskPool]:
        """Serve an expert acquired at runtime (replication): its pools are made
        here, and the caller (``Server.add_backend``) hands them to the Runtime
        and declares the expert. Returns the new pools."""
        if uid in self.backends and uid in self.forward_pools:
            return []
        self.backends[uid] = backend
        self._register_pools(uid, backend)
        return [self.forward_pools[uid], self.backward_pools[uid]]

    def _admit(self, context: P2PContext, tensors, kind: str) -> None:
        """Fair-share gate: draw this request's sample count from the calling
        client's token bucket (raises the typed ClientOverBudgetError shed).
        Runs inside the serving span so sheds stay attributed per client."""
        if self.admission is None:
            return
        cost = 1.0
        if tensors:
            first = tensors[0]
            if getattr(first, "ndim", 0):
                # samples, not requests: batching harder must not dodge the
                # budget. Decode steps are [batch, positions, hid] — charge
                # positions too (a prefill is prompt_len tokens of work).
                cost = float(first.shape[0])
                if getattr(first, "ndim", 0) >= 3:
                    cost *= float(first.shape[1])
        self.admission.admit(str(context.remote_id), cost, kind=kind)

    @property
    def activation_compression(self) -> str:
        """Canonical knob value of this server's wire dtype ("float16", "none", …)."""
        return codec_name(self.activation_codec)

    def all_pools(self) -> List[TaskPool]:
        return list(self.forward_pools.values()) + list(self.backward_pools.values())

    @staticmethod
    def _serving_trace(kind: str, uid: str, context: P2PContext, tensors=None) -> _trace:
        """The per-request serving span (ServingLedger assembles one record per
        finished span; see telemetry/serving.py). ``client`` is the remote
        caller — per-client attribution rides every record."""
        attributes = {
            "kind": kind,
            "expert": uid,
            "peer": str(context.local_id),
            "client": str(context.remote_id),
        }
        if tensors:
            first = tensors[0]
            if getattr(first, "ndim", 0):
                attributes["batch"] = int(first.shape[0])
        return _trace(SERVING_SPAN, **attributes)

    # ------------------------------------------------------------------ RPCs

    async def rpc_info(self, request: runtime_pb2.ExpertUID, context: P2PContext) -> runtime_pb2.ExpertInfoResponse:
        backend = self.backends.get(request.uid)
        if backend is None:
            raise KeyError(f"unknown expert {request.uid!r}")
        info = backend.get_info()
        info["span_support"] = True  # clients only group co-located blocks if set
        # wire-dtype negotiation: clients serialize their request activations
        # with the server's declared codec (NONE stays bit-identical)
        info["activation_compression"] = self.activation_compression
        if self.decode_sessions.supports(request.uid):
            info["decode_max_len"] = self.decode_sessions.max_len
        return runtime_pb2.ExpertInfoResponse(serialized_info=MSGPackSerializer.dumps(info))

    async def _run_forward(self, uid: str, tensors: List[np.ndarray]) -> List[np.ndarray]:
        pool = self.forward_pools.get(uid)
        if pool is None:
            raise KeyError(f"unknown expert {uid!r}")
        backend = self.backends[uid]
        if len(tensors) != backend.num_inputs:
            raise ValueError(f"expert {uid!r} takes {backend.num_inputs} tensors, got {len(tensors)}")
        return await pool.submit_task(*tensors)

    async def _run_backward(self, uid: str, tensors: List[np.ndarray]) -> List[np.ndarray]:
        pool = self.backward_pools.get(uid)
        if pool is None:
            raise KeyError(f"unknown expert {uid!r}")
        backend = self.backends[uid]
        expected = backend.num_inputs + backend.num_outputs
        if len(tensors) != expected:
            raise ValueError(
                f"expert {uid!r} backward takes {expected} tensors (inputs + output grads), got {len(tensors)}"
            )
        return await pool.submit_task(*tensors)

    def _span_uids(self, uid: str, metadata: bytes) -> List[str]:
        """Span execution: request metadata may name CONSECUTIVE co-located blocks
        (``{"uids": [...]}`` starting with the request uid) to run as one chain —
        per-call round-trips for a pipeline drop from #blocks to #servers."""
        meta = MSGPackSerializer.loads(metadata) if metadata else {}
        uids = meta.get("uids") or [uid]
        if uids[0] != uid:
            raise ValueError(f"span uids must start with the request uid {uid!r}, got {uids!r}")
        for prev, nxt in zip(uids, uids[1:]):
            prev_backend, next_backend = self.backends.get(prev), self.backends.get(nxt)
            if prev_backend is None or next_backend is None:
                raise KeyError(f"unknown expert in span: {prev!r} or {nxt!r}")
            if prev_backend.num_outputs != next_backend.num_inputs:
                raise ValueError(
                    f"span chain mismatch: {prev!r} outputs {prev_backend.num_outputs} "
                    f"tensors but {nxt!r} takes {next_backend.num_inputs}"
                )
        return uids

    async def _run_forward_span(self, uids: List[str], tensors: List[np.ndarray]) -> List[np.ndarray]:
        for span_uid in uids:
            tensors = await self._run_forward(span_uid, tensors)
        return tensors

    async def _run_backward_span(self, uids: List[str], tensors: List[np.ndarray]) -> List[np.ndarray]:
        """Chained backward: recover each block's inputs with a forward sweep, then
        backpropagate block by block in reverse (every block's backward also steps
        its optimizer — same semantics as per-block RPCs)."""
        first = self.backends[uids[0]]
        block_inputs, current = [], tensors[: first.num_inputs]
        for span_uid in uids:
            block_inputs.append(current)
            if span_uid != uids[-1]:
                current = await self._run_forward(span_uid, current)
        grads = tensors[first.num_inputs:]
        for span_uid, inputs in zip(reversed(uids), reversed(block_inputs)):
            grads = await self._run_backward(span_uid, [*inputs, *grads])
        return grads

    # ------------------------------------------------------------------ codecs

    async def _deserialize_request(self, tensors) -> List[np.ndarray]:
        """Parse request tensors into host arrays; big payloads decode off the
        event loop, small ones inline (the executor hop would dominate them)."""
        if not tensors:
            return []
        tensor_list = list(tensors)
        if sum(len(t.buffer) for t in tensor_list) < _OFF_LOOP_CODEC_BYTES:
            return _decode_all(tensor_list)
        return await run_in_executor(_decode_all, tensor_list)

    def _serialize_outputs(self, outputs: List[np.ndarray]) -> List[runtime_pb2.Tensor]:
        # allow_inplace: each output row range is private to its task (views of
        # the fresh device-transfer batch), so the fp16 clip may reuse it
        return [serialize_tensor(o, self.activation_codec, None, True) for o in outputs]

    async def _respond(self, outputs: List[np.ndarray]) -> WireParts:
        """Serialize the response with the server's wire dtype (off-loop past
        the inline threshold), accrue the serialize phase onto the active
        serving span, and frame the tensors scatter-gather (buffers uncopied
        to the AEAD)."""
        start = time.perf_counter()
        if sum(int(getattr(o, "nbytes", 0)) for o in outputs) < _OFF_LOOP_CODEC_BYTES:
            serialized = self._serialize_outputs(outputs)
        else:
            serialized = await run_in_executor(self._serialize_outputs, outputs)
        accrue_span_phase("serialize_s", time.perf_counter() - start)
        response = expert_response_parts(serialized)
        _SERVER_BYTES_SENT.inc(response.nbytes)
        return response

    async def rpc_forward(self, request: runtime_pb2.ExpertRequest, context: P2PContext) -> runtime_pb2.ExpertResponse:
        _SERVER_BYTES_RECEIVED.inc(request.ByteSize())
        inputs = await self._deserialize_request(request.tensors)
        with self._serving_trace("forward", request.uid, context, inputs) as span:
            self._admit(context, inputs, "forward")
            uids = self._span_uids(request.uid, request.metadata)
            if span is not None and len(uids) > 1:
                span.set("span_len", len(uids))
            outputs = await self._run_forward_span(uids, inputs)
            return await self._respond(outputs)

    async def rpc_backward(self, request: runtime_pb2.ExpertRequest, context: P2PContext) -> runtime_pb2.ExpertResponse:
        _SERVER_BYTES_RECEIVED.inc(request.ByteSize())
        inputs = await self._deserialize_request(request.tensors)
        with self._serving_trace("backward", request.uid, context, inputs) as span:
            self._admit(context, inputs, "backward")
            uids = self._span_uids(request.uid, request.metadata)
            if span is not None and len(uids) > 1:
                span.set("span_len", len(uids))
            grads = await self._run_backward_span(uids, inputs)
            return await self._respond(grads)

    async def _run_decode(self, uid: str, metadata: bytes, tensors: List[np.ndarray]) -> np.ndarray:
        meta = MSGPackSerializer.loads(metadata) if metadata else {}
        session_id = meta.get("session_id")
        if not session_id:
            raise ValueError("rpc_decode requires a session_id in request metadata")
        [x] = tensors
        # span execution: chain consecutive co-located pipeline blocks' session
        # steps in ONE rpc; each per-uid step still goes through decode_async, so
        # cross-client continuous batching applies at every block of the span
        uids = self._span_uids(uid, metadata)
        reset = bool(meta.get("reset", False))
        for span_uid in uids:
            step_start = time.perf_counter()
            x = await self.decode_sessions.decode_async(span_uid, str(session_id), x, reset)
            # decode bypasses the pools: the whole session step (incl. the
            # continuous-batching flush window) is the compute phase
            accrue_span_phase("compute_s", time.perf_counter() - step_start)
        return x

    async def rpc_decode(self, request: runtime_pb2.ExpertRequest, context: P2PContext) -> runtime_pb2.ExpertResponse:
        """One KV-cache session step (decode_session.py). Metadata carries
        ``{"session_id": str, "reset": bool}``; sessions bypass the batching
        pools — each holds its own per-client device cache."""
        _SERVER_BYTES_RECEIVED.inc(request.ByteSize())
        tensors = await self._deserialize_request(request.tensors)
        with self._serving_trace("decode", request.uid, context, tensors):
            self._admit(context, tensors, "decode")
            output = await self._run_decode(request.uid, request.metadata, tensors)
            return await self._respond([output])

    async def rpc_replica_state(
        self, request: runtime_pb2.ExpertUID, context: P2PContext
    ) -> AsyncIterator[runtime_pb2.ExpertResponse]:
        """Expert replication transfer: stream this expert's construction spec and
        full ``state_dict`` blob to a peer acquiring a replica. The first message
        carries msgpack metadata (spec, byte length, blake2b digest); the blob
        follows in 1 MiB chunks riding Tensor buffers. Backends without a
        ``replication_spec`` (``Server.create`` sets one on every expert built from
        the layer registry; a checkpoint-loaded Llama block has none) refuse: they
        replicate by loading the same checkpoint, not over RPC."""
        backend = self.backends.get(request.uid)
        if backend is None:
            raise KeyError(f"unknown expert {request.uid!r}")
        spec = getattr(backend, "replication_spec", None)
        if spec is None:
            raise ValueError(
                f"expert {request.uid!r} carries no replication spec; "
                f"replicate it from its source checkpoint instead"
            )
        blob = await run_in_executor(backend.state_dict)
        digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
        yield runtime_pb2.ExpertResponse(
            metadata=MSGPackSerializer.dumps({
                "spec": dict(spec),
                "total_bytes": len(blob),
                "digest": digest,
            })
        )
        view = memoryview(blob)
        for offset in range(0, len(blob), _STREAM_CHUNK):
            chunk = bytes(view[offset:offset + _STREAM_CHUNK])
            _SERVER_BYTES_SENT.inc(len(chunk))
            yield runtime_pb2.ExpertResponse(
                tensors=[runtime_pb2.Tensor(buffer=chunk, dtype="uint8")]
            )

    # NOTE on the stream RPCs below: the serving span must not wrap a `yield`
    # (an async generator's body runs in its consumer's context), so it closes
    # after compute and the response chunks then serialize LAZILY, one tensor
    # at a time — a multi-hundred-MB streamed response must never be
    # materialized whole. Stream kinds therefore carry no `serialize_s` phase.

    async def rpc_decode_stream(
        self, requests: AsyncIterator[runtime_pb2.ExpertRequest], context: P2PContext
    ) -> AsyncIterator[runtime_pb2.ExpertResponse]:
        """Streaming variant for prefill chunks over the unary payload cap."""
        with self._serving_trace("decode_stream", "?", context) as span:
            uid, metadata, tensors = await self._collect_stream_with_metadata(requests)
            if span is not None:
                span.set("expert", uid)
                if tensors and getattr(tensors[0], "ndim", 0):
                    span.set("batch", int(tensors[0].shape[0]))
            self._admit(context, tensors, "decode")
            output = await self._run_decode(uid, metadata, tensors)
        async for message in self._stream_response([output]):
            yield message

    async def rpc_forward_stream(
        self, requests: AsyncIterator[runtime_pb2.ExpertRequest], context: P2PContext
    ) -> AsyncIterator[runtime_pb2.ExpertResponse]:
        with self._serving_trace("forward_stream", "?", context) as span:
            uid, metadata, tensors = await self._collect_stream_with_metadata(requests)
            if span is not None:
                span.set("expert", uid)
                if tensors and getattr(tensors[0], "ndim", 0):
                    span.set("batch", int(tensors[0].shape[0]))
            self._admit(context, tensors, "forward")
            outputs = await self._run_forward_span(self._span_uids(uid, metadata), tensors)
        async for message in self._stream_response(outputs):
            yield message

    async def rpc_backward_stream(
        self, requests: AsyncIterator[runtime_pb2.ExpertRequest], context: P2PContext
    ) -> AsyncIterator[runtime_pb2.ExpertResponse]:
        with self._serving_trace("backward_stream", "?", context) as span:
            uid, metadata, tensors = await self._collect_stream_with_metadata(requests)
            if span is not None:
                span.set("expert", uid)
                if tensors and getattr(tensors[0], "ndim", 0):
                    span.set("batch", int(tensors[0].shape[0]))
            self._admit(context, tensors, "backward")
            grads = await self._run_backward_span(self._span_uids(uid, metadata), tensors)
        async for message in self._stream_response(grads):
            yield message

    async def _collect_stream_with_metadata(self, requests: AsyncIterator[runtime_pb2.ExpertRequest]):
        """Collect a streamed request: uid + first message's metadata + tensors.
        Chunk reassembly/deserialization runs off-loop (one tensor at a time,
        as the chunks arrive)."""
        uid = None
        metadata = b""

        async def parts():
            nonlocal uid, metadata
            async for request in requests:
                _SERVER_BYTES_RECEIVED.inc(request.ByteSize())
                if uid is None and request.uid:
                    uid = request.uid
                if not metadata and request.metadata:
                    metadata = request.metadata
                yield list(request.tensors)

        tensors = _host_arrays(await deserialize_tensor_stream(parts(), off_loop=True))
        if uid is None:
            # wire input from a remote peer: a proper error the client can read
            # (an assert would vanish under -O and crash as a bare AssertionError)
            raise ValueError("streamed expert request carried no expert uid")
        return uid, metadata, tensors

    async def _stream_response(self, outputs: List[np.ndarray]):
        """Lazy streamed response: each tensor serializes off-loop (with the
        server's wire dtype) only when its turn comes, and its chunks are
        zero-copy memoryview slices framed scatter-gather."""
        for out in outputs:
            if int(getattr(out, "nbytes", 0)) < _OFF_LOOP_CODEC_BYTES:
                serialized = serialize_tensor(out, self.activation_codec, None, True)
            else:
                serialized = await run_in_executor(
                    serialize_tensor, out, self.activation_codec, None, True
                )
            for chunk in split_response_for_wire(serialized, _STREAM_CHUNK):
                _SERVER_BYTES_SENT.inc(chunk.nbytes)
                yield chunk


def _host_arrays(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Decoded CPU tensors as the numpy arrays the task pools take (bfloat16, which
    numpy lacks, widened to float32: the backends compute from float32 inputs)."""
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy() for t in tensors]


def _decode_all(tensors: Sequence[runtime_pb2.Tensor]) -> List[np.ndarray]:
    return _host_arrays([deserialize_tensor(t) for t in tensors])
