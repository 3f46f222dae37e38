"""Serialization facade: one codec instance per CompressionType value, plus the
serving path's wire splicers: hand-encoded ``ExpertRequest``/``ExpertResponse``
frames whose tensor buffers ride as separate scatter-gather buffers
(:class:`~hivemind_tpu_torch.utils.streaming.WireParts`) instead of being copied
into one ``SerializeToString`` blob (the port of
hivemind_tpu/compression/serialization.py). The frames are byte-identical to
protobuf's own encoding, so the receive side parses them with the generated
classes."""

from __future__ import annotations

from typing import Any, AsyncIterator, List, Optional, Sequence

import torch

from hivemind_tpu_torch.compression.base import (
    CompressionBase,
    CompressionInfo,
    CompressionType,
    NoCompression,
)
from hivemind_tpu_torch.compression.floating import Float16Compression, ScaledFloat16Compression
from hivemind_tpu_torch.compression.quantization import (
    BlockwiseQuantization,
    Quantile8BitQuantization,
    Uniform8BitQuantization,
)
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor
from hivemind_tpu_torch.utils.streaming import WireParts, split_for_streaming

_CODECS = {
    CompressionType.NONE: NoCompression(),
    CompressionType.FLOAT16: Float16Compression(),
    CompressionType.MEANSTD_16BIT: ScaledFloat16Compression(),
    CompressionType.UNIFORM_8BIT: Uniform8BitQuantization(),
    CompressionType.QUANTILE_8BIT: Quantile8BitQuantization(),
    CompressionType.BLOCKWISE_8BIT: BlockwiseQuantization(),
}

_missing = set(runtime_pb2.CompressionType.values()) - set(_CODECS)
if _missing:
    raise ImportError(f"no codec registered for CompressionType values {sorted(_missing)}")


def get_codec(compression_type: int) -> CompressionBase:
    return _CODECS[compression_type]


def resolve_activation_codec(name: Optional[str]) -> CompressionBase:
    """The serving wire dtype by knob value ("none", "float16", "meanstd_16bit",
    ...: any CompressionType name, case-insensitive; None or "" is NONE)."""
    if not name:
        return _CODECS[CompressionType.NONE]
    try:
        # Value() rejects anything that is not an enum member, so a remote name
        # cannot reach the enum wrapper's other attributes
        value = runtime_pb2.CompressionType.Value(str(name).upper())
    except ValueError:
        valid = ", ".join(k.lower() for k in runtime_pb2.CompressionType.keys())
        raise ValueError(f"unknown activation compression {name!r}; expected one of: {valid}") from None
    return _CODECS[value]


def codec_name(codec: CompressionBase) -> str:
    """The canonical lowercase knob value of a codec ("float16", "none", ...)."""
    return runtime_pb2.CompressionType.Name(codec.compression_type).lower()


def serialize_tensor(
    tensor: Any,
    compression: CompressionBase | int = CompressionType.NONE,
    info: Optional[CompressionInfo] = None,
    allow_inplace: bool = False,
) -> runtime_pb2.Tensor:
    if isinstance(compression, int):
        compression = _CODECS[compression]
    return compression.compress(tensor, info, allow_inplace)


def deserialize_tensor(serialized: runtime_pb2.Tensor) -> torch.Tensor:
    """The CPU tensor a message encodes."""
    return _CODECS[serialized.compression].extract(serialized)


def _clone_tensor_metadata(source: runtime_pb2.Tensor) -> runtime_pb2.Tensor:
    """A Tensor message with every field of ``source`` but its payload (and chunks)."""
    return runtime_pb2.Tensor(
        size=source.size,
        dtype=source.dtype,
        requires_grad=source.requires_grad,
        compression=source.compression,
    )


async def deserialize_tensor_stream(
    stream: AsyncIterator[List[runtime_pb2.Tensor]], off_loop: bool = False
) -> List[torch.Tensor]:
    """Reassemble tensors from a stream of chunked parts: each tensor arrives as its
    first message (with ``chunks`` = total count) followed by buffer-only
    continuation messages. ``off_loop=True`` joins and decodes each completed
    tensor in the shared executor, so a large tensor does not stall the loop."""

    def _combine(chunk_parts: List[runtime_pb2.Tensor]) -> torch.Tensor:
        combined = _clone_tensor_metadata(chunk_parts[0])
        combined.buffer = b"".join(p.buffer for p in chunk_parts)
        return deserialize_tensor(combined)

    tensors: List[torch.Tensor] = []
    parts: List[runtime_pb2.Tensor] = []
    async for chunk_batch in stream:
        for chunk in chunk_batch:
            parts.append(chunk)
            if len(parts) == (parts[0].chunks or 1):
                tensors.append(await run_in_executor(_combine, parts) if off_loop else _combine(parts))
                parts = []
    if parts:
        raise ValueError(f"stream ended mid-tensor: got {len(parts)}/{parts[0].chunks} chunks")
    return tensors


def split_tensor_for_streaming(serialized: runtime_pb2.Tensor, chunk_size_bytes: int) -> List[runtime_pb2.Tensor]:
    """Split one serialized tensor into wire-sized chunk messages (the inverse of
    ``deserialize_tensor_stream``'s reassembly)."""
    buffers = list(split_for_streaming(serialized.buffer, chunk_size_bytes))
    first = _clone_tensor_metadata(serialized)
    first.buffer = buffers[0]
    first.chunks = len(buffers)
    return [first] + [runtime_pb2.Tensor(buffer=extra) for extra in buffers[1:]]


# ------------------------------------------------------------------ wire splicers
#
# Concatenating encoded fields in field-number order is what SerializeToString
# emits, so a Tensor is framed as [buffer-field header][the buffer itself]
# [metadata fields], with the buffer as its own scatter-gather part. The tags
# follow proto/runtime.proto.

_TENSOR_BUFFER_TAG = b"\x0a"  # Tensor.buffer = 1, wire type 2
_REQUEST_UID_TAG = b"\x0a"  # ExpertRequest.uid = 1
_REQUEST_TENSOR_TAG = b"\x12"  # ExpertRequest.tensors = 2
_REQUEST_METADATA_TAG = b"\x1a"  # ExpertRequest.metadata = 3
_RESPONSE_TENSOR_TAG = b"\x0a"  # ExpertResponse.tensors = 1
_RESPONSE_METADATA_TAG = b"\x12"  # ExpertResponse.metadata = 2


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tensor_field_parts(serialized: runtime_pb2.Tensor, field_tag: bytes) -> List[bytes]:
    """One Tensor as a length-delimited field of an outer message, its buffer a
    part of its own."""
    buffer = serialized.buffer
    meta = _clone_tensor_metadata(serialized)
    meta.chunks = serialized.chunks
    meta_bytes = meta.SerializeToString()
    # the buffer (field 1) precedes the metadata fields (2..6), as protobuf emits them
    inner = [_TENSOR_BUFFER_TAG + _varint(len(buffer)), buffer, meta_bytes] if buffer else [meta_bytes]
    return [field_tag + _varint(sum(len(part) for part in inner)), *inner]


def expert_request_parts(uid: str, tensors: Sequence[runtime_pb2.Tensor], metadata: bytes = b"") -> WireParts:
    """``ExpertRequest(uid=, tensors=, metadata=)`` as scatter-gather parts."""
    parts: List[Any] = []
    if uid:
        uid_bytes = uid.encode("utf-8")
        parts.append(_REQUEST_UID_TAG + _varint(len(uid_bytes)) + uid_bytes)
    for tensor in tensors:
        parts.extend(_tensor_field_parts(tensor, _REQUEST_TENSOR_TAG))
    if metadata:
        parts.append(_REQUEST_METADATA_TAG + _varint(len(metadata)) + metadata)
    return WireParts(*parts)


def expert_response_parts(tensors: Sequence[runtime_pb2.Tensor], metadata: bytes = b"") -> WireParts:
    """``ExpertResponse(tensors=, metadata=)`` as scatter-gather parts."""
    parts: List[Any] = []
    for tensor in tensors:
        parts.extend(_tensor_field_parts(tensor, _RESPONSE_TENSOR_TAG))
    if metadata:
        parts.append(_RESPONSE_METADATA_TAG + _varint(len(metadata)) + metadata)
    return WireParts(*parts)


def split_response_for_wire(serialized: runtime_pb2.Tensor, chunk_size_bytes: int) -> List[WireParts]:
    """One serialized tensor as a list of ``ExpertResponse`` stream-chunk frames
    (the wire-parts form of ``split_tensor_for_streaming``): the buffer is sliced
    as memoryviews, never copied chunk by chunk."""
    view = memoryview(serialized.buffer)
    total_chunks = max(1, -(-len(view) // chunk_size_bytes)) if len(view) else 1
    first = _clone_tensor_metadata(serialized)
    first.chunks = total_chunks
    meta_bytes = first.SerializeToString()
    out: List[WireParts] = []
    for index in range(total_chunks):
        chunk = view[index * chunk_size_bytes : (index + 1) * chunk_size_bytes]
        inner: List[Any] = []
        if len(chunk):
            inner.extend([_TENSOR_BUFFER_TAG + _varint(len(chunk)), chunk])
        if index == 0:
            inner.append(meta_bytes)
        out.append(WireParts(_RESPONSE_TENSOR_TAG + _varint(sum(len(part) for part in inner)), *inner))
    return out
