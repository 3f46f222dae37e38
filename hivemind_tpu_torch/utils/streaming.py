"""Split serialized tensors into stream-sized chunks and combine them back, and
the scatter-gather container of one wire message (the port's copy of
hivemind_tpu/utils/streaming.py)."""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple, Union

STREAMING_CHUNK_SIZE_BYTES = 2**16

Buffer = Union[bytes, bytearray, memoryview]


class WireParts:
    """One wire message as a list of buffers whose concatenation IS the serialized
    protobuf: a multi-MB tensor buffer rides as its own buffer instead of being
    copied into one ``SerializeToString`` blob. The receive side parses the joined
    frame with the generated classes, as usual."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Buffer):
        self.parts: Tuple[Buffer, ...] = tuple(p for p in parts if len(p))

    @property
    def nbytes(self) -> int:
        return sum(len(part) for part in self.parts)

    def join(self) -> bytes:
        """The message as one bytes object (for senders that cannot scatter-gather)."""
        return b"".join(bytes(part) if not isinstance(part, bytes) else part for part in self.parts)

    def __len__(self) -> int:
        return self.nbytes


def split_for_streaming(data: bytes, chunk_size_bytes: int = STREAMING_CHUNK_SIZE_BYTES) -> Iterator[bytes]:
    """Split a byte string into chunks of at most chunk_size_bytes. Always yields at
    least one (possibly empty) chunk."""
    if not data:
        yield b""
        return
    for offset in range(0, len(data), chunk_size_bytes):
        yield data[offset : offset + chunk_size_bytes]


def combine_from_streaming(chunks: Iterable[bytes]) -> bytes:
    return b"".join(chunks)
