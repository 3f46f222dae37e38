"""Error-feedback residual state for the quantized averaging wire (the port of
hivemind_tpu/averaging/residual.py).

When a link's wire codec is lossy (8-bit tiers), each quantization discards
``x − dequantize(quantize(x))``. Left uncompensated, those errors random-walk
into the model across rounds. Error feedback fixes this by carrying the
discarded remainder forward: round N's quantization error is added back to the
value *before* quantizing round N+1, so the time-average of what crosses the
wire is unbiased (the classic EF-SGD argument).

A :class:`ResidualStore` lives on the AVERAGER (not the per-round runner) and
holds one fp32 plane per wire leg, indexed by **global offset in the logical
concatenated tensor stream**:

- ``"send"`` — the reduce-scatter leg: the quantization error of each part this
  peer ships to its reducers. Every element is shipped to exactly one reducer
  per round, so one full-size plane covers the leg no matter how the group (and
  therefore the partition) is composed.
- ``"reduce"`` — the all-gather leg: this peer, as a reducer, quantizes each
  averaged part ONCE (the same bytes go to every lossy-tier sender — see
  ``absolute_part`` in averaging.proto) and keeps the quantization error of the
  average, again by global offset.

Because planes are offset-indexed, residual state **survives group-composition
changes**: a different partition next round still lines up element-for-element.
Planes are allocated lazily on first lossy use (a lossless swarm pays nothing)
and ``ensure(total_elements)`` resets them when the tensor schema changes — the
"reset on group change" rule: residuals from a different schema are garbage.
Memory is O(total_elements) per plane and **independent of the number of
peers** (no per-peer buffers to leak when a peer departs).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from hivemind_tpu_torch.compression import CompressionBase
from hivemind_tpu_torch.proto import runtime_pb2

PLANES = ("send", "reduce")


class ResidualStore:
    """Per-averager error-feedback residual planes (see module docstring).

    Thread-safe: parts are compressed concurrently in the shared executor, but
    each part touches a disjoint global span, so only plane *allocation* needs
    the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._planes: Dict[str, np.ndarray] = {}
        self._total_elements: Optional[int] = None

    def ensure(self, total_elements: int) -> None:
        """Pin the stream size; a CHANGED size (new tensor schema / partition
        universe) discards all residual state — stale offsets would compensate
        the wrong elements."""
        with self._lock:
            if self._total_elements != total_elements:
                self._planes.clear()
                self._total_elements = int(total_elements)

    def view(self, plane: str, start: int, stop: int) -> np.ndarray:
        """A writable fp32 view of ``plane`` over global span [start, stop),
        allocating the plane (zeros) on first use."""
        assert plane in PLANES, f"unknown residual plane {plane!r}"
        with self._lock:
            buffer = self._planes.get(plane)
            if buffer is None:
                assert self._total_elements is not None, "call ensure() before view()"
                buffer = np.zeros(self._total_elements, np.float32)
                self._planes[plane] = buffer
        return buffer[start:stop]

    def reset(self) -> None:
        """Drop all residual state (e.g. after adopting state from peers: the
        new tensors owe nothing to our old quantization errors)."""
        with self._lock:
            self._planes.clear()

    def footprint_bytes(self) -> int:
        with self._lock:
            return sum(buffer.nbytes for buffer in self._planes.values())


def compress_with_feedback(
    part32: np.ndarray, codec: CompressionBase, residual: np.ndarray
) -> runtime_pb2.Tensor:
    """Quantize ``part32 + residual`` and fold the new quantization error back
    into ``residual`` (both legs use this; ``part32`` is never mutated).

    The residual buffer doubles as the compensated staging area, so the only
    allocations are the codec's own outputs:

        residual += part            # residual now holds the compensated value
        wire      = quantize(residual)
        residual -= dequantize(wire)  # what the wire discarded this round
    """
    assert residual.shape == part32.reshape(-1).shape, (residual.shape, part32.shape)
    flat32 = part32.reshape(-1).astype(np.float32, copy=False)
    np.add(residual, flat32, out=residual)
    try:
        serialized = codec.compress(residual)  # must not mutate its input (no allow_inplace)
        decoded = codec.extract(serialized).numpy().reshape(-1).astype(np.float32, copy=False)
    except BaseException:
        # the residual doubles as staging: a codec failure mid-flight must not
        # leave the whole part folded into EF state as phantom "error" (the
        # next round would ship a ~2x-magnitude span) — roll the staging back
        np.subtract(residual, flat32, out=residual)
        raise
    np.subtract(residual, decoded, out=residual)
    return serialized
