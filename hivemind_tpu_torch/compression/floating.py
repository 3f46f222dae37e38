"""Float16 codecs (the port of hivemind_tpu/compression/floating.py)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from hivemind_tpu_torch.compression.base import (
    CompressionBase,
    CompressionInfo,
    CompressionType,
    as_float32,
    dtype_name,
    from_float32,
)
from hivemind_tpu_torch.proto import runtime_pb2

FP16_MAX = 65504.0


class Float16Compression(CompressionBase):
    """Clamp to the fp16 range and cast."""

    compression_type = CompressionType.FLOAT16
    is_lossy = True

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        clipped32 = np.clip(as_float32(tensor), -FP16_MAX, FP16_MAX)
        return runtime_pb2.Tensor(
            buffer=clipped32.astype(np.float16).tobytes(),
            size=tensor.shape,
            dtype=dtype_name(tensor),
            compression=self.compression_type,
        )

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        half = np.frombuffer(serialized.buffer, dtype=np.float16)
        return from_float32(half.astype(np.float32), serialized.dtype or "float32", serialized.size)

    def estimate_compression_ratio(self, info: CompressionInfo) -> float:
        return 16.0 / (8 * (info.descriptor.itemsize if info.descriptor else 4))


class ScaledFloat16Compression(Float16Compression):
    """Normalize per last axis by mean/std, cast to fp16, and ship the fp32 stats
    alongside (MEANSTD_16BIT)."""

    compression_type = CompressionType.MEANSTD_16BIT

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        array32 = as_float32(tensor)
        if array32.ndim == 0:
            array32 = array32.reshape(1)
            means = np.zeros(1, np.float32)
            stds = np.ones(1, np.float32)
            normalized = array32
        else:
            means = array32.mean(axis=-1, keepdims=True, dtype=np.float32)
            stds = array32.std(axis=-1, keepdims=True, dtype=np.float32) + 1e-6
            normalized = (array32 - means) / stds
        half = np.clip(normalized, -FP16_MAX, FP16_MAX).astype(np.float16)
        buffer = half.tobytes() + means.astype(np.float32).tobytes() + stds.astype(np.float32).tobytes()
        return runtime_pb2.Tensor(buffer=buffer, size=tensor.shape, dtype=dtype_name(tensor),
                                  compression=self.compression_type)

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        shape = tuple(serialized.size)
        numel = int(np.prod(shape)) if shape else 1
        stats_shape = (*shape[:-1], 1) if shape else (1,)
        stats_count = int(np.prod(stats_shape))
        half_bytes = numel * 2
        half = np.frombuffer(serialized.buffer, dtype=np.float16, count=numel)
        means = np.frombuffer(serialized.buffer, dtype=np.float32, count=stats_count, offset=half_bytes)
        stds = np.frombuffer(serialized.buffer, dtype=np.float32, count=stats_count, offset=half_bytes + stats_count * 4)
        restored = half.astype(np.float32).reshape(shape or (1,))
        restored = restored * stds.reshape(stats_shape) + means.reshape(stats_shape)
        return from_float32(restored, serialized.dtype or "float32", shape)
