"""8-bit quantization codecs (the port of hivemind_tpu/compression/quantization.py):
uniform (6σ buckets with a bucket-mean codebook), quantile (256 empirical
quantiles) and blockwise absmax int8 per 4096 elements. Plain numpy on the host,
the same formulas and the same fp32 operation order as the JAX package's wire
path, so the two write the same bytes."""

from __future__ import annotations

import struct
from typing import Any, Optional, Tuple

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
from hivemind_tpu_torch.ops.quantization import (
    BLOCKWISE_BLOCK_SIZE,
    UNIFORM_NUM_BUCKETS,
    UNIFORM_RANGE_IN_SIGMAS,
    hash_sample_indices,
    pad_to_block,
    quantile_quantize,
)
from hivemind_tpu_torch.proto import runtime_pb2

# statistics (mean/std and the bucket-mean codebook) come from a bounded hash
# sample past this size, the quantile codec's sampler
_STATS_SAMPLE = 1 << 17


def _stats_indices(size: int) -> Optional[np.ndarray]:
    """Hash-sample indices for codebook statistics, or None (use everything)."""
    if size <= _STATS_SAMPLE:
        return None
    return hash_sample_indices(size, _STATS_SAMPLE)


def _uniform_quantize_np(flat32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform 8-bit quantization over [mean − 6σ, mean + 6σ] with a bucket-mean
    codebook (midpoints for empty buckets). The input is never written."""
    if flat32.size == 0:
        return np.zeros(0, np.uint8), np.zeros(UNIFORM_NUM_BUCKETS, np.float32)
    indices = _stats_indices(flat32.size)
    sample = flat32 if indices is None else flat32[indices]
    mean = float(np.mean(sample))
    std = float(np.std(sample)) + 1e-11
    lo = mean - UNIFORM_RANGE_IN_SIGMAS * std
    hi = mean + UNIFORM_RANGE_IN_SIGMAS * std
    scale = (UNIFORM_NUM_BUCKETS - 1) / (hi - lo)
    scaled = (flat32 - np.float32(lo)) * np.float32(scale)
    codes = np.clip(np.rint(scaled), 0, UNIFORM_NUM_BUCKETS - 1).astype(np.uint8)
    sample_codes = codes if indices is None else codes[indices]
    sums = np.bincount(sample_codes, weights=sample, minlength=UNIFORM_NUM_BUCKETS)
    counts = np.bincount(sample_codes, minlength=UNIFORM_NUM_BUCKETS)
    midpoints = lo + (np.arange(UNIFORM_NUM_BUCKETS, dtype=np.float64) + 0.5) / scale
    codebook = np.where(counts > 0, sums / np.maximum(counts, 1), midpoints)
    return codes, codebook.astype(np.float32, copy=False)


def _blockwise_quantize_np(padded32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-4096-block absmax int8, in numpy (the kernels' formula); the input is
    never written."""
    blocks = padded32.reshape(-1, BLOCKWISE_BLOCK_SIZE)
    absmax = np.maximum(blocks.max(axis=1), -blocks.min(axis=1))
    scale = np.where(absmax > 0, 127.0 / absmax, 0.0).astype(np.float32, copy=False)
    codes = np.clip(np.rint(blocks * scale[:, None]), -127, 127).astype(np.int8)
    return codes, absmax.astype(np.float32, copy=False)


def _flat_float32(tensor: Any) -> np.ndarray:
    return np.ascontiguousarray(as_float32(tensor)).reshape(-1)


class _CodebookQuantization(CompressionBase):
    """Shared wire format: [u32 codebook_size][fp32 codebook][u8 codes]."""

    is_lossy = True

    def _quantize(self, flat32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        codes, codebook = self._quantize(_flat_float32(tensor))
        codes = np.asarray(codes, dtype=np.uint8)
        codebook = np.asarray(codebook, dtype=np.float32)
        buffer = struct.pack("<I", codebook.size) + codebook.tobytes() + codes.tobytes()
        return runtime_pb2.Tensor(buffer=buffer, size=tensor.shape, dtype=dtype_name(tensor),
                                  compression=self.compression_type)

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        (codebook_size,) = struct.unpack_from("<I", serialized.buffer)
        codebook = np.frombuffer(serialized.buffer, dtype=np.float32, count=codebook_size, offset=4)
        codes = np.frombuffer(serialized.buffer, dtype=np.uint8, offset=4 + codebook_size * 4)
        return from_float32(codebook[codes.astype(np.int64, copy=False)], serialized.dtype or "float32", serialized.size)

    def estimate_compression_ratio(self, info: CompressionInfo) -> float:
        return 8.0 / (8 * (info.descriptor.itemsize if info.descriptor else 4))


class Uniform8BitQuantization(_CodebookQuantization):
    compression_type = CompressionType.UNIFORM_8BIT

    def _quantize(self, flat32):
        return _uniform_quantize_np(flat32)


class Quantile8BitQuantization(_CodebookQuantization):
    """Codebook = 256 empirical quantiles, from a hash-sampled subset past 2^20
    elements (``ops.quantization.quantile_quantize``)."""

    compression_type = CompressionType.QUANTILE_8BIT

    def _quantize(self, flat32):
        return quantile_quantize(flat32)


class BlockwiseQuantization(CompressionBase):
    """Per-4096-block absmax int8. Wire format: [u32 n_blocks][u32 true_size]
    [fp32 absmax per block][i8 codes]."""

    compression_type = CompressionType.BLOCKWISE_8BIT
    is_lossy = True

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        padded, true_size = pad_to_block(_flat_float32(tensor))
        codes, absmax = _blockwise_quantize_np(padded)
        buffer = struct.pack("<II", absmax.size, true_size) + absmax.tobytes() + codes.tobytes()
        return runtime_pb2.Tensor(buffer=buffer, size=tensor.shape, dtype=dtype_name(tensor),
                                  compression=self.compression_type)

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        n_blocks, true_size = struct.unpack_from("<II", serialized.buffer)
        absmax = np.frombuffer(serialized.buffer, dtype=np.float32, count=n_blocks, offset=8)
        codes = np.frombuffer(serialized.buffer, dtype=np.int8, offset=8 + n_blocks * 4)
        if n_blocks == 0:  # a zero-element tensor: reshape(0, -1) would raise
            restored = np.zeros(0, np.float32)
        else:
            restored = codes.astype(np.float32).reshape(n_blocks, -1) * (absmax / np.float32(127.0))[:, None]
            restored = restored.reshape(-1)[:true_size]
        return from_float32(restored, serialized.dtype or "float32", serialized.size)

    def estimate_compression_ratio(self, info: CompressionInfo) -> float:
        return 8.25 / (8 * (info.descriptor.itemsize if info.descriptor else 4))
