"""Quantization math (the port of hivemind_tpu/ops/quantization.py).

- Plain PyTorch blockwise absmax int8 (``blockwise_quantize``/``blockwise_dequantize``):
  the plain versions of the ``csrc/blockwise_int8.cu`` kernels, the CPU path of
  their wrappers and the reference the kernels are held to, bit for bit.
- The host codec helpers of the wire layer (``compression/quantization.py``):
  numpy, as in the JAX package, so the wire bytes are the same on both sides.

Bit-identity notes: both divisions are tensor-by-tensor on purpose. PyTorch turns
``scalar / tensor`` into ``reciprocal(tensor) * scalar`` and, on CUDA, a division
by a Python scalar into a multiplication by its reciprocal; either rounds
differently from the IEEE division that jnp and the kernels perform.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCKWISE_BLOCK_SIZE = 4096  # parity with the reference's bitsandbytes blocksize
UNIFORM_NUM_BUCKETS = 256
UNIFORM_RANGE_IN_SIGMAS = 6.0
QUANTILE_SAMPLE_SIZE = 1 << 20  # codebook estimation sample for large tensors


def blockwise_quantize(flat: torch.Tensor, block_size: int = BLOCKWISE_BLOCK_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization of a flat fp32 tensor whose size is a
    multiple of ``block_size``.

    :returns: (int8 codes [n_blocks, block_size], fp32 absmax [n_blocks])
    """
    blocks = flat.to(torch.float32).reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax, torch.zeros_like(absmax))
    # torch.round rounds half to even, as jnp.round and the kernel's rintf do
    codes = torch.clamp(torch.round(blocks * scale[:, None]), -127, 127).to(torch.int8)
    return codes, absmax


def blockwise_dequantize(codes: torch.Tensor, absmax: torch.Tensor, block_size: int = BLOCKWISE_BLOCK_SIZE) -> torch.Tensor:
    """Inverse of :func:`blockwise_quantize`: fp32 ``[n_blocks * block_size]``."""
    scale = absmax / torch.full_like(absmax, 127.0)
    return (codes.to(torch.float32) * scale[:, None]).reshape(-1)


def blockwise_dequantize_window(codes: torch.Tensor, absmax: torch.Tensor, row_stride: int, base: int,
                                block_size: int = BLOCKWISE_BLOCK_SIZE) -> torch.Tensor:
    """:func:`blockwise_dequantize` of a window of a tensor's flat codes: ``codes``
    ``[rows, cols]`` holds flat elements ``base + i * row_stride + j``, and ``absmax``
    is the whole tensor's. Returns fp32 ``[rows, cols]``, bit for bit what the whole
    tensor's dequantize holds there."""
    rows, cols = codes.shape
    flat = (base + torch.arange(rows, device=codes.device)[:, None] * row_stride
            + torch.arange(cols, device=codes.device)[None, :])
    scale = absmax / torch.full_like(absmax, 127.0)
    return codes.to(torch.float32) * scale[flat // block_size]


# ------------------------------------------------------------------ host codec helpers


def hash_sample_indices(size: int, count: int) -> np.ndarray:
    """``count`` layout-independent sample indices into a flat array of ``size`` by
    a multiplicative hash (Knuth's 2654435761): unlike strided sampling, they share
    no period with any channel layout. The one sampler of every host codec
    statistic, so the wire bytes stay reproducible."""
    indices = (np.arange(count, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(size)
    return indices.astype(np.int64, copy=False)


def quantile_quantize(flat) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile 8-bit quantization: the codebook is the 256 empirical quantiles,
    estimated from a hash-sampled 2^20-element subset past that size, in numpy.

    :returns: (uint8 codes, fp32 codebook [256])
    """
    flat32 = np.asarray(flat, dtype=np.float32).reshape(-1)
    if flat32.size == 0:
        return np.zeros(0, np.uint8), np.zeros(UNIFORM_NUM_BUCKETS, np.float32)
    if flat32.size > QUANTILE_SAMPLE_SIZE:
        sample = np.sort(flat32[hash_sample_indices(flat32.size, QUANTILE_SAMPLE_SIZE)])
    else:
        sample = np.sort(flat32)
    # evenly spaced order statistics of the sorted sample = empirical quantiles
    positions = np.linspace(0.5 / UNIFORM_NUM_BUCKETS, 1 - 0.5 / UNIFORM_NUM_BUCKETS, UNIFORM_NUM_BUCKETS) * (sample.size - 1)
    codebook = sample[np.round(positions).astype(np.int64)].astype(np.float32)
    edges = (codebook[1:] + codebook[:-1]) / 2
    return _encode_against_edges(flat32, edges), codebook


_ENCODE_GRID = 1 << 16


def _encode_against_edges(flat32: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """``np.searchsorted(edges, flat32)`` as uint8, bit for bit, faster: a uniform
    grid's lookup table resolves every element whose grid bin lies wholly inside
    one bucket, and only elements in bins that straddle an edge are searched."""
    # float64 grid arithmetic keeps each element's bin consistent with the grid
    # boundaries for any float32 data
    lo, hi = float(edges[0]), float(edges[-1])
    span = hi - lo
    if not span > 0:  # a constant tensor: no grid to build
        return np.searchsorted(edges, flat32).astype(np.uint8)
    scale = (_ENCODE_GRID - 2) / span
    grid_starts = lo + np.arange(_ENCODE_GRID + 1, dtype=np.float64) / scale
    lut = np.searchsorted(edges, grid_starts).astype(np.uint8)
    safe = lut[:-1] == lut[1:]
    bins = np.clip(((flat32.astype(np.float64) - lo) * scale).astype(np.int64), 0, _ENCODE_GRID - 1)
    codes = lut[bins]
    unsafe = ~safe[bins]
    codes[unsafe] = np.searchsorted(edges, flat32[unsafe]).astype(np.uint8)
    return codes


def dequantize_with_codebook(codes: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Host-side lookup decode."""
    return codebook[codes.astype(np.int64)]


def pad_to_block(flat: np.ndarray, block_size: int = BLOCKWISE_BLOCK_SIZE) -> tuple:
    """Pad a flat array to a multiple of block_size; returns (padded, original_size)."""
    remainder = flat.size % block_size
    if remainder == 0:
        return flat, flat.size
    padded = np.concatenate([flat, np.zeros(block_size - remainder, dtype=flat.dtype)])
    return padded, flat.size
