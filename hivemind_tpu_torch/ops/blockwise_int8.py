"""Blockwise absmax int8 quantize/dequantize: wrappers of the Hopper kernels in
``csrc/blockwise_int8.cu`` (the port of hivemind_tpu/ops/pallas_quantization.py).

A wrapper given a CPU tensor runs the plain PyTorch version
(``ops/quantization.py``); given a CUDA tensor it launches its kernel or raises —
there is no fallback. ``launches`` on each wrapper counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.ops.quantization import (
    BLOCKWISE_BLOCK_SIZE,
    blockwise_dequantize as blockwise_dequantize_plain,
    blockwise_quantize as blockwise_quantize_plain,
)

__all__ = [
    "blockwise_int8_quantize", "blockwise_int8_dequantize",
    "blockwise_quantize_plain", "blockwise_dequantize_plain",
]


def _library() -> ctypes.CDLL:
    library = _build.load_library("blockwise_int8")
    if library.hm_blockwise_quantize.argtypes is None:
        pointers = [ctypes.c_void_p] * 3
        library.hm_blockwise_quantize.argtypes = [*pointers, ctypes.c_longlong, ctypes.c_void_p]
        library.hm_blockwise_dequantize.argtypes = [*pointers, ctypes.c_longlong, ctypes.c_void_p]
        library.hm_blockwise_quantize.restype = ctypes.c_int
        library.hm_blockwise_dequantize.restype = ctypes.c_int
    return library


def _check_cuda_input(tensor: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA or CPU tensor, got {tensor.device}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tensor.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector accesses")


def blockwise_int8_quantize(flat: torch.Tensor, block_size: int = BLOCKWISE_BLOCK_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization of a flat fp32 tensor padded to a multiple
    of ``block_size`` (the caller pads, as ``quantize_params`` does).

    :returns: (int8 codes [n_blocks, block_size], fp32 absmax [n_blocks])
    """
    if flat.dim() != 1 or flat.numel() % block_size:
        raise ValueError(f"expected a flat tensor padded to a multiple of {block_size}, got {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return blockwise_quantize_plain(flat, block_size)
    if block_size != BLOCKWISE_BLOCK_SIZE:
        raise ValueError(f"the kernel takes block_size={BLOCKWISE_BLOCK_SIZE} only, got {block_size}")
    _check_cuda_input(flat, torch.float32, "flat")
    n_blocks = flat.numel() // block_size
    if n_blocks >= 2**31:
        raise ValueError(f"{n_blocks} blocks exceed the kernel's grid")
    codes = torch.empty((n_blocks, block_size), dtype=torch.int8, device=flat.device)
    absmax = torch.empty((n_blocks,), dtype=torch.float32, device=flat.device)
    library = _library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = library.hm_blockwise_quantize(flat.data_ptr(), codes.data_ptr(), absmax.data_ptr(), n_blocks, stream)
    _build.check_launch(library, status, "blockwise_int8_quantize")
    blockwise_int8_quantize.launches += 1
    return codes, absmax


def blockwise_int8_dequantize(codes: torch.Tensor, absmax: torch.Tensor, block_size: int = BLOCKWISE_BLOCK_SIZE) -> torch.Tensor:
    """Inverse of :func:`blockwise_int8_quantize`: fp32 ``[n_blocks * block_size]``."""
    if codes.dim() != 2 or codes.shape[1] != block_size or absmax.shape != (codes.shape[0],):
        raise ValueError(
            f"expected codes [n, {block_size}] and absmax [n], got {tuple(codes.shape)} and {tuple(absmax.shape)}"
        )
    if codes.device != absmax.device:
        raise ValueError(f"codes on {codes.device} but absmax on {absmax.device}")
    if codes.device.type == "cpu":
        return blockwise_dequantize_plain(codes, absmax, block_size)
    if block_size != BLOCKWISE_BLOCK_SIZE:
        raise ValueError(f"the kernel takes block_size={BLOCKWISE_BLOCK_SIZE} only, got {block_size}")
    _check_cuda_input(codes, torch.int8, "codes")
    _check_cuda_input(absmax, torch.float32, "absmax")
    n_blocks = codes.shape[0]
    if n_blocks >= 2**31:
        raise ValueError(f"{n_blocks} blocks exceed the kernel's grid")
    out = torch.empty((n_blocks * block_size,), dtype=torch.float32, device=codes.device)
    library = _library()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        status = library.hm_blockwise_dequantize(codes.data_ptr(), absmax.data_ptr(), out.data_ptr(), n_blocks, stream)
    _build.check_launch(library, status, "blockwise_int8_dequantize")
    blockwise_int8_dequantize.launches += 1
    return out


blockwise_int8_quantize.launches = 0
blockwise_int8_dequantize.launches = 0
