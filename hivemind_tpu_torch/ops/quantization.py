"""Plain PyTorch blockwise absmax int8 quantization (the port of
hivemind_tpu/ops/quantization.py:18-42). These are the plain versions of the
``csrc/blockwise_int8.cu`` kernels: the CPU path of their wrappers and the
reference the kernels are held to, bit for bit.

Bit-identity notes: both divisions are tensor-by-tensor on purpose. PyTorch turns
``scalar / tensor`` into ``reciprocal(tensor) * scalar`` and, on CUDA, a division
by a Python scalar into a multiplication by its reciprocal; either rounds
differently from the IEEE division that jnp and the kernels perform.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCKWISE_BLOCK_SIZE = 4096  # parity with the reference's bitsandbytes blocksize


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
