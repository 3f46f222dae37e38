"""Int8 weight-only parameter storage for serving (the port of
hivemind_tpu/ops/quantized_params.py).

A parameter dict (``name -> tensor``, as ``nn.Module.state_dict`` gives it) is
converted entry by entry: float tensors with ``ndim >= 2`` and at least
``MIN_QUANT_SIZE`` elements become :class:`QuantizedTensor` (int8 codes + one fp32
absmax per 4096-element block, kept on the tensor's device: ~4x smaller resident
than fp32); norm scales and biases stay exact. ``dequantize_tree`` runs inside
every forward, so only the int8 form stays resident and dense fp32 weights exist
transiently during a call.

Code order: a 2-D weight is an ``nn.Linear`` weight ``[out, in]`` here and a flax
Dense kernel ``[in, out]`` in the JAX package, so 2-D tensors are encoded in
transposed (``[in, out]``) order. Both packages then cut the same 4096-element
blocks from one checkpoint and hold bit-identical int8 codes and absmax; the
dequantized weight comes back as a transposed view, which ``F.linear`` takes
without a copy.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from hivemind_tpu_torch.ops.blockwise_int8 import blockwise_int8_dequantize, blockwise_int8_quantize
from hivemind_tpu_torch.ops.quantization import BLOCKWISE_BLOCK_SIZE

QUANT_BLOCK_SIZE = BLOCKWISE_BLOCK_SIZE
MIN_QUANT_SIZE = 4096  # tensors smaller than one block stay exact


class QuantizedTensor:
    """Blockwise-int8 weight: ``codes`` [n_blocks, block] int8 + ``absmax``
    [n_blocks] fp32, remembering the original shape/dtype/true size and whether
    the codes hold the tensor's transpose (2-D weights, see module docstring)."""

    def __init__(self, codes: torch.Tensor, absmax: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype,
                 size: int, transposed: bool = False):
        self.codes, self.absmax = codes, absmax
        self.shape, self.dtype, self.size = tuple(shape), dtype, size
        self.transposed = transposed

    @property
    def nbytes(self) -> int:
        return self.codes.numel() * self.codes.element_size() + self.absmax.numel() * self.absmax.element_size()

    def dequantize(self) -> torch.Tensor:
        flat = blockwise_int8_dequantize(self.codes, self.absmax, QUANT_BLOCK_SIZE)[: self.size]
        if self.transposed:
            return flat.reshape(self.shape[::-1]).T.to(self.dtype)
        return flat.reshape(self.shape).to(self.dtype)

    def __repr__(self):
        return f"QuantizedTensor(shape={self.shape}, blocks={self.codes.shape[0]}, device={self.codes.device})"


ParamDict = Dict[str, Union[torch.Tensor, QuantizedTensor]]


def quantize_params(params: Dict[str, torch.Tensor], min_size: int = MIN_QUANT_SIZE) -> ParamDict:
    """Float tensors with ``ndim >= 2`` and ``>= min_size`` elements become
    QuantizedTensor, on the device they lie on."""

    def convert(tensor: torch.Tensor):
        # only float MATRICES quantize: 1-D tensors are norm scales/biases whose
        # exactness matters far more than their bytes (a 4096-wide RMSNorm scale
        # has size == one quant block, so a pure size test would catch it)
        if tensor.dim() < 2 or tensor.numel() < min_size or not tensor.is_floating_point():
            return tensor
        transposed = tensor.dim() == 2
        ordered = tensor.detach().T if transposed else tensor.detach()
        flat = ordered.to(torch.float32).contiguous().reshape(-1)
        pad = (-flat.numel()) % QUANT_BLOCK_SIZE
        if pad:
            flat = F.pad(flat, (0, pad))
        codes, absmax = blockwise_int8_quantize(flat.contiguous(), QUANT_BLOCK_SIZE)
        return QuantizedTensor(codes, absmax, tensor.shape, tensor.dtype, tensor.numel(), transposed)

    return {name: convert(tensor) for name, tensor in params.items()}


def dequantize_tree(params: ParamDict) -> Dict[str, torch.Tensor]:
    """Materialize a quantized dict back to dense tensors (call inside the forward)."""
    return {
        name: value.dequantize() if isinstance(value, QuantizedTensor) else value
        for name, value in params.items()
    }


def tree_param_bytes(params: ParamDict) -> int:
    """Resident bytes of a (possibly quantized) parameter dict."""
    total = 0
    for value in params.values():
        if isinstance(value, QuantizedTensor):
            total += value.nbytes
        else:
            total += value.numel() * value.element_size()
    return total
