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

A shard of a tensor-parallel serving mesh holds a :class:`QuantizedWindow`: the
rows or columns of one quantized 2-D weight that the shard computes with, cut from
the whole tensor's codes, beside the whole tensor's absmax. Its codes are the same
bytes, so a mesh and a single device serve the same int8 weights.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from hivemind_tpu_torch.ops.blockwise_int8 import (
    blockwise_int8_dequantize,
    blockwise_int8_dequantize_window,
    blockwise_int8_quantize,
)
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


class QuantizedWindow:
    """A shard of a 2-D :class:`QuantizedTensor`: ``codes`` ``[rows, cols]`` int8 are
    the flax-ordered (``[in, out]``) codes of input rows ``[r0, r0 + rows)`` and output
    columns ``[c0, c0 + cols)``, and ``absmax`` is the whole tensor's, as the JAX
    package replicates a 1-D leaf. ``base = r0 * out + c0`` and ``row_stride = out``
    place the window in the whole tensor's flat codes. ``dequantize`` gives the
    shard's weight ``[cols, rows]`` (``nn.Linear`` layout, a transposed view)."""

    def __init__(self, codes: torch.Tensor, absmax: torch.Tensor, row_stride: int, base: int, dtype: torch.dtype):
        self.codes, self.absmax = codes, absmax
        self.row_stride, self.base, self.dtype = row_stride, base, dtype
        self.shape = (codes.shape[1], codes.shape[0])

    @property
    def nbytes(self) -> int:
        return self.codes.numel() * self.codes.element_size() + self.absmax.numel() * self.absmax.element_size()

    def _whole_blocks(self) -> bool:
        """Whole rows that start a block and fill whole blocks (a row-parallel shard at
        Llama widths), with a 16-byte aligned absmax slice: the blockwise kernel's input.
        On such shards the blockwise kernel beats the window entry on an H100 (chip_smoke's
        ``[mesh_serving]`` times both on ffn_down's and attention_out's row shards)."""
        rows, cols = self.codes.shape
        return (cols == self.row_stride and self.base % QUANT_BLOCK_SIZE == 0
                and (rows * cols) % QUANT_BLOCK_SIZE == 0 and (self.base // QUANT_BLOCK_SIZE) % 4 == 0)

    def dequantize(self) -> torch.Tensor:
        rows, cols = self.codes.shape
        if self._whole_blocks():
            first = self.base // QUANT_BLOCK_SIZE
            blocks = self.codes.reshape(-1, QUANT_BLOCK_SIZE)
            flat = blockwise_int8_dequantize(blocks, self.absmax[first : first + blocks.shape[0]], QUANT_BLOCK_SIZE)
            window = flat.reshape(rows, cols)
        else:
            window = blockwise_int8_dequantize_window(self.codes, self.absmax, self.row_stride, self.base,
                                                      QUANT_BLOCK_SIZE)
        return window.T.to(self.dtype)

    def __repr__(self):
        return f"QuantizedWindow(shape={self.shape}, base={self.base}, device={self.codes.device})"


def cut_window(tensor: QuantizedTensor, dim: int, start: int, stop: int, device) -> QuantizedWindow:
    """The ``[start, stop)`` range along ``dim`` of a quantized ``nn.Linear`` weight
    ``[out, in]`` (0: output features, the flax columns; 1: input features, the flax
    rows), copied to ``device`` with the whole tensor's absmax. A serving mesh cuts
    uneven ranges, and overlapping ones where two shards read one KV head."""
    if not tensor.transposed:
        raise ValueError("only 2-D weights (coded in flax [in, out] order) split into windows")
    n_out, n_in = tensor.shape
    codes = tensor.codes.reshape(-1)[: tensor.size].reshape(n_in, n_out)
    if dim == 0:
        window, base = codes[:, start:stop], start
    else:
        window, base = codes[start:stop], start * n_out
    own = torch.empty(window.shape, dtype=window.dtype, device=device).copy_(window)  # never a view of the whole
    return QuantizedWindow(own, tensor.absmax.to(device, copy=True), n_out, base, tensor.dtype)


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
