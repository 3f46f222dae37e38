"""Fused flash-attention forward: the wrapper of the Hopper kernel in
``csrc/flash_attention.cu`` (the port of the forward half of
hivemind_tpu/ops/pallas_attention.py), its plain PyTorch version, and
``attention_auto``, the dispatch the expert blocks call.

Layout is the JAX package's: q, k, v ``[B, T, H, D]`` → out ``[B, T, H, D]`` in the
input dtype and lse ``[B, H, T]`` fp32. Forward-only in this slice: the
``torch.autograd.Function`` with the two backward kernels comes with training.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises. ``flash_attention_lse.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.parallel.ring_attention import plain_attention

SUPPORTED_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain PyTorch: fp32 math on any input dtype
    (the TPU kernel also casts its tiles to fp32), masking with -1e30."""
    seq = q.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        positions = torch.arange(seq, device=q.device)
        scores = scores.masked_fill(positions[None, :] > positions[:, None], _NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype), lse


def _library() -> ctypes.CDLL:
    library = _build.load_library("flash_attention")
    fn = library.hm_flash_forward
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return library


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, tensor in (("q", q), ("k", k), ("v", v)):
        if tensor.device != q.device or tensor.device.type != "cuda":
            raise ValueError(f"q, k, v must lie on one CUDA device; {name} is on {tensor.device}")
        if tensor.dtype != q.dtype:
            raise TypeError(f"q, k, v must share a dtype; {name} is {tensor.dtype}, q is {q.dtype}")
        if tensor.stride(-1) != 1:
            raise ValueError(f"{name}'s last (head_dim) dimension must be contiguous")
        if q.dtype == torch.bfloat16 and (tensor.data_ptr() % 16 or any(s % 8 for s in tensor.stride()[:3])):
            raise ValueError(f"bf16 {name} must be 16-byte aligned with strides that are multiples of 8")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {SUPPORTED_HEAD_DIMS}, got {q.shape[-1]}")
    if q.shape[0] * q.shape[2] >= 65536 or q.shape[1] >= 2**31 - 64:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention on full ``[B, T, H, D]`` sequences (q, k, v of one shape)
    returning ``(out, lse)``; ``lse`` is ``[B, H, T]`` fp32."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one [B, T, H, D] shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check_cuda_inputs(q, k, v)
    batch, seq, heads, head_dim = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    library = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = library.hm_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch, seq, heads, head_dim,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), int(q.dtype == torch.bfloat16), head_dim ** -0.5, stream,
        )
    _build.check_launch(library, status, "flash_attention_lse")
    flash_attention_lse.launches += 1
    return out, lse


flash_attention_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Fused flash attention on ``[B, T, H, D]`` (full sequences; for padded batches
    use the mask-capable ``plain_attention``). Forward only in this slice."""
    return flash_attention_lse(q, k, v, causal)[0]


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """The attention core of the expert blocks: the flash kernel for unmasked square
    attention on CUDA tensors, ``plain_attention`` for a padding mask, for
    q_len != k_len (its causal mask is end-aligned) and on the CPU."""
    if mask is None and q.shape[1] == k.shape[1] and q.is_cuda:
        return flash_attention(q, k, v, causal)
    return plain_attention(q, k, v, mask=mask, causal=causal)
