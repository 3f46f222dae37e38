"""The attention cores of hivemind_tpu/parallel/ring_attention.py: ``plain_attention``
and the single-device branch of ``mesh_attention_core``. Ring attention over
several cards (any mesh) waits for the multi-GPU slice."""

from __future__ import annotations

from typing import Any, Optional

import torch


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Single-device attention on ``[B, T, H, D]``, computed in the inputs' dtype.

    :param mask: optional [B, T_k] key-validity mask
    :param causal: lower-triangular masking aligned to the END of the key sequence,
        so incremental decode (q_len=1 against a cached k_len) sees all past keys
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.finfo(scores.dtype).min
    if mask is not None:
        scores = scores.masked_fill(~mask.to(torch.bool)[:, None, None, :], neg)
    if causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((q_len, k_len), dtype=torch.bool, device=scores.device).tril(diagonal=k_len - q_len)
        scores = scores.masked_fill(~tri, neg)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mesh_attention_core(
    mesh: Any,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The attention dispatch of mesh-aware models. With ``mesh`` None it is
    ``attention_auto``: the flash kernels on unmasked CUDA tensors (the ALBERT
    train step, whose loss encodes without a mask), ``plain_attention`` otherwise.
    Any mesh raises: sequence-parallel ring attention comes with the multi-GPU slice."""
    if mesh is not None:
        raise NotImplementedError("a mesh (sequence-parallel ring attention) comes with the multi-GPU slice of the port")
    from hivemind_tpu_torch.ops.flash_attention import attention_auto

    return attention_auto(q, k, v, mask=mask, causal=causal)
