"""The plain attention core (the port of ``plain_attention``,
hivemind_tpu/parallel/ring_attention.py:186-211). Ring attention over several
cards waits for the multi-GPU slice."""

from __future__ import annotations

from typing import Optional

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
