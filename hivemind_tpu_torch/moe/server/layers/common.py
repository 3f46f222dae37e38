"""Built-in expert blocks + registry (the port of
hivemind_tpu/moe/server/layers/common.py): 'ffn', 'transformer',
'causal_transformer', 'llama_block' and 'nop'. The two decoder blocks also run
KV-cache decode steps (``forward(x, cache_k, cache_v, index)``), which
``moe/server/decode_session.py`` drives.

The blocks reproduce the flax modules' numerics: dense layers keep fp32
parameters and compute in bf16 (flax ``Dense(dtype=bf16, param_dtype=fp32)``),
LayerNorm uses flax's eps 1e-6, norms compute their statistics in fp32 and emit
bf16, ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default), RoPE angles
are fp32 cast to the activation dtype, and every block returns fp32. Parameter
names follow the flax tree (``query.weight`` is flax's ``query/kernel``,
transposed; see ``hivemind_tpu_torch/convert.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hivemind_tpu_torch.ops.flash_attention import attention_auto
from hivemind_tpu_torch.parallel.ring_attention import plain_attention

# a decode step's write position: an int for every row, or a [batch] tensor with
# one per row (the decode-session manager's merged step)
Index = Union[int, torch.Tensor]

name_to_block: Dict[str, Callable[..., nn.Module]] = {}
name_to_input: Dict[str, Callable[[int, int], np.ndarray]] = {}


def register_expert_class(name: str, sample_input: Callable[[int, int], np.ndarray]):
    """Register an ``nn.Module`` factory under ``name``; ``sample_input(batch, hid)``
    builds a schema-defining dummy input."""

    def decorator(factory):
        if name in name_to_block:
            raise ValueError(f"expert class {name!r} already registered")
        name_to_block[name] = factory
        name_to_input[name] = sample_input
        return factory

    return decorator


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization with flax's defaults in distribution: matrices
    ~ N(0, 1/fan_in) (flax's lecun_normal, untruncated), biases 0, scales 1."""
    with torch.no_grad():
        for name, param in module.named_parameters():
            if param.dim() >= 2:
                param.normal_(0.0, param.shape[1] ** -0.5, generator=generator)
            elif name.endswith("bias"):
                param.zero_()
            else:
                param.fill_(1.0)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: fp32 weight
    ``[out, in]``, compute and output in ``dtype`` (bf16 by default)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:class:`Dense`'s arithmetic on a weight ``[out, in]``: inputs, weight and bias
    cast to ``dtype``, the product in ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=dtype)``: eps 1e-6, fp32 statistics, output in
    ``dtype`` (bf16 by default)."""

    def __init__(self, dim: int, device=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dim, eps=1e-6, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias, self.eps).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=bfloat16)``: fp32 statistics, bf16 out."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """:class:`RMSNorm`'s arithmetic: fp32 statistics, the scale, bf16 out."""
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * weight).to(torch.bfloat16)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


class FeedforwardExpert(nn.Module):
    """hid -> 4*hid -> hid feedforward with layernorm (the reference's 'ffn')."""

    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(hidden_dim, hidden_dim * 4, device=device)
        self.Dense_1 = Dense(hidden_dim * 4, hidden_dim, device=device)
        self.LayerNorm_0 = LayerNorm(hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Dense_1(_gelu(self.Dense_0(x)))
        return self.LayerNorm_0(x + h).to(torch.float32)


class TransformerExpert(nn.Module):
    """One post-norm transformer encoder block operating on [batch, seq, hid]."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "attention_out"):
            setattr(self, name, Dense(hidden_dim, hidden_dim, device=device))
        self.LayerNorm_0 = LayerNorm(hidden_dim, device=device)
        self.ffn_up = Dense(hidden_dim, 4 * hidden_dim, device=device)
        self.ffn_down = Dense(4 * hidden_dim, hidden_dim, device=device)
        self.LayerNorm_1 = LayerNorm(hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, hid = x.shape
        heads = (batch, seq, self.num_heads, hid // self.num_heads)
        q, k, v = (proj(x).reshape(heads) for proj in (self.query, self.key, self.value))
        attn = self.attention_out(attention_auto(q, k, v).reshape(batch, seq, hid))
        x = self.LayerNorm_0(x + attn)
        h = self.ffn_down(_gelu(self.ffn_up(x)))
        return self.LayerNorm_1(x + h).to(torch.float32)


def _decode_attention(q, k_new, v_new, cache_k, cache_v, index: Index, groups: int = 1):
    """The KV-cache attention step of the decoder blocks (the JAX package's
    ``_decode_attention``). Writes ``k_new``/``v_new`` into the caches at
    ``index``, IN PLACE, then attends the chunk's queries over every position the
    session holds. Two session shapes: prefill (``index == 0``, a chunk of any
    length, causal within it) and a 1-token step (attends every position ≤ its
    index). With a tensor ``index`` (1-token steps only) each row writes and
    attends at its own position. ``groups`` > 1 repeats the grouped-query KV heads
    at attention time: the caches stay in the compact kv-heads layout.
    Returns (context, cache_k, cache_v)."""
    batch, new_len = q.shape[0], q.shape[1]
    max_len = cache_k.shape[1]
    if isinstance(index, torch.Tensor):
        if new_len != 1:
            raise ValueError(f"per-row indices take 1-token steps, got a chunk of {new_len}")
        rows = torch.arange(batch, device=index.device)
        cache_k[rows, index] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, index] = v_new[:, 0].to(cache_v.dtype)
        last = index[:, None]
    else:
        cache_k[:, index : index + new_len] = k_new.to(cache_k.dtype)
        cache_v[:, index : index + new_len] = v_new.to(cache_v.dtype)
        last = index
    expand = (lambda t: t.repeat_interleave(groups, dim=2)) if groups > 1 else (lambda t: t)
    if new_len == 1:
        valid = (torch.arange(max_len, device=q.device)[None, :] <= last).expand(batch, max_len)  # key validity
        context = plain_attention(q, expand(cache_k), expand(cache_v), mask=valid)
    else:
        # a prefill at the session start: causal attention over the chunk is exact
        # (the cache holds nothing before index 0)
        context = plain_attention(q, expand(k_new), expand(v_new), causal=True)
    return context, cache_k, cache_v


def _zero_caches(batch: int, max_len: int, kv_heads: int, head_dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (batch, max_len, kv_heads, head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


class CausalTransformerExpert(nn.Module):
    """One pre-norm DECODER block on [batch, seq, hid]: causal attention + gelu ffn.
    Causality makes right-padded prefixes exact.

    Decode sessions: called with ``(cache_k, cache_v, index)`` it runs one
    KV-cache step and returns ``(y, cache_k, cache_v)``; see ``_decode_attention``."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.attention_norm = LayerNorm(hidden_dim, device=device)
        for name in ("query", "key", "value", "attention_out"):
            setattr(self, name, Dense(hidden_dim, hidden_dim, device=device))
        self.ffn_norm = LayerNorm(hidden_dim, device=device)
        self.ffn_up = Dense(hidden_dim, 4 * hidden_dim, device=device)
        self.ffn_down = Dense(4 * hidden_dim, hidden_dim, device=device)

    def init_decode_cache(self, batch: int, max_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """bf16 zeros ``[batch, max_len, heads, head_dim]`` for K and for V."""
        return _zero_caches(batch, max_len, self.num_heads, self.hidden_dim // self.num_heads, device)

    def forward(self, x: torch.Tensor, cache_k: Optional[torch.Tensor] = None,
                cache_v: Optional[torch.Tensor] = None, index: Optional[Index] = None):
        batch, seq, hid = x.shape
        heads = (batch, seq, self.num_heads, hid // self.num_heads)
        normed = self.attention_norm(x)
        q, k, v = (proj(normed).reshape(heads) for proj in (self.query, self.key, self.value))
        if cache_k is None:
            attn = attention_auto(q, k, v, causal=True).reshape(batch, seq, hid)
        else:
            context, cache_k, cache_v = _decode_attention(q, k, v, cache_k, cache_v, index)
            attn = context.reshape(batch, seq, hid)
        x = x + self.attention_out(attn)
        h = self.ffn_up(self.ffn_norm(x))
        y = (x + self.ffn_down(_gelu(h))).to(torch.float32)
        return y if cache_k is None else (y, cache_k, cache_v)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)  # split halves, as HF's Llama and the JAX package
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, theta: float = 10000.0, offset: Index = 0) -> torch.Tensor:
    """Rotary position embedding over [batch, seq, heads, head_dim] (head_dim even);
    angles in fp32, cast to the activation dtype. ``offset`` shifts the positions:
    decode steps rotate their tokens at their absolute positions. It is an int,
    or a [batch] tensor with one offset per row."""
    seq, dim = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    positions = torch.arange(seq, dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        positions = offset.to(torch.float32)[:, None] + positions[None, :]  # [batch, seq]
    else:
        positions = (offset + positions)[None, :]  # [1, seq]
    angles = positions[..., None] * freqs
    angles = torch.cat([angles, angles], dim=-1)  # [batch or 1, seq, dim]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


class LlamaBlockExpert(nn.Module):
    """One Llama-family decoder block on [batch, seq, hid]: pre-RMSNorm, rotary
    position embeddings, causal attention with optional grouped-query KV heads,
    and a SwiGLU MLP — the block shape Petals serves for Llama models."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int = 8,
        num_kv_heads: int = 0,  # 0 = multi-head (Llama-7B); lower for GQA
        rope_theta: float = 10000.0,
        ffn_inner: int = 0,  # 0 = the 8/3 rule; real checkpoints set intermediate_size
        rms_eps: float = 1e-6,  # real checkpoints set rms_norm_eps (Llama-2: 1e-5)
        device=None,
    ):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads={num_heads} is not a multiple of num_kv_heads={kv_heads}")
        self.hidden_dim, self.num_heads, self.num_kv_heads, self.rope_theta = hidden_dim, num_heads, kv_heads, rope_theta
        head_dim = hidden_dim // num_heads
        inner = ffn_inner or -(-8 * hidden_dim // 3 // 8) * 8  # 8/3*hid rounded up to 8
        dense = lambda n_in, n_out: Dense(n_in, n_out, bias=False, device=device)
        self.attention_norm = RMSNorm(hidden_dim, rms_eps, device=device)
        self.query = dense(hidden_dim, num_heads * head_dim)
        self.key = dense(hidden_dim, kv_heads * head_dim)
        self.value = dense(hidden_dim, kv_heads * head_dim)
        self.attention_out = dense(hidden_dim, hidden_dim)
        self.ffn_norm = RMSNorm(hidden_dim, rms_eps, device=device)
        self.ffn_gate = dense(hidden_dim, inner)
        self.ffn_up = dense(hidden_dim, inner)
        self.ffn_down = dense(inner, hidden_dim)

    def init_decode_cache(self, batch: int, max_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """bf16 zeros ``[batch, max_len, kv_heads, head_dim]`` for K and for V:
        the compact grouped-query layout."""
        return _zero_caches(batch, max_len, self.num_kv_heads, self.hidden_dim // self.num_heads, device)

    def forward(self, x: torch.Tensor, cache_k: Optional[torch.Tensor] = None,
                cache_v: Optional[torch.Tensor] = None, index: Optional[Index] = None):
        batch, seq, hid = x.shape
        heads, kv_heads = self.num_heads, self.num_kv_heads
        head_dim = hid // heads
        offset = 0 if cache_k is None else index  # decode: rotate at the absolute position
        normed = self.attention_norm(x)
        q = apply_rope(self.query(normed).reshape(batch, seq, heads, head_dim), self.rope_theta, offset)
        k = apply_rope(self.key(normed).reshape(batch, seq, kv_heads, head_dim), self.rope_theta, offset)
        v = self.value(normed).reshape(batch, seq, kv_heads, head_dim)
        if cache_k is None:
            if kv_heads != heads:  # grouped-query: each KV head serves heads/kv_heads queries
                k = k.repeat_interleave(heads // kv_heads, dim=2)
                v = v.repeat_interleave(heads // kv_heads, dim=2)
            attn = attention_auto(q, k, v, causal=True).reshape(batch, seq, hid)
        else:
            context, cache_k, cache_v = _decode_attention(q, k, v, cache_k, cache_v, index, groups=heads // kv_heads)
            attn = context.reshape(batch, seq, hid)
        x = x + self.attention_out(attn)
        normed = self.ffn_norm(x)
        y = (x + self.ffn_down(F.silu(self.ffn_gate(normed)) * self.ffn_up(normed))).to(torch.float32)
        return y if cache_k is None else (y, cache_k, cache_v)


class NopExpert(nn.Module):
    """Identity with a dummy parameter (reference 'nop' expert for transport tests)."""

    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


register_expert_class("ffn", lambda batch, hid: np.zeros((batch, hid), np.float32))(FeedforwardExpert)
register_expert_class("transformer", lambda batch, hid: np.zeros((batch, 64, hid), np.float32))(TransformerExpert)
register_expert_class("causal_transformer", lambda batch, hid: np.zeros((batch, 64, hid), np.float32))(CausalTransformerExpert)
register_expert_class("llama_block", lambda batch, hid: np.zeros((batch, 64, hid), np.float32))(LlamaBlockExpert)
register_expert_class("nop", lambda batch, hid: np.zeros((batch, hid), np.float32))(NopExpert)
