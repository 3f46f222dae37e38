"""Attention cores of the port (hivemind_tpu/parallel/ring_attention.py):
``plain_attention``, ring attention over a mesh's sequence axis, and
``mesh_attention_core``, the dispatch of mesh-aware models.

Ring attention keeps each rank's local queries and rotates keys and values around the
``sp`` axis of a :class:`~hivemind_tpu_torch.parallel.mesh.Mesh`, merging the softmax
online, so the whole sequence never sits on one rank. Every input is the rank's LOCAL
sequence shard ``[batch, seq_local, heads, head_dim]``; shards are contiguous chunks in
rank order.

- :func:`ring_attention`, the einsum ring, plain PyTorch in the inputs' dtype. Its
  rotations are an autograd function whose backward sends each gradient back the way its
  value came, so autograd carries the dK/dV partial sums back around the ring.
- :func:`ring_flash_attention`, the kernel ring: each step runs the flash forward
  (``ops.flash_attention.flash_attention_lse``) and the shards' outputs merge through
  their log-sum-exp in fp32; the backward recomputes through the einsum ring, as the JAX
  package's ``custom_vjp`` does.

Over gloo, the rotated blocks of ranks that share a card pass through pinned host
buffers (``Mesh.ring_shift``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

_NEG_INF = -1e30  # matches ops/flash_attention: finite, so lse merges stay NaN-free


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


class _RingShift(torch.autograd.Function):
    """``tensors`` sent one step along the ring (the JAX ``ppermute``); the backward
    sends their gradients one step back."""

    @staticmethod
    def forward(ctx, mesh, axis: str, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(mesh.ring_shift(tensors, axis, 1))

    @staticmethod
    def backward(ctx, *grads):
        # a block a causal rank never reads (a future shard at the last step) has no gradient
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.specs)]
        return (None, None, *ctx.mesh.ring_shift(grads, ctx.axis, -1))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, axis: str = "sp",
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``axis`` in the inputs' dtype, differentiable.

    ``causal=True``: the block received at ring step s comes from rank j = (i − s) mod P
    and counts fully when j < i, causally when j == i (the local block) and not at all
    when j > i (a future shard)."""
    size, here = mesh.shape[axis], mesh.coordinate[axis]
    scale = q.shape[-1] ** -0.5
    zeros_bht = q[..., 0].transpose(1, 2) * 0  # [B, H, T_local]
    row_max, row_sum, acc = zeros_bht - float("inf"), zeros_bht, q * 0
    tri = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
    k_cur, v_cur = k, v
    for step in range(size):
        if step:
            k_cur, v_cur = _RingShift.apply(mesh, axis, k_cur, v_cur)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale
        if causal:
            source = (here - step) % size
            if source > here:
                scores = torch.full_like(scores, _NEG_INF)
            elif source == here:
                scores = scores.masked_fill(~tri, _NEG_INF)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(scores - new_max[..., None])
        if causal:
            # a fully masked row of a block leaves scores == new_max: exp(0) would weigh 1
            probs = probs.masked_fill(scores <= _NEG_INF / 2, 0.0)
        acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", probs, v_cur)
        row_sum = row_sum * correction + probs.sum(dim=-1)
        row_max = new_max
    return acc / row_sum.transpose(1, 2)[..., None]


def _merge(out: torch.Tensor, lse: torch.Tensor, out_i: torch.Tensor, lse_i: torch.Tensor):
    """Two normalized partial outputs (fp32) merged through their log-sum-exp."""
    new_lse = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - new_lse).transpose(1, 2)[..., None]
    return out * w_old + out_i.float() * w_new, new_lse


def ring_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, axis: str = "sp",
                       causal: bool = False) -> torch.Tensor:
    """The kernel ring's forward (no autograd): step 0 is the local block (causal when
    ``causal``), then each received block; a future shard's lse is set to -1e30 before
    the merge, so it weighs nothing."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse

    size, here = mesh.shape[axis], mesh.coordinate[axis]
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    out = out.float()
    k_cur, v_cur = k, v
    for step in range(1, size):
        k_cur, v_cur = mesh.ring_shift((k_cur, v_cur), axis, 1)
        out_i, lse_i = flash_attention_lse(q, k_cur, v_cur)
        if causal and (here - step) % size > here:
            lse_i = torch.full_like(lse_i, _NEG_INF)
        out, lse = _merge(out, lse, out_i, lse_i)
    return out.to(q.dtype)


class RingFlashAttentionFunction(torch.autograd.Function):
    """``ring_flash_attention`` (the JAX ``custom_vjp``): the kernel ring forward; the
    backward recomputes through the einsum ring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis: str, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.mesh, ctx.axis, ctx.causal = mesh, axis, causal
        return ring_flash_forward(q, k, v, mesh, axis, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ring_attention(q, k, v, ctx.mesh, ctx.axis, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout.to(q.dtype))
        return dq, dk, dv, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, axis: str = "sp",
                         causal: bool = False) -> torch.Tensor:
    """Ring attention with the flash kernel as each step's core (same contract as
    :func:`ring_attention`). CUDA tensors launch ``flash_attention_lse`` once a step or
    raise where no kernel runs; CPU tensors take its plain version."""
    return RingFlashAttentionFunction.apply(q, k, v, mesh, axis, causal)


def mesh_attention_core(
    mesh: Any,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The attention dispatch of mesh-aware models. A mesh with ``sp > 1`` runs ring
    attention over its sequence axis: the kernel ring on CUDA tensors, the einsum ring on
    the CPU (``attention_auto``'s rule). Otherwise (no mesh, or the rank's local heads
    of a tensor-parallel mesh) ``attention_auto``: the flash kernels on unmasked CUDA
    tensors, ``plain_attention`` otherwise. ``mask`` (key validity) is for the
    single-rank path only: ring shards carry full sequences."""
    if mesh is not None and mesh.shape["sp"] > 1:
        if mask is not None:
            raise ValueError("ring attention shards carry full sequences (no padding mask)")
        if q.is_cuda:
            return ring_flash_attention(q, k, v, mesh, "sp", causal)
        return ring_attention(q, k, v, mesh, "sp", causal)
    from hivemind_tpu_torch.ops.flash_attention import attention_auto

    return attention_auto(q, k, v, mask=mask, causal=causal)
