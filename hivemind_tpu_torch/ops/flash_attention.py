"""Fused flash attention, both directions: the wrappers of the Hopper kernels in
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu`` (the dQ
pass and the dK/dV pass of the backward), the port of
hivemind_tpu/ops/pallas_attention.py; their plain PyTorch versions; the
``torch.autograd.Function`` that joins them; and ``attention_auto``, the dispatch
the expert blocks and ALBERT call.

Layout is the JAX package's: q, k, v ``[B, T, H, D]`` → out ``[B, T, H, D]`` in the
input dtype and lse ``[B, H, T]`` fp32. The backward recomputes the probabilities
from the saved lse (``p = exp(s·scale − lse)``), with ``δ = rowsum(dO∘O)`` taken
outside the kernels, as the JAX package does.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it launches
a kernel or raises. Each kernel wrapper counts its launches in ``.launches``
(``flash_attention_lse``, ``flash_attention_backward_dq``,
``flash_attention_backward_dkv``).

Each direction has two designs (:func:`flash_route`): ``"wgmma"`` for bf16 at
head_dim 64 or 128 (the served and trained widths), and ``"simt"`` for the rest:
fp32, fp16, and bf16 at any other head_dim up to 256, as the TPU kernels take any
head_dim as their block. :func:`flash_refusal` names the few inputs neither takes.
A view a kernel cannot read through its strides is copied first
(:func:`_kernel_layout`).

The wgmma kernels read q, k, v (and dout) by TMA: the wrapper describes each
tensor to the kernel's C entry point as a 4-D view (:func:`tma_geometry`), from
which the entry point encodes the tensor maps. The two backward passes share one
view of each tensor (:func:`backward_geometries`), which
``flash_attention_backward`` computes once for both.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.parallel.ring_attention import plain_attention

WGMMA_HEAD_DIMS = (64, 128)  # the bf16 head dims of the wgmma kernels
SIMT_MAX_HEAD_DIM = 256  # the SIMT kernels take head_dim 1 to 256
SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the C entry points' dtype codes
SIMT_ROWS = 16  # rows a SIMT block owns
_MAX_ROW_TILES = 65535  # the grid's y dimension: row tiles of one batch*head
_NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``q·kᵀ·D^-½`` in fp32 as ``[B, H, T, T]``, causal entries set to -1e30."""
    seq = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * q.shape[-1] ** -0.5
    if causal:
        positions = torch.arange(seq, device=q.device)
        scores = scores.masked_fill(positions[None, :] > positions[:, None], _NEG_INF)
    return scores


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain PyTorch: fp32 math on any input dtype
    (the TPU kernel also casts its tiles to fp32), masking with -1e30."""
    scores = _scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype), lse


# ------------------------------------------------------------------ TMA geometry

TMA_BOX_COLS = 64  # bf16 columns per TMA box: one 128-byte swizzled row
FORWARD_TILE_ROWS = 128  # the forward's query and KV tiles
BACKWARD_BOX_ROWS = 64  # both backward passes: a box is a streamed tile, or half of a resident one
_TMA_MAX_STRIDE = 2**40  # cuTensorMapEncodeTiled's bound on a byte stride


class TmaGeometry(NamedTuple):
    """A bf16 ``[B, T, H, D]`` tensor as a 4-D TMA view, innermost dimension first:
    ``dims`` (D, H, T, B), the byte ``strides`` of H, T and B, and the ``box`` one
    load copies, (64, 1, rows, 1). A tile row of D columns takes D / 64 such
    boxes, each its own 128-byte swizzle region in shared memory."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]

    def as_ctypes(self) -> ctypes.Array:
        """The 11 int64s the C entry points read as ``sm90::TmaGeometry``."""
        return (ctypes.c_longlong * 11)(*self.dims, *self.strides, *self.box)


def tma_geometry(t: torch.Tensor, rows: int) -> TmaGeometry:
    """The TMA view of ``t`` (bf16 ``[B, T, H, D]``) with boxes of 64 columns by
    ``rows`` rows; raises ``ValueError`` on a view TMA cannot take: a head dim that
    is not contiguous or not a multiple of 64, a base address that is not 16-byte
    aligned, or a B, T or H stride that is not a multiple of 16 bytes below 2^40."""
    if t.dim() != 4 or t.dtype != torch.bfloat16:
        raise ValueError(f"TMA views take bf16 [B, T, H, D] tensors, got {t.dtype} of shape {tuple(t.shape)}")
    batch, seq, heads, dim = t.shape
    stride_b, stride_t, stride_h, stride_d = t.stride()
    if stride_d != 1 or dim % TMA_BOX_COLS:
        raise ValueError(f"TMA needs a contiguous head dim that is a multiple of {TMA_BOX_COLS}, got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")
    strides = (2 * stride_h, 2 * stride_t, 2 * stride_b)  # bf16: 2 bytes an element
    if (strides[0] | strides[1] | strides[2]) % 16 or max(strides) >= _TMA_MAX_STRIDE:
        raise ValueError(f"TMA needs H, T and B strides that are multiples of 16 bytes below 2^40, got {strides} bytes")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte aligned base address")
    return TmaGeometry((dim, heads, seq, batch), strides, (TMA_BOX_COLS, 1, rows, 1))


def backward_geometries(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor) -> Tuple[TmaGeometry, ...]:
    """The TMA views of q, k, v, dout (bf16 ``[B, T, H, D]``) that both backward
    passes read: boxes of 64 columns by 64 rows."""
    return tuple(tma_geometry(t, BACKWARD_BOX_ROWS) for t in (q, k, v, dout))


# ------------------------------------------------------------------ forward


def _library() -> ctypes.CDLL:
    library = _build.load_library("flash_attention")
    bf16, simt = library.hm_flash_forward_bf16, library.hm_flash_forward_simt
    if bf16.argtypes is None:
        geometry = ctypes.POINTER(ctypes.c_longlong)
        # q, k, v, out, lse; B, T, H, D; geometries of q, k, v; out's strides; causal, scale, stream
        bf16.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [geometry] * 3 + [ctypes.c_longlong] * 3
                         + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        bf16.restype = ctypes.c_int
        # q, k, v, out, lse; dtype, B, T, H, D; strides of q, k, v, out; causal, scale, stream
        simt.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                         + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        simt.restype = ctypes.c_int
    return library


def flash_route(q: torch.Tensor) -> str:
    """Which design runs ``q`` (and k, v of its shape and dtype): ``"wgmma"`` for
    bf16 at head_dim 64 or 128, ``"simt"`` otherwise."""
    return "wgmma" if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS else "simt"


def _bf16_aligned(t: torch.Tensor) -> bool:
    """What TMA needs of a bf16 view: a 16-byte aligned base and batch, time and
    head strides that are multiples of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def needs_copy(t: torch.Tensor) -> bool:
    """Whether the kernels must read a contiguous copy of ``t`` rather than ``t``
    through its strides: a head dim that is not contiguous, or a view the wgmma
    kernels' TMA cannot take (an unaligned base or stride)."""
    return t.stride(-1) != 1 or (flash_route(t) == "wgmma" and not _bf16_aligned(t))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides, else a
    contiguous copy in a fresh allocation (a fused projection's unaligned slice,
    or a gradient from autograd that is broadcast or misaligned; ``contiguous()``
    would return a contiguous view with an unaligned base as it is)."""
    return t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t


def flash_refusal(q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> Optional[Tuple[type, str]]:
    """Why no flash kernel can take ``q`` and ``others`` (named tensors of q's
    shape), as ``(exception type, message)``, or None when one can (after a copy,
    where :func:`needs_copy` says so). It reads shapes and dtypes only, so it
    answers for ``meta`` tensors too; the caller tests the device."""
    for name, tensor in others:
        if tensor.dtype != q.dtype:
            return TypeError, f"q, k, v must share a dtype; {name} is {tensor.dtype}, q is {q.dtype}"
    if q.dtype not in SIMT_DTYPES:
        return TypeError, f"the flash kernels take bfloat16, float16 or float32, got {q.dtype}"
    batch, seq, heads, head_dim = q.shape
    if not 0 < head_dim <= SIMT_MAX_HEAD_DIM:
        return ValueError, f"the flash kernels take head_dim 1 to {SIMT_MAX_HEAD_DIM}, got {head_dim}"
    rows = FORWARD_TILE_ROWS if flash_route(q) == "wgmma" else SIMT_ROWS
    if batch * heads >= 2**31 or -(-seq // rows) > _MAX_ROW_TILES:
        return ValueError, f"shape {tuple(q.shape)} exceeds the kernels' grid (B*H < 2^31, T <= {rows * _MAX_ROW_TILES})"
    return None


def _check_cuda_inputs(q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> None:
    for name, tensor in (("q", q), *others):
        if tensor.device != q.device or tensor.device.type != "cuda":
            raise ValueError(f"q, k, v must lie on one CUDA device; {name} is on {tensor.device}")
    refusal = flash_refusal(q, *others)
    if refusal is not None:
        error, message = refusal
        raise error(message)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one [B, T, H, D] shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _strides(*tensors: torch.Tensor) -> Tuple[int, ...]:
    """The B, T and H strides of each tensor, in elements."""
    return tuple(s for t in tensors for s in t.stride()[:3])


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention on full ``[B, T, H, D]`` sequences (q, k, v of one shape)
    returning ``(out, lse)``; ``lse`` is ``[B, H, T]`` fp32. Forward only, as in
    the JAX package: ``flash_attention`` is the differentiable entry."""
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal)
    _check_cuda_inputs(q, ("k", k), ("v", v))
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    batch, seq, heads, head_dim = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    library = _library()
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if flash_route(q) == "wgmma":
            status = library.hm_flash_forward_bf16(
                *pointers, batch, seq, heads, head_dim,
                *(tma_geometry(t, FORWARD_TILE_ROWS).as_ctypes() for t in (q, k, v)), *out.stride()[:3],
                int(causal), head_dim ** -0.5, stream,
            )
        else:
            status = library.hm_flash_forward_simt(
                *pointers, SIMT_DTYPES[q.dtype], batch, seq, heads, head_dim, *_strides(q, k, v, out),
                int(causal), head_dim ** -0.5, stream,
            )
    _build.check_launch(library, status, "flash_attention_lse")
    flash_attention_lse.launches += 1
    return out, lse


flash_attention_lse.launches = 0


# ------------------------------------------------------------------ backward


def flash_backward_terms(q, k, v, dout, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-pair terms both backward passes share (the JAX ``_bwd_tile``), in
    fp32 as ``[B, H, T, T]``: ``p = exp(s·scale − lse)`` recomputed from the saved
    lse, and ``dS = p∘(dO·Vᵀ − δ)·scale``. ``delta`` is ``[B, H, T]`` fp32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(torch.float32), v.to(torch.float32))
    ds = p * (dp - delta[..., None]) * q.shape[-1] ** -0.5
    return p, ds


def flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, causal: bool = False) -> torch.Tensor:
    """The dQ pass in plain PyTorch: ``dQ = Σ_kv dS·K``, fp32 math, q's dtype out."""
    _, ds = flash_backward_terms(q, k, v, dout, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32)).to(q.dtype)


def flash_attention_backward_dkv_plain(q, k, v, dout, lse, delta, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV pass in plain PyTorch: ``dK = Σ_q dSᵀ·Q``, ``dV = Σ_q Pᵀ·dO``."""
    p, ds = flash_backward_terms(q, k, v, dout, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``δ = rowsum(dO∘O)`` in fp32, as ``[B, H, T]`` contiguous."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_plain(q, k, v, out, lse, dout, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole backward in plain PyTorch, from the forward's ``(out, lse)``: the
    algorithm of the JAX kernels' two passes, without autograd."""
    dout = dout.to(q.dtype)
    delta = _delta(out, dout)
    dq = flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, causal)
    return (dq, *flash_attention_backward_dkv_plain(q, k, v, dout, lse, delta, causal))


def _bwd_library() -> ctypes.CDLL:
    library = _build.load_library("flash_attention_bwd")
    if library.hm_flash_backward_dq_bf16.argtypes is None:
        # each: q, k, v, dout, lse, delta, its outputs (dq, or dk and dv); then SIMT
        # its dtype code; B, T, H, D; then the layout: SIMT, the strides of q, k, v,
        # dout and of the outputs; bf16, the geometries of q, k, v, dout and the
        # outputs' strides; causal, scale, stream
        simt_layout = [ctypes.c_longlong] * 15
        bf16_layout = [ctypes.POINTER(ctypes.c_longlong)] * 4 + [ctypes.c_longlong] * 3
        for name, outputs, dtype, layout in (("dq_simt", 1, [ctypes.c_int], simt_layout),
                                             ("dkv_simt", 2, [ctypes.c_int], simt_layout),
                                             ("dq_bf16", 1, [], bf16_layout), ("dkv_bf16", 2, [], bf16_layout)):
            fn = getattr(library, f"hm_flash_backward_{name}")
            fn.argtypes = ([ctypes.c_void_p] * (6 + outputs) + dtype + [ctypes.c_int] * 4 + layout
                           + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return library


def _check_backward_inputs(q, k, v, dout, lse, delta) -> None:
    _check_shapes(q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"dout has shape {tuple(dout.shape)}, expected {tuple(q.shape)}")
    _check_cuda_inputs(q, ("k", k), ("v", v), ("dout", dout))
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, tensor in (("lse", lse), ("delta", delta)):
        if tensor.shape != rows or tensor.dtype != torch.float32 or not tensor.is_contiguous() or tensor.device != q.device:
            raise ValueError(f"{name} must be a contiguous fp32 [B, H, T] tensor on {q.device}")


def _launch_pass(name: str, q, k, v, dout, lse, delta, outputs, causal: bool, geometries) -> None:
    """Launch the pass ``name`` ("dq" or "dkv") of q's route on the pointers of q,
    k, v, dout, lse, delta and ``outputs``: wgmma reads the four TMA views
    ``geometries`` (:func:`backward_geometries` when None), SIMT the strides."""
    if flash_route(q) == "wgmma":
        if geometries is None:
            geometries = backward_geometries(q, k, v, dout)
        entry, dtype = f"hm_flash_backward_{name}_bf16", ()
        layout = (*(g.as_ctypes() for g in geometries), *outputs[0].stride()[:3])
    else:
        entry, dtype = f"hm_flash_backward_{name}_simt", (SIMT_DTYPES[q.dtype],)
        layout = _strides(q, k, v, dout, outputs[0])
    library = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = getattr(library, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outputs), *dtype, *q.shape, *layout, int(causal), q.shape[-1] ** -0.5, stream,
        )
    _build.check_launch(library, status, entry)


def flash_attention_backward_dq(q, k, v, dout, lse, delta, causal: bool = False,
                                geometries: Optional[Tuple[TmaGeometry, ...]] = None) -> torch.Tensor:
    """The dQ pass (``_flash_bwd_dq_kernel``): ``dq`` in q's dtype. ``geometries``:
    the bf16 inputs' TMA views, if the caller has them already."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, causal)
    _check_backward_inputs(q, k, v, dout, lse, delta)
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    _launch_pass("dq", q, k, v, dout, lse, delta, (dq,), causal, geometries)
    flash_attention_backward_dq.launches += 1
    return dq


def flash_attention_backward_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                                 geometries: Optional[Tuple[TmaGeometry, ...]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV pass (``_flash_bwd_dkv_kernel``): ``(dk, dv)`` in k's and v's
    dtype. ``geometries`` as for the dQ pass."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_attention_backward_dkv_plain(q, k, v, dout, lse, delta, causal)
    _check_backward_inputs(q, k, v, dout, lse, delta)
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv
    _launch_pass("dkv", q, k, v, dout, lse, delta, (dk, dv), causal, geometries)
    flash_attention_backward_dkv.launches += 1
    return dk, dv


flash_attention_backward_dq.launches = 0
flash_attention_backward_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``(out, lse)`` and the cotangent ``dout``
    (cast to q's dtype first, as the JAX package's ``_flash_bwd``): the dQ kernel,
    then the dK/dV kernel; ``δ`` and, for bf16, the TMA views both read are
    computed here, once."""
    dout = dout.to(q.dtype)
    if _on_cpu(q, k, v, out, lse, dout):
        return flash_attention_backward_plain(q, k, v, out, lse, dout, causal)
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    delta = _delta(out, dout)
    geometries = backward_geometries(q, k, v, dout) if flash_route(q) == "wgmma" else None
    dq = flash_attention_backward_dq(q, k, v, dout, lse, delta, causal, geometries)
    return (dq, *flash_attention_backward_dkv(q, k, v, dout, lse, delta, causal, geometries))


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with its fused backward (the JAX ``custom_vjp``): the
    forward saves ``(q, k, v, out, lse)``; the backward runs the two passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if not _on_cpu(q, k, v):  # the views the kernels read, copied once for both directions
            q, k, v = (_kernel_layout(t) for t in (q, k, v))
        out, lse = flash_attention_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Fused flash attention on ``[B, T, H, D]`` (full sequences; for padded batches
    use the mask-capable ``plain_attention``), differentiable through the two
    backward kernels."""
    return FlashAttentionFunction.apply(q, k, v, causal)


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """The attention core of the expert blocks and ALBERT, dispatched as the JAX
    package's: the flash kernels for unmasked square attention on CUDA tensors
    (they raise where none can run: :func:`flash_refusal`), ``plain_attention``
    for a padding mask, for q_len != k_len (its causal mask is end-aligned) and on
    the CPU, as the JAX package falls back to the einsum core off the TPU."""
    if mask is None and q.shape == k.shape == v.shape and q.dim() == 4 and q.is_cuda:
        return flash_attention(q, k, v, causal)
    return plain_attention(q, k, v, mask=mask, causal=causal)
