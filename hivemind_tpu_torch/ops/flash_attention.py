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
``flash_attention_backward_dkv``), those on the packed-heads view also in
``.packed.launches``, those on the copied-rows view (the forward, dK/dV) also in
``.copied.launches``, the 3xTF32 kernels' also in ``.tf32x3.launches`` (every pass)
and the SIMT dQ kernel's also in ``.simt.launches``.

Each pass (the forward, the dQ pass, the dK/dV pass) has up to three designs,
chosen by :func:`flash_route`: ``"wgmma"`` (tensor cores fed by TMA), ``"tf32x3"``
(fp32 on the tensor cores: every product formed from TF32 hi and lo parts, 3xTF32)
and ``"simt"`` (fp32 FMAs on the CUDA cores). A 16-bit input runs wgmma in all three
passes at a head_dim from 16 to 256 that is a multiple of 8, or any other whose H·D
is a multiple of 8 and whose :func:`tma_span` is at most 256 (TinyBERT's 26, through
the packed-heads view below); every other 16-bit head_dim from 1 to 256 (below 16,
or one whose H·D is not a multiple of 8, or whose span passes 256) runs the forward
and the dK/dV pass on wgmma through the copied-rows view below and the dQ pass on
SIMT. fp32 runs all three passes on tf32x3 at a head_dim from 16 to 128 that is a
multiple of 4 (plain TF32 would round its inputs to 10 mantissa bits), and every
other fp32 head_dim on SIMT. SIMT takes any head_dim up to 256, as the TPU kernels
take any head_dim as their block.
A CUDA input launches its pass's route or raises: no route falls back to another.
:func:`flash_refusal` names the few inputs no design takes. A view a kernel cannot
read through its strides is copied first (:func:`_kernel_layout`).

The wgmma kernels read q, k, v (and dout) by TMA: the wrapper describes each
tensor to the kernel's C entry point as a view (:func:`tma_geometry`), from which
the entry point encodes the tensor maps: the 4-D view (D, H, T, B) at a head_dim
that is a multiple of 8, else the packed-heads view (H·D, T, B), whose rows are
whole tokens (its head stride of 2·D bytes would not be TMA's multiple of 16). TMA
takes only a start column that is a multiple of 8 there, so head h's boxes start
(h·D) mod 8 columns before it, and a tile spans up to :func:`tma_span` columns;
the tiles a kernel streams are copied a head's bytes at a time instead (cp.async),
so a neighbouring head's values never reach a head's products. The two backward
passes share one view of each tensor (:func:`backward_geometries`), which
``flash_attention_backward`` computes once, when they run wgmma.

A 16-bit tensor with no TMA view (its rows 2·H·D bytes apart, not a multiple of 16, or
a head_dim below 16) is read through the copied-rows view (:func:`copied_rows`): the
wgmma forward and dK/dV kernels take its strides, and their producer warpgroup copies
every tile, resident or streamed, a head's bytes at a time by cp.async (by aligned
4-byte loads and byte permutes where a row's source is 2 bytes off the tile's words;
:func:`row_pieces`), into tiles
zeroed once, so a neighbour's bytes never reach them. A head lands at one column of
its tiles for every row, set by where q's row 0 of the head lies modulo a power of two
(:func:`copy_plan`); no copy of the tensor is made, an unaligned view included.

The tf32x3 kernels read fp32 q, k, v (and dout) through their strides with 16-byte
loads (a 16-byte aligned base, strides that are multiples of 4 elements) and split
each value into its TF32 hi and lo parts on the card; :func:`tf32_split` is that
split in PyTorch, for the tests' emulation and ``chip_smoke.py``'s planted fault.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.parallel.ring_attention import plain_attention

PASSES = ("forward", "dq", "dkv")
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
WGMMA_WIDTHS = (64, 128, 256)  # the padded head dims the wgmma kernels are built for
WGMMA_MIN_HEAD_DIM = 16
SIMT_MAX_HEAD_DIM = 256  # the SIMT kernels take head_dim 1 to 256
TF32X3_HEAD_DIMS = (16, 128)  # fp32 head dims the 3xTF32 kernels take, multiples of TF32X3_ALIGN
TF32X3_ALIGN = 4  # elements: a head's row is whole 16-byte chunks
SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # every C entry point's dtype codes
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


# ------------------------------------------------------------------ 3xTF32


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (cast to fp32) as ``(hi, lo)``: hi is x rounded to TF32 (10 explicit
    mantissa bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``), lo is
    ``x − hi`` rounded likewise; both keep their low 13 bits zero, and
    ``|x − hi − lo| ≤ 2⁻²²·|x|``. The split the tf32x3 kernels make of every operand (a
    product ``a·b`` is then ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``), for the tests'
    emulation of them and for the planted fault ``chip_smoke.py`` rejects (inputs
    rounded to plain TF32); no kernel path calls it. Finite inputs only."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)  # + half of the dropped bits' range carries into the kept ones
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x.to(torch.float32))
    return hi, rna(x.to(torch.float32) - hi)


# ------------------------------------------------------------------ TMA geometry

TMA_BOX_COLS = 64  # 16-bit columns per TMA box: one 128-byte swizzled row
FORWARD_TILE_ROWS = 128  # query rows a forward or dQ block owns (and the forward's KV tiles below a padded width of 256)
# rows of the boxes of the views both backward passes are handed (from which the dQ pass at
# a padded width of 256 encodes K's and V's maps with boxes of 32 rows)
BACKWARD_BOX_ROWS = 64
_TMA_MAX_STRIDE = 2**40  # cuTensorMapEncodeTiled's bound on a byte stride


def padded_head_dim(span: int) -> int:
    """The width a wgmma kernel computes a tile that spans ``span`` columns at (the
    head_dim, or :func:`tma_span`'s): the least of 64, 128 and 256 that holds it (the
    columns past the head's read as zeros, or are zeroed)."""
    return next(width for width in WGMMA_WIDTHS if span <= width)


def forward_box_rows(span: int) -> int:
    """Rows of the forward's KV tiles and TMA boxes: 128, or 64 at a padded width
    of 256, where a 128-row tile's scores would not fit the registers beside O."""
    return 64 if padded_head_dim(span) > 128 else FORWARD_TILE_ROWS


def dkv_block_rows(span: int) -> int:
    """KV rows a dK/dV block owns: 128, or 64 at a padded width of 256, where its
    two warpgroups split the columns of the same rows."""
    return 64 if padded_head_dim(span) > 128 else 128


class TmaGeometry(NamedTuple):
    """A bf16 or fp16 ``[B, T, H, D]`` tensor as a 4-D TMA view, innermost dimension
    first: ``dims``, the byte ``strides`` of the outer three, and the ``box`` one
    load copies, (64, 1, rows, 1). A tile row takes ``padded_head_dim(tma_span(D, H))
    / 64`` such boxes, each its own 128-byte swizzle region in shared memory.

    * D a multiple of 8, the 4-D view: dims (D, H, T, B), strides of H, T and B.
      The columns past D read as zeros.
    * Any other D, the packed-heads view (H·D, T, B) with a head dimension of one:
      dims (H·D, 1, T, B), strides (2·H·D, T's, B's). TMA takes only a start column
      that is a multiple of 8 (16 bytes), so head h's boxes start at column h·D
      rounded down to one (``head_column`` = D), (h·D) mod 8 columns before the
      head's first: the tile's columns around the head's hold its neighbours' values
      (zeroed by the kernels where they matter), past H·D zeros."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    head_column: int = 0  # the column head h's boxes start at, per h: D in the packed-heads view

    def as_ctypes(self) -> ctypes.Array:
        """The 11 int64s the C entry points read as ``sm90::TmaGeometry``."""
        return (ctypes.c_longlong * 11)(*self.dims, *self.strides, *self.box)

    def head_origin(self, head: int) -> Tuple[int, int]:
        """The (column, head) coordinates of head ``head``'s first box, as the kernels
        compute them (``sm90::head_origin``)."""
        if self.head_column:
            return head * self.head_column // 8 * 8, 0
        return 0, head


def packed_heads(head_dim: int) -> bool:
    """Whether TMA reads a head_dim through the packed-heads view: one that is not a
    multiple of 8, whose 2·D-byte head stride TMA cannot take."""
    return head_dim % 8 != 0


def tma_span(head_dim: int, heads: int) -> int:
    """The columns a wgmma tile of one head spans (the C side's ``tma_span``): the
    head_dim in the 4-D view; in the packed-heads view the head_dim plus the most
    columns any head's boxes start before it, (h·D) mod 8 over the heads."""
    if not packed_heads(head_dim):
        return head_dim
    return head_dim + max(h * head_dim % 8 for h in range(min(heads, 8)))


def tma_geometry(t: torch.Tensor, rows: int) -> TmaGeometry:
    """The TMA view of ``t`` (bf16 or fp16 ``[B, T, H, D]``) with boxes of 64
    columns by ``rows`` rows; raises ``ValueError`` on a view TMA cannot take: a
    head dim that is not contiguous or outside 16 to 256; at a head dim that is not
    a multiple of 8, heads not packed in the row (head stride D) or an H·D that is
    not a multiple of 8; a base address that is not 16-byte aligned, or an outer
    stride that is not a multiple of 16 bytes below 2^40."""
    if t.dim() != 4 or t.dtype not in WGMMA_DTYPES:
        raise ValueError(f"TMA views take bf16 or fp16 [B, T, H, D] tensors, got {t.dtype} of shape {tuple(t.shape)}")
    batch, seq, heads, dim = t.shape
    stride_b, stride_t, stride_h, stride_d = t.stride()
    if stride_d != 1 or not WGMMA_MIN_HEAD_DIM <= dim <= WGMMA_WIDTHS[-1]:
        raise ValueError(f"TMA needs a contiguous head dim from {WGMMA_MIN_HEAD_DIM} to {WGMMA_WIDTHS[-1]}, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if not packed_heads(dim):
        dims, strides, head_column = (dim, heads, seq, batch), (2 * stride_h, 2 * stride_t, 2 * stride_b), 0
    elif stride_h == dim and heads * dim % 8 == 0:
        dims, strides, head_column = (heads * dim, 1, seq, batch), (2 * heads * dim, 2 * stride_t, 2 * stride_b), dim
    else:
        raise ValueError(f"a head dim that is not a multiple of 8 takes TMA's packed-heads view: heads packed in the row "
                         f"(head stride D) and H·D a multiple of 8, got shape {tuple(t.shape)}, strides {t.stride()}")
    if (strides[0] | strides[1] | strides[2]) % 16 or max(strides) >= _TMA_MAX_STRIDE:
        raise ValueError(f"TMA needs outer strides that are multiples of 16 bytes below 2^40, got {strides} bytes")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte aligned base address")
    return TmaGeometry(dims, strides, (TMA_BOX_COLS, 1, rows, 1), head_column)


# ------------------------------------------------------------------ the copied-rows view

COPY_MAX_PIECE = 16  # bytes: the widest cp.async piece, and the most a shift can take from a row's alignment
COPY_PIECES = (16, 8, 4)  # cp.async's pieces; a 2-byte piece is a plain load and store


def copied_rows(t: torch.Tensor) -> bool:
    """Whether the wgmma forward and dK/dV pass read ``t`` through the copied-rows view: a
    bf16 or fp16 head_dim from 1 to 256 that no TMA view takes, one below 16 or one that is
    not a multiple of 8 whose H·D is not one either or whose :func:`tma_span` passes 256.
    The producer copies every tile (resident and streamed) a head's bytes at a time
    (:func:`row_pieces`), at the shift :func:`copy_plan` sets; the dQ pass stays on SIMT."""
    heads, head_dim = t.shape[-2:]
    if t.dtype not in WGMMA_DTYPES or not 0 < head_dim <= WGMMA_WIDTHS[-1]:
        return False
    if head_dim < WGMMA_MIN_HEAD_DIM:
        return True
    return packed_heads(head_dim) and not (heads * head_dim % 8 == 0 and tma_span(head_dim, heads) <= WGMMA_WIDTHS[-1])


def copy_shift(address: int, modulus: int) -> int:
    """The tile column a block's head lands at on the copied-rows view: the byte address of
    the head's row 0 of q modulo ``modulus``, halved (``sm90::copied_shift``)."""
    return address % modulus // 2


class CopyPlan(NamedTuple):
    """How the copied-rows view lands q's heads in the tiles: ``modulus`` (16, 8, 4 or 2
    bytes), from which each block's shift is :func:`copy_shift`, and ``span``, the columns a
    tile spans, head_dim plus the largest shift (``copied_span`` on the C side)."""

    modulus: int
    span: int


def copy_plan(q: torch.Tensor) -> CopyPlan:
    """The copied-rows view's plan for ``q`` (the tensors of its shape and dtype land at q's
    shifts). Every row of a head is congruent to its row 0 modulo the largest power of two up
    to 16 that divides the row stride in bytes, so with that modulus each of q's rows is
    copied in pieces that wide. A smaller modulus keeps the shift from carrying the head into
    a wider tile than the head_dim alone needs (it would double the products at 128 or 256),
    at the price of narrower pieces; at 2 the shift is 0. The residues of b·sb and h·sh
    repeat within 8 steps, so the first 8 batches and heads show every shift."""
    batch, _, heads, head_dim = q.shape
    stride_b, stride_t, stride_h = (2 * s for s in q.stride()[:3])
    modulus = COPY_MAX_PIECE
    while modulus > 2 and stride_t % modulus:
        modulus //= 2
    while True:
        shift = max(copy_shift(q.data_ptr() + b * stride_b + h * stride_h, modulus)
                    for b in range(min(batch, 8)) for h in range(min(heads, 8)))
        span = head_dim + shift
        if modulus == 2 or (span <= WGMMA_WIDTHS[-1] and padded_head_dim(span) == padded_head_dim(head_dim)):
            return CopyPlan(modulus, span)
        modulus //= 2


def row_pieces(source: int, first: int, last: int) -> Tuple[Tuple[int, int], ...]:
    """The pieces ``sm90::load_head_row<true>`` stores one row in, as (tile byte, bytes):
    tile bytes [first, last) of the row, whose tile byte x is the source byte ``source + x``.
    Each piece is the widest of :data:`COPY_PIECES` that divides both its tile offset and
    its source address and fits before ``last``, else 2 bytes (a row's last, at a multiple
    of 4, by a 4-byte cp.async whose other 2 bytes are zero-filled; any other by a plain
    load and store). A row whose source is 2 bytes
    off the tile's 4-byte words is stored as whole tile words instead, from ``first``
    rounded down to a multiple of 4 to ``last`` rounded up, each from two aligned source
    words (:func:`permuted_words`), its halves outside [first, last) zero."""
    align = COPY_MAX_PIECE
    while align > 2 and source % align:
        align //= 2
    if align == 2:
        return tuple((x, 4) for x in range(first & ~3, (last + 3) & ~3, 4))
    pieces, x = [], first
    while x < last:
        width = next((w for w in COPY_PIECES if w <= align and x % w == 0 and x + w <= last), 2)
        pieces.append((x, width))
        x += width
    return tuple(pieces)


def permuted_words(source: int, first: int, last: int) -> Tuple[int, ...]:
    """The aligned 4-byte source words ``sm90::copy_row_permuted`` reads for a row whose
    source is 2 bytes off the tile's words: the word at ``source + y − 2`` for each multiple
    of 4, y, from ``first`` rounded down to ``last`` rounded up, whose bytes meet the head's,
    [source + first, source + last). Tile word y takes the upper half of word y and the
    lower half of word y + 4."""
    return tuple(source + y - 2 for y in range(first & ~3, ((last + 3) & ~3) + 1, 4) if y + 2 > first and y - 2 < last)


def backward_geometries(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor) -> Tuple[TmaGeometry, ...]:
    """The TMA views of q, k, v, dout (bf16 or fp16 ``[B, T, H, D]``) that both
    backward passes' wgmma kernels read: boxes of 64 columns by 64 rows."""
    return tuple(tma_geometry(t, BACKWARD_BOX_ROWS) for t in (q, k, v, dout))


# ------------------------------------------------------------------ forward


def _library() -> ctypes.CDLL:
    library = _build.load_library("flash_attention")
    wgmma, simt = library.hm_flash_forward_wgmma, library.hm_flash_forward_simt
    if wgmma.argtypes is None:
        geometry = ctypes.POINTER(ctypes.c_longlong)
        # q, k, v, out, lse; dtype, B, T, H, D; geometries of q, k, v; out's strides; causal, scale, stream
        wgmma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [geometry] * 3 + [ctypes.c_longlong] * 3
                          + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        wgmma.restype = ctypes.c_int
        # q, k, v, out, lse; dtype, B, T, H, D; strides of q, k, v, out; causal, scale, stream
        # tf32x3: the same arguments as SIMT; copied: and the shift modulus before causal
        copied = library.hm_flash_forward_copied
        for fn, extra in ((simt, []), (library.hm_flash_forward_tf32x3, []), (copied, [ctypes.c_int])):
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + extra
                           + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return library


def tf32x3_takes(q: torch.Tensor) -> bool:
    """Whether the 3xTF32 kernels (one for each pass) take ``q``: fp32 at a head_dim
    from 16 to 128 that is a multiple of 4."""
    head_dim = q.shape[-1]
    low, high = TF32X3_HEAD_DIMS
    return q.dtype == torch.float32 and low <= head_dim <= high and head_dim % TF32X3_ALIGN == 0


def flash_route(q: torch.Tensor, which: str = "forward") -> str:
    """Which design runs the pass ``which`` ("forward", "dq" or "dkv") on ``q`` (and
    the tensors of its shape and dtype): ``"wgmma"`` in every pass for bf16 and fp16
    at a head_dim from 16 to 256 that TMA reads, a multiple of 8 (the 4-D view) or any
    other whose H·D is a multiple of 8 and whose :func:`tma_span` is at most 256 (the
    packed-heads view); on every other bf16 or fp16 head_dim from 1 to 256
    (:func:`copied_rows`), ``"wgmma"`` for the forward and the dK/dV pass and ``"simt"``
    for the dQ pass; ``"tf32x3"`` for fp32 where :func:`tf32x3_takes`; ``"simt"``
    otherwise."""
    if which not in PASSES:
        raise ValueError(f"flash_route answers for {PASSES}, got {which!r}")
    head_dim = q.shape[-1]
    if tf32x3_takes(q):
        return "tf32x3"
    if copied_rows(q):
        return "simt" if which == "dq" else "wgmma"
    if q.dtype not in WGMMA_DTYPES or not WGMMA_MIN_HEAD_DIM <= head_dim <= WGMMA_WIDTHS[-1]:
        return "simt"
    return "wgmma"


def flash_routes(q: torch.Tensor) -> str:
    """Each pass's route, as the labels print it: ``forward=wgmma dq=wgmma dkv=wgmma``."""
    return " ".join(f"{which}={flash_route(q, which)}" for which in PASSES)


def _tma_aligned(t: torch.Tensor) -> bool:
    """What TMA needs of a 16-bit view: a 16-byte aligned base and batch and time
    strides that are multiples of 8 elements; a head stride that is one too (the 4-D
    view), or, at a head_dim that is not a multiple of 8, the head_dim itself (the
    packed-heads view)."""
    stride_b, stride_t, stride_h, _ = t.stride()
    head_ok = stride_h == t.shape[-1] if packed_heads(t.shape[-1]) else stride_h % 8 == 0
    return t.data_ptr() % 16 == 0 and stride_b % 8 == 0 and stride_t % 8 == 0 and head_ok


def _vector_aligned(t: torch.Tensor) -> bool:
    """What the tf32x3 kernels' 16-byte loads need of an fp32 view: a 16-byte aligned
    base and batch, time and head strides that are multiples of 4 elements."""
    stride_b, stride_t, stride_h, _ = t.stride()
    return t.data_ptr() % 16 == 0 and not (stride_b | stride_t | stride_h) % TF32X3_ALIGN


def needs_copy(t: torch.Tensor) -> bool:
    """Whether the kernels must read a contiguous copy of ``t`` rather than ``t``
    through its strides: a head dim that is not contiguous, or a view that a pass
    reading it by TMA cannot take (an unaligned base or stride, or heads not packed
    in the row at a head_dim that is not a multiple of 8), or by 16-byte loads (the
    tf32x3 passes: an unaligned base or stride). Every input a wgmma or tf32x3 pass
    takes, the forward takes on the same route. The copied-rows view reads any 16-bit
    view whose head dim is contiguous through its strides (each row's pieces follow its
    own alignment), as the SIMT dQ pass beside it does."""
    route = flash_route(t, "forward")
    return (t.stride(-1) != 1 or (route == "wgmma" and not copied_rows(t) and not _tma_aligned(t))
            or (route == "tf32x3" and not _vector_aligned(t)))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides, else a
    contiguous copy in a fresh allocation (a fused projection's unaligned slice,
    or a gradient from autograd that is broadcast or misaligned; ``contiguous()``
    would return a contiguous view with an unaligned base as it is)."""
    return t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t


def flash_refusal(q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> Optional[Tuple[type, str]]:
    """Why no flash kernel can take ``q`` and ``others`` (named tensors of q's
    shape), as ``(exception type, message)``, or None when one can (after a copy,
    where :func:`needs_copy` says so: a fresh copy is 16-byte aligned, with its
    heads packed). It reads shapes and dtypes only, so it answers for ``meta``
    tensors too; the caller tests the device. The grid is checked against each
    pass's block rows, the finest the tightest."""
    for name, tensor in others:
        if tensor.dtype != q.dtype:
            return TypeError, f"q, k, v must share a dtype; {name} is {tensor.dtype}, q is {q.dtype}"
    if q.dtype not in SIMT_DTYPES:
        return TypeError, f"the flash kernels take bfloat16, float16 or float32, got {q.dtype}"
    batch, seq, heads, head_dim = q.shape
    if not 0 < head_dim <= SIMT_MAX_HEAD_DIM:
        return ValueError, f"the flash kernels take head_dim 1 to {SIMT_MAX_HEAD_DIM}, got {head_dim}"
    rows = min(_block_rows(q, which) for which in PASSES)  # every pass's grid, the finest the tightest
    if batch * heads >= 2**31 or -(-seq // rows) > _MAX_ROW_TILES:
        return ValueError, f"shape {tuple(q.shape)} exceeds the kernels' grid (B*H < 2^31, T <= {rows * _MAX_ROW_TILES})"
    return None


def tf32x3_block_rows(head_dim: int, which: str) -> int:
    """Rows a block of a tf32x3 pass owns: the forward's and the dQ pass's query rows,
    128 (two warpgroups) up to a head_dim of 64 and 64 above; the dK/dV pass's 64 KV
    rows."""
    return 128 if which != "dkv" and head_dim <= 64 else 64


def _block_rows(q: torch.Tensor, which: str) -> int:
    """Rows (of the grid's row dimension) a block of the pass ``which`` owns."""
    route = flash_route(q, which)
    if route == "simt":
        return SIMT_ROWS
    if route == "tf32x3":
        return tf32x3_block_rows(q.shape[-1], which)
    if which != "dkv":
        return FORWARD_TILE_ROWS
    return dkv_block_rows(copy_plan(q).span if copied_rows(q) else tma_span(q.shape[-1], q.shape[-2]))


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
    route = flash_route(q, "forward")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma" and copied_rows(q):  # the strides, and where the heads land
            status = library.hm_flash_forward_copied(
                *pointers, SIMT_DTYPES[q.dtype], batch, seq, heads, head_dim, *_strides(q, k, v, out),
                copy_plan(q).modulus, int(causal), head_dim ** -0.5, stream,
            )
        elif route == "wgmma":
            rows = forward_box_rows(tma_span(head_dim, heads))
            status = library.hm_flash_forward_wgmma(
                *pointers, SIMT_DTYPES[q.dtype], batch, seq, heads, head_dim,
                *(tma_geometry(t, rows).as_ctypes() for t in (q, k, v)), *out.stride()[:3],
                int(causal), head_dim ** -0.5, stream,
            )
        else:  # simt or tf32x3: the strides
            status = getattr(library, f"hm_flash_forward_{route}")(
                *pointers, SIMT_DTYPES[q.dtype], batch, seq, heads, head_dim, *_strides(q, k, v, out),
                int(causal), head_dim ** -0.5, stream,
            )
    _build.check_launch(library, status, "flash_attention_lse")
    _count_launch(flash_attention_lse, q, "forward")
    return out, lse


class LaunchCount:
    """A launch count read and reset as a wrapper's ``.launches``: a wrapper's
    ``.packed`` counts its launches on the packed-heads view, ``.copied`` (the forward,
    dK/dV) those on the copied-rows view, ``.tf32x3`` those of its 3xTF32 kernel,
    ``.simt`` (dQ) those of its SIMT kernel."""

    def __init__(self):
        self.launches = 0


def _count_launch(wrapper, q: torch.Tensor, which: str) -> None:
    """One launch of ``wrapper``'s kernel (the pass ``which``) on q: in ``.launches``;
    in ``.packed.launches`` when it read the packed-heads view (a wgmma kernel at a
    head_dim that is not a multiple of 8 with a TMA view), in ``.copied.launches`` when it
    read the copied-rows view; in ``.tf32x3.launches`` or ``.simt.launches`` where the
    wrapper counts that route."""
    wrapper.launches += 1
    route = flash_route(q, which)
    if route == "wgmma" and copied_rows(q):
        wrapper.copied.launches += 1
    elif route == "wgmma" and packed_heads(q.shape[-1]):
        wrapper.packed.launches += 1
    counted = getattr(wrapper, route, None)  # the route's own count, where the wrapper keeps one
    if isinstance(counted, LaunchCount):
        counted.launches += 1


flash_attention_lse.launches = 0
flash_attention_lse.packed = LaunchCount()
flash_attention_lse.copied = LaunchCount()
flash_attention_lse.tf32x3 = LaunchCount()


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
    if library.hm_flash_backward_dq_wgmma.argtypes is None:
        # each: q, k, v, dout, lse, delta, its outputs (dq, or dk and dv); its dtype
        # code; B, T, H, D; then the layout: SIMT, the strides of q, k, v, dout and of
        # the outputs; wgmma, the geometries of q, k, v, dout and the outputs'
        # strides; causal, scale, stream
        # (the copied-rows dK/dV pass: SIMT's, and the shift modulus)
        simt_layout = [ctypes.c_longlong] * 15
        wgmma_layout = [ctypes.POINTER(ctypes.c_longlong)] * 4 + [ctypes.c_longlong] * 3
        for name, outputs, layout in (("dq_simt", 1, simt_layout), ("dkv_simt", 2, simt_layout),
                                      ("dq_wgmma", 1, wgmma_layout), ("dkv_wgmma", 2, wgmma_layout),
                                      ("dq_tf32x3", 1, simt_layout), ("dkv_tf32x3", 2, simt_layout),
                                      ("dkv_copied", 2, simt_layout + [ctypes.c_int])):
            fn = getattr(library, f"hm_flash_backward_{name}")
            fn.argtypes = ([ctypes.c_void_p] * (6 + outputs) + [ctypes.c_int] * 5 + layout
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
    """Launch the pass ``name`` ("dq" or "dkv") on its route for q on the pointers
    of q, k, v, dout, lse, delta and ``outputs``: wgmma reads the four TMA views
    ``geometries`` (:func:`backward_geometries` when None), or on the copied-rows view
    the strides and :func:`copy_plan`'s modulus; SIMT and tf32x3 the strides."""
    route = flash_route(q, name)
    if route == "wgmma" and copied_rows(q):
        route, layout = "copied", (*_strides(q, k, v, dout, outputs[0]), copy_plan(q).modulus)
    elif route == "wgmma":
        if geometries is None:
            geometries = backward_geometries(q, k, v, dout)
        layout = (*(g.as_ctypes() for g in geometries), *outputs[0].stride()[:3])
    else:
        layout = _strides(q, k, v, dout, outputs[0])
    entry = f"hm_flash_backward_{name}_{route}"
    library = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = getattr(library, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outputs), SIMT_DTYPES[q.dtype], *q.shape, *layout, int(causal), q.shape[-1] ** -0.5,
            stream,
        )
    _build.check_launch(library, status, entry)


def flash_attention_backward_dq(q, k, v, dout, lse, delta, causal: bool = False,
                                geometries: Optional[Tuple[TmaGeometry, ...]] = None) -> torch.Tensor:
    """The dQ pass (``_flash_bwd_dq_kernel``): ``dq`` in q's dtype. ``geometries``:
    the inputs' TMA views, if the caller has them already (read on the wgmma
    route only)."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, causal)
    _check_backward_inputs(q, k, v, dout, lse, delta)
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    _launch_pass("dq", q, k, v, dout, lse, delta, (dq,), causal, geometries)
    _count_launch(flash_attention_backward_dq, q, "dq")
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
    _count_launch(flash_attention_backward_dkv, q, "dkv")
    return dk, dv


flash_attention_backward_dq.launches = 0
flash_attention_backward_dkv.launches = 0
flash_attention_backward_dq.packed = LaunchCount()
flash_attention_backward_dkv.packed = LaunchCount()
flash_attention_backward_dkv.copied = LaunchCount()
flash_attention_backward_dq.simt = LaunchCount()
flash_attention_backward_dq.tf32x3 = LaunchCount()
flash_attention_backward_dkv.tf32x3 = LaunchCount()


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``(out, lse)`` and the cotangent ``dout``
    (cast to q's dtype first, as the JAX package's ``_flash_bwd``): the dQ kernel,
    then the dK/dV kernel, on their route; ``δ`` and, when they run wgmma, the TMA
    views the wgmma passes read are computed here, once, and handed to both."""
    dout = dout.to(q.dtype)
    if _on_cpu(q, k, v, out, lse, dout):
        return flash_attention_backward_plain(q, k, v, out, lse, dout, causal)
    q, k, v, dout = (_kernel_layout(t) for t in (q, k, v, dout))
    delta = _delta(out, dout)
    geometries = backward_geometries(q, k, v, dout) if flash_route(q, "dq") == "wgmma" else None
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
