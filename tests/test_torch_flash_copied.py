"""The copied-rows view of the wgmma flash forward and dK/dV pass, on the CPU.

bf16 and fp16 inputs that no TMA view takes (a head dim below 16, or one that is not a
multiple of 8 whose H·D is not one either or whose packed span passes 256) run the forward
and the dK/dV pass on the tensor cores, their producer copying every tile a head's bytes at
a time (``csrc/sm90.cuh``, ``load_head_row<true>``); the dQ pass stays on SIMT. Here: the
routes and launches on meta tensors, the Python mirror of the copy's plan and pieces held to
hand-worked cases and, by ``hypothesis``, to what the kernels need of every piece; and the
plain versions, which ``chip_smoke.py`` holds the kernels to on the card, against the JAX
package's Pallas kernels in interpret mode at those head dims."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from hivemind_tpu.ops.pallas_attention import _flash_backward as jax_flash_backward
from hivemind_tpu.ops.pallas_attention import _flash_forward as jax_flash_forward
from hivemind_tpu_torch.ops import flash_attention as flash_module
from hivemind_tpu_torch.ops.flash_attention import (
    COPY_PIECES,
    CopyPlan,
    copied_rows,
    copy_plan,
    copy_shift,
    flash_attention_backward,
    flash_attention_backward_dkv,
    flash_attention_backward_dq,
    flash_attention_backward_plain,
    flash_attention_lse,
    flash_attention_plain,
    flash_routes,
    padded_head_dim,
    permuted_words,
    row_pieces,
)

torch.set_num_threads(1)


def _meta(shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _offset(shape, elements: int, dtype=torch.bfloat16) -> torch.Tensor:
    """A contiguous meta view whose base lies ``elements`` elements into its storage."""
    return torch.empty(int(np.prod(shape)) + elements, dtype=dtype, device="meta")[elements:].view(shape)


# ------------------------------------------------------------------ the plan


# a view -> its plan, worked out by hand (2 bytes an element): the modulus is the largest power
# of two up to 16 dividing the row stride in bytes, the shift (address of a head's row 0 mod the
# modulus) / 2, the span head_dim + the largest shift, unless that would pad the head wider
@pytest.mark.parametrize("make, plan", [
    (lambda: _meta((2, 1000, 5, 20)), CopyPlan(8, 20)),  # rows of 200 bytes; heads 40 apart: shift 0
    (lambda: _offset((2, 64, 5, 20), 1), CopyPlan(8, 21)),  # 2 bytes into its storage: every head at column 1
    (lambda: _meta((2, 64, 3, 21), torch.float16), CopyPlan(2, 21)),  # rows of 126 bytes: 2-byte pieces, no shift
    (lambda: _meta((2, 64, 4, 8)), CopyPlan(16, 8)),  # rows of 64 bytes, heads 16 apart
    (lambda: _offset((1, 64, 3, 100), 3), CopyPlan(8, 103)),  # rows of 600 bytes, 6 bytes in: column 3
    # rows of 2032 bytes, heads 508 apart: mod 16 the heads land at 0, 6, 4, 2 (a span of 260), mod 8 at 0, 2
    (lambda: _meta((2, 64, 4, 254), torch.float16), CopyPlan(8, 256)),
    # a slice 14 bytes into rows of 256: column 7 (69 > 64), 3 (65 > 64), then 1 under a modulus of 4
    (lambda: _meta((1, 64, 1, 128))[..., 7:69], CopyPlan(4, 63)),
], ids=["d20_hd100", "d20_offset", "fp16_d21", "d8", "d100_offset", "fp16_d254", "d62_narrowed"])
def test_copy_plan_worked_by_hand(make, plan):
    q = make()
    assert copied_rows(q) and copy_plan(q) == plan
    assert padded_head_dim(plan.span) == padded_head_dim(q.shape[-1])  # never a wider tile than the head's own


# (source, first, last) -> the pieces (tile byte, bytes) of one row, worked out by hand
@pytest.mark.parametrize("source, first, last, pieces", [
    (0, 0, 40, ((0, 16), (16, 16), (32, 8))),  # head dim 20, aligned as the tile
    (8, 0, 40, ((0, 8), (8, 8), (16, 8), (24, 8), (32, 8))),  # the source 8-byte aligned: 8-byte pieces
    (0, 6, 46, ((6, 2), (8, 8), (16, 16), (32, 8), (40, 4), (44, 2))),  # shift 3: the ends narrow
    (4, 2, 44, ((2, 2),) + tuple((x, 4) for x in range(4, 44, 4))),  # 4-byte aligned source, shift 1
    (16, 0, 16, ((0, 16),)),  # head dim 8
    # a source 2 bytes off the tile's words: whole tile words, the last one's upper half zero
    (2, 0, 42, tuple((x, 4) for x in range(0, 44, 4))),
    (6, 2, 44, tuple((x, 4) for x in range(0, 44, 4))),  # shift 1: the first word's lower half zero
], ids=["aligned", "source_8", "shift_3", "source_4", "d8", "source_2", "source_2_shift_1"])
def test_row_pieces_worked_by_hand(source, first, last, pieces):
    assert row_pieces(source, first, last) == pieces


# (source, first, last) -> the aligned source words a row 2 bytes off the tile's words reads
@pytest.mark.parametrize("source, first, last, words", [
    (2, 0, 42, tuple(range(0, 44, 4))),  # tile bytes [-2, 2) to [38, 42): the head's 42 bytes, no word past them
    (6, 2, 44, tuple(range(8, 52, 4))),  # [2, 6) to [42, 46): the word before the head's first byte is not read
], ids=["source_2", "source_2_shift_1"])
def test_permuted_words_worked_by_hand(source, first, last, words):
    assert permuted_words(source, first, last) == words


def _head_row(t: torch.Tensor, b: int, h: int, r: int) -> int:
    """The byte address of row r of head h of batch b of a 16-bit [B, T, H, D] view."""
    stride_b, stride_t, stride_h, _ = t.stride()
    return t.data_ptr() + 2 * (b * stride_b + r * stride_t + h * stride_h)


@st.composite
def _copied_inputs(draw):
    """q, k, v as meta views of one storage each: any batch, heads and head dim the copied-rows
    view takes, each tensor with its own padding of the row and of the head stride (rows
    possibly not packed) and its own base offset in elements."""
    batch, heads = draw(st.integers(1, 12)), draw(st.integers(1, 12))
    # any head dim, and often one just below a padded width, where a shift could carry it past
    head_dim = draw(st.one_of(st.integers(1, 256), st.integers(57, 63), st.integers(121, 127),
                              st.integers(249, 255)))
    dtype = draw(st.sampled_from([torch.bfloat16, torch.float16]))
    tensors = []
    for _ in range(3):
        head_stride = head_dim + draw(st.integers(0, 9))
        row = heads * head_stride + draw(st.integers(0, 9))
        seq, offset = 2, draw(st.integers(0, 15))
        storage = torch.empty(offset + batch * seq * row, dtype=dtype, device="meta")
        tensors.append(storage.as_strided((batch, seq, heads, head_dim), (seq * row, row, head_stride, 1), offset))
    return tensors


@settings(max_examples=200, deadline=None)
@given(_copied_inputs())
def test_every_piece_is_aligned_on_both_sides_and_covers_the_head_alone(tensors):
    """For every block (b, h) and row of q, k and v: each piece of ``row_pieces`` starts at a
    multiple of its width in the tile and in the source (cp.async's rule; 2-byte pieces are
    plain loads), the pieces cover the tile bytes [2s, 2s + 2·D) once each and so read the
    head's 2·D bytes and no neighbour's; a row 2 bytes off the tile's words is stored as
    whole tile words from aligned source words that each hold some of the head's bytes, and
    every half inside the head's bytes has its word read; q's rows start as aligned as the
    modulus (so their pieces are that wide where the tile allows); and the span (the C
    side's, over the first 8 batches and heads) is the largest shift over every block and
    stays at 256 or below."""
    q = tensors[0]
    assume(copied_rows(q))
    batch, seq, heads, head_dim = q.shape
    plan = copy_plan(q)
    assert plan.modulus in (2, 4, 8, 16) and plan.span <= 256
    assert padded_head_dim(plan.span) == padded_head_dim(head_dim)
    shifts = [copy_shift(_head_row(q, b, h, 0), plan.modulus) for b in range(batch) for h in range(heads)]
    assert plan.span == head_dim + max(shifts)  # 8 batches and 8 heads show every shift
    for b in range(batch):
        for h in range(heads):
            shift = copy_shift(_head_row(q, b, h, 0), plan.modulus)
            first, last = 2 * shift, 2 * (shift + head_dim)
            for which, t in enumerate(tensors):
                for r in range(seq):
                    row = _head_row(t, b, h, r)
                    line = row - first  # where the tile's byte 0 would lie
                    pieces = row_pieces(line, first, last)
                    if line % 4 == 2:  # whole tile words, each from two aligned source words
                        assert pieces == tuple((y, 4) for y in range(first & ~3, (last + 3) & ~3, 4))
                        words = permuted_words(line, first, last)
                        assert all(w % 4 == 0 and w + 4 > row and w < row + 2 * head_dim for w in words)
                        # tile bytes [y, y + 2) come from the word at line + y - 2, [y + 2, y + 4) from line + y + 2
                        assert all(line + y - 2 + 2 * half in words
                                   for y, _ in pieces for half in (0, 2) if first <= y + half < last)
                        continue
                    x = first
                    for start, width in pieces:
                        assert start == x and width in (*COPY_PIECES, 2)
                        assert start % width == 0 and (line + start) % width == 0
                        x += width
                    assert x == last  # the head's bytes, [row, row + 2·D), and nothing else
                    if which == 0:  # q's rows: as aligned as the modulus
                        assert line % plan.modulus == 0


# ------------------------------------------------------------------ routes and launches


@pytest.fixture
def recorded_launches(monkeypatch):
    """The wrappers on meta tensors, with the kernels' C entry points recorded instead of
    called: ``calls`` collects (entry point, arguments)."""
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(flash_module, "_check_cuda_inputs", lambda *tensors: None)
    monkeypatch.setattr(flash_module, "_library", Library)
    monkeypatch.setattr(flash_module, "_bwd_library", Library)
    monkeypatch.setattr(flash_module._build, "check_launch", lambda library, status, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("Stream", (), {"cuda_stream": 7})())
    for wrapper, routes in ((flash_attention_lse, ("packed", "copied", "tf32x3")),
                            (flash_attention_backward_dq, ("packed", "simt", "tf32x3")),
                            (flash_attention_backward_dkv, ("packed", "copied", "tf32x3"))):
        monkeypatch.setattr(wrapper, "launches", 0)
        for route in routes:
            monkeypatch.setattr(wrapper, route, flash_module.LaunchCount())
    return calls


def test_copied_view_launches_its_entries_through_the_strides_and_counts_them(recorded_launches):
    """bf16 [2, 96, 5, 20] sliced from a fused [B, T, 3, H, D] projection (H·D = 100: no TMA
    view): the forward launches ``hm_flash_forward_copied`` and the backward the SIMT dQ pass
    and ``hm_flash_backward_dkv_copied``, each with the views' B, T, H strides in elements
    (no copy, no TMA geometry) and the plan's modulus; each counts once on its view."""
    fused = _meta((2, 96, 3, 5, 20))
    q, k, v = fused.unbind(2)  # T stride 300: rows of 600 bytes, modulus 8
    assert flash_routes(q) == "forward=wgmma dq=simt dkv=wgmma" and copy_plan(q) == CopyPlan(8, 20)
    out, lse = flash_attention_lse(q, k, v, causal=True)
    flash_attention_backward(q, k, v, out, lse, _meta((2, 96, 5, 20)), causal=True)
    assert [name for name, _ in recorded_launches] == [
        "hm_flash_forward_copied", "hm_flash_backward_dq_simt", "hm_flash_backward_dkv_copied"]
    forward = recorded_launches[0][1]
    assert forward[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())  # read where they lie
    assert forward[5:10] == (1, 2, 96, 5, 20)  # dtype code (bf16), B, T, H, D
    assert forward[10:22] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    assert forward[22:24] == (8, 1)  # the modulus, causal
    dkv = recorded_launches[2][1]
    assert dkv[8:13] == (1, 2, 96, 5, 20) and dkv[13:16] == q.stride()[:3] and dkv[28:30] == (8, 1)
    counts = [(flash_attention_lse.launches, flash_attention_lse.copied.launches, flash_attention_lse.packed.launches),
              (flash_attention_backward_dq.launches, flash_attention_backward_dq.simt.launches,
               flash_attention_backward_dq.packed.launches),
              (flash_attention_backward_dkv.launches, flash_attention_backward_dkv.copied.launches,
               flash_attention_backward_dkv.packed.launches)]
    assert counts == [(1, 1, 0), (1, 1, 0), (1, 1, 0)]


@pytest.mark.parametrize("make, modulus", [
    (lambda: _offset((2, 64, 5, 20), 1), 8),  # one element off 16-byte alignment
    (lambda: _meta((2, 64, 3, 21), torch.float16), 2),
    (lambda: _meta((2, 64, 4, 8)), 16),
    (lambda: _meta((1, 64, 4, 254), torch.float16), 8),
], ids=["unaligned_d20", "fp16_d21", "d8", "fp16_d254"])
def test_copied_view_reads_each_input_where_it_lies(recorded_launches, make, modulus):
    """No copy on the copied-rows view, an unaligned base included: the forward's pointers
    are the inputs', with the plan's modulus."""
    q = make()
    flash_attention_lse(q, q, q)
    (name, args), = recorded_launches
    assert name == "hm_flash_forward_copied" and args[0] == q.data_ptr() and args[22] == modulus
    assert flash_attention_lse.copied.launches == 1 and flash_attention_lse.packed.launches == 0


# ------------------------------------------------------------------ parity with the JAX kernels


def _ulp_excess(ours: torch.Tensor, theirs, mantissa_bits: int) -> float:
    """How far past one ulp (of the JAX value, in a type with ``mantissa_bits``) ours lies."""
    ours, theirs = ours.float().numpy(), np.asarray(theirs, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(theirs), 2.0**-126))) - mantissa_bits)
    return float((np.abs(ours - theirs) - ulp).max())


# (heads, head_dim, dtype): H·D = 100 in bf16, H·D = 63 in fp16 (rows 2-byte aligned), head dim 8
COPIED_CASES = [(5, 20, jnp.bfloat16), (3, 21, jnp.float16), (4, 8, jnp.bfloat16)]
MANTISSA = {jnp.bfloat16: 7, jnp.float16: 10}


@pytest.mark.parametrize("heads, head_dim, dtype", COPIED_CASES, ids=["bf16_hd100", "fp16_hd63", "bf16_d8"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200])  # 200: a ragged tail block
def test_plain_forward_matches_jax_kernel_on_copied_inputs(seq, causal, heads, head_dim, dtype):
    """The plain forward against the JAX kernel in interpret mode on the 16-bit inputs the
    copied-rows view reads: both cast to fp32, sum in another order and round the output
    once, so each element agrees within one ulp of the type plus that order's noise near
    zero (1e-6); lse (fp32) within 1e-5, as the fp16 parity test's."""
    rng = np.random.RandomState(seq + head_dim + causal)
    q, k, v = (jnp.asarray(rng.randn(2, seq, heads, head_dim), dtype) for _ in range(3))
    out_j, lse_j = jax_flash_forward(q, k, v, causal=causal, interpret=True)
    to_torch = lambda a: torch.from_numpy(np.array(a, np.float32)).to(  # noqa: E731
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float16)
    out_t, lse_t = flash_attention_plain(to_torch(q), to_torch(k), to_torch(v), causal)
    assert copied_rows(out_t) and out_t.dtype == to_torch(q).dtype
    assert _ulp_excess(out_t, out_j, MANTISSA[dtype]) <= 1e-6
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads, head_dim, dtype", COPIED_CASES, ids=["bf16_hd100", "fp16_hd63", "bf16_d8"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200])
def test_plain_backward_matches_jax_backward_kernels_on_copied_inputs(seq, causal, heads, head_dim, dtype):
    """The plain backward against the JAX package's two passes in interpret mode, from the
    same (out, lse) and a non-uniform cotangent, on the copied-rows view's inputs: dq, dk, dv
    within one ulp of the type plus 1e-6, as the bf16 and fp16 parity tests hold them."""
    rng = np.random.RandomState(seq + head_dim + 2 * causal)
    q, k, v = (jnp.asarray(rng.randn(1, seq, heads, head_dim), dtype) for _ in range(3))
    dout = jnp.asarray(rng.randn(1, seq, heads, head_dim) * np.cos(np.arange(head_dim)), dtype)
    out, lse = jax_flash_forward(q, k, v, causal=causal, interpret=True)
    expected = jax_flash_backward(q, k, v, out, lse, dout, causal=causal, interpret=True)
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float16
    args = [torch.from_numpy(np.array(a, np.float32)) for a in (q, k, v, out, lse, dout)]
    args = [a.to(torch_dtype) if i != 4 else a for i, a in enumerate(args)]  # lse stays fp32
    got = flash_attention_backward_plain(*args, causal)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, expected):
        assert ours.dtype == torch_dtype and ours.shape == tuple(q.shape)
        assert _ulp_excess(ours, theirs, MANTISSA[dtype]) <= 1e-6, name
