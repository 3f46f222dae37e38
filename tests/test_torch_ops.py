"""PyTorch port vs JAX package: the ops that hold a kernel, on the CPU.

The port's wrappers, given CPU tensors, run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do. Inputs
come from numpy seeds and are handed to both. The CUDA kernels themselves are
held to these plain versions on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize  # noqa: F401  (see the note below the imports)
import torch

from hivemind_tpu.ops.pallas_attention import _flash_backward as jax_flash_backward
from hivemind_tpu.ops.pallas_attention import _flash_forward as jax_flash_forward
from hivemind_tpu.ops.pallas_attention import flash_attention_lse as jax_flash_attention_lse
from hivemind_tpu.ops.pallas_quantization import pallas_blockwise_dequantize, pallas_blockwise_quantize
from hivemind_tpu.ops.quantized_params import quantize_params as jax_quantize_params
from hivemind_tpu.ops.quantized_params import tree_param_bytes as jax_tree_param_bytes
from hivemind_tpu.parallel.ring_attention import plain_attention as jax_plain_attention
from hivemind_tpu_torch.ops import flash_attention as flash_module
from hivemind_tpu_torch.ops.blockwise_int8 import blockwise_int8_dequantize, blockwise_int8_quantize
from hivemind_tpu_torch.ops.flash_attention import (
    BACKWARD_BOX_ROWS,
    FORWARD_TILE_ROWS,
    PASSES,
    FlashAttentionFunction,
    TmaGeometry,
    attention_auto,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_dkv,
    flash_attention_backward_dq,
    flash_attention_backward_plain,
    flash_attention_lse,
    flash_refusal,
    dkv_block_rows,
    flash_route,
    flash_routes,
    forward_box_rows,
    needs_copy,
    padded_head_dim,
    tma_geometry,
    tma_span,
)
from hivemind_tpu_torch.ops.quantized_params import (
    QuantizedTensor,
    dequantize_tree,
    quantize_params,
    tree_param_bytes,
)
from hivemind_tpu_torch.parallel.ring_attention import plain_attention

# the shapes are tiny: one intra-op thread is enough, and it leaves the cores to
# the timing-sensitive swarm tests that share the machine with this file
torch.set_num_threads(1)

# The JAX package's averager imports scipy.optimize lazily, on its event loop, in
# the middle of an all-reduce round (averaging/load_balancing.py). Cold, that
# import outlasts the round's timeouts, so whether a swarm test such as
# test_averaging.py::test_averaging_basic_group passed hung on which files had run
# before it in the same process. Every process collects this file, so the import
# at its top leaves scipy.optimize loaded before any test runs.

# ------------------------------------------------------------------ flash attention


@pytest.mark.parametrize("head_dim", [16, 32, 80, 256, 26])  # 80: Phi-2's, 256: Gemma-7B's, 26: TinyBERT's
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200])  # 200: a ragged tail block
def test_flash_plain_matches_jax_kernel_and_plain(seq, causal, head_dim):
    """fp32 parity at tests/test_models_parallel.py's tolerances: 2e-5 on out,
    1e-5 on lse."""
    rng = np.random.RandomState(seq + head_dim + causal)
    q, k, v = (rng.randn(2, seq, 4, head_dim).astype(np.float32) for _ in range(3))
    out_j, lse_j = jax_flash_attention_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, True)
    exact = jax_plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out_t, lse_t = flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert out_t.dtype == torch.float32 and lse_t.shape == (2, 4, seq)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(exact), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal).numpy(), out_t.numpy()
    )


@pytest.mark.parametrize("head_dim", [16, 64, 80, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200])  # 200: a ragged tail block
def test_flash_backward_plain_matches_jax_backward_kernels(seq, causal, head_dim):
    """The plain backward against the JAX package's two Pallas passes in interpret
    mode, from the same (out, lse) and a non-uniform cotangent: fp32, at
    tests/test_models_parallel.py's gradient tolerances (rtol 2e-4, atol 2e-5).
    Measured: max abs error <= 9.6e-7, at most 0.021 of an element's limit."""
    rng = np.random.RandomState(seq + head_dim + 2 * causal)
    q, k, v = (rng.randn(1, seq, 2, head_dim).astype(np.float32) for _ in range(3))
    dout = (rng.randn(1, seq, 2, head_dim) * np.cos(np.arange(head_dim))).astype(np.float32)
    out, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    expected = jax_flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse, jnp.asarray(dout),
                                  causal=causal, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, dout)]
    got = flash_attention_backward_plain(*args, causal)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in flash_attention_backward(*args, causal)]),
                                  np.stack([g.numpy() for g in got]))  # CPU tensors take the plain version
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, expected):
        assert ours.dtype == torch.float32 and ours.shape == q.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("head_dim", [20, 26])  # 26: TinyBERT's; both on the packed-heads view at H = 4
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200])
def test_flash_backward_plain_matches_jax_backward_kernels_in_bf16(seq, causal, head_dim):
    """The plain backward against the JAX package's two Pallas passes in interpret mode on
    bf16 inputs at head dims that are not a multiple of 8, where H·D is (the inputs every
    wgmma pass reads through the packed-heads view, whose kernels are held to this plain
    version on the card): both sum in fp32 from the same bf16 inputs and (out, lse), in
    another order, and round to bf16 once, so dq, dk, dv agree within one bf16 ulp plus
    that order's noise near zero."""
    rng = np.random.RandomState(seq + head_dim + 2 * causal)
    q, k, v = (jnp.asarray(rng.randn(1, seq, 4, head_dim), jnp.bfloat16) for _ in range(3))
    dout = jnp.asarray(rng.randn(1, seq, 4, head_dim) * np.cos(np.arange(head_dim)), jnp.bfloat16)
    out, lse = jax_flash_forward(q, k, v, causal=causal, interpret=True)
    expected = jax_flash_backward(q, k, v, out, lse, dout, causal=causal, interpret=True)
    args = [torch.from_numpy(np.array(a, np.float32)) for a in (q, k, v, out, lse, dout)]
    args = [a.to(torch.bfloat16) if i != 4 else a for i, a in enumerate(args)]  # lse stays fp32
    got = flash_attention_backward_plain(*args, causal)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, expected):
        assert ours.dtype == torch.bfloat16 and ours.shape == tuple(q.shape)
        ours, theirs = ours.float().numpy(), np.asarray(theirs, np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(theirs), 2.0**-126))) - 7)
        excess = np.abs(ours - theirs) - ulp
        assert excess.max() <= 1e-6, f"{name}: {excess.max()} beyond one bf16 ulp"


def _within_fp16_ulp(ours: torch.Tensor, theirs, what: str) -> None:
    """Each element within one fp16 ulp of the JAX kernel's, plus 1e-6: both sum in
    fp32, in another order, before rounding to fp16 once; near zero, where an fp16
    ulp shrinks to 2^-24, that order's noise (measured: <= 5.4e-7 beyond one ulp)
    is the larger."""
    ours, theirs = ours.numpy().astype(np.float32), np.asarray(theirs)
    assert ours.dtype == np.float32 and theirs.dtype == np.float16
    excess = np.abs(ours - theirs.astype(np.float32)) - np.spacing(np.abs(theirs)).astype(np.float32)
    assert excess.max() <= 1e-6, f"{what}: {excess.max()} beyond one fp16 ulp"


@pytest.mark.parametrize("head_dim", [80, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel_in_fp16(causal, head_dim):
    """fp16 inputs (the dtype Llama-2 checkpoints ship in) through the plain forward
    and the JAX kernel in interpret mode: both cast the tiles to fp32 and round the
    output to fp16 once, so they agree within one fp16 ulp; lse (fp32) within 1e-5."""
    rng = np.random.RandomState(head_dim + causal)
    q, k, v = (rng.randn(2, 200, 4, head_dim).astype(np.float16) for _ in range(3))
    out_j, lse_j = jax_flash_attention_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, True)
    out_t, lse_t = flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert out_t.dtype == torch.float16
    _within_fp16_ulp(out_t.float(), out_j, "out")
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim", [32, 80, 128, 256, 26])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_plain_matches_jax_backward_kernels_in_fp16(causal, head_dim):
    """The plain backward against the JAX package's two passes in interpret mode on
    fp16 inputs, from the same (out, lse): dq, dk, dv within one fp16 ulp."""
    rng = np.random.RandomState(head_dim + 2 * causal)
    q, k, v = (rng.randn(2, 200, 4, head_dim).astype(np.float16) for _ in range(3))
    dout = (rng.randn(2, 200, 4, head_dim) * np.cos(np.arange(head_dim))).astype(np.float16)
    out, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    expected = jax_flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse, jnp.asarray(dout),
                                  causal=causal, interpret=True)
    got = flash_attention_backward_plain(*[torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, dout)], causal)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, expected):
        assert ours.dtype == torch.float16 and ours.shape == q.shape
        _within_fp16_ulp(ours.float(), theirs, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_matches_autograd_through_plain_attention(causal):
    """``flash_attention`` on CPU tensors differentiates through the plain passes;
    fp32 gradients agree with autograd through the einsum core within 2e-5
    (measured: <= 1.1e-6)."""
    rng = np.random.RandomState(5 + causal)
    inputs = [torch.from_numpy(rng.randn(2, 72, 3, 16).astype(np.float32)).requires_grad_() for _ in range(3)]
    weight = torch.from_numpy(rng.randn(2, 72, 3, 16).astype(np.float32))
    before = (flash_attention_lse.launches, flash_attention_backward_dq.launches, flash_attention_backward_dkv.launches)
    fused = torch.autograd.grad((flash_attention(*inputs, causal) * weight).sum(), inputs)
    exact = torch.autograd.grad((plain_attention(*inputs, causal=causal) * weight).sum(), inputs)
    for name, ours, theirs in zip("qkv", fused, exact):
        torch.testing.assert_close(ours, theirs, rtol=2e-5, atol=2e-5, msg=f"d{name}")
    assert FlashAttentionFunction.apply(*inputs, causal).grad_fn is not None
    assert (flash_attention_lse.launches, flash_attention_backward_dq.launches,
            flash_attention_backward_dkv.launches) == before  # no kernel runs on the CPU


def test_plain_attention_matches_jax_with_mask_and_end_aligned_causal():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 3, 4, 8).astype(np.float32)  # q_len 3 against k_len 10: end-aligned causal
    k, v = (rng.randn(2, 10, 4, 8).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, 10) > 0.3
    mask[:, -1] = True
    for kwargs in (dict(causal=True), dict(mask=mask), dict(mask=mask, causal=True)):
        exact = jax_plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    **{key: jnp.asarray(val) if key == "mask" else val for key, val in kwargs.items()})
        ported = plain_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 **{key: torch.from_numpy(val) if key == "mask" else val for key, val in kwargs.items()})
        np.testing.assert_allclose(ported.numpy(), np.asarray(exact), rtol=2e-5, atol=2e-5, err_msg=str(kwargs))


def test_attention_auto_routes_cpu_and_masked_calls_to_plain_attention():
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32)) for _ in range(3))
    before = flash_attention_lse.launches
    torch.testing.assert_close(attention_auto(q, k, v, causal=True), plain_attention(q, k, v, causal=True), rtol=0, atol=0)
    mask = torch.ones(1, 16, dtype=torch.bool)
    torch.testing.assert_close(attention_auto(q, k, v, mask=mask), plain_attention(q, k, v, mask=mask), rtol=0, atol=0)
    assert flash_attention_lse.launches == before  # no kernel runs on the CPU


def _meta(shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _misaligned_view(shape) -> torch.Tensor:
    """A bf16 view one element into its storage: 2 bytes off 16-byte alignment."""
    return torch.empty(int(np.prod(shape)) + 1, dtype=torch.bfloat16, device="meta")[1:].view(shape)


W, S, T = "wgmma", "simt", "tf32x3"


# each input -> its routes (forward, dq, dkv), whether the kernels read a copy, what no kernel takes
@pytest.mark.parametrize(
    "make,routes,copy,refusal",
    [
        (lambda: _meta((2, 64, 4, 16)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 32)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 64)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 80)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 96)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 128)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 256)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 64), torch.float32), (T, T, T), False, None),  # 3xTF32 in every pass
        (lambda: _meta((2, 64, 4, 64), torch.float16), (W, W, W), False, None),
        (lambda: _meta((4096, 8, 16, 64)), (W, W, W), False, None),  # B·H = 65536
        (lambda: _meta((4096, 8, 16, 32), torch.float16), (W, W, W), False, None),  # B·H = 65536
        (lambda: _misaligned_view((2, 64, 4, 64)), (W, W, W), True, None),  # TMA needs a copy
        (lambda: _misaligned_view((2, 64, 4, 32)), (W, W, W), True, None),  # so does d32
        (lambda: _meta((2, 4, 64, 64)).transpose(1, 2), (W, W, W), False, None),  # a strided view TMA takes
        (lambda: _meta((2, 64, 64, 4)).transpose(2, 3), (W, W, W), True, None),  # head dim not contiguous
        (lambda: _meta((2, 64, 4, 64), torch.float64), (S, S, S), False, (TypeError, "bfloat16, float16 or float32")),
        (lambda: _meta((2, 64, 4, 512)), (S, S, S), False, (ValueError, "head_dim")),
        (lambda: _meta((1, 16 * 65535 + 1, 1, 20)), (W, S, W), False, (ValueError, "grid")),  # SIMT dQ's 16 rows
        (lambda: _meta((1, 128 * 65535 + 1, 1, 64)), (W, W, W), False, (ValueError, "grid")),
        (lambda: _meta((2, 64, 4, 128), torch.float16), (W, W, W), False, None),
        # 40-byte head strides: the packed-heads view (H·D = 80) for every pass
        (lambda: _meta((2, 64, 4, 20)), (W, W, W), False, None),
        (lambda: _meta((2, 64, 4, 128), torch.float32), (T, T, T), False, None),  # 3xTF32, not plain TF32
        (lambda: _misaligned_view((2, 64, 4, 20)), (W, W, W), True, None),  # TMA needs a copy
        (lambda: _meta((1, 128 * 65535 + 1, 1, 32)), (W, W, W), False, (ValueError, "grid")),  # the dQ pass's 128
        (lambda: _meta((2, 64, 5, 20)), (W, S, W), False, None),  # H·D = 100: no TMA view, the copied-rows view
        (lambda: _misaligned_view((2, 64, 5, 20)), (W, S, W), False, None),  # read through its strides
        (lambda: _meta((2, 64, 8, 25)), (W, W, W), False, None),  # an odd head dim: rows start 2-byte aligned
        (lambda: _meta((2, 64, 4, 196), torch.float16), (W, W, W), False, None),  # padded to 256
        (lambda: _meta((4, 128, 12, 26)), (W, W, W), False, None),  # TinyBERT's 12 heads of 26
        (lambda: _meta((2, 4, 64, 20)).transpose(1, 2), (W, W, W), True, None),  # heads not packed in the row
        # every packed pass's 128-row blocks (the dQ pass's 16-row SIMT blocks bounded it before it took the view)
        (lambda: _meta((1, 128 * 65535 + 1, 2, 20)), (W, W, W), False, (ValueError, "grid")),
        # boxes start up to 6 columns early (254 mod 8), so a tile spans 260 (past 256): the copied-rows view
        (lambda: _meta((2, 64, 4, 254), torch.float16), (W, S, W), False, None),
        (lambda: _meta((2, 64, 4, 252), torch.float16), (W, W, W), False, None),  # spans 256
        (lambda: _meta((2, 64, 4, 8)), (W, S, W), False, None),  # below wgmma's 16: the copied-rows view
        (lambda: _meta((2, 64, 3, 21), torch.float16), (W, S, W), False, None),  # H·D = 63: rows 2-byte aligned
        (lambda: _meta((1, 64, 3, 100)), (W, S, W), False, None),  # H·D = 300
    ],
    ids=["d16", "d32", "d64", "d80", "d96", "d128", "d256", "fp32", "fp16", "bh65536", "bh65536_fp16",
         "misaligned", "misaligned_d32", "strided", "d_strided", "fp64", "d512", "simt_rows", "wgmma_rows",
         "fp16_d128", "d20", "fp32_d128", "misaligned_d20", "dq_rows", "d20_hd100", "misaligned_d20_hd100", "d25",
         "fp16_d196", "tinybert", "d20_heads_strided", "mixed_rows", "d254_span", "d252_span", "d8_copied",
         "fp16_d21_hd63", "d100_hd300"],
)
def test_flash_refusal_predicts_what_the_kernel_takes(make, routes, copy, refusal):
    """The wrappers' predicates, on meta tensors: which design runs each pass of an
    input, whether the kernels read a copy of it, and what no kernel takes (the
    wrapper raises it; every other unmasked square call on the card runs a flash
    kernel)."""
    q = make()
    assert tuple(flash_route(q, which) for which in PASSES) == routes
    assert flash_route(q) == routes[0]  # the forward's, by default
    assert needs_copy(q) is copy
    laid_out = flash_module._kernel_layout(q)
    assert (laid_out is not q) is copy and not needs_copy(laid_out)  # a copy the kernels can read
    got = flash_refusal(q, ("k", q), ("v", q))
    if refusal is None:
        assert got is None
    else:
        assert got[0] is refusal[0] and refusal[1] in got[1], got
    mixed = flash_refusal(_meta((2, 64, 4, 64)), ("k", _meta((2, 64, 4, 64), torch.float32)))
    assert mixed[0] is TypeError and "share a dtype" in mixed[1]
    with pytest.raises(ValueError, match="answers for"):
        flash_route(q, "backward")


# head_dim -> the padded width the wgmma kernels compute it at, the forward's KV tile and box
# rows, and the KV rows a dK/dV block owns (64 at 256, where its warpgroups split the columns)
@pytest.mark.parametrize("head_dim, padded, box_rows, dkv_rows", [
    (16, 64, 128, 128), (64, 64, 128, 128), (72, 128, 128, 128), (128, 128, 128, 128),
    (136, 256, 64, 64), (192, 256, 64, 64), (256, 256, 64, 64),
])
def test_wgmma_widths_and_tiles(head_dim, padded, box_rows, dkv_rows):
    assert (padded_head_dim(head_dim), forward_box_rows(head_dim), dkv_block_rows(head_dim)) == (padded, box_rows, dkv_rows)


# (head_dim, heads) -> the columns a tile spans (head_dim plus the most (h·D) mod 8 over the
# heads, in the packed-heads view) and the padded width, worked out by hand
@pytest.mark.parametrize("head_dim, heads, span, padded", [
    (64, 12, 64, 64), (20, 16, 24, 64), (26, 12, 32, 64), (25, 16, 32, 64), (25, 2, 26, 64),
    (62, 4, 68, 128), (100, 8, 104, 128), (196, 4, 200, 256), (252, 2, 256, 256),
])
def test_packed_tiles_span_the_head_and_its_shift(head_dim, heads, span, padded):
    assert (tma_span(head_dim, heads), padded_head_dim(tma_span(head_dim, heads))) == (span, padded)


def test_flash_routes_name_each_pass_and_the_grid_takes_the_finest_rows():
    """The labels' route string, and the grid check against each pass's block rows: at
    bf16 head_dim 256 the dK/dV pass's 64-row blocks bound T before the forward's and
    the dQ pass's 128; at head_dim 20 where H·D is a multiple of 8 every pass runs wgmma
    on the packed-heads view (a span of 24, padded to 64), so 128-row blocks bound it;
    where H·D is not, the forward and the dK/dV pass run wgmma on the copied-rows view and
    the SIMT dQ pass's 16 rows bound it."""
    assert flash_routes(_meta((1, 64, 2, 256))) == "forward=wgmma dq=wgmma dkv=wgmma"
    assert flash_routes(_meta((1, 64, 2, 20), torch.float16)) == "forward=wgmma dq=wgmma dkv=wgmma"
    assert flash_routes(_meta((1, 64, 5, 20), torch.float16)) == "forward=wgmma dq=simt dkv=wgmma"
    assert flash_routes(_meta((4, 128, 12, 26))) == "forward=wgmma dq=wgmma dkv=wgmma"
    assert flash_refusal(_meta((1, 128 * 65535, 2, 20))) is None
    error, message = flash_refusal(_meta((1, 128 * 65535 + 1, 2, 20)))
    assert error is ValueError and f"T <= {128 * 65535}" in message
    assert flash_refusal(_meta((1, 64 * 65535, 1, 256))) is None
    error, message = flash_refusal(_meta((1, 64 * 65535 + 1, 1, 256)))
    assert error is ValueError and f"T <= {64 * 65535}" in message
    assert flash_refusal(_meta((1, 128 * 65535, 1, 128))) is None  # bf16 128: every pass 128 rows a block
    assert flash_refusal(_meta((1, 16 * 65535, 1, 20))) is None
    error, message = flash_refusal(_meta((1, 16 * 65535 + 1, 1, 20)))
    assert error is ValueError and f"T <= {16 * 65535}" in message


def test_flash_wrapper_refuses_what_it_cannot_take():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one \\[B, T, H, D\\] shape"):
        flash_attention_lse(q, torch.zeros(1, 9, 2, 16), q)
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):  # never silently computed off the card
        flash_attention_lse(meta, meta, meta)
    rows = torch.zeros(1, 2, 8, device="meta")
    for backward_pass in (flash_attention_backward_dq, flash_attention_backward_dkv):
        with pytest.raises(ValueError, match="CUDA device"):
            backward_pass(meta, meta, meta, meta, rows, rows)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_backward_dq(meta, meta, meta, torch.zeros(1, 4, 2, 16, device="meta"), rows, rows)


def _fused_q() -> torch.Tensor:
    """q sliced out of a fused [B, T, 3, H, D] projection: T stride 3·H·D."""
    return torch.empty(2, 512, 3, 12, 64, dtype=torch.bfloat16, device="meta")[:, :, 0]


def _fused_q26() -> torch.Tensor:
    """TinyBERT's q sliced out of a fused [B, T, 3, 12, 26] projection: T stride 3·312."""
    return torch.empty(2, 128, 3, 12, 26, dtype=torch.bfloat16, device="meta")[:, :, 0]


# (tensor, box rows) -> dims, byte strides of the outer three dimensions, box, the boxes a
# tile row takes (its padded width, 64, 128 or 256, over 64) and head 3's first box's
# (column, head) coordinates, worked out by hand: bf16 and fp16 are 2 bytes, so a stride of s
# elements is 2s bytes. A head dim that is a multiple of 8 takes the 4-D view: dims (D, H, T,
# B), strides of (H, T, B), head h at (0, h). Any other takes the packed-heads view: dims (H·D,
# 1, T, B), strides (2·H·D, T's, B's), head h at (h·D rounded down to a multiple of 8, 0).
@pytest.mark.parametrize("make, rows, dims, strides, box, boxes, origin", [
    (lambda: torch.empty(2, 1000, 16, 64, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,
     (64, 16, 1000, 2), (2 * 64, 2 * 16 * 64, 2 * 1000 * 16 * 64), (64, 1, 128, 1), 1, (0, 3)),
    (lambda: torch.empty(32, 512, 12, 64, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,  # ALBERT's
     (64, 12, 512, 32), (128, 1536, 786432), (64, 1, 64, 1), 1, (0, 3)),
    (lambda: torch.empty(1, 2048, 32, 128, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,  # D = 128: two boxes
     (128, 32, 2048, 1), (256, 8192, 16777216), (64, 1, 64, 1), 2, (0, 3)),
    (_fused_q, BACKWARD_BOX_ROWS, (64, 12, 512, 2), (128, 2 * 3 * 12 * 64, 2 * 512 * 3 * 12 * 64), (64, 1, 64, 1), 1, (0, 3)),
    (lambda: torch.empty(1, 2048, 32, 128, dtype=torch.float16, device="meta"), BACKWARD_BOX_ROWS,  # fp16: bf16's
     (128, 32, 2048, 1), (256, 8192, 16777216), (64, 1, 64, 1), 2, (0, 3)),
    (lambda: torch.empty(2, 1000, 16, 32, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,  # one box, half past D
     (32, 16, 1000, 2), (64, 1024, 1024000), (64, 1, 128, 1), 1, (0, 3)),
    (lambda: torch.empty(1, 2048, 32, 80, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,  # Phi-2's: padded to 128
     (80, 32, 2048, 1), (160, 5120, 10485760), (64, 1, 128, 1), 2, (0, 3)),
    (lambda: torch.empty(1, 512, 8, 96, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,
     (96, 8, 512, 1), (192, 1536, 786432), (64, 1, 64, 1), 2, (0, 3)),
    (lambda: torch.empty(1, 2048, 16, 256, dtype=torch.float16, device="meta"), forward_box_rows(256),  # Gemma-7B's
     (256, 16, 2048, 1), (512, 8192, 16777216), (64, 1, 64, 1), 4, (0, 3)),
    # the packed-heads view: TinyBERT's 26 (H·D = 312), head dim 20 backward, an odd 25, fp16 196
    (lambda: torch.empty(4, 128, 12, 26, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,
     (312, 1, 128, 4), (624, 624, 128 * 624), (64, 1, 128, 1), 1, (72, 0)),  # 78 rounded down to 72
    (lambda: torch.empty(2, 1000, 16, 20, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,
     (320, 1, 1000, 2), (640, 640, 1000 * 640), (64, 1, 64, 1), 1, (56, 0)),
    (lambda: torch.empty(2, 1000, 16, 25, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,
     (400, 1, 1000, 2), (800, 800, 1000 * 800), (64, 1, 128, 1), 1, (72, 0)),
    (lambda: torch.empty(1, 512, 4, 196, dtype=torch.float16, device="meta"), forward_box_rows(200),  # span 196 + 4
     (784, 1, 512, 1), (1568, 1568, 512 * 1568), (64, 1, 64, 1), 4, (584, 0)),
    (_fused_q26, BACKWARD_BOX_ROWS, (312, 1, 128, 2), (624, 3 * 624, 128 * 3 * 624), (64, 1, 64, 1), 1, (72, 0)),
], ids=["contiguous", "albert", "head_dim_128", "fused_qkv", "fp16", "head_dim_32", "head_dim_80", "head_dim_96",
        "head_dim_256_fp16", "packed_tinybert", "packed_head_dim_20", "packed_head_dim_25", "packed_head_dim_196_fp16",
        "packed_fused_qkv"])
def test_tma_geometry_describes_the_kernels_views(make, rows, dims, strides, box, boxes, origin):
    t = make()
    geometry = tma_geometry(t, rows)
    assert (geometry.dims, geometry.strides, geometry.box) == (dims, strides, box)
    assert padded_head_dim(tma_span(t.shape[-1], t.shape[-2])) // geometry.box[0] == boxes
    assert list(geometry.as_ctypes()) == [*dims, *strides, *box]  # the order sm90::TmaGeometry reads
    assert geometry.head_origin(3) == origin


@pytest.mark.parametrize("make, match", [
    (lambda: torch.empty(1, 64, 8, 66, dtype=torch.bfloat16, device="meta")[..., :64], "multiples of 16 bytes"),
    (lambda: torch.empty(1, 64, 8, 72, dtype=torch.bfloat16, device="meta")[..., 1:65], "16-byte aligned"),
    (lambda: torch.empty(1, 64, 64, 8, dtype=torch.bfloat16, device="meta").transpose(2, 3), "contiguous head dim"),
    (lambda: torch.empty(1, 64, 8, 64, dtype=torch.float32, device="meta"), "bf16 or fp16"),
    (lambda: torch.empty(1, 64, 5, 20, dtype=torch.bfloat16, device="meta"), "multiple of 8"),  # H·D = 100
    (lambda: torch.empty(1, 64, 8, 8, dtype=torch.float16, device="meta"), "from 16 to 256"),
    (lambda: torch.empty(1, 8, 64, 20, dtype=torch.bfloat16, device="meta").transpose(1, 2), "packed in the row"),
    (lambda: torch.empty(1, 64, 8, 28, dtype=torch.bfloat16, device="meta")[..., :20], "packed in the row"),
], ids=["head_stride_132_bytes", "misaligned_base", "strided_head_dim", "fp32", "head_dim_20", "head_dim_8",
        "head_dim_20_heads_strided", "head_dim_20_sliced"])
def test_tma_geometry_refuses_views_tma_cannot_take(make, match):
    with pytest.raises(ValueError, match=match):
        tma_geometry(make(), FORWARD_TILE_ROWS)


def _backward_inputs(batch, seq, heads, dim, fused, dtype=torch.bfloat16):
    """q, k, v, dout as meta tensors: four of one shape, or four views of one fused
    [B, T, 4, H, D] tensor (T stride 4·H·D)."""
    if fused:
        return torch.empty(batch, seq, 4, heads, dim, dtype=dtype, device="meta").unbind(2)
    return [torch.empty(batch, seq, heads, dim, dtype=dtype, device="meta") for _ in range(4)]


# [B, T, H, D], fused or not, and dtype -> the dims (D, H, T, B) and byte strides of (H, T,
# B) of all four views, worked out by hand (2 bytes an element); every box is 64 columns x
# 64 rows
@pytest.mark.parametrize("shape, fused, dtype, dims, strides", [
    ((32, 512, 12, 64), False, torch.bfloat16, (64, 12, 512, 32), (128, 1536, 786432)),  # ALBERT's
    ((2, 1000, 16, 64), True, torch.bfloat16, (64, 16, 1000, 2), (128, 4 * 16 * 128, 1000 * 4 * 16 * 128)),  # ragged T
    ((1, 2000, 32, 128), False, torch.bfloat16, (128, 32, 2000, 1), (256, 8192, 2000 * 8192)),  # ragged T, D = 128
    ((1, 256, 32, 128), True, torch.bfloat16, (128, 32, 256, 1), (256, 4 * 32 * 256, 256 * 4 * 32 * 256)),  # fused
    ((1, 512, 8, 96), False, torch.bfloat16, (96, 8, 512, 1), (192, 1536, 786432)),  # padded to 128
    ((1, 2048, 32, 128), False, torch.float16, (128, 32, 2048, 1), (256, 8192, 2048 * 8192)),  # fp16 Llama-2's
    ((1, 512, 4, 256), True, torch.bfloat16, (256, 4, 512, 1), (512, 4 * 4 * 512, 512 * 4 * 4 * 512)),  # D = 256
], ids=["albert", "fused_ragged_d64", "ragged_d128", "fused_d128", "mixed_d96", "fp16_d128", "fused_d256"])
def test_backward_hands_both_passes_one_geometry_per_tensor(monkeypatch, shape, fused, dtype, dims, strides):
    """``flash_attention_backward`` computes the TMA views of q, k, v, dout once and
    hands the same four to both passes, which run wgmma on every input one of them
    does. Meta tensors stand in for CUDA ones; the launches are recorded instead of
    made."""
    q, k, v, dout = _backward_inputs(*shape, fused, dtype)
    batch, seq, heads, _ = shape
    views, launched = [], []
    tma_geometry_of = flash_module.tma_geometry
    monkeypatch.setattr(flash_module, "tma_geometry", lambda t, rows: views.append(rows) or tma_geometry_of(t, rows))
    monkeypatch.setattr(flash_module, "_check_cuda_inputs", lambda *tensors: None)
    monkeypatch.setattr(flash_module, "_launch_pass", lambda name, *args: launched.append((name, args[-1])))
    monkeypatch.setattr(flash_attention_backward_dq, "launches", 0)
    monkeypatch.setattr(flash_attention_backward_dkv, "launches", 0)
    lse = torch.empty(batch, heads, seq, device="meta")
    flash_attention_backward(q, k, v, torch.empty_like(q), lse, dout, causal=True)
    assert views == [BACKWARD_BOX_ROWS] * 4  # one view per tensor, for both passes
    expected = (TmaGeometry(dims, strides, (64, 1, 64, 1)),) * 4
    assert [name for name, _ in launched] == ["dq", "dkv"] and launched[1][1] == expected
    assert flash_route(q, "dq") == flash_route(q, "dkv") == "wgmma" and launched[0][1] is launched[1][1]


# [B, T, H, D], fused or not -> the packed-heads views' dims (H·D, 1, T, B) and byte strides
# (2·H·D, T's, B's), worked out by hand
@pytest.mark.parametrize("shape, fused, dims, strides", [
    ((2, 1000, 16, 20), False, (320, 1, 1000, 2), (640, 640, 1000 * 640)),
    ((4, 128, 12, 26), True, (312, 1, 128, 4), (624, 4 * 624, 128 * 4 * 624)),  # TinyBERT's, fused
    ((1, 512, 4, 196), False, (784, 1, 512, 1), (1568, 1568, 512 * 1568)),
], ids=["d20", "fused_tinybert", "d196"])
def test_backward_computes_the_packed_views_once_for_the_dkv_pass(monkeypatch, shape, fused, dims, strides):
    """At a head dim that is not a multiple of 8 (H·D a multiple of 8) both backward
    passes run wgmma on the packed-heads view: ``flash_attention_backward`` computes the
    four views once and hands the one set to the dQ pass and to the dK/dV pass."""
    q, k, v, dout = _backward_inputs(*shape, fused)
    batch, seq, heads, dim = shape
    views, launched = [], []
    tma_geometry_of = flash_module.tma_geometry
    monkeypatch.setattr(flash_module, "tma_geometry", lambda t, rows: views.append(rows) or tma_geometry_of(t, rows))
    monkeypatch.setattr(flash_module, "_check_cuda_inputs", lambda *tensors: None)
    monkeypatch.setattr(flash_module, "_launch_pass", lambda name, *args: launched.append((name, args[-1])))
    for wrapper in (flash_attention_backward_dq, flash_attention_backward_dkv):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "packed", flash_module.LaunchCount())
    flash_attention_backward(q, k, v, torch.empty_like(q), torch.empty(batch, heads, seq, device="meta"), dout, True)
    assert (flash_route(q, "dq"), flash_route(q, "dkv")) == ("wgmma", "wgmma")
    # each launch counted, and counted as one on the packed-heads view
    assert [(w.launches, w.packed.launches) for w in (flash_attention_backward_dq, flash_attention_backward_dkv)] == [
        (1, 1), (1, 1)]
    assert views == [BACKWARD_BOX_ROWS] * 4
    expected = (TmaGeometry(dims, strides, (64, 1, 64, 1), dim),) * 4
    assert [name for name, _ in launched] == ["dq", "dkv"] and launched[1][1] == expected
    assert launched[0][1] is launched[1][1]


# ------------------------------------------------------------------ blockwise int8


def _quantization_input() -> np.ndarray:
    rng = np.random.RandomState(7)
    flat = (rng.randn(5 * 4096) * rng.rand(5 * 4096) * 3).astype(np.float32)
    flat[2 * 4096 : 3 * 4096] = 0.0  # an all-zero block: scale 0, codes 0
    ties = flat[3 * 4096 : 4 * 4096]
    ties[:] = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.0], np.float32), 4096)
    ties[-1] = 127.0  # absmax 127 → scale exactly 1.0: every x.5 is an exact tie
    return flat


def test_quantize_matches_pallas_kernel_bit_for_bit_with_half_even_ties():
    flat = _quantization_input()
    codes_p, absmax_p = pallas_blockwise_quantize(flat, interpret=True)
    codes_t, absmax_t = blockwise_int8_quantize(torch.from_numpy(flat))
    assert codes_t.dtype == torch.int8 and codes_t.shape == (5, 4096) and absmax_t.dtype == torch.float32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_p))
    np.testing.assert_array_equal(absmax_t.numpy(), np.asarray(absmax_p))
    tie_codes = codes_t[3, :8].tolist()
    assert tie_codes == [0, 2, 2, 0, -2, -2, 126, 3]  # half to even, never half away from zero
    assert codes_t[2].abs().max().item() == 0 and absmax_t[2].item() == 0.0


def test_dequantize_matches_pallas_kernel_bit_for_bit():
    flat = _quantization_input()
    codes_p, absmax_p = pallas_blockwise_quantize(flat, interpret=True)
    out_p = pallas_blockwise_dequantize(codes_p, absmax_p, interpret=True)
    out_t = blockwise_int8_dequantize(torch.tensor(np.asarray(codes_p)), torch.tensor(np.asarray(absmax_p)))
    assert out_t.shape == (5 * 4096,) and out_t.dtype == torch.float32
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_p))


def test_quantize_wrappers_validate_inputs():
    with pytest.raises(ValueError, match="multiple of 4096"):
        blockwise_int8_quantize(torch.zeros(4097))
    with pytest.raises(ValueError, match="codes"):
        blockwise_int8_dequantize(torch.zeros(2, 4096, dtype=torch.int8), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        blockwise_int8_quantize(torch.zeros(4096, device="meta"))


def test_quantize_params_matches_jax_rule_codes_and_bytes():
    """Same selection rule (float, ndim >= 2, size >= 4096), same resident bytes, and
    bit-identical codes for a Linear weight [out, in] and its flax kernel [in, out]."""
    rng = np.random.RandomState(11)
    arrays = {
        "matrix": rng.randn(96, 100).astype(np.float32),  # 9600 elements: padded to 3 blocks
        "small_matrix": rng.randn(8, 8).astype(np.float32),  # below one block: exact
        "norm": rng.randn(4096).astype(np.float32),  # 1-D: exact even at one block
    }
    ported = quantize_params({name: torch.from_numpy(np.ascontiguousarray(a.T)) for name, a in arrays.items()})
    reference = jax_quantize_params({name: jnp.asarray(a) for name, a in arrays.items()})
    assert isinstance(ported["matrix"], QuantizedTensor)
    assert not isinstance(ported["small_matrix"], QuantizedTensor) and not isinstance(ported["norm"], QuantizedTensor)
    np.testing.assert_array_equal(ported["matrix"].codes.numpy(), np.asarray(reference["matrix"].codes))
    np.testing.assert_array_equal(ported["matrix"].absmax.numpy(), np.asarray(reference["matrix"].absmax))
    assert tree_param_bytes(ported) == jax_tree_param_bytes(reference)
    dense = dequantize_tree(ported)
    # the dequantize kernel itself is bit-identical (test above); XLA's fusion of the
    # JAX tree path may round the scale product differently by one ulp
    np.testing.assert_allclose(dense["matrix"].numpy().T, np.asarray(reference["matrix"].dequantize()), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(dense["norm"].numpy(), arrays["norm"])
    assert dense["matrix"].shape == (100, 96) and dense["matrix"].dtype == torch.float32
