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
    flash_route,
    needs_copy,
    tma_geometry,
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


@pytest.mark.parametrize("head_dim", [16, 32])
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


@pytest.mark.parametrize("head_dim", [16, 64])
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


@pytest.mark.parametrize(
    "make,route,copy,refusal",
    [
        (lambda: _meta((2, 64, 4, 16)), "simt", False, None),
        (lambda: _meta((2, 64, 4, 32)), "simt", False, None),
        (lambda: _meta((2, 64, 4, 64)), "wgmma", False, None),
        (lambda: _meta((2, 64, 4, 80)), "simt", False, None),
        (lambda: _meta((2, 64, 4, 96)), "simt", False, None),
        (lambda: _meta((2, 64, 4, 128)), "wgmma", False, None),
        (lambda: _meta((2, 64, 4, 256)), "simt", False, None),
        (lambda: _meta((2, 64, 4, 64), torch.float32), "simt", False, None),
        (lambda: _meta((2, 64, 4, 64), torch.float16), "simt", False, None),
        (lambda: _meta((4096, 8, 16, 64)), "wgmma", False, None),  # B·H = 65536
        (lambda: _meta((4096, 8, 16, 32), torch.float16), "simt", False, None),  # B·H = 65536
        (lambda: _misaligned_view((2, 64, 4, 64)), "wgmma", True, None),  # TMA needs a copy
        (lambda: _misaligned_view((2, 64, 4, 32)), "simt", False, None),  # read through its strides
        (lambda: _meta((2, 4, 64, 64)).transpose(1, 2), "wgmma", False, None),  # a strided view TMA takes
        (lambda: _meta((2, 64, 64, 4)).transpose(2, 3), "wgmma", True, None),  # head dim not contiguous
        (lambda: _meta((2, 64, 4, 64), torch.float64), "simt", False, (TypeError, "bfloat16, float16 or float32")),
        (lambda: _meta((2, 64, 4, 512)), "simt", False, (ValueError, "head_dim")),
        (lambda: _meta((1, 16 * 65535 + 1, 1, 32)), "simt", False, (ValueError, "grid")),
        (lambda: _meta((1, 128 * 65535 + 1, 1, 64)), "wgmma", False, (ValueError, "grid")),
    ],
    ids=["d16", "d32", "d64", "d80", "d96", "d128", "d256", "fp32", "fp16", "bh65536", "bh65536_fp16",
         "misaligned", "misaligned_d32", "strided", "d_strided", "fp64", "d512", "simt_rows", "wgmma_rows"],
)
def test_flash_refusal_predicts_what_the_kernel_takes(make, route, copy, refusal):
    """The wrappers' predicates, on meta tensors: which design runs an input, whether
    the kernels read a copy of it, and what no kernel takes (the wrapper raises it;
    every other unmasked square call on the card runs a flash kernel)."""
    q = make()
    assert flash_route(q) == route
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


# (tensor, box rows) -> dims (D, H, T, B), byte strides of (H, T, B), box, and the boxes
# a tile row takes (D / 64), worked out by hand: bf16 is 2 bytes, so a stride of s
# elements is 2s bytes
@pytest.mark.parametrize("make, rows, dims, strides, box, boxes", [
    (lambda: torch.empty(2, 1000, 16, 64, dtype=torch.bfloat16, device="meta"), FORWARD_TILE_ROWS,
     (64, 16, 1000, 2), (2 * 64, 2 * 16 * 64, 2 * 1000 * 16 * 64), (64, 1, 128, 1), 1),
    (lambda: torch.empty(32, 512, 12, 64, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,  # ALBERT's
     (64, 12, 512, 32), (128, 1536, 786432), (64, 1, 64, 1), 1),
    (lambda: torch.empty(1, 2048, 32, 128, dtype=torch.bfloat16, device="meta"), BACKWARD_BOX_ROWS,  # D = 128: two boxes
     (128, 32, 2048, 1), (256, 8192, 16777216), (64, 1, 64, 1), 2),
    (_fused_q, BACKWARD_BOX_ROWS, (64, 12, 512, 2), (128, 2 * 3 * 12 * 64, 2 * 512 * 3 * 12 * 64), (64, 1, 64, 1), 1),
], ids=["contiguous", "albert", "head_dim_128", "fused_qkv"])
def test_tma_geometry_describes_the_kernels_views(make, rows, dims, strides, box, boxes):
    geometry = tma_geometry(make(), rows)
    assert (geometry.dims, geometry.strides, geometry.box) == (dims, strides, box)
    assert geometry.dims[0] // geometry.box[0] == boxes
    assert list(geometry.as_ctypes()) == [*dims, *strides, *box]  # the order sm90::TmaGeometry reads


@pytest.mark.parametrize("make, match", [
    (lambda: torch.empty(1, 64, 8, 66, dtype=torch.bfloat16, device="meta")[..., :64], "multiples of 16 bytes"),
    (lambda: torch.empty(1, 64, 8, 72, dtype=torch.bfloat16, device="meta")[..., 1:65], "16-byte aligned"),
    (lambda: torch.empty(1, 64, 64, 8, dtype=torch.bfloat16, device="meta").transpose(2, 3), "contiguous head dim"),
    (lambda: torch.empty(1, 64, 8, 64, dtype=torch.float32, device="meta"), "bf16"),
], ids=["head_stride_132_bytes", "misaligned_base", "strided_head_dim", "fp32"])
def test_tma_geometry_refuses_views_tma_cannot_take(make, match):
    with pytest.raises(ValueError, match=match):
        tma_geometry(make(), FORWARD_TILE_ROWS)


def _backward_inputs(batch, seq, heads, dim, fused):
    """q, k, v, dout as bf16 meta tensors: four of one shape, or four views of one
    fused [B, T, 4, H, D] tensor (T stride 4·H·D)."""
    if fused:
        return torch.empty(batch, seq, 4, heads, dim, dtype=torch.bfloat16, device="meta").unbind(2)
    return [torch.empty(batch, seq, heads, dim, dtype=torch.bfloat16, device="meta") for _ in range(4)]


# [B, T, H, D] and fused or not -> the dims (D, H, T, B) and byte strides of (H, T, B) of
# all four views, worked out by hand; every box is 64 columns x 64 rows
@pytest.mark.parametrize("shape, fused, dims, strides", [
    ((32, 512, 12, 64), False, (64, 12, 512, 32), (128, 1536, 786432)),  # ALBERT's
    ((2, 1000, 16, 64), True, (64, 16, 1000, 2), (128, 4 * 16 * 128, 1000 * 4 * 16 * 128)),  # ragged T
    ((1, 2000, 32, 128), False, (128, 32, 2000, 1), (256, 8192, 2000 * 8192)),  # ragged T, D = 128
    ((1, 256, 32, 128), True, (128, 32, 256, 1), (256, 4 * 32 * 256, 256 * 4 * 32 * 256)),  # the expert's, fused
], ids=["albert", "fused_ragged_d64", "ragged_d128", "fused_d128"])
def test_backward_hands_both_passes_one_geometry_per_tensor(monkeypatch, shape, fused, dims, strides):
    """``flash_attention_backward`` computes the TMA views of q, k, v, dout once and
    hands the same four to the dQ and the dK/dV pass. Meta tensors stand in for CUDA
    ones; the launches are recorded instead of made."""
    q, k, v, dout = _backward_inputs(*shape, fused)
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
    assert [name for name, _ in launched] == ["dq", "dkv"] and launched[0][1] is launched[1][1]
    assert launched[0][1] == (TmaGeometry(dims, strides, (64, 1, 64, 1)),) * 4


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
