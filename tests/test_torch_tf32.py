"""The 3xTF32 flash kernels (fp32's forward, dQ and dK/dV passes on the tensor cores), on the CPU.

The kernels split every fp32 operand into TF32 hi and lo parts and form each product
from three TF32 products, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. They run only on the card,
where ``chip_smoke.py`` holds them to the plain versions; here ``tf32_split`` (the split
in PyTorch) is checked bit by bit, the kernels' arithmetic is emulated on the plain
versions and held to the JAX package's Pallas kernels in interpret mode within the fp32
limits ``chip_smoke.py`` states, plain TF32 arithmetic is shown to miss those limits, and
the wrappers' routes, copies and launch counts are checked on meta tensors."""

import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemind_tpu.ops.pallas_attention import _flash_backward as jax_flash_backward
from hivemind_tpu.ops.pallas_attention import _flash_forward as jax_flash_forward
from hivemind_tpu_torch.ops import flash_attention as flash_module
from hivemind_tpu_torch.ops.flash_attention import (
    PASSES,
    flash_attention_backward,
    flash_attention_backward_dkv,
    flash_attention_backward_dq,
    flash_attention_lse,
    flash_refusal,
    flash_route,
    flash_routes,
    needs_copy,
    tf32_split,
    tf32x3_block_rows,
)

torch.set_num_threads(1)  # tiny shapes; leaves the cores to the swarm tests that share the machine

_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # its limits and error readings; it imports no torch at module level

LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, to nearest with ties away from zero, in float64 (an
    independent statement of cvt.rna.tf32.f32 for normal fp32 values)."""
    mantissa, exponent = np.frexp(x.astype(np.float64))  # |mantissa| in [0.5, 1)
    return np.sign(mantissa) * np.floor(np.abs(mantissa) * 2.0**11 + 0.5) * np.exp2(exponent - 11.0)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e3, 1e30])
def test_tf32_split_rounds_each_part_to_tf32(scale):
    """hi is x rounded to TF32 and lo is x − hi rounded likewise, both with their low 13 bits
    zero, and x − hi − lo within 2⁻²²·|x|: on seeded normal values of either sign at
    magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = (rng.standard_normal(8192) * scale).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert not (_bits(hi) & LOW_BITS).any() and not (_bits(lo) & LOW_BITS).any()
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _round_tf32(x))
    residual = x.astype(np.float64) - hi.numpy().astype(np.float64)
    np.testing.assert_array_equal(lo.numpy().astype(np.float64), _round_tf32(residual.astype(np.float32)))
    error = np.abs(residual - lo.numpy().astype(np.float64))
    assert (error <= 2.0**-22 * np.abs(x.astype(np.float64))).all(), (error / np.abs(x)).max()


def test_tf32_split_rounds_ties_away_from_zero_and_keeps_zero():
    """Half-way cases (low 13 bits exactly 0x1000) round away from zero, as cvt.rna does,
    on either sign; exact TF32 values and zero split into themselves and a zero lo."""
    patterns = np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF, 0x3F801001, 0x3F802000, 0x0, 0x80000000],
                        dtype=np.uint32)
    hi, lo = tf32_split(torch.from_numpy(patterns.view(np.float32)))
    assert [hex(b) for b in _bits(hi)] == ["0x3f802000", "0xbf802000", "0x3f804000", "0x3f800000", "0x3f802000",
                                           "0x3f802000", "0x0", "0x80000000"]
    assert lo[5].item() == 0.0 and lo[6].item() == 0.0
    assert lo[0].item() == -(2.0**-11) and lo[1].item() == 2.0**-11  # x − hi: the tie's lost half step


def _products(spec: str, a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """``einsum(spec, a, b)`` in fp32 with every product formed from TF32 parts: split, the
    3xTF32 kernels' a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the small terms first, one fp32
    sum); otherwise plain TF32's a_hi·b_hi. A product of two TF32 values is exact in fp32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if not split:
        return torch.einsum(spec, a_hi, b_hi)
    return torch.einsum(spec, a_lo, b_hi) + torch.einsum(spec, a_hi, b_lo) + torch.einsum(spec, a_hi, b_hi)


def _emulated_forward(q, k, v, causal: bool, split: bool):
    """The plain forward with its two products in TF32 arithmetic (``_products``)."""
    seq = q.shape[1]
    scores = _products("bqhd,bkhd->bhqk", q, k, split) * q.shape[-1] ** -0.5
    if causal:
        positions = torch.arange(seq)
        scores = scores.masked_fill(positions[None, :] > positions[:, None], -1e30)
    lse = torch.logsumexp(scores, dim=-1)
    return _products("bhqk,bkhd->bqhd", torch.exp(scores - lse[..., None]), v, split), lse


def _emulated_dkv(q, k, v, dout, lse, delta, causal: bool, split: bool):
    """The plain dK/dV pass with its four products in TF32 arithmetic: S and dP, then
    dK = Σ dSᵀ·Q and dV = Σ Pᵀ·dO."""
    seq, scale = q.shape[1], q.shape[-1] ** -0.5
    scores = _products("bqhd,bkhd->bhqk", q, k, split) * scale
    if causal:
        positions = torch.arange(seq)
        scores = scores.masked_fill(positions[None, :] > positions[:, None], -1e30)
    p = torch.exp(scores - lse[..., None])
    ds = p * (_products("bqhd,bkhd->bhqk", dout, v, split) - delta[..., None]) * scale
    return _products("bhqk,bqhd->bkhd", ds, q, split), _products("bhqk,bqhd->bkhd", p, dout, split)


def _emulated_dq(q, k, v, dout, lse, delta, causal: bool, split: bool):
    """The plain dQ pass with its three products in TF32 arithmetic: S and dP, then
    dQ = Σ dS·K."""
    seq, scale = q.shape[1], q.shape[-1] ** -0.5
    scores = _products("bqhd,bkhd->bhqk", q, k, split) * scale
    if causal:
        positions = torch.arange(seq)
        scores = scores.masked_fill(positions[None, :] > positions[:, None], -1e30)
    p = torch.exp(scores - lse[..., None])
    ds = p * (_products("bqhd,bkhd->bhqk", dout, v, split) - delta[..., None]) * scale
    return _products("bhqk,bkhd->bqhd", ds, k, split)


# (B, T, H, D, causal): ALBERT's head dim at a ragged T, head dim 20 (a multiple of 4, not of 8),
# and 128 (the 3xTF32 kernels' other width)
EMULATED_CASES = [(1, 200, 2, 64, False), (1, 200, 2, 64, True), (1, 136, 2, 20, True), (1, 128, 2, 128, True)]


def _inputs(batch, seq, heads, dim, causal):
    rng = np.random.default_rng(seq + dim + causal)
    return [rng.standard_normal((batch, seq, heads, dim)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("batch, seq, heads, dim, causal", EMULATED_CASES)
def test_tf32x3_forward_emulation_meets_the_fp32_limits_against_the_jax_kernel(batch, seq, heads, dim, causal):
    """The forward with every product in 3xTF32 against the JAX package's Pallas forward in
    interpret mode on the same fp32 inputs, within ``chip_smoke.py``'s fp32 limits (out:
    FLASH_TOL["float32"], each element against atol + rtol·Σp|v|; lse: LSE_TOL); the same
    forward in plain TF32 misses them, as the card's planted fault does. Measured: 3xTF32 at
    most 0.018 of an element's limit (norm ratios <= 5.4e-7); plain TF32 3.4 to 11.4 limits."""
    q, k, v, _ = _inputs(batch, seq, heads, dim, causal)
    out_j, lse_j = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    ref_out, ref_lse = torch.from_numpy(np.array(out_j)), torch.from_numpy(np.array(lse_j))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    scale = flash_module.flash_attention_plain(tq, tk, tv.abs(), causal)[0]
    readings = {}
    for split in (True, False):
        out, lse = _emulated_forward(tq, tk, tv, causal, split)
        readings[split] = (smoke.error_reading(out, ref_out, scale, smoke.FLASH_TOL["float32"], 23),
                           smoke.error_reading(lse, ref_lse, ref_lse.abs(), smoke.LSE_TOL, 23))
    assert readings[True][0]["ok"] and readings[True][1]["ok"], readings[True]
    assert not (readings[False][0]["ok"] and readings[False][1]["ok"]), readings[False]


@pytest.mark.parametrize("batch, seq, heads, dim, causal", EMULATED_CASES)
def test_tf32x3_dkv_emulation_meets_the_fp32_limits_against_the_jax_kernel(batch, seq, heads, dim, causal):
    """The dK/dV pass with every product in 3xTF32 against the JAX package's Pallas dK/dV
    pass in interpret mode, from the JAX forward's (out, lse) and a non-uniform cotangent,
    within ``chip_smoke.py``'s fp32 limits (FLASH_BWD_TOL["float32"], each element against
    atol + rtol·scale, scale the plain backward on absolute values); plain TF32 misses them.
    Measured: 3xTF32 at most 0.014 of an element's limit (norm ratios <= 7.7e-7, the limit
    1e-5); plain TF32 3.0 to 6.4 limits (norm ratios 4.1e-4 to 6.1e-4)."""
    q, k, v, dout = _inputs(batch, seq, heads, dim, causal)
    dout = (dout * np.cos(np.arange(dim))).astype(np.float32)
    out, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    _, dk_j, dv_j = jax_flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse, jnp.asarray(dout),
                                       causal=causal, interpret=True)
    tq, tk, tv, tdout = (torch.from_numpy(t) for t in (q, k, v, dout))
    tlse = torch.from_numpy(np.array(lse))
    delta = flash_module._delta(torch.from_numpy(np.array(out)), tdout)
    scales = smoke.backward_scales(torch, tq, tk, tv, tdout, tlse, delta, causal)[1:]
    refs = (torch.from_numpy(np.array(dk_j)), torch.from_numpy(np.array(dv_j)))
    readings = {}
    for split in (True, False):
        got = _emulated_dkv(tq, tk, tv, tdout, tlse, delta, causal, split)
        readings[split] = [smoke.error_reading(g, r, sc, smoke.FLASH_BWD_TOL["float32"], 23)
                           for g, r, sc in zip(got, refs, scales)]
    assert all(r["ok"] for r in readings[True]), readings[True]
    assert not all(r["ok"] for r in readings[False]), readings[False]


@pytest.mark.parametrize("batch, seq, heads, dim, causal", EMULATED_CASES)
def test_tf32x3_dq_emulation_meets_the_fp32_limits_against_the_jax_kernel(batch, seq, heads, dim, causal):
    """The dQ pass with its three products in 3xTF32 against the JAX package's Pallas dQ pass in
    interpret mode, from the JAX forward's (out, lse) and a non-uniform cotangent, within
    ``chip_smoke.py``'s fp32 limits (FLASH_BWD_TOL["float32"], each element against atol +
    rtol·Σ|dS||K|); the same pass in plain TF32 misses them, as the card's planted fault does.
    Measured: 3xTF32 at most 0.11 of an element's limit (norm ratios <= 7.4e-7, the limit 1e-5);
    plain TF32 4.4 to 32 limits (norm ratios 5.5e-4 to 6.4e-4)."""
    q, k, v, dout = _inputs(batch, seq, heads, dim, causal)
    dout = (dout * np.cos(np.arange(dim))).astype(np.float32)
    out, lse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    dq_j, _, _ = jax_flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse, jnp.asarray(dout),
                                    causal=causal, interpret=True)
    tq, tk, tv, tdout = (torch.from_numpy(t) for t in (q, k, v, dout))
    tlse = torch.from_numpy(np.array(lse))
    delta = flash_module._delta(torch.from_numpy(np.array(out)), tdout)
    scale = smoke.backward_scales(torch, tq, tk, tv, tdout, tlse, delta, causal)[0]
    ref = torch.from_numpy(np.array(dq_j))
    readings = {split: smoke.error_reading(_emulated_dq(tq, tk, tv, tdout, tlse, delta, causal, split), ref, scale,
                                           smoke.FLASH_BWD_TOL["float32"], 23)
                for split in (True, False)}
    assert readings[True]["ok"], readings[True]
    assert not readings[False]["ok"], readings[False]


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


T, S = "tf32x3", "simt"


# fp32 input -> each pass's route (forward, dq, dkv), whether the kernels read a copy
@pytest.mark.parametrize("make, routes, copy", [
    (lambda: _meta((2, 64, 4, 64)), (T, T, T), False),
    (lambda: _meta((2, 64, 4, 128)), (T, T, T), False),
    (lambda: _meta((2, 64, 4, 20)), (T, T, T), False),  # a multiple of 4, not of 8
    (lambda: _meta((2, 64, 4, 16)), (T, T, T), False),
    (lambda: _meta((2, 64, 4, 18)), (S, S, S), False),  # not a multiple of 4: rows not whole 16-byte chunks
    (lambda: _meta((2, 64, 4, 12)), (S, S, S), False),  # below 16
    (lambda: _meta((2, 64, 4, 132)), (S, S, S), False),  # past 128
    (lambda: _meta((2, 64, 4, 256)), (S, S, S), False),
    (lambda: _meta((2, 64, 3, 4, 64))[:, :, 1], (T, T, T), False),  # a fused projection's slice: 16-byte aligned
    (lambda: _meta((2, 64, 4, 66))[..., :64], (T, T, T), True),  # head stride 66: not a multiple of 4
    (lambda: _meta((2 * 64 * 4 * 64 + 1,))[1:].view(2, 64, 4, 64), (T, T, T), True),  # 4 bytes off 16-byte alignment
    (lambda: _meta((2, 64, 4, 18))[..., :16], (T, T, T), True),  # head stride 18
    (lambda: _meta((2, 64, 64, 4)).transpose(2, 3), (T, T, T), True),  # head dim not contiguous
], ids=["d64", "d128", "d20", "d16", "d18", "d12", "d132", "d256", "fused", "head_stride_66", "misaligned",
        "head_stride_18", "strided_head_dim"])
def test_fp32_routes_take_tf32x3_in_every_pass_and_simt_outside_its_head_dims(make, routes, copy):
    q = make()
    assert tuple(flash_route(q, which) for which in PASSES) == routes
    assert flash_routes(q) == " ".join(f"{which}={route}" for which, route in zip(PASSES, routes))
    assert needs_copy(q) is copy
    laid_out = flash_module._kernel_layout(q)
    assert (laid_out is not q) is copy and not needs_copy(laid_out)
    assert flash_refusal(q, ("k", q), ("v", q)) is None


def test_tf32x3_blocks_and_the_grid_take_the_finest_rows():
    """A tf32x3 forward or dQ block owns 128 query rows up to a head_dim of 64 and 64 above, a
    dK/dV block 64 KV rows, which bound T; at a head_dim SIMT takes, its 16 rows a block do."""
    assert [tf32x3_block_rows(d, "forward") for d in (16, 64, 68, 128)] == [128, 128, 64, 64]
    assert [tf32x3_block_rows(d, "dq") for d in (16, 64, 68, 128)] == [128, 128, 64, 64]
    assert [tf32x3_block_rows(d, "dkv") for d in (16, 64, 128)] == [64, 64, 64]
    for head_dim, rows in ((64, 64), (128, 64), (18, 16)):
        assert flash_refusal(_meta((1, rows * 65535, 1, head_dim))) is None
        error, message = flash_refusal(_meta((1, rows * 65535 + 1, 1, head_dim)))
        assert error is ValueError and f"T <= {rows * 65535}" in message


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
    for wrapper, routes in ((flash_attention_lse, ("packed", "tf32x3")),
                            (flash_attention_backward_dq, ("packed", "simt", "tf32x3")),
                            (flash_attention_backward_dkv, ("packed", "tf32x3"))):
        monkeypatch.setattr(wrapper, "launches", 0)
        for route in routes:
            monkeypatch.setattr(wrapper, route, flash_module.LaunchCount())
    return calls


def test_fp32_wrappers_launch_tf32x3_and_simt_through_the_strides_and_count_each_route(recorded_launches):
    """An fp32 [B, T, H, 64] forward and backward launch ``hm_flash_forward_tf32x3``,
    ``hm_flash_backward_dq_tf32x3`` and ``hm_flash_backward_dkv_tf32x3`` with the tensors'
    B, T, H strides in elements (no TMA views); at head_dim 18 the three SIMT kernels run; each
    launch counts on its route."""
    fused = _meta((2, 96, 3, 4, 64))
    q, k, v = fused.unbind(2)  # T stride 3·4·64, read through it
    out, lse = flash_attention_lse(q, k, v, causal=True)
    assert out.is_contiguous() and lse.shape == (2, 4, 96)
    flash_attention_backward(q, k, v, out, lse, _meta((2, 96, 4, 64)), causal=True)
    names = [name for name, _ in recorded_launches]
    assert names == ["hm_flash_forward_tf32x3", "hm_flash_backward_dq_tf32x3", "hm_flash_backward_dkv_tf32x3"]
    forward_args = recorded_launches[0][1]
    assert forward_args[5:10] == (0, 2, 96, 4, 64)  # dtype code (fp32), B, T, H, D
    assert forward_args[10:22] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    assert forward_args[-3:-1] == (1, 64 ** -0.5)
    dq_args = recorded_launches[1][1]
    assert dq_args[7:12] == (0, 2, 96, 4, 64) and dq_args[12:15] == q.stride()[:3]
    assert dq_args[24:27] == (96 * 4 * 64, 4 * 64, 64)  # dq's, contiguous
    dkv_args = recorded_launches[2][1]
    assert dkv_args[8:13] == (0, 2, 96, 4, 64) and dkv_args[13:16] == q.stride()[:3]
    q18 = _meta((2, 96, 4, 18))
    out18, lse18 = flash_attention_lse(q18, q18, q18)
    flash_attention_backward(q18, q18, q18, out18, lse18, q18)
    assert [name for name, _ in recorded_launches[3:]] == [
        "hm_flash_forward_simt", "hm_flash_backward_dq_simt", "hm_flash_backward_dkv_simt"]
    counts = [(flash_attention_lse.launches, flash_attention_lse.tf32x3.launches, flash_attention_lse.packed.launches),
              (flash_attention_backward_dq.launches, flash_attention_backward_dq.tf32x3.launches,
               flash_attention_backward_dq.simt.launches),
              (flash_attention_backward_dkv.launches, flash_attention_backward_dkv.tf32x3.launches)]
    assert counts == [(2, 1, 0), (2, 1, 1), (2, 1)]
