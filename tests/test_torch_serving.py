"""PyTorch port vs JAX package: the expert blocks, ModuleBackend, TaskPool/Runtime
and the Llama checkpoint loader, on the CPU (``device="cpu"``).

Both packages get the same weights: the flax params are carried across with
``hivemind_tpu_torch.convert.from_flax_params`` (their random inits differ by
design: jax.random vs torch.Generator). Both compute dense layers in bf16, so
outputs agree within a stated bf16 tolerance: the largest absolute difference
over the reference's largest magnitude, as ops/device_check.py measures it.
Whole-block errors cannot tell apart conventions whose effect is far below that
tolerance (tanh vs erf gelu, LayerNorm eps), so each convention the blocks share
with flax also has a unit test of its own."""

import asyncio
import json

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.layers.common import apply_rope as jax_apply_rope
from hivemind_tpu.moe.server.llama_loader import load_llama_blocks as jax_load_llama_blocks
from hivemind_tpu.moe.server.llama_loader import predict_block_param_bytes as jax_predict_block_param_bytes
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.ops.quantized_params import dequantize_tree as jax_dequantize_tree
from hivemind_tpu_torch.convert import from_flax_params
from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.layers.common import Dense, LayerNorm, RMSNorm, _gelu, _rotate_half, apply_rope
from hivemind_tpu_torch.moe.server.llama_loader import (
    LlamaCheckpointConfig,
    SafetensorsFile,
    device_hbm_bytes,
    load_llama_blocks,
    plan_block_capacity,
    predict_block_param_bytes,
)
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.runtime import Runtime
from hivemind_tpu_torch.moe.server.task_pool import ServerOverloadedError, TaskPool

# the shapes are tiny: one intra-op thread is enough, and it leaves the cores to
# the timing-sensitive swarm tests that share the machine with this file
torch.set_num_threads(1)

# bf16 compute on both sides. Measured on these seeds: one block <= 5.3e-3, two
# chained blocks <= 9.7e-3; int8 vs fp weights in the port 1.35e-2.
MAX_REL_ERR = 8e-3
CHAIN_MAX_REL_ERR = 1.2e-2
INT8_VS_FP_REL_ERR = 2e-2  # quantization error, ops/device_check.py:26's tolerance
BF16_ULP = 2.0**-7  # one bf16 ulp, relative to the value, at its worst


def _max_rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


# ------------------------------------------------------------------ conventions


def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    expected = np.asarray(jax.nn.gelu(x))
    np.testing.assert_allclose(_gelu(torch.from_numpy(x)).numpy(), expected, rtol=0, atol=1e-6)
    erf_gelu = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf_gelu - expected).max() > 1e-4  # the check tells the two gelus apart


def _small_variance_input(rng, hid):
    # variance ~1e-6: an eps of 1e-5 in place of 1e-6 rescales the output by ~0.4
    # (no large mean: flax's one-pass variance would cancel catastrophically)
    return np.asarray(1e-3 * rng.randn(4, 6, hid), np.float32)


def _assert_within_one_bf16_ulp(got: torch.Tensor, expected) -> None:
    assert got.dtype == torch.bfloat16
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=BF16_ULP, atol=1e-6)


def test_layer_norm_matches_flax_eps_and_bf16_output():
    rng = np.random.RandomState(11)
    hid = 48
    x = _small_variance_input(rng, hid)
    scale, bias = (1.0 + 0.1 * rng.randn(hid)).astype(np.float32), (0.1 * rng.randn(hid)).astype(np.float32)
    flax_norm = flax_nn.LayerNorm(dtype=jnp.bfloat16)
    expected = flax_norm.apply({"params": {"scale": scale, "bias": bias}}, x)
    norm = LayerNorm(hid)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        _assert_within_one_bf16_ulp(norm(torch.from_numpy(x)), expected)
        torch_default_eps = torch.nn.functional.layer_norm(torch.from_numpy(x), (hid,), norm.weight, norm.bias)
    assert np.abs(torch_default_eps.numpy() - np.asarray(expected, np.float32)).max() > 0.1


def test_rms_norm_matches_flax_eps_and_bf16_output():
    rng = np.random.RandomState(12)
    hid = 48
    x = np.asarray(1e-3 * rng.randn(4, 6, hid), np.float32)  # mean square ~1e-6
    scale = (1.0 + 0.1 * rng.randn(hid)).astype(np.float32)
    for eps in (1e-6, 1e-5):  # the JAX block's default, and Llama-2's rms_norm_eps
        expected = flax_nn.RMSNorm(epsilon=eps, dtype=jnp.bfloat16).apply({"params": {"scale": scale}}, x)
        norm = RMSNorm(hid, eps)
        norm.load_state_dict({"weight": torch.from_numpy(scale)})
        with torch.no_grad():
            _assert_within_one_bf16_ulp(norm(torch.from_numpy(x)), expected)
            other = RMSNorm(hid, 1e-5 if eps == 1e-6 else 1e-6)
            other.load_state_dict({"weight": torch.from_numpy(scale)})
            assert np.abs(other(torch.from_numpy(x)).float().numpy() - np.asarray(expected, np.float32)).max() > 0.1


def test_dense_computes_in_bf16_on_fp32_params():
    rng = np.random.RandomState(13)
    x = rng.randn(5, 32).astype(np.float32)
    kernel, bias = (rng.randn(32, 24) / np.sqrt(32)).astype(np.float32), (0.1 * rng.randn(24)).astype(np.float32)
    expected = flax_nn.Dense(24, dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    dense = Dense(32, 24)
    dense.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()), "bias": torch.from_numpy(bias)})
    assert dense.weight.dtype == torch.float32
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=0, atol=BF16_ULP * np.abs(expected).max())


def test_rope_matches_jax_split_halves_and_fp32_angles():
    assert _rotate_half(torch.tensor([1.0, 2.0, 3.0, 4.0])).tolist() == [-3.0, -4.0, 1.0, 2.0]
    rng = np.random.RandomState(14)
    x = rng.randn(2, 40, 3, 16).astype(np.float32)
    for theta in (10000.0, 500000.0):
        expected = np.asarray(jax_apply_rope(jnp.asarray(x), theta))
        np.testing.assert_allclose(apply_rope(torch.from_numpy(x), theta).numpy(), expected, rtol=0, atol=2e-5)
        x16 = torch.from_numpy(x).to(torch.bfloat16)
        expected16 = jax_apply_rope(jnp.asarray(x, jnp.bfloat16), theta)
        got16 = apply_rope(x16, theta)
        assert got16.dtype == torch.bfloat16
        _assert_within_one_bf16_ulp(got16, expected16)


def _random_flax_params(params, rng):
    """Replace every leaf: kernels ~ N(0, 1/fan_in), norm scales near 1, biases small."""

    def leaf(path, value):
        name = path[-1].key
        shape = np.shape(value)
        if name == "kernel":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[0]), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


BLOCK_CASES = [
    ("ffn", {}, (3, 32), None),
    ("transformer", {"num_heads": 4}, (2, 16, 32), None),
    ("causal_transformer", {"num_heads": 4}, (2, 16, 32), None),
    ("llama_block", {"num_heads": 4}, (2, 16, 64), None),
    ("llama_block", {"num_heads": 4, "num_kv_heads": 2}, (2, 16, 64), None),  # grouped-query
    ("llama_block", {"num_heads": 4, "num_kv_heads": 2, "ffn_inner": 96, "rms_eps": 1e-5}, (2, 16, 64), "int8"),
    ("nop", {}, (3, 32), None),
    # TinyBERT_General_4L_312D's attention widths: hidden 312, 12 heads of 26
    ("transformer", {"num_heads": 12}, (2, 16, 312), None),
]


@pytest.mark.parametrize(
    "block,kwargs,shape,quantization", BLOCK_CASES,
    ids=["ffn", "transformer", "causal_transformer", "llama", "llama_gqa", "llama_int8", "nop", "transformer_tinybert"],
)
def test_block_backend_matches_jax(block, kwargs, shape, quantization):
    rng = np.random.RandomState(len(block) + len(kwargs))
    x = rng.randn(*shape).astype(np.float32)
    hid = shape[-1]
    jax_backend = JaxModuleBackend("jax", jax_blocks[block](hid, **kwargs), optimizer=optax.sgd(0.0),
                                   sample_input=x, weight_quantization=quantization)
    flax_params = _random_flax_params(jax_dequantize_tree(jax_backend.params), rng)
    jax_backend.load_params(flax_params)
    backend = ModuleBackend("torch", name_to_block[block](hid, **kwargs), sample_input=x,
                            weight_quantization=quantization, device="cpu")
    backend.load_params(from_flax_params(block, flax_params))

    expected = jax_backend.forward(x)[0]
    got = backend.forward(x)[0]
    assert got.dtype == np.float32 and got.shape == expected.shape
    assert _max_rel_err(got, expected) < MAX_REL_ERR
    assert backend.param_bytes() == jax_backend.param_bytes()
    info, jax_info = backend.get_info(), jax_backend.get_info()
    for ours, theirs in zip(info["forward_schema"] + info["outputs_schema"],
                            jax_info["forward_schema"] + jax_info["outputs_schema"]):
        assert (ours.shape, ours.dtype) == (theirs.shape, theirs.dtype)


def test_int8_backend_stays_close_to_fp_and_refuses_backward():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 64).astype(np.float32)
    make = lambda: name_to_block["llama_block"](64, num_heads=4)
    fp = ModuleBackend("fp", make(), sample_input=x, device="cpu", rng_seed=3)
    q8 = ModuleBackend("q8", make(), sample_input=x, device="cpu", rng_seed=3, weight_quantization="int8")
    assert q8.param_bytes() < fp.param_bytes() / 3
    assert _max_rel_err(q8.forward(x)[0], fp.forward(x)[0]) < INT8_VS_FP_REL_ERR
    with pytest.raises(RuntimeError, match="int8 weight-only"):  # as the JAX backend
        q8.backward(x, x)
    assert q8.get_info()["updates"] == 0
    with pytest.raises(KeyError, match="missing"):
        fp.load_params({})

    # weights given at construction are served as given, with no seeded init
    given = ModuleBackend("given", make(), sample_input=x, device="cpu", rng_seed=4, params=fp.snapshot_params())
    np.testing.assert_array_equal(given.forward(x)[0], fp.forward(x)[0])
    given_q8 = ModuleBackend("given_q8", make(), sample_input=x, device="cpu", weight_quantization="int8",
                             params=fp.snapshot_params())
    np.testing.assert_array_equal(given_q8.forward(x)[0], q8.forward(x)[0])
    assert given_q8.get_info()["outputs_schema"] == q8.get_info()["outputs_schema"]
    wrong_shape = {**fp.snapshot_params(), "ffn_norm.weight": torch.ones(3)}
    with pytest.raises(ValueError, match="ffn_norm.weight"):
        ModuleBackend("bad", make(), sample_input=x, device="cpu", params=wrong_shape)
    with pytest.raises(KeyError, match="missing"):
        ModuleBackend("bad", make(), sample_input=x, device="cpu", params={})

    # the fp backend trains: the default optimizer is SGD at learning rate 0, so it
    # reports input gradients and counts the update without moving its weights
    before = {key: tensor.clone() for key, tensor in fp.snapshot_params().items()}
    (grad,) = fp.backward(x, np.ones_like(x))
    assert grad.shape == x.shape and np.isfinite(grad).all() and np.abs(grad).max() > 0
    assert fp.update_count == fp.get_info()["updates"] == 1
    assert all(torch.equal(before[key], tensor) for key, tensor in fp.snapshot_params().items())
    with pytest.raises(ValueError, match="gradient"):
        fp.backward(x)
    # weights given at construction are copied: training one backend leaves the other as it was
    trained = ModuleBackend("trained", make(), sample_input=x, device="cpu", params=fp.snapshot_params(),
                            optimizer=lambda tensors: torch.optim.SGD(tensors, lr=1e-2))
    trained.backward(x, np.ones_like(x))
    assert not np.array_equal(trained.forward(x)[0], fp.forward(x)[0])
    np.testing.assert_array_equal(given.forward(x)[0], fp.forward(x)[0])


# ------------------------------------------------------------------ task pool


async def test_task_pool_sheds_checks_outputs_and_splits_by_shape():
    pool = TaskPool(lambda x: [x * 2], "shed", max_queue_size=0)
    with pytest.raises(ServerOverloadedError):
        await pool.submit_task(np.zeros((1, 4), np.float32))

    bad = TaskPool(lambda x: [x[:1]], "bad", max_batch_size=8)
    runtime = Runtime([bad])
    runtime.start()
    try:
        results = await asyncio.gather(
            bad.submit_task(np.zeros((2, 4), np.float32)),
            bad.submit_task(np.zeros((2, 4), np.float32)),
            return_exceptions=True,
        )
    finally:
        await runtime.shutdown()
    assert all(isinstance(r, ValueError) and "mis-slice" in str(r) for r in results)

    pool = TaskPool(lambda x: [x], "split", max_batch_size=8)
    submits = [asyncio.ensure_future(pool.submit_task(np.zeros((1, length), np.float32))) for length in (3, 3, 5, 3)]
    await asyncio.sleep(0)  # every submit has queued its task
    try:
        assert pool.priority == pool._queue[0].timestamp  # the oldest queued task
        for expected in ([3, 3], [5], [3]):  # a batch stops at the first task of another shape
            assert [task.args[0].shape[1] for task in pool.pop_batch()] == expected
        assert pool.priority == float("inf")
    finally:
        for submit in submits:
            submit.cancel()
        await asyncio.gather(*submits, return_exceptions=True)


# ------------------------------------------------------------------ llama loader

HID, HEADS, KV_HEADS, INNER, LAYERS = 128, 4, 2, 352, 2


def _write_checkpoint(path, seed=0):
    """A tiny sharded HF-layout Llama checkpoint: 2 layers across 2 shard files."""
    rng = np.random.RandomState(seed)
    (path / "config.json").write_text(json.dumps({
        "hidden_size": HID, "num_attention_heads": HEADS, "num_key_value_heads": KV_HEADS,
        "intermediate_size": INNER, "num_hidden_layers": LAYERS, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5,
    }))
    head_dim = HID // HEADS
    weight_map = {}
    for layer in range(LAYERS):
        prefix = f"model.layers.{layer}."
        scale = 1.0 / np.sqrt(HID)
        tensors = {
            prefix + "self_attn.q_proj.weight": rng.randn(HEADS * head_dim, HID) * scale,
            prefix + "self_attn.k_proj.weight": rng.randn(KV_HEADS * head_dim, HID) * scale,
            prefix + "self_attn.v_proj.weight": rng.randn(KV_HEADS * head_dim, HID) * scale,
            prefix + "self_attn.o_proj.weight": rng.randn(HID, HID) * scale,
            prefix + "mlp.gate_proj.weight": rng.randn(INNER, HID) * scale,
            prefix + "mlp.up_proj.weight": rng.randn(INNER, HID) * scale,
            prefix + "mlp.down_proj.weight": rng.randn(HID, INNER) * scale,
            prefix + "input_layernorm.weight": 1.0 + 0.1 * rng.randn(HID),
            prefix + "post_attention_layernorm.weight": 1.0 + 0.1 * rng.randn(HID),
        }
        shard = f"model-{layer:05d}-of-{LAYERS:05d}.safetensors"
        save_file({k: v.astype(np.float32) for k, v in tensors.items()}, path / shard)
        weight_map.update({name: shard for name in tensors})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


@pytest.mark.parametrize("quantization", [None, "int8"])
async def test_served_chain_matches_jax_backends(tmp_path, quantization):
    """Requests chained block 0 → block 1 through the port's TaskPool/Runtime agree
    with the JAX ModuleBackend.forward chain; same-shape requests share batches."""
    _write_checkpoint(tmp_path)
    jax_backends, _ = jax_load_llama_blocks(tmp_path, weight_quantization=quantization)
    backends, config = load_llama_blocks(tmp_path, weight_quantization=quantization, device="cpu", max_batch_size=8)
    assert list(backends) == ["llama.0", "llama.1"] and config.rms_norm_eps == 1e-5
    for uid, backend in backends.items():
        assert backend.param_bytes() == jax_backends[uid].param_bytes()
        assert backend.param_bytes() == predict_block_param_bytes(config, quantization)

    pools = [TaskPool(backends[f"llama.{i}"].forward, f"llama.{i}", max_batch_size=8) for i in range(LAYERS)]
    runtime = Runtime(pools)
    runtime.start()
    rng = np.random.RandomState(1)
    requests = [rng.randn(1, length, HID).astype(np.float32) for length in (16, 16, 16, 16, 24)]

    async def chain(x):
        for pool in pools:
            (x,) = await pool.submit_task(x)
        return x

    try:
        outputs = await asyncio.wait_for(asyncio.gather(*(chain(x) for x in requests)), timeout=120)
    finally:
        await runtime.shutdown()
    assert runtime.batches_processed < len(requests) * LAYERS  # the four 16-long requests merged
    for x, got in zip(requests, outputs):
        expected = x
        for i in range(LAYERS):
            expected = jax_backends[f"llama.{i}"].forward(expected)[0]
        assert got.shape == x.shape
        assert _max_rel_err(got, expected) < CHAIN_MAX_REL_ERR


def test_safetensors_reader_matches_safe_open(tmp_path):
    rng = np.random.RandomState(2)
    tensors = {
        "f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(4, 6).astype(np.float32)).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.randint(-128, 127, size=(9,)).astype(np.int8)),
        "i64": torch.from_numpy(rng.randint(0, 1 << 40, size=(2, 2)).astype(np.int64)),
        "empty": torch.zeros(0, 3),
    }
    path = tmp_path / "model.safetensors"
    save_torch_file(tensors, str(path), metadata={"format": "pt"})
    ours = SafetensorsFile(path)
    assert sorted(ours.keys()) == sorted(tensors)
    with safe_open(str(path), framework="pt") as reference:
        for name in tensors:
            expected = reference.get_tensor(name)
            got = ours.get(name)
            assert got.shape == tuple(expected.shape)
            if expected.dtype == torch.bfloat16:
                assert got.dtype == np.float32  # widened exactly
                np.testing.assert_array_equal(got, expected.float().numpy())
            else:
                assert got.dtype == expected.numpy().dtype
                np.testing.assert_array_equal(got, expected.numpy())


def test_capacity_planning_matches_jax_arithmetic():
    config = LlamaCheckpointConfig(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32,
                                   intermediate_size=11008, num_hidden_layers=32, rms_norm_eps=1e-5)
    from hivemind_tpu.moe.server.llama_loader import LlamaCheckpointConfig as JaxConfig

    jax_config = JaxConfig(**config.__dict__)
    for quantization in (None, "int8"):
        assert predict_block_param_bytes(config, quantization) == jax_predict_block_param_bytes(jax_config, quantization)
    block = predict_block_param_bytes(config, "int8")
    assert plan_block_capacity(block, hbm_bytes=80 * 2**30) == int(80 * 2**30 * 0.8) // block
    assert plan_block_capacity(block, hbm_bytes=2**30, decode_sessions=4, cache_bytes_per_session_block=2**20) == int(
        2**30 * 0.8) // (block + 4 * 2**20)
    assert device_hbm_bytes("cpu") is None
    with pytest.raises(ValueError, match="hbm_bytes"):
        plan_block_capacity(block, device="cpu")
