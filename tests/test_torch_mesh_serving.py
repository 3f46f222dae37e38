"""The port's serving mesh (``MeshModuleBackend`` over a ``ServingMesh``) against the JAX
package's ``MeshModuleBackend``, on the CPU: the port's mesh is 2 × ``cpu``, the JAX
mesh the first 2 of the 8 virtual CPU devices, both loading the tiny checkpoint of
``tests/test_llama_loader.py`` (hidden 128, 4 heads, 2 KV heads, inner 352, 2 layers).

Tolerances: both packages compute the blocks' dense layers in bf16. Through two chained
blocks the port's single device and the JAX package agree within 1.2e-2
(``tests/test_torch_serving.py``'s chain limit); the mesh rounds each shard's partial of
``attention_out`` and ``ffn_down`` to bf16 before the fp32 sum, one more bf16 rounding
(2⁻⁸ relative) of each partial, so the mesh is held within 2e-2 of the JAX mesh and of
the port's single device (measured: 6.3e-3 to 1.1e-2). The backward (one SGD step) is the
same bf16 block run the other way, held the same way: the input gradient and each
parameter's step within 2e-2 of the reference's largest (measured against the JAX mesh:
8.7e-3 and up to 1.45e-2, the query kernel; against the single device: 7.8e-3 and
1.15e-2). The int8 codes, absmax, byte counts, cache shapes, capacity plans, the norm
copies after a step and the state blobs are exact."""

from __future__ import annotations

import contextlib
import signal
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from hivemind_tpu.moe.server.decode_session import DecodeSessionManager as JaxDecodeSessionManager
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.llama_loader import LlamaCheckpointConfig as JaxLlamaCheckpointConfig
from hivemind_tpu.moe.server.llama_loader import decode_cache_bytes as jax_decode_cache_bytes
from hivemind_tpu.moe.server.llama_loader import load_llama_blocks as jax_load_llama_blocks
from hivemind_tpu.moe.server.llama_loader import plan_block_capacity as jax_plan_block_capacity
from hivemind_tpu.moe.server.llama_loader import predict_block_param_bytes as jax_predict_block_param_bytes
from hivemind_tpu.moe.server.mesh_backend import MeshModuleBackend as JaxMeshModuleBackend
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.ops.quantized_params import dequantize_tree as jax_dequantize_tree
from hivemind_tpu_torch.convert import from_flax_albert_params, from_flax_params
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe import RemoteSequential
from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.llama_loader import (
    LlamaCheckpointConfig,
    decode_cache_bytes,
    load_llama_blocks,
    plan_block_capacity,
    predict_block_param_bytes,
)
from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.mesh_backend import MeshModuleBackend, ServingMesh, kv_ranges
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.server import Server
from hivemind_tpu_torch.ops.blockwise_int8 import blockwise_int8_dequantize_window
from hivemind_tpu_torch.ops.quantization import blockwise_dequantize, blockwise_dequantize_window, blockwise_quantize
from hivemind_tpu_torch.ops.quantized_params import QuantizedWindow
from hivemind_tpu_torch.telemetry import REGISTRY
from hivemind_tpu_torch.utils import flax_msgpack

from test_llama_loader import HEADS, HID, KV_HEADS, LAYERS, _write_checkpoint
from test_torch_serving import _random_flax_params

torch.set_num_threads(1)  # tiny shapes; leave the cores to the timing-sensitive swarm tests

SHARDS = 2
MESH_TOL = 2e-2
BACKWARD_LR = 1e-2
QUANTIZATIONS = [None, "int8"]


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test (TimeoutError at the blocked call) after ``seconds`` of wall time."""

    def _expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _max_rel_err(got, expected) -> float:
    got, expected = np.asarray(got, np.float32), np.asarray(expected, np.float32)
    return float(np.abs(got - expected).max() / (np.abs(expected).max() + 1e-9))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_llama")
    _write_checkpoint(path)
    return path


def _port_mesh(checkpoint, quantization, prefix="mesh."):
    return load_llama_blocks(checkpoint, mesh=ServingMesh(["cpu"] * SHARDS), weight_quantization=quantization,
                             uid_prefix=prefix)[0]


def _jax_mesh(checkpoint, quantization):
    mesh = Mesh(np.array(jax.devices()[:SHARDS]).reshape(SHARDS), ("tp",))
    return jax_load_llama_blocks(checkpoint, uid_prefix="mesh.", mesh=mesh, weight_quantization=quantization)[0]


@pytest.fixture(scope="module", params=QUANTIZATIONS, ids=["fp32", "int8"])
def meshes(request, checkpoint):
    quantization = request.param
    return quantization, _port_mesh(checkpoint, quantization), _jax_mesh(checkpoint, quantization)


def _chain(backends, x):
    for backend in backends.values():
        x = np.asarray(backend.forward(x)[0])
    return x


def test_prefill_matches_the_jax_mesh_and_the_single_device(meshes, checkpoint):
    quantization, port, jax_mesh = meshes
    assert all(isinstance(backend, MeshModuleBackend) for backend in port.values())
    x = np.random.RandomState(0).randn(2, 7, HID).astype(np.float32)
    got = _chain(port, x)
    single = _chain(load_llama_blocks(checkpoint, device="cpu", weight_quantization=quantization)[0], x)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert _max_rel_err(got, _chain(jax_mesh, x)) < MESH_TOL
    assert _max_rel_err(got, single) < MESH_TOL


def test_int8_codes_and_absmax_are_the_jax_packages_bit_for_bit(checkpoint):
    port = _port_mesh(checkpoint, "int8")["mesh.0"]
    jax_params = _jax_mesh(checkpoint, "int8")["mesh.0"].params
    windows = 0
    for key, pieces in zip(port.params[0], zip(*(shard.values() for shard in port.params))):
        if not isinstance(pieces[0], QuantizedWindow):
            continue
        reference = jax_params[key.split(".")[0]]["kernel"]  # a flax [in, out] kernel, quantized whole
        n_in, n_out = reference.shape
        codes = np.asarray(reference.codes).reshape(-1)[: n_in * n_out].reshape(n_in, n_out)
        # column-parallel shards hold flax columns, row-parallel shards flax rows
        axis = 1 if pieces[0].codes.shape[0] == n_in else 0
        np.testing.assert_array_equal(np.concatenate([piece.codes.numpy() for piece in pieces], axis=axis), codes)
        for piece in pieces:
            np.testing.assert_array_equal(piece.absmax.numpy(), np.asarray(reference.absmax))
        windows += 1
    assert windows == 7


def test_param_bytes_leaf_specs_and_info_match_the_jax_mesh(meshes):
    _quantization, port, jax_mesh = meshes
    for uid, backend in port.items():
        reference = jax_mesh[uid]
        assert backend.param_bytes_per_device() == reference.param_bytes_per_device()
        assert backend.param_bytes() == reference.param_bytes()
        for leaf in jax.tree_util.tree_leaves(reference.params):
            assert backend.leaf_spec(leaf) == tuple(reference.leaf_spec(leaf)), leaf.shape
        info, jax_info = backend.get_info(), reference.get_info()
        assert (info["mesh_devices"], info["shard_axis"]) == (jax_info["mesh_devices"], jax_info["shard_axis"]) == (SHARDS, "tp")
        assert info["forward_schema"][0].shape == jax_info["forward_schema"][0].shape
        assert repr(backend) == repr(reference)


def test_per_shard_caches_match_the_jax_mesh(meshes):
    quantization, port, jax_mesh = meshes
    backend, reference = port["mesh.0"], jax_mesh["mesh.0"]
    cache_k, cache_v = backend.shard_decode_cache(*backend.module.init_decode_cache(2, 32, "meta"))
    jax_k, _jax_v = reference.shard_decode_cache(*reference.module.init_decode_cache(2, 32))
    assert [tuple(shard.data.shape) for shard in jax_k.addressable_shards] == [tuple(c.shape) for c in cache_k]
    assert [tuple(c.shape) for c in cache_v] == [(2, 32, KV_HEADS // SHARDS, HID // HEADS)] * SHARDS
    assert all(c.dtype == torch.bfloat16 and not c.any() for c in (*cache_k, *cache_v))
    # the decode-session manager keeps a session's caches as those shards
    manager = DecodeSessionManager(port, max_len=32)
    manager.decode("mesh.0", "s", np.random.RandomState(1).randn(1, 3, HID).astype(np.float32), reset=True)
    session = manager._sessions[("mesh.0", "s")]
    assert [tuple(c.shape) for c in session.cache_k] == [(1, 32, KV_HEADS // SHARDS, HID // HEADS)] * SHARDS
    assert all(c.abs().sum() > 0 for c in session.cache_k)  # the prefill wrote every shard


@pytest.mark.parametrize("quantization", QUANTIZATIONS, ids=["fp32", "int8"])
def test_merged_steps_stack_and_copy_back_shard_by_shard(checkpoint, quantization):
    """Three sessions step merged on the mesh: the stack is made shard by shard, each
    session's own shards receive exactly their rows' new position (and stay their own
    storage), and each output matches the same session stepped alone within the bf16
    limit (a stacked batch may round its GEMMs differently from one row)."""
    mesh = _port_mesh(checkpoint, quantization)
    rng = np.random.RandomState(3)
    prompts = [rng.randn(1, 4 + i, HID).astype(np.float32) for i in range(3)]
    tokens = [rng.randn(1, 1, HID).astype(np.float32) for _ in range(3)]
    merged, alone = DecodeSessionManager(mesh, max_len=16), DecodeSessionManager(mesh, max_len=16)
    for i, prompt in enumerate(prompts):
        merged.decode("mesh.0", f"s{i}", prompt, reset=True)
        alone.decode("mesh.0", f"s{i}", prompt, reset=True)
    sessions = [merged._sessions[("mesh.0", f"s{i}")] for i in range(3)]
    storages = [[c.untyped_storage().data_ptr() for c in s.cache_k + s.cache_v] for s in sessions]
    stacks = []
    step = merged._batched_step
    merged._batched_step = lambda *args: stacks.append(step(*args)) or stacks[-1]
    outputs = merged._decode_batch("mesh.0", [(None, session, x) for session, x in zip(sessions, tokens)])
    [(_y, stack_k, stack_v)] = stacks
    assert [tuple(c.shape) for c in stack_k] == [(3, 16, KV_HEADS // SHARDS, HID // HEADS)] * SHARDS
    stack_storages = {c.untyped_storage().data_ptr() for c in stack_k + stack_v}
    for row, (session, prompt) in enumerate(zip(sessions, prompts)):
        assert session.index == prompt.shape[1] + 1
        assert [c.untyped_storage().data_ptr() for c in session.cache_k + session.cache_v] == storages[row]
        assert stack_storages.isdisjoint(storages[row])
        for own, stacked in zip(session.cache_k + session.cache_v, stack_k + stack_v):
            torch.testing.assert_close(own[0], stacked[row], rtol=0, atol=0)
        expected = alone.decode("mesh.0", f"s{row}", tokens[row], reset=False)
        assert _max_rel_err(outputs[row], expected) < MESH_TOL


@pytest.mark.parametrize("quantization", QUANTIZATIONS, ids=["fp32", "int8"])
def test_mesh_state_dict_is_a_single_device_backends_and_loads_both_ways(checkpoint, quantization):
    mesh = _port_mesh(checkpoint, quantization)["mesh.0"]
    single = load_llama_blocks(checkpoint, layers=[0], device="cpu", weight_quantization=quantization)[0]["llama.0"]
    blob = mesh.state_dict()
    assert blob == single.state_dict()
    # the mesh's blob into a fresh single-device backend, and a single device's into a mesh
    other = load_llama_blocks(checkpoint, layers=[1], device="cpu", weight_quantization=quantization)[0]["llama.1"]
    other.load_state_dict(blob)
    assert other.state_dict() == blob
    other_mesh = _port_mesh(checkpoint, quantization)["mesh.1"]
    other_mesh.load_state_dict(single.state_dict())
    assert other_mesh.state_dict() == blob
    for key, tensor in mesh.gather_params().items():
        torch.testing.assert_close(other_mesh.gather_params()[key], tensor, rtol=0, atol=0)


def test_window_dequantize_plain_matches_numpy_and_the_whole_tensor():
    rng = np.random.default_rng(7)
    n_in, n_out = 96, 352  # 33,792 codes: 9 blocks, the last one partial, blocks straddling rows
    weight = rng.standard_normal(n_in * n_out).astype(np.float32)
    flat = torch.from_numpy(np.concatenate([weight, np.zeros(9 * 4096 - weight.size, np.float32)]))
    codes, absmax = blockwise_quantize(flat)
    grid = codes.reshape(-1)[: n_in * n_out].reshape(n_in, n_out)
    whole = blockwise_dequantize(codes, absmax)[: n_in * n_out].reshape(n_in, n_out)
    scale = absmax.numpy() / np.float32(127.0)
    for rows, cols in ((slice(0, n_in), slice(88, 176)), (slice(48, 96), slice(0, n_out)), (slice(5, 9), slice(3, 10))):
        window = grid[rows, cols].contiguous()
        base = rows.start * n_out + cols.start
        index = base + np.arange(window.shape[0])[:, None] * n_out + np.arange(window.shape[1])[None, :]
        expected = window.numpy().astype(np.float32) * scale[index // 4096]
        got = blockwise_dequantize_window(window, absmax, n_out, base)
        np.testing.assert_array_equal(got.numpy(), expected)
        np.testing.assert_array_equal(got.numpy(), whole[rows, cols].numpy())
        # the wrapper runs the plain version on CPU tensors
        np.testing.assert_array_equal(blockwise_int8_dequantize_window(window, absmax, n_out, base).numpy(), expected)
    with pytest.raises(ValueError, match="exceeds"):
        blockwise_int8_dequantize_window(grid[:, 300:].contiguous(), absmax, n_out, 4000)
    # neither a CPU nor a CUDA tensor: refused, never computed by the plain version
    with pytest.raises(ValueError, match="CUDA or CPU"):
        blockwise_int8_dequantize_window(grid[:4, :8].contiguous().to("meta"), absmax.to("meta"), n_out, 0)


def test_the_mesh_refuses_the_backward(checkpoint):
    """An int8 mesh refuses the backward, as the int8 single-device backend does (and
    the JAX package's): its weights are codes, not trainable tensors."""
    backend = _port_mesh(checkpoint, "int8")["mesh.0"]
    x = np.zeros((1, 3, HID), np.float32)
    with pytest.raises(RuntimeError, match="int8 weight-only"):
        backend.backward(x, x)
    assert backend.optimizer is None and backend.update_count == 0


def _steps(after: dict, before: dict) -> dict:
    return {key: np.asarray(after[key], np.float32) - np.asarray(before[key], np.float32) for key in before}


def test_mesh_backward_matches_the_jax_mesh_and_the_single_device(checkpoint):
    """One backward with an SGD step on the port's 2 × cpu mesh, the JAX mesh of 2 devices
    (GSPMD differentiates its sharded forward) and the port's single device, from the same
    weights, input and output gradient: the input gradient and each parameter's step within
    MESH_TOL of the largest, and the norm copies identical on every shard after the step."""
    rng = np.random.RandomState(11)
    x, grad_out = (rng.randn(2, 9, HID).astype(np.float32) for _ in range(2))
    mesh = load_llama_blocks(checkpoint, layers=[0], mesh=ServingMesh(["cpu"] * SHARDS),
                             optimizer=lambda p: torch.optim.SGD(p, lr=BACKWARD_LR))[0]["llama.0"]
    single = load_llama_blocks(checkpoint, layers=[0], device="cpu",
                               optimizer=lambda p: torch.optim.SGD(p, lr=BACKWARD_LR))[0]["llama.0"]
    reference = jax_load_llama_blocks(checkpoint, layers=[0], optimizer=optax.sgd(BACKWARD_LR),
                                      mesh=Mesh(np.array(jax.devices()[:SHARDS]).reshape(SHARDS), ("tp",)))[0]["llama.0"]
    before = {key: tensor.clone() for key, tensor in mesh.gather_params().items()}
    (grad_x,) = mesh.backward(x, grad_out)
    (single_grad_x,) = single.backward(x, grad_out)
    (jax_grad_x,) = reference.backward(x, grad_out)
    assert mesh.update_count == 1 and mesh.get_info()["updates"] == 1
    assert grad_x.shape == x.shape and np.isfinite(grad_x).all()
    assert _max_rel_err(grad_x, jax_grad_x) < MESH_TOL
    assert _max_rel_err(grad_x, single_grad_x) < MESH_TOL
    steps = _steps(mesh.gather_params(), before)
    jax_after = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, reference.params))
    for name, expected in (("jax", _steps(jax_after, before)), ("single", _steps(single.snapshot_params(), before))):
        for key, step in steps.items():
            assert np.abs(step).max() > 0, key
            assert _max_rel_err(step, expected[key]) < MESH_TOL, (name, key, _max_rel_err(step, expected[key]))
    for key in ("attention_norm.weight", "ffn_norm.weight"):
        copies = [shard[key] for shard in mesh.params]
        assert all(torch.equal(copy, copies[0]) for copy in copies[1:]), key
    # the next forward runs on the stepped shards
    np.testing.assert_allclose(mesh.forward(x)[0], _chain({"s": single}, x), rtol=0, atol=MESH_TOL * np.abs(
        _chain({"s": single}, x)).max())


@pytest.mark.parametrize("optimizer", ["adam", "sgd_momentum"])
def test_a_stepped_mesh_state_dict_loads_into_a_single_device_and_back(checkpoint, optimizer):
    """After a step, the mesh's blob holds its optimizer's statistics assembled from the
    shards, in the single-device optax layout: a single-device backend restores it and
    writes the same bytes, and a mesh restores those bytes and steps on as the first
    mesh does."""
    factory = {"adam": lambda p: torch.optim.Adam(p, lr=1e-3),
               "sgd_momentum": lambda p: torch.optim.SGD(p, lr=1e-2, momentum=0.9)}[optimizer]
    rng = np.random.RandomState(12)
    x, grad_out = (rng.randn(1, 5, HID).astype(np.float32) for _ in range(2))
    mesh = load_llama_blocks(checkpoint, layers=[0], mesh=ServingMesh(["cpu"] * SHARDS), optimizer=factory)[0]["llama.0"]
    mesh.backward(x, grad_out)
    blob = mesh.state_dict()
    restored = flax_msgpack.msgpack_restore(blob)
    first = restored["opt_state"]["0"]
    assert (set(first) == {"count", "mu", "nu"} and int(first["count"]) == 1) if optimizer == "adam" else "trace" in first
    single = load_llama_blocks(checkpoint, layers=[1], device="cpu", optimizer=factory)[0]["llama.1"]
    single.load_state_dict(blob)
    assert single.state_dict() == blob
    other = load_llama_blocks(checkpoint, layers=[1], mesh=ServingMesh(["cpu"] * SHARDS), optimizer=factory)[0]["llama.1"]
    other.load_state_dict(single.state_dict())
    assert other.state_dict() == blob
    # both meshes take the same second step
    mesh.backward(x, grad_out)
    other.backward(x, grad_out)
    assert other.state_dict() == mesh.state_dict()


@pytest.mark.parametrize("quantization", QUANTIZATIONS, ids=["fp32", "int8"])
@pytest.mark.parametrize("mesh_devices", [1, 2, 8])
def test_capacity_planning_with_mesh_devices_matches_jax(quantization, mesh_devices):
    config = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32, intermediate_size=11008,
                  num_hidden_layers=32)
    block = predict_block_param_bytes(LlamaCheckpointConfig(**config), quantization)
    assert block == jax_predict_block_param_bytes(JaxLlamaCheckpointConfig(**config), quantization)
    cache = decode_cache_bytes(LlamaCheckpointConfig(**config), batch=1, max_len=512)
    assert cache == jax_decode_cache_bytes(JaxLlamaCheckpointConfig(**config), batch=1, max_len=512)
    for budget in (600 * 1024**2, 80 * 1024**3):
        for sessions in (0, 2, 8):
            kwargs = dict(hbm_bytes=budget, decode_sessions=sessions, cache_bytes_per_session_block=cache,
                          mesh_devices=mesh_devices)
            assert plan_block_capacity(block, **kwargs) == jax_plan_block_capacity(block, **kwargs)


def test_hbm_planning_7b_mesh_pooling():
    """The JAX package's test_hbm_planning_7b_mesh_pooling numbers: one card of 600 MB holds
    no fp32 7B block, a mesh of 8 pools to several."""
    config = LlamaCheckpointConfig(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32,
                                   intermediate_size=11008, num_hidden_layers=32)
    block = predict_block_param_bytes(config)
    assert block > 700 * 1024**2
    budget, cache = 600 * 1024**2, decode_cache_bytes(config, batch=1, max_len=512)
    single = plan_block_capacity(block, hbm_bytes=budget, decode_sessions=2, cache_bytes_per_session_block=cache)
    pooled = plan_block_capacity(block, hbm_bytes=budget, decode_sessions=2, cache_bytes_per_session_block=cache,
                                 mesh_devices=8)
    assert single == 0 and pooled >= 4
    assert pooled == jax_plan_block_capacity(block, hbm_bytes=budget, decode_sessions=2,
                                             cache_bytes_per_session_block=cache, mesh_devices=8)


def _decode_chain(pipe, hidden, session, steps):
    chunks = [np.asarray(pipe.decode_step(hidden, session, reset=True))]
    for _ in range(steps):
        chunks.append(np.asarray(pipe.decode_step(chunks[-1][:, -1:], session)))
    return np.concatenate(chunks, axis=1)


def test_mesh_sharded_server_is_token_identical_over_rpc(checkpoint):
    """The same checkpoint served twice from one Server, meshed and single-device: a
    6-step decode chain through RemoteSequential (each step feeds the last output back,
    so any divergence compounds) gives the same argmax chain under a fixed surrogate
    head, and two meshed sessions stepping at once merge into one step."""
    backends = {**_port_mesh(checkpoint, None, prefix="meshed."),
                **load_llama_blocks(checkpoint, device="cpu", uid_prefix="single.")[0]}
    dht = DHT(start=True)
    server = Server(dht, backends, decode_max_len=64, activation_compression="none")
    client = None
    try:
        with deadline(120):
            server.run_in_background(await_ready=True)
            time.sleep(1.0)
            client = DHT(initial_peers=[str(m) for m in dht.get_visible_maddrs()], start=True)
            rng = np.random.RandomState(5)
            prompt_len, steps = 6, 6
            hidden = rng.randn(1, prompt_len, HID).astype(np.float32)
            outputs = {prefix: _decode_chain(RemoteSequential(client, prefix, LAYERS), hidden, f"tok_{prefix}", steps)
                       for prefix in ("meshed.", "single.")}
            meshed, single = outputs["meshed."], outputs["single."]
            assert meshed.shape == single.shape == (1, prompt_len + steps, HID)
            # bf16 blocks, and the feedback chain compounds the rounding over 6 steps:
            # the norm check is loose, the argmax chain exact (the JAX package's test)
            assert np.linalg.norm(meshed - single) / np.linalg.norm(single) < 3e-2
            proj = rng.randn(HID, 64).astype(np.float32)  # a fixed surrogate LM head
            np.testing.assert_array_equal(np.argmax(meshed @ proj, axis=-1), np.argmax(single @ proj, axis=-1))

            # one merged step of two meshed sessions: a wide flush window, so the two
            # steps in flight at once share one device call
            manager = server.handler.decode_sessions
            manager.flush_window, manager.merge_recency_s = 0.5, 30.0
            pipes = [RemoteSequential(client, "meshed.", LAYERS) for _ in range(2)]
            starts = [rng.randn(1, prompt_len, HID).astype(np.float32) for _ in range(2)]
            firsts = [np.asarray(pipe.decode_step(x, f"merge_{i}", reset=True)) for i, (pipe, x) in
                      enumerate(zip(pipes, starts))]
            batched = REGISTRY.get("hivemind_moe_decode_steps_total").labels(path="batched").value
            results = [None, None]

            def step(i):
                results[i] = np.asarray(pipes[i].decode_step(firsts[i][:, -1:], f"merge_{i}"))

            threads = [threading.Thread(target=step, args=(i,)) for i in range(2)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            assert REGISTRY.get("hivemind_moe_decode_steps_total").labels(path="batched").value - batched >= 2 * LAYERS
            single_pipe = RemoteSequential(client, "single.", LAYERS)
            for i in range(2):
                single_pipe.decode_step(starts[i], f"alone_{i}", reset=True)
                expected = np.asarray(single_pipe.decode_step(firsts[i][:, -1:], f"alone_{i}"))
                assert _max_rel_err(results[i], expected) < MESH_TOL
                np.testing.assert_array_equal(np.argmax(results[i] @ proj, axis=-1), np.argmax(expected @ proj, axis=-1))
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()
        dht.shutdown()



# ---------------------------------------------------------------------- every block, any N
#
# Each registered block over meshes of N CPU shards, against the JAX MeshModuleBackend
# on a JAX mesh of the first N virtual devices and against the port's single device,
# from the same seeded numpy weights (``convert.py``). The widths are chosen so that the
# cuts are uneven: hidden 80 and 5 heads (1/2/2 heads over 3 shards, 1/1/1/2 over 4), an
# ffn of 320 (106/107/107 over 3); the Llama cases read 2 KV heads from 8 heads over 4
# and 8 shards (each KV head copied to 2 and 4 shards) and from 6 heads over 4 (2/3/2/3
# heads; shards 1 and 3 start inside a group) and 5 heads over 3. Leaves of at least 4096 elements quantize
# (``ffn_up`` and the like, their windows cutting blocks). Limits: MESH_TOL for every
# output, input gradient and step (the blocks compute in bf16; a row-parallel bias is
# added after the fp32 reduce, where the single device adds it inside its bf16 Dense
# output: one more bf16 rounding, inside the limit); the copies after a step, the state
# blobs and the weights gathered back are exact.

BLOCK_HID = 80
MESH_BLOCKS = [
    (block, kwargs, parts)
    for block, kwargs in (("ffn", {}), ("transformer", {"num_heads": 5}), ("causal_transformer", {"num_heads": 5}),
                          ("det_dropout", {}), ("nop", {}))
    for parts in (2, 3, 4)
] + [
    ("llama_block", {"num_heads": 8, "num_kv_heads": 2}, 4),  # each KV head on 2 shards
    ("llama_block", {"num_heads": 8, "num_kv_heads": 2}, 8),  # each KV head on 4 shards
    ("llama_block", {"num_heads": 5, "num_kv_heads": 5}, 3),  # uneven heads, no groups
    ("llama_block", {"num_heads": 10, "num_kv_heads": 2}, 4),  # 2/3/2/3 heads, shards starting inside a group
]
DECODING_BLOCKS = ("causal_transformer", "llama_block")


def _block_inputs(block: str, rng) -> tuple:
    if block in ("ffn", "nop"):
        return (rng.randn(3, BLOCK_HID).astype(np.float32),)
    if block == "det_dropout":
        return rng.randn(3, BLOCK_HID).astype(np.float32), (rng.rand(3, BLOCK_HID) > 0.2).astype(np.float32)
    return (rng.randn(2, 9, BLOCK_HID).astype(np.float32),)


def _block_triplet(block, kwargs, parts, quantization, inputs, seed=0):
    """The JAX mesh, the port's mesh and the port's single device of one block, all
    loaded with the same seeded weights and SGD(BACKWARD_LR)."""
    sample = dict(sample_inputs=inputs) if len(inputs) > 1 else dict(sample_input=inputs[0])
    jax_mesh = Mesh(np.array(jax.devices()[:parts]).reshape(parts), ("tp",))
    reference = JaxMeshModuleBackend("ref", jax_blocks[block](BLOCK_HID, **kwargs), mesh=jax_mesh,
                                     optimizer=optax.sgd(BACKWARD_LR), weight_quantization=quantization, **sample)
    flax_params = _random_flax_params(jax_dequantize_tree(reference.params), np.random.RandomState(seed))
    reference.load_params(flax_params)
    params = from_flax_params(block, flax_params)
    sgd = lambda tensors: torch.optim.SGD(tensors, lr=BACKWARD_LR)
    mesh = MeshModuleBackend("mesh", name_to_block[block](BLOCK_HID, **kwargs), mesh=ServingMesh(["cpu"] * parts),
                             optimizer=sgd, weight_quantization=quantization, params=params, **sample)
    single = ModuleBackend("single", name_to_block[block](BLOCK_HID, **kwargs), optimizer=sgd, device="cpu",
                           weight_quantization=quantization, params=params, **sample)
    return reference, mesh, single, params


def _mesh_case_id(case):
    block, kwargs, parts = case
    heads = f"-{kwargs['num_heads']}h{kwargs['num_kv_heads']}kv" if "num_kv_heads" in kwargs else ""
    return f"{block}{heads}-N{parts}"


@pytest.mark.parametrize("quantization", QUANTIZATIONS, ids=["fp32", "int8"])
@pytest.mark.parametrize("case", MESH_BLOCKS, ids=[_mesh_case_id(case) for case in MESH_BLOCKS])
def test_every_block_over_any_mesh_matches_the_jax_mesh(case, quantization):
    """Forward, decode (prefill and two steps), the state blob loaded both ways and, for
    fp32, one backward with an SGD step: the port's mesh of N shards against the JAX
    mesh of N devices and the port's single device."""
    block, kwargs, parts = case
    rng = np.random.RandomState(parts + len(block))
    inputs = _block_inputs(block, rng)
    reference, mesh, single, params = _block_triplet(block, kwargs, parts, quantization, inputs)

    got = mesh.forward(*inputs)[0]
    assert got.shape == inputs[0].shape and np.isfinite(got).all()
    assert _max_rel_err(got, reference.forward(*inputs)[0]) < MESH_TOL
    assert _max_rel_err(got, single.forward(*inputs)[0]) < MESH_TOL
    # every distinct tensor once; a quantized leaf's windows hold no padding to a whole block
    padding = sum(value.codes.numel() - value.size for value in single.params.values() if hasattr(value, "codes"))
    assert mesh.param_bytes() == single.param_bytes() - padding
    assert mesh.get_info()["mesh_devices"] == parts

    if block in DECODING_BLOCKS:
        prompt, steps = inputs[0][:1, :5], [rng.randn(1, 1, BLOCK_HID).astype(np.float32) for _ in range(2)]
        managers = [DecodeSessionManager({"b": mesh}, max_len=16), DecodeSessionManager({"b": single}, max_len=16),
                    JaxDecodeSessionManager({"b": reference}, max_len=16)]
        for chunk, reset in ((prompt, True), (steps[0], False), (steps[1], False)):
            ours, alone, theirs = (np.asarray(manager.decode("b", "s", chunk, reset=reset)) for manager in managers)
            assert _max_rel_err(ours, theirs) < MESH_TOL and _max_rel_err(ours, alone) < MESH_TOL
        session = managers[0]._sessions[("b", "s")]
        heads = kwargs["num_heads"]
        expected = [stop - start for start, stop in kv_ranges(heads, kwargs.get("num_kv_heads", heads), parts)]
        assert [c.shape[2] for c in session.cache_k] == expected
        assert all(c.shape[:2] == (1, 16) for c in session.cache_k + session.cache_v)

    # the mesh's blob is the single device's, and each loads the other's
    blob = mesh.state_dict()
    assert blob == single.state_dict()
    _, other_mesh, other_single, _ = _block_triplet(block, kwargs, parts, quantization, inputs, seed=1)
    other_mesh.load_state_dict(single.state_dict())
    other_single.load_state_dict(blob)
    assert other_mesh.state_dict() == other_single.state_dict() == blob

    if quantization is not None:
        with pytest.raises(RuntimeError, match="int8 weight-only"):
            mesh.backward(*inputs, got)
        return
    grad_out = rng.randn(*got.shape).astype(np.float32)
    before = mesh.gather_params()
    grads = mesh.backward(*inputs, grad_out)
    jax_grads = reference.backward(*inputs, grad_out)
    single_grads = single.backward(*inputs, grad_out)
    for ours, theirs, alone in zip(grads, jax_grads, single_grads):
        assert ours.shape == np.shape(theirs) and np.isfinite(ours).all()
        assert _max_rel_err(ours, theirs) < MESH_TOL and _max_rel_err(ours, alone) < MESH_TOL
    steps = _steps(mesh.gather_params(), before)
    largest = max(np.abs(step).max() for step in steps.values())
    jax_after = from_flax_params(block, jax.tree_util.tree_map(np.asarray, reference.params))
    for name, expected in (("jax", _steps(jax_after, before)), ("single", _steps(single.snapshot_params(), before))):
        for key, step in steps.items():
            if key == "key.bias":  # softmax ignores it: its exact gradient is 0, rounding noise on every side
                assert np.abs(step).max() < MESH_TOL * largest
                continue
            assert _max_rel_err(step, expected[key]) < MESH_TOL, (name, key, _max_rel_err(step, expected[key]))
    # every copy took the same step: the norms on every shard, a KV head's rows on each of its shards
    for key, leaf in mesh.plan.leaves.items():
        if leaf.kind == "copy":
            copies = [shard[key] for shard in mesh.params]
            assert all(torch.equal(copy, copies[0]) for copy in copies[1:]), key
        elif leaf.unit == "kv":
            size = mesh._unit_size["kv"]
            rows = {}
            for (start, stop), shard in zip(mesh._ranges["kv"], mesh.params):
                for j in range(start, stop):
                    row = shard[key].narrow(0, (j - start) * size, size)
                    assert torch.equal(rows.setdefault(j, row), row), (key, j)
    # the stepped mesh still writes the single device's blob shape and loads back
    single.load_state_dict(mesh.state_dict())
    assert single.state_dict() == mesh.state_dict()


def test_a_module_with_no_plan_is_refused():
    """A custom expert no plan names cannot be served over a mesh."""

    class Custom(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.ones(8, 8))

        def forward(self, x):
            return x @ self.weight

    with pytest.raises(TypeError, match="no tensor-parallel plan for Custom"):
        MeshModuleBackend("custom", Custom(), mesh=ServingMesh(["cpu"] * 2), sample_input=np.zeros((2, 8), np.float32))


@pytest.mark.parametrize("parts", [3, 4])
def test_a_checkpoint_whose_kv_heads_do_not_divide_the_mesh_is_served(checkpoint, parts):
    """The tiny checkpoint's 2 KV heads over 3 and 4 shards (each KV head copied):
    load_llama_blocks serves it, and the two chained blocks match the single device."""
    mesh = load_llama_blocks(checkpoint, mesh=ServingMesh(["cpu"] * parts))[0]
    x = np.random.RandomState(parts).randn(1, 6, HID).astype(np.float32)
    expected = _chain(load_llama_blocks(checkpoint, device="cpu")[0], x)
    assert _max_rel_err(_chain(mesh, x), expected) < MESH_TOL
