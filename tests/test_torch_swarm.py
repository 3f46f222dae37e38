"""The port's expert ``Server`` and ``RemoteSequential`` against the JAX package's, in
one swarm over loopback TCP: a port client chains blocks served by a JAX server and
a JAX client blocks served by a port server, both found through the DHT alone; a
route runs block 0 on a port server and block 1 on a JAX server; a decode session
fails over when the replica it pinned dies; autograd through the pipe steps each
server once; ``_generate_uids`` skips uids the DHT already holds; and the handler
options that ``Server`` passes reach admission and the pools.

Tolerances: fp32 experts (Dense in float32, then tanh) 1e-5 with the "none" wire;
the Llama blocks compute their dense layers in bf16 on both sides, so their outputs
are held within 2e-2 relative and their greedy ids by the teacher-forced rule
(the chosen logit within 2e-2 of the best). Each test runs under a wall-clock
deadline (``deadline``)."""

from __future__ import annotations

import contextlib
import json
import random
import signal
import time
import uuid

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import save_file
from torch import nn

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.moe.client.remote_sequential import RemoteSequential as JaxRemoteSequential
from hivemind_tpu.moe.server.dht_handler import get_experts as jax_get_experts
from hivemind_tpu.moe.server.dht_handler import declare_experts as jax_declare_experts
from hivemind_tpu.moe.server.llama_loader import LlamaClientHead as JaxLlamaClientHead
from hivemind_tpu.moe.server.llama_loader import generate_greedy as jax_generate_greedy
from hivemind_tpu.moe.server.llama_loader import load_llama_blocks as jax_load_llama_blocks
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.moe.server.server import Server as JaxServer
from hivemind_tpu_torch.convert import from_flax_albert_params
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe import RemoteSequential, Server, background_server, get_experts
from hivemind_tpu_torch.moe.client import RemoteExpert
from hivemind_tpu_torch.moe.server import FairShareAdmission, ModuleBackend, store_experts
from hivemind_tpu_torch.moe.server.layers.common import Dense
from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks
from hivemind_tpu_torch.moe.server.server import _generate_uids, default_optimizer
from hivemind_tpu_torch.resilience import reset_all_boards
from hivemind_tpu_torch.telemetry.serving import is_overload_error

HID, HEADS, KV_HEADS, INNER, LAYERS, VOCAB = 64, 4, 2, 128, 2, 64
FP32_TOL = 1e-5
BF16_RTOL = 2e-2
GREEDY_LOGIT_RTOL = 2e-2
PROMPT, NEW = 6, 8


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


@pytest.fixture(autouse=True)
def reset_port_breakers():
    yield
    reset_all_boards()  # the port's expert breakers: a killed replica must not ban the next test's


def wait_for(predicate, timeout: float = 20.0, what: str = "condition"):
    started = time.monotonic()
    while not predicate():
        if time.monotonic() - started > timeout:
            raise TimeoutError(f"{what} not reached in {timeout} s")
        time.sleep(0.05)


# ------------------------------------------------------------------ experts


class JaxLinearTanh(jnn.Module):
    hid: int

    @jnn.compact
    def __call__(self, x):
        return jnp.tanh(jnn.Dense(self.hid, dtype=jnp.float32, param_dtype=jnp.float32)(x))


class LinearTanh(nn.Module):
    def __init__(self, hid: int):
        super().__init__()
        self.Dense_0 = Dense(hid, hid, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.Dense_0(x))


def linear_pair(uid: str, lr: float, seed: int):
    """An fp32 expert in each package with the same weights (the JAX one's, from ``seed``)."""
    sample = (np.zeros((2, 3, HID), np.float32),)
    theirs = JaxModuleBackend(uid, JaxLinearTanh(HID), optimizer=optax.sgd(lr), sample_inputs=sample, rng_seed=seed)
    params = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, theirs.params))
    ours = ModuleBackend(uid, LinearTanh(HID), sample_inputs=sample, params=params, device="cpu",
                         optimizer=lambda tensors: torch.optim.SGD(tensors, lr=lr))
    return theirs, ours


def write_checkpoint(path, seed: int = 0) -> None:
    """A tiny HF-layout Llama checkpoint: 2 layers, and the embedding, final norm
    and LM head."""
    rng = np.random.RandomState(seed)
    (path / "config.json").write_text(json.dumps({
        "hidden_size": HID, "num_attention_heads": HEADS, "num_key_value_heads": KV_HEADS,
        "intermediate_size": INNER, "num_hidden_layers": LAYERS, "rope_theta": 10000.0, "rms_norm_eps": 1e-5}))
    head_dim, scale = HID // HEADS, 1.0 / np.sqrt(HID)
    weight_map = {}
    for layer in range(LAYERS):
        prefix = f"model.layers.{layer}."
        tensors = {
            prefix + "self_attn.q_proj.weight": rng.randn(HEADS * head_dim, HID) * scale,
            prefix + "self_attn.k_proj.weight": rng.randn(KV_HEADS * head_dim, HID) * scale,
            prefix + "self_attn.v_proj.weight": rng.randn(KV_HEADS * head_dim, HID) * scale,
            prefix + "self_attn.o_proj.weight": rng.randn(HID, HID) * scale,
            prefix + "mlp.gate_proj.weight": rng.randn(INNER, HID) * scale,
            prefix + "mlp.up_proj.weight": rng.randn(INNER, HID) * scale,
            prefix + "mlp.down_proj.weight": rng.randn(HID, INNER) * scale,
            prefix + "input_layernorm.weight": np.ones(HID),
            prefix + "post_attention_layernorm.weight": np.ones(HID),
        }
        shard = f"model-{layer:05d}.safetensors"
        save_file({name: value.astype(np.float32) for name, value in tensors.items()}, path / shard)
        weight_map.update({name: shard for name in tensors})
    head = {"model.embed_tokens.weight": rng.randn(VOCAB, HID) * scale, "model.norm.weight": np.ones(HID),
            "lm_head.weight": rng.randn(VOCAB, HID) * scale}
    save_file({name: value.astype(np.float32) for name, value in head.items()}, path / "model-head.safetensors")
    weight_map.update({name: "model-head.safetensors" for name in head})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


# ------------------------------------------------------------------ the swarm


class Swarm:
    """A port server and a JAX server on one DHT, and a client DHT of each package.

    - ``lin.*``: fp32 experts, never trained; the same weights in both packages.
    - ``llm.*``: the checkpoint's Llama blocks.
    - ``tr.*``: fp32 experts trained by every backward (SGD 0.1).
    - ``mix.*`` / ``mixllm.*``: block 0 on the port server, block 1 on the JAX one.
    Each package's server serves its copy under ``p``/``j`` + the name above."""

    def __init__(self, checkpoint):
        self.checkpoint = checkpoint
        port, jax_side = {}, {}
        for name, lr in (("lin", 0.0), ("tr", 0.1)):
            for index in range(2):
                theirs, ours = linear_pair(f"{name}.{index}", lr, seed=10 * index + int(lr * 10))
                port[f"p{name}.{index}"], jax_side[f"j{name}.{index}"] = ours, theirs
        for index in range(2):
            theirs, ours = linear_pair(f"mix.{index}", 0.1, seed=50 + index)
            (port if index == 0 else jax_side)[f"mix.{index}"] = ours if index == 0 else theirs
            self.__dict__.setdefault("mix_twins", {})[f"mix.{index}"] = (theirs, ours)
        port.update(load_llama_blocks(checkpoint, uid_prefix="pllm.", device="cpu")[0])
        jax_side.update(jax_load_llama_blocks(checkpoint, uid_prefix="jllm.")[0])
        port.update(load_llama_blocks(checkpoint, layers=[0], uid_prefix="mixllm.", device="cpu")[0])
        jax_side.update(jax_load_llama_blocks(checkpoint, layers=[1], uid_prefix="mixllm.")[0])
        for uid, backend in list(port.items()) + list(jax_side.items()):
            backend.name = uid
        self.backends, self.jax_backends = port, jax_side
        # the local references: port twins of every fp32 expert, never served
        self.twins = {f"lin.{i}": linear_pair(f"lin.{i}", 0.0, seed=10 * i)[1] for i in range(2)}
        self.local_llm = load_llama_blocks(checkpoint, device="cpu")[0]

        self.dht = DHT(start=True)
        maddrs = [str(m) for m in self.dht.get_visible_maddrs()]
        self.server = Server(self.dht, port, decode_max_len=64, activation_compression="none")
        self.server.run_in_background(await_ready=True, timeout=30)
        self.jax_dht = JaxDHT(initial_peers=maddrs, start=True)
        self.jax_server = JaxServer(self.jax_dht, jax_side, decode_max_len=64, activation_compression="none")
        self.jax_server.run_in_background(await_ready=True, timeout=30)
        self.client_dht = DHT(initial_peers=[str(m) for m in self.jax_dht.get_visible_maddrs()], start=True)
        self.jax_client_dht = JaxDHT(initial_peers=maddrs, start=True)
        uids = [f"{side}{name}.{i}" for side in "pj" for name in ("lin", "tr", "llm") for i in range(2)]
        uids += ["mix.0", "mix.1", "mixllm.0", "mixllm.1"]
        wait_for(lambda: all(info is not None for info in get_experts(self.client_dht, uids))
                 and all(info is not None for info in jax_get_experts(self.jax_client_dht, uids)),
                 what="both packages' clients resolving every block")
        self.head = LlamaClientHead.load(checkpoint, device="cpu")
        self.jax_head = JaxLlamaClientHead.load(checkpoint)

    def pipe(self, client: str, prefix: str, **kwargs):
        if client == "port":
            return RemoteSequential(self.client_dht, prefix, 2, **kwargs)
        return JaxRemoteSequential(self.jax_client_dht, prefix, 2, **kwargs)

    def close(self):
        self.jax_client_dht.shutdown()
        self.client_dht.shutdown()
        self.jax_server.shutdown()
        self.jax_dht.shutdown()
        self.server.shutdown()
        self.dht.shutdown()


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    checkpoint = tmp_path_factory.mktemp("llama")
    write_checkpoint(checkpoint)
    with deadline(120):
        swarm = Swarm(checkpoint)
    yield swarm
    swarm.close()


DIRECTIONS = ["port-client-on-jax-server", "jax-client-on-port-server"]


def _client_and_prefix(direction: str, name: str):
    return ("port", f"j{name}.") if direction == DIRECTIONS[0] else ("jax", f"p{name}.")


def _call(client: str, pipe, x: np.ndarray) -> np.ndarray:
    if client == "port":
        with torch.no_grad():
            return pipe(torch.from_numpy(x)).numpy()
    return np.asarray(pipe(jnp.asarray(x)))


def _teacher_forced_gaps(head, blocks, ids: np.ndarray) -> np.ndarray:
    hidden = head.embed(ids[:, :-1]).numpy()
    for uid in sorted(blocks):
        hidden = blocks[uid].forward(hidden)[0]
    logits = head.logits(hidden[:, PROMPT - 1:]).numpy()[0]
    chosen = logits[np.arange(ids.shape[1] - PROMPT), ids[0, PROMPT:]]
    return (logits.max(axis=-1) - chosen) / np.maximum(np.abs(logits.max(axis=-1)), 1.0)


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_each_package_resolves_the_others_servers_through_the_dht(swarm, direction):
    with deadline(30):
        if direction == DIRECTIONS[0]:
            infos = get_experts(swarm.client_dht, ["jlin.0", "jllm.1", "mix.1"])
            assert {info.peer_id.to_bytes() for info in infos} == {swarm.jax_dht.peer_id.to_bytes()}
        else:
            infos = jax_get_experts(swarm.jax_client_dht, ["plin.0", "pllm.1", "mix.0"])
            assert {info.peer_id.to_bytes() for info in infos} == {swarm.dht.peer_id.to_bytes()}
        assert {info.compression for info in infos} == {"none"}  # the record's codec, in both formats
        assert all(len(info.replica_set) == 1 for info in infos)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_forward_through_the_pipe_across_packages(swarm, direction):
    client, prefix = _client_and_prefix(direction, "lin")
    x = np.random.RandomState(1).randn(3, 5, HID).astype(np.float32)
    expected = x
    for index in range(2):
        expected = swarm.twins[f"lin.{index}"].forward(expected)[0]
    with deadline(60):
        pipe = swarm.pipe(client, prefix)
        got = _call(client, pipe, x)
        groups = pipe._grouped_range(0, 2)
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=0, atol=FP32_TOL)
    assert [len(uids) for _head, uids in groups] == [2]  # co-located blocks run as one span


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_decode_and_greedy_generation_across_packages(swarm, direction):
    client, prefix = _client_and_prefix(direction, "llm")
    hidden = np.random.RandomState(2).randn(1, 9, HID).astype(np.float32)
    local = hidden
    for uid in sorted(swarm.local_llm):
        local = swarm.local_llm[uid].forward(local)[0]
    prompt = np.random.RandomState(3).randint(0, VOCAB, size=(1, PROMPT))
    with deadline(90):
        pipe = swarm.pipe(client, prefix)
        session = uuid.uuid4().hex
        outputs = [pipe.decode_step(hidden[:, :6], session, reset=True)]
        outputs += [pipe.decode_step(hidden[:, t:t + 1], session) for t in range(6, 9)]
        if client == "port":
            ids = generate_greedy(swarm.head, pipe, prompt, NEW)
        else:
            ids = jax_generate_greedy(swarm.jax_head, pipe, prompt, NEW)
        pipe.close_decode_session(session)
    decoded = np.concatenate([np.asarray(out) for out in outputs], axis=1)
    np.testing.assert_allclose(decoded, local, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(local).max())
    assert ids.shape == (1, PROMPT + NEW) and np.array_equal(ids[:, :PROMPT], prompt)
    gaps = _teacher_forced_gaps(swarm.head, swarm.local_llm, ids)
    assert gaps.max() <= GREEDY_LOGIT_RTOL, gaps


def test_a_route_with_block_0_on_a_port_server_and_block_1_on_a_jax_server(swarm):
    x = np.random.RandomState(4).randn(2, 5, HID).astype(np.float32)
    jax_mix_1, port_mix_0 = swarm.mix_twins["mix.1"][0], swarm.mix_twins["mix.0"][1]
    twin_0 = linear_pair("mix.0", 0.1, seed=50)[1]
    twin_1 = linear_pair("mix.1", 0.1, seed=51)[1]
    hidden_1 = twin_0.forward(x)[0]
    expected = twin_1.forward(hidden_1)[0]
    weights = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    (grad_1,) = twin_1.backward(hidden_1, weights)
    (expected_grad,) = twin_0.backward(x, grad_1)
    updates = (port_mix_0.update_count, jax_mix_1.update_count)
    prompt = np.random.RandomState(6).randint(0, VOCAB, size=(1, PROMPT))
    with deadline(90):
        pipe = swarm.pipe("port", "mix.")
        groups = pipe._grouped_range(0, 2)
        assert [head.peer_id.to_bytes() for head, _uids in groups] == [
            swarm.dht.peer_id.to_bytes(), swarm.jax_dht.peer_id.to_bytes()]
        with torch.no_grad():
            got = pipe(torch.from_numpy(x)).numpy()
        x_grad = torch.from_numpy(x).requires_grad_(True)
        (pipe(x_grad) * torch.from_numpy(weights)).sum().backward()
        ids = generate_greedy(swarm.head, swarm.pipe("port", "mixllm."), prompt, NEW)
    np.testing.assert_allclose(got, expected, rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(x_grad.grad.numpy(), expected_grad, rtol=0, atol=FP32_TOL)
    assert (port_mix_0.update_count, jax_mix_1.update_count) == (updates[0] + 1, updates[1] + 1)
    assert _teacher_forced_gaps(swarm.head, swarm.local_llm, ids).max() <= GREEDY_LOGIT_RTOL


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_autograd_through_the_pipe_steps_each_server_once(swarm, direction):
    client, prefix = _client_and_prefix(direction, "tr")
    served = swarm.jax_backends if client == "port" else swarm.backends
    twins = []
    for index in range(2):
        twin = linear_pair(f"tr.{index}", 0.1, seed=10 * index + 1)[1]
        before = served[f"{prefix}{index}"]
        current = (from_flax_albert_params(jax.tree_util.tree_map(np.asarray, before.params)) if client == "port"
                   else {key: tensor.clone() for key, tensor in before.params.items()})
        twin.load_params(current)
        twins.append(twin)
    x = np.random.RandomState(7).randn(2, 4, HID).astype(np.float32)
    weights = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    hidden_1 = twins[0].forward(x)[0]
    (grad_1,) = twins[1].backward(hidden_1, weights)
    (expected,) = twins[0].backward(x, grad_1)
    counts = [served[f"{prefix}{index}"].update_count for index in range(2)]
    with deadline(60):
        pipe = swarm.pipe(client, prefix)
        if client == "port":
            x_grad = torch.from_numpy(x).requires_grad_(True)
            (pipe(x_grad) * torch.from_numpy(weights)).sum().backward()
            grad = x_grad.grad.numpy()
        else:
            grad = np.asarray(jax.grad(lambda xx: jnp.sum(pipe(xx) * weights))(jnp.asarray(x)))
    np.testing.assert_allclose(grad, expected, rtol=0, atol=FP32_TOL)
    assert [served[f"{prefix}{index}"].update_count for index in range(2)] == [counts[0] + 1, counts[1] + 1]


def test_span_unaware_server_gets_per_block_calls(swarm):
    with deadline(60):
        pipe = swarm.pipe("port", "jlin.")
        groups = pipe._grouped_range(0, 2)
        assert [len(uids) for _head, uids in groups] == [2]
        pipe._span_support[groups[0][0].peer_id] = False  # as if the JAX server were an older build
        groups = pipe._grouped_range(0, 2)
        assert [len(uids) for _head, uids in groups] == [1, 1] and all(head.span is None for head, _ in groups)
        x = np.random.RandomState(9).randn(1, 3, HID).astype(np.float32)
        got = _call("port", pipe, x)
    expected = swarm.twins["lin.1"].forward(swarm.twins["lin.0"].forward(x)[0])[0]
    np.testing.assert_allclose(got, expected, rtol=0, atol=FP32_TOL)
    assert len(pipe) == 2 and pipe.block_uid(1) == "jlin.1" and pipe.decode_capacity() is None


def test_decode_failover_mid_generation_matches_an_uninterrupted_run(swarm):
    """Block 0 on the JAX server, block 1 on two port replicas: the replica the
    session pinned dies after three tokens, and the session re-prefills the other
    from its retained history; the ids equal those of an uninterrupted run."""
    checkpoint = swarm.checkpoint
    maddrs = [str(m) for m in swarm.dht.get_visible_maddrs()]
    jax_dht = JaxDHT(initial_peers=maddrs, start=True)
    jax_server = JaxServer(jax_dht, jax_load_llama_blocks(checkpoint, layers=[0], uid_prefix="fo.")[0],
                           decode_max_len=64, activation_compression="none")
    replicas = []
    for _ in range(2):
        dht = DHT(initial_peers=maddrs, start=True)
        server = Server(dht, load_llama_blocks(checkpoint, layers=[1], uid_prefix="fo.", device="cpu")[0],
                        decode_max_len=64, activation_compression="none")
        replicas.append((dht, server))
    prompt = np.random.RandomState(10).randint(0, VOCAB, size=(1, PROMPT))
    try:
        with deadline(120):
            jax_server.run_in_background(await_ready=True, timeout=30)
            for _dht, server in replicas:
                server.run_in_background(await_ready=True, timeout=30)
            replica_ids = [dht.peer_id for dht, _server in replicas]
            wait_for(lambda: [len(info.replica_set) if info else 0 for info in get_experts(
                swarm.client_dht, ["fo.0", "fo.1"])] == [1, 2], what="both replicas of fo.1 declared")
            pipe = RemoteSequential(swarm.client_dht, "fo.", 2, max_retries=4)
            reference = generate_greedy(swarm.head, pipe, prompt, NEW, session_id="uninterrupted")
            killed = []

            class KillingPipe:
                def __init__(self):
                    self.calls = 0

                def decode_step(self, hidden, session_id, reset=False):
                    if self.calls == 3:  # three tokens are out: kill the pinned block-1 replica
                        pinned = pipe._decode_routes[session_id]["route"][-1][0].peer_id
                        for dht, server in replicas:
                            if dht.peer_id == pinned:
                                server.shutdown()
                                dht.shutdown()
                                killed.append(pinned)
                    self.calls += 1
                    return pipe.decode_step(hidden, session_id, reset=reset)

            ids = generate_greedy(swarm.head, KillingPipe(), prompt, NEW, session_id="failover")
            final = pipe._decode_routes["failover"]["route"][-1][0].peer_id
        assert len(killed) == 1 and final != killed[0]
        assert final in replica_ids
        np.testing.assert_array_equal(ids, reference)
    finally:
        for dht, server in replicas:
            if dht.is_alive:
                server.shutdown()
                dht.shutdown()
        jax_server.shutdown()
        jax_dht.shutdown()


def test_generate_uids_skips_uids_the_dht_already_holds(swarm):
    with deadline(60):
        taken = [f"dedup.{index}" for index in range(8)]
        jax_declare_experts(swarm.jax_dht, taken, compression="none")
        wait_for(lambda: all(info is not None for info in get_experts(swarm.client_dht, taken)),
                 what="the JAX declarations")
        random.seed(0)
        chosen = _generate_uids(2, "dedup.[0:10]", swarm.client_dht)
    assert sorted(chosen) == ["dedup.8", "dedup.9"]
    with pytest.raises(RuntimeError, match="unique uids"):
        _generate_uids(3, "dedup.[0:10]", swarm.client_dht, attempts_per_expert=2)


def test_restored_handler_options_reach_admission_and_the_pools():
    backends = {"adm.0": linear_pair("adm.0", 0.0, seed=1)[1]}
    with deadline(60):
        dht = DHT(start=True)
        server = Server(dht, backends, client_rate=0.01, client_burst=3, max_queue_size=5,
                        decode_max_sessions=7, activation_compression="none")
        client = None
        try:
            handler = server.handler
            assert isinstance(handler.admission, FairShareAdmission)
            assert (handler.admission.rate_per_s, handler.admission.burst) == (0.01, 3)
            assert {pool.max_queue_size for pool in handler.all_pools()} == {5}
            assert handler.decode_sessions.max_sessions == 7
            server.run_in_background(await_ready=True, timeout=30)
            client = DHT(initial_peers=[str(m) for m in dht.get_visible_maddrs()], start=True)
            wait_for(lambda: get_experts(client, ["adm.0"])[0] is not None, what="the declaration")
            [info] = get_experts(client, ["adm.0"])
            expert = RemoteExpert(info, client.node.p2p)
            x = np.ones((3, HID), np.float32)
            expert.forward_np(x)  # three samples: the burst
            with pytest.raises(Exception) as shed:
                expert.forward_np(x)
            assert is_overload_error(shed.value) and "ClientOverBudgetError" in str(shed.value)
        finally:
            if client is not None:
                client.shutdown()
            server.shutdown()
            dht.shutdown()
    default = Server(DHT(start=False), dict(backends))
    assert default.handler.admission is None and {p.max_queue_size for p in default.handler.all_pools()} == {1024}
    assert default.handler.decode_sessions.max_sessions == 64


def test_server_create_builds_experts_on_the_cpu_when_asked_and_refuses_later_slices(tmp_path):
    with deadline(60):
        with background_server(expert_uids=["ffn_cpu.0"], expert_cls="ffn", hidden_dim=8, device="cpu",
                               activation_compression="none") as (dht, server):
            backend = server.backends["ffn_cpu.0"]
            assert backend.device.type == "cpu" and isinstance(backend.optimizer, torch.optim.Adam)
            client = DHT(initial_peers=[str(m) for m in dht.get_visible_maddrs()], start=True)
            try:
                wait_for(lambda: get_experts(client, ["ffn_cpu.0"])[0] is not None, what="the declaration")
                [info] = get_experts(client, ["ffn_cpu.0"])
                out = RemoteExpert(info, client.node.p2p).forward_np(np.ones((2, 8), np.float32))[0]
                np.testing.assert_allclose(out, backend.forward(np.ones((2, 8), np.float32))[0], atol=FP32_TOL)
            finally:
                client.shutdown()
    # the options of the later slice are served now (the name of this test predates
    # them): a checkpoint restores at create, a replica-only volunteer starts empty,
    # and a hot-expert server carries a replication spec on every expert
    with deadline(60):
        dht = DHT(start=False)
        donor = Server.create(expert_uids=["x.0"], hidden_dim=8, device="cpu", dht=dht, replicate_hot_experts=True)
        assert donor.replication is not None and donor.replication.replica_slots == 0
        assert donor.backends["x.0"].replication_spec["expert_cls"] == "ffn"
        store_experts(donor.backends, tmp_path)
        restored = Server.create(expert_uids=["x.0"], hidden_dim=8, device="cpu", dht=dht, rng_seed=7,
                                 checkpoint_dir=tmp_path)
        assert restored.backends["x.0"].state_dict() == donor.backends["x.0"].state_dict()
        assert restored.checkpoint_saver is not None and restored.replication is None
        volunteer = Server.create(dht=dht, device="cpu", replica_slots=2)
        assert volunteer.backends == {} and volunteer.runtime.pools == []
        assert volunteer.replication.replica_slots == 2 and volunteer.device.type == "cpu"


def test_default_optimizer_is_optax_adam():
    """``Server.create``'s default: Adam at 1e-3 with optax's eps (1e-8, outside the
    root) and bias correction of both moments; three steps on the same gradients."""
    rng = np.random.RandomState(11)
    params = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * scale for scale in (1.0, 1e-3, 30.0)]
    tensor = torch.tensor(params, requires_grad=True)
    optimizer = default_optimizer([tensor])
    transform = optax.adam(1e-3)
    theirs = jnp.asarray(params)
    state = transform.init(theirs)
    for grad in grads:
        tensor.grad = torch.from_numpy(grad)
        optimizer.step()
        updates, state = transform.update(jnp.asarray(grad), state, theirs)
        theirs = optax.apply_updates(theirs, updates)
    np.testing.assert_allclose(tensor.detach().numpy(), np.asarray(theirs), rtol=0, atol=1e-6)
