"""The port's transport and expert RPCs against the JAX package's, over loopback TCP:
a port P2P and a JAX P2P complete the handshake and call each other's namespaced
servicers; a port RemoteExpert is served by a JAX ConnectionHandler and a JAX
RemoteExpert by a port one (info, forward unary and streamed, backward, decode
sessions, the two-input dropout expert, typed overload errors, wire-byte
counters), and autograd through a port RemoteExpert gives the local backend's
input gradient.

Tolerances: fp32 experts 1e-5 (the same float32 arithmetic in XLA and torch), the
bf16 decoder block 2e-2 relative (bf16 rounding of the dense layers). Every
server sends with activation compression "none", so the wire adds nothing.
Each test runs under a wall-clock deadline (``deadline``)."""

from __future__ import annotations

import contextlib
import signal
from typing import AsyncIterator

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
from torch_relay_support import add_echo, call_echo, running_daemon

from hivemind_tpu.moe.client.expert import RemoteExpert as JaxRemoteExpert
from hivemind_tpu.moe.expert_uid import ExpertInfo as JaxExpertInfo
from hivemind_tpu.moe.server.admission import FairShareAdmission as JaxFairShareAdmission
from hivemind_tpu.moe.server.connection_handler import ConnectionHandler as JaxConnectionHandler
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.layers import name_to_input as jax_inputs
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.moe.server.runtime import Runtime as JaxRuntime
from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import P2PContext as JaxP2PContext
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.p2p import ServicerBase as JaxServicerBase
from hivemind_tpu.proto import runtime_pb2 as jax_pb2
from hivemind_tpu.telemetry import REGISTRY as JAX_REGISTRY
from hivemind_tpu.utils.loop import get_loop_runner as jax_loop_runner
from hivemind_tpu_torch.convert import from_flax_albert_params, from_flax_params
from hivemind_tpu_torch.moe.client import RemoteExpert
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
from hivemind_tpu_torch.moe.server import ConnectionHandler, FairShareAdmission, ModuleBackend, Runtime
from hivemind_tpu_torch.moe.server.layers import name_to_block, name_to_input
from hivemind_tpu_torch.moe.server.layers.common import Dense
from hivemind_tpu_torch.p2p import P2P, P2PContext, P2PHandlerError, PeerID, ServicerBase
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.resilience import reset_all_boards
from hivemind_tpu_torch.telemetry import REGISTRY
from hivemind_tpu_torch.telemetry.serving import SCORECARDS, is_overload_error
from hivemind_tpu_torch.utils.loop import get_loop_runner

HID = 64
FP32_TOL = 1e-5
BF16_RTOL = 2e-2
STREAM_SHAPE = (4, 2100, HID)  # 537,600 fp32 values: 2.05 MiB, over the 2 MiB unary cap


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


def run(runner, coro, timeout: float = 30.0):
    return runner.run_coroutine(coro, return_future=True).result(timeout)


# ------------------------------------------------------------------ experts


class JaxLinearTanh(jnn.Module):
    """An fp32 expert (Dense in float32, then tanh): backward parity at 1e-5."""

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


def _expert_pair(uid: str, kind: str, lr: float):
    """A JAX backend and a port backend (CPU) with the same weights."""
    if kind == "linear":
        sample = (np.zeros((2, HID), np.float32),)
        theirs = JaxModuleBackend(uid, JaxLinearTanh(HID), optimizer=optax.sgd(lr), sample_inputs=sample)
        params = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, theirs.params))
        module = LinearTanh(HID)
    else:
        sample = jax_inputs[kind](2, HID)
        sample = sample if isinstance(sample, tuple) else (sample,)
        theirs = JaxModuleBackend(uid, jax_blocks[kind](HID), optimizer=optax.sgd(lr), sample_inputs=sample)
        params = from_flax_params(kind, jax.tree_util.tree_map(np.asarray, theirs.params))
        module = name_to_block[kind](HID)
        sample = name_to_input[kind](2, HID)
        sample = sample if isinstance(sample, tuple) else (sample,)
    ours = ModuleBackend(uid, module, sample_inputs=sample, params=params, device="cpu",
                         optimizer=lambda tensors: torch.optim.SGD(tensors, lr=lr))
    return theirs, ours


EXPERTS = {  # uid -> (kind, learning rate)
    "lin.0": ("linear", 0.0),  # forward, info, overload, counters: never trained
    "train.0": ("linear", 0.1),  # the cross-package backward
    "det_dropout.0": ("det_dropout", 0.0),
    "blk.0": ("causal_transformer", 0.0),  # decode sessions
    "blk.1": ("causal_transformer", 0.0),  # the second block of a decode span
    "span.0": ("linear", 0.1),  # a two-block span, forward and backward
    "span.1": ("linear", 0.1),
}


class Swarm:
    """A port server, a JAX server with the same experts, and a client of each package."""

    def __init__(self):
        self.runner, self.jax_runner = get_loop_runner(), jax_loop_runner()
        pairs = {uid: _expert_pair(uid, kind, lr) for uid, (kind, lr) in EXPERTS.items()}
        self.jax_backends = {uid: pair[0] for uid, pair in pairs.items()}
        self.backends = {uid: pair[1] for uid, pair in pairs.items()}
        self.twin = _expert_pair("lin.0", "linear", 0.0)[1]  # the port twin of lin.0, never served
        self.twin.load_params({k: v.clone() for k, v in self.backends["lin.0"].params.items()})

        async def start_port():
            handler = ConnectionHandler(self.backends, decode_max_len=32, activation_compression="none")
            server, client = await P2P.create(), await P2P.create()
            await handler.add_p2p_handlers(server)
            runtime = Runtime(handler.all_pools())
            runtime.start()
            return handler, server, client, runtime

        async def start_jax():
            handler = JaxConnectionHandler(self.jax_backends, decode_max_len=32, activation_compression="none")
            server, client = await JaxP2P.create(), await JaxP2P.create()
            await handler.add_p2p_handlers(server)
            runtime = JaxRuntime(handler.all_pools(), stats_report_interval=None)
            runtime.start()
            return handler, server, client, runtime

        self.handler, self.server, self.client, self.runtime = run(self.runner, start_port())
        self.jax_handler, self.jax_server, self.jax_client, self.jax_runtime = run(self.jax_runner, start_jax())
        # each client knows both servers by address
        self.jax_server_id = PeerID(self.jax_server.peer_id.to_bytes())
        self.server_id_for_jax = JaxPeerID(self.server.peer_id.to_bytes())
        self.client.add_peer_addr(self.server.peer_id, str(self.server.get_visible_maddrs()[0]))
        self.client.add_peer_addr(self.jax_server_id, str(self.jax_server.get_visible_maddrs()[0]))
        self.jax_client.add_peer_addr(self.server_id_for_jax, str(self.server.get_visible_maddrs()[0]))
        self.jax_client.add_peer_addr(self.jax_server.peer_id, str(self.jax_server.get_visible_maddrs()[0]))

    def port_expert(self, uid: str, at_jax: bool) -> RemoteExpert:
        """A port client's handle on ``uid`` at the JAX server or the port server."""
        return RemoteExpert(ExpertInfo(uid, self.jax_server_id if at_jax else self.server.peer_id), self.client)

    def jax_expert(self, uid: str, at_port: bool) -> JaxRemoteExpert:
        return JaxRemoteExpert(JaxExpertInfo(uid, self.server_id_for_jax if at_port else self.jax_server.peer_id),
                               self.jax_client)

    def close(self):
        async def stop_port():
            await self.runtime.shutdown()
            await self.client.shutdown()
            await self.server.shutdown()

        async def stop_jax():
            self.jax_runtime.shutdown()
            await self.jax_client.shutdown()
            await self.jax_server.shutdown()

        run(self.runner, stop_port())
        run(self.jax_runner, stop_jax())


@pytest.fixture(scope="module")
def swarm():
    with deadline(120):
        swarm = Swarm()
    yield swarm
    with deadline(30):
        swarm.close()


@pytest.fixture(autouse=True)
def _fresh_client_state():
    reset_all_boards()
    SCORECARDS.clear()
    yield


# ------------------------------------------------------------------ transport


class PortEcho(ServicerBase):
    async def rpc_echo(self, request: runtime_pb2.ExpertUID, context: P2PContext) -> runtime_pb2.ExpertUID:
        return runtime_pb2.ExpertUID(uid=f"port:{request.uid}:{context.remote_id.to_base58()[:6]}")

    async def rpc_count(
        self, request: runtime_pb2.ExpertUID, context: P2PContext
    ) -> AsyncIterator[runtime_pb2.ExpertResponse]:
        for index in range(int(request.uid)):
            yield runtime_pb2.ExpertResponse(metadata=b"port%d" % index)


class JaxEcho(JaxServicerBase):
    _class_handle_name = "PortEcho"  # one wire name for both packages' servicers

    async def rpc_echo(self, request: jax_pb2.ExpertUID, context: JaxP2PContext) -> jax_pb2.ExpertUID:
        return jax_pb2.ExpertUID(uid=f"jax:{request.uid}:{context.remote_id.to_base58()[:6]}")

    async def rpc_count(
        self, request: jax_pb2.ExpertUID, context: JaxP2PContext
    ) -> AsyncIterator[jax_pb2.ExpertResponse]:
        for index in range(int(request.uid)):
            yield jax_pb2.ExpertResponse(metadata=b"jax%d" % index)


async def test_port_and_jax_peers_handshake_and_call_namespaced_servicers_both_ways():
    ours, theirs = await P2P.create(), await JaxP2P.create()
    try:
        await PortEcho().add_p2p_handlers(ours, namespace="ns")
        await JaxEcho().add_p2p_handlers(theirs, namespace="ns")
        their_id, our_id = PeerID(theirs.peer_id.to_bytes()), JaxPeerID(ours.peer_id.to_bytes())
        assert await ours.connect(str(theirs.get_visible_maddrs()[0])) == their_id  # the handshake authenticates
        theirs.add_peer_addr(our_id, str(ours.get_visible_maddrs()[0]))

        port_stub = PortEcho.get_stub(ours, their_id, namespace="ns")
        reply = await port_stub.rpc_echo(runtime_pb2.ExpertUID(uid="a"), timeout=10)
        assert reply.uid == f"jax:a:{ours.peer_id.to_base58()[:6]}"
        chunks = [m.metadata async for m in port_stub.rpc_count(runtime_pb2.ExpertUID(uid="3"), timeout=10)]
        assert chunks == [b"jax0", b"jax1", b"jax2"]

        jax_stub = JaxEcho.get_stub(theirs, our_id, namespace="ns")
        reply = await jax_stub.rpc_echo(jax_pb2.ExpertUID(uid="b"), timeout=10)
        assert reply.uid == f"port:b:{theirs.peer_id.to_base58()[:6]}"
        chunks = [m.metadata async for m in jax_stub.rpc_count(jax_pb2.ExpertUID(uid="2"), timeout=10)]
        assert chunks == [b"port0", b"port1"]
        # a handler name nobody registered is a typed remote error, not a hang
        with pytest.raises(P2PHandlerError, match="unknown handler"):
            await ours.call_protobuf_handler(their_id, "ns::PortEcho.rpc_nothing", runtime_pb2.ExpertUID())
    finally:
        await ours.shutdown()
        await theirs.shutdown()


async def test_transport_options_of_a_later_slice_raise():
    """The options that raised NotImplementedError until the relay/NAT slice landed now
    each do what the JAX package's do, against the port's relay daemon: ``relays``
    registers at it, ``native_transport`` spawns a private daemon that owns the public
    listener, ``data_proxy_port`` routes outbound dials through the daemon and
    ``inbound_data_proxy`` moves the listener into it."""
    with deadline(40), running_daemon() as daemon:
        nodes = [await P2P.create(relays=[f"127.0.0.1:{daemon.port}"]), await P2P.create(native_transport=True),
                 await P2P.create(data_proxy_port=daemon.port),
                 await P2P.create(data_proxy_port=daemon.port, inbound_data_proxy=True)]
        relayed, native, outbound, inbound = nodes
        try:
            assert len(relayed._relays) == 1 and relayed._relays[0].registered
            assert native._native_daemon is not None and native._native_daemon.alive
            assert native._inbound_proxy_active and inbound._inbound_proxy_active
            for server in (native, inbound):
                assert server.get_visible_maddrs()[0].port != server._listen_port  # the daemon's listener
                await add_echo(server, "echo", lambda n: n + 1)
                await outbound.connect(server.get_visible_maddrs()[0])
                assert await call_echo(outbound, server.peer_id, "echo", 41) == 42
            assert outbound._proxied_dials == 2
        finally:
            for node in nodes:
                await node.shutdown()
        assert native._native_daemon is None and not relayed._relays


# ------------------------------------------------------------------ expert RPCs across packages


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_rpc_info_across_packages(swarm, direction):
    with deadline(60):
        for uid in EXPERTS:
            info = (swarm.port_expert(uid, at_jax=True) if direction == "port_client_jax_server"
                    else swarm.jax_expert(uid, at_port=True)).info
            backend = swarm.backends[uid]
            assert [(d.shape, d.dtype) for d in info["forward_schema"]] == [
                (d.shape, d.dtype) for d in backend.forward_schema]
            assert [(d.shape, d.dtype) for d in info["outputs_schema"]] == [
                (d.shape, d.dtype) for d in backend.outputs_schema]
            assert info["activation_compression"] == "none" and info["span_support"] is True
            assert ("decode_max_len" in info) == (EXPERTS[uid][0] == "causal_transformer")


@pytest.mark.parametrize("shape", [(3, HID), STREAM_SHAPE], ids=["unary", "stream"])
@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_forward_across_packages(swarm, direction, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with deadline(60):
        if direction == "port_client_jax_server":
            [out] = swarm.port_expert("lin.0", at_jax=True).forward_np(x)
        else:
            [out] = swarm.jax_expert("lin.0", at_port=True).forward_np(x)
    [expected] = swarm.twin.forward(x)
    assert out.shape == x.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, expected, rtol=0, atol=FP32_TOL)


def test_two_input_dropout_expert_across_packages(swarm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, HID)).astype(np.float32)
    mask = (rng.random((3, HID)) > 0.2).astype(np.float32)
    with deadline(60):
        [ours] = swarm.port_expert("det_dropout.0", at_jax=True).forward_np(x, mask)
        [theirs] = swarm.jax_expert("det_dropout.0", at_port=True).forward_np(x, mask)
    [local] = swarm.backends["det_dropout.0"].forward(x, mask)
    np.testing.assert_allclose(ours, local, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(local).max())
    np.testing.assert_array_equal(theirs, local)  # served by this very backend


def test_backward_across_packages_trains_both_servers_alike(swarm):
    """The port client's backward on the JAX server and the JAX client's on the port
    server: the input gradients and the servers' SGD steps agree within 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, HID)).astype(np.float32)
    grad_out = rng.standard_normal((3, HID)).astype(np.float32)
    before = {k: v.clone() for k, v in swarm.backends["train.0"].params.items()}
    with deadline(60):
        [grad_at_jax] = swarm.port_expert("train.0", at_jax=True).backward_np(x, grad_out)
        [grad_at_port] = swarm.jax_expert("train.0", at_port=True).backward_np(x, grad_out)
    np.testing.assert_allclose(grad_at_jax, grad_at_port, rtol=0, atol=FP32_TOL)
    assert swarm.jax_backends["train.0"].update_count == swarm.backends["train.0"].update_count == 1
    jax_after = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, swarm.jax_backends["train.0"].params))
    for name, tensor in swarm.backends["train.0"].params.items():
        assert not torch.equal(tensor, before[name])  # the step moved the weights
        np.testing.assert_allclose(tensor.numpy(), jax_after[name].numpy(), rtol=0, atol=FP32_TOL)


def test_decode_sessions_across_packages(swarm):
    """Reset with a prompt, then single-token steps, each way; a continuation on an
    unknown session is a KeyError on the server, typed across the wire."""
    hidden = np.random.default_rng(3).standard_normal((1, 9, HID)).astype(np.float32)
    port_client, jax_client = swarm.port_expert("blk.0", at_jax=True), swarm.jax_expert("blk.0", at_port=True)
    with deadline(90):
        results = []
        for expert in (port_client, jax_client):
            outputs = [expert.decode_np(hidden[:, :6], "s0", reset=True)]
            outputs += [expert.decode_np(hidden[:, t:t + 1], "s0") for t in range(6, 9)]
            results.append(np.concatenate(outputs, axis=1))
        for expert in (port_client, jax_client):
            with pytest.raises(Exception, match="KeyError: .*unknown or expired decode session"):
                expert.decode_np(hidden[:, :1], "never-started")
    ours, theirs = results
    assert ours.shape == theirs.shape == hidden.shape
    np.testing.assert_allclose(ours, theirs, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(theirs).max())


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_span_execution_across_packages(swarm, direction):
    """Two co-located blocks in one RPC (request metadata ``{"uids": [...]}``, which
    ``rpc_info``'s ``span_support`` invites) against one RPC per block at the other
    package's server, which holds the same weights: forward (unary and streamed),
    backward (the span's forward sweep, then each block's backward and SGD step in
    reverse) and decode session steps. Each direction steps both servers' blocks
    once, so their weights stay equal."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, HID)).astype(np.float32)
    x_stream = rng.standard_normal(STREAM_SHAPE).astype(np.float32)
    grad_out = rng.standard_normal((3, HID)).astype(np.float32)
    hidden = rng.standard_normal((1, 7, HID)).astype(np.float32)
    if direction == "port_client_jax_server":
        spanned = lambda uid: swarm.port_expert(uid, at_jax=True)  # noqa: E731
        per_block = lambda uid: swarm.port_expert(uid, at_jax=False)  # noqa: E731
    else:
        spanned = lambda uid: swarm.jax_expert(uid, at_port=True)  # noqa: E731
        per_block = lambda uid: swarm.jax_expert(uid, at_port=False)  # noqa: E731
    head = spanned("span.0")
    head.span = ["span.0", "span.1"]
    first, second = per_block("span.0"), per_block("span.1")
    updates = {uid: (swarm.backends[uid].update_count, swarm.jax_backends[uid].update_count)
               for uid in ("span.0", "span.1")}
    with deadline(90):
        for inputs in (x, x_stream):
            [got] = head.forward_np(inputs)
            [expected] = second.forward_np(*first.forward_np(inputs))
            assert got.shape == inputs.shape
            np.testing.assert_allclose(got, expected, rtol=0, atol=FP32_TOL)

        [grad_span] = head.backward_np(x, grad_out)
        [hid_out] = first.forward_np(x)
        [grad_hid] = second.backward_np(hid_out, grad_out)
        [grad_blocks] = first.backward_np(x, grad_hid)
        np.testing.assert_allclose(grad_span, grad_blocks, rtol=0, atol=FP32_TOL)

        session = f"span-{direction}"
        block_head = spanned("blk.0")
        blocks = [per_block("blk.0"), per_block("blk.1")]
        got, expected = [], []
        for start, stop in ((0, 4), (4, 5), (5, 6), (6, 7)):
            got.append(block_head.decode_np(hidden[:, start:stop], session, reset=start == 0,
                                            span=["blk.0", "blk.1"]))
            step = hidden[:, start:stop]
            for block in blocks:
                step = block.decode_np(step, session, reset=start == 0)
            expected.append(step)
    for uid in ("span.0", "span.1"):  # one SGD step on each server, in either order
        ours, theirs = swarm.backends[uid], swarm.jax_backends[uid]
        assert (ours.update_count, theirs.update_count) == (updates[uid][0] + 1, updates[uid][1] + 1)
        jax_params = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, theirs.params))
        for name, tensor in ours.params.items():
            np.testing.assert_allclose(tensor.numpy(), jax_params[name].numpy(), rtol=0, atol=FP32_TOL)
    got, expected = np.concatenate(got, axis=1), np.concatenate(expected, axis=1)
    assert got.shape == hidden.shape
    np.testing.assert_allclose(got, expected, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(expected).max())


@pytest.mark.parametrize("shed", ["ServerOverloadedError", "ClientOverBudgetError"])
@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_overload_errors_are_typed_across_the_wire(swarm, direction, shed):
    handler = swarm.jax_handler if direction == "port_client_jax_server" else swarm.handler
    pool = handler.forward_pools["lin.0"]
    saved = pool.max_queue_size, handler.admission
    if shed == "ServerOverloadedError":
        pool.max_queue_size = 0
    else:
        admission = FairShareAdmission if handler is swarm.handler else JaxFairShareAdmission
        handler.admission = admission(1e-6, burst=1.0)
    x = np.ones((2, HID), np.float32)  # two samples: over the one-token burst
    try:
        with deadline(60):
            expert = (swarm.port_expert("lin.0", at_jax=True) if direction == "port_client_jax_server"
                      else swarm.jax_expert("lin.0", at_port=True))
            with pytest.raises(Exception) as caught:
                expert.forward_np(x)
    finally:
        pool.max_queue_size, handler.admission = saved
    assert shed in str(caught.value) and is_overload_error(caught.value)


def _counter(registry, name: str, **labels) -> float:
    family = registry.get(name)
    return 0.0 if family is None else family.value(**labels)


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_wire_byte_counters_agree_on_both_sides(swarm, direction):
    client_registry, server_registry = (REGISTRY, JAX_REGISTRY) if direction == "port_client_jax_server" \
        else (JAX_REGISTRY, REGISTRY)
    names = {
        "sent": ("hivemind_moe_bytes_sent_total", {"direction": "client"}),
        "received": ("hivemind_moe_bytes_received_total", {"direction": "server"}),
        "answered": ("hivemind_moe_bytes_sent_total", {"direction": "server"}),
        "got": ("hivemind_moe_bytes_received_total", {"direction": "client"}),
        "rpc_out": ("hivemind_p2p_rpc_bytes_total", {"handler": "ConnectionHandler.rpc_forward", "direction": "out"}),
        "rpc_in": ("hivemind_p2p_rpc_bytes_total", {"handler": "ConnectionHandler.rpc_forward", "direction": "in"}),
    }
    registries = {"sent": client_registry, "received": server_registry, "answered": server_registry,
                  "got": client_registry, "rpc_out": client_registry, "rpc_in": server_registry}
    before = {key: _counter(registries[key], name, **labels) for key, (name, labels) in names.items()}
    x = np.random.default_rng(4).standard_normal((5, HID)).astype(np.float32)
    with deadline(60):
        if direction == "port_client_jax_server":
            swarm.port_expert("lin.0", at_jax=True).forward_np(x)
        else:
            swarm.jax_expert("lin.0", at_port=True).forward_np(x)
    delta = {key: _counter(registries[key], name, **labels) - before[key] for key, (name, labels) in names.items()}
    assert delta["sent"] == delta["received"] > x.nbytes
    assert delta["answered"] == delta["got"] > x.nbytes
    # the transport counts what it framed: the request on both sides
    assert delta["rpc_out"] == delta["rpc_in"] == delta["sent"]


def test_autograd_through_a_port_remote_expert_gives_the_local_gradient(swarm):
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((4, HID)).astype(np.float32), requires_grad=True)
    weights = torch.tensor(rng.standard_normal((4, HID)).astype(np.float32))
    with deadline(60):
        y = swarm.port_expert("lin.0", at_jax=False)(x)
        (y * weights).sum().backward()
    [expected_y] = swarm.twin.forward(x.detach().numpy())
    [expected_grad] = swarm.twin.backward(x.detach().numpy(), weights.numpy())
    np.testing.assert_allclose(y.detach().numpy(), expected_y, rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(x.grad.numpy(), expected_grad, rtol=0, atol=FP32_TOL)


def test_autograd_through_a_two_input_expert_reaches_both_inputs(swarm):
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((3, HID)).astype(np.float32), requires_grad=True)
    mask = torch.tensor((rng.random((3, HID)) > 0.2).astype(np.float32), requires_grad=True)
    weights = torch.tensor(rng.standard_normal((3, HID)).astype(np.float32))
    with deadline(60):
        y = swarm.port_expert("det_dropout.0", at_jax=False)(x, mask)
        (y * weights).sum().backward()
    # the served backend itself, called locally (learning rate 0: its weights stay as they are)
    grad_x, grad_mask = swarm.backends["det_dropout.0"].backward(x.detach().numpy(), mask.detach().numpy(),
                                                                 weights.numpy())
    np.testing.assert_array_equal(x.grad.numpy(), grad_x)
    np.testing.assert_array_equal(mask.grad.numpy(), grad_mask)
    assert np.abs(grad_mask).max() > 0
