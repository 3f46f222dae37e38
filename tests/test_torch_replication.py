"""Expert state across the two packages: the port's copy of flax's msgpack format
against ``flax.serialization``; ``ModuleBackend.state_dict``/``load_state_dict``
blobs restored across packages (params, Adam moments and counts, int8 codes);
``store_experts``/``load_experts`` checkpoints read by the other package; hot-expert
replication between a port volunteer and a JAX donor and the reverse, and a corrupt
or truncated transfer; and ``Runtime.add_pool``.

Tolerances: a restored blob is held byte for byte (the same state writes the same
bytes); one more Adam step after a cross-package restore on an fp32 expert
(Dense in float32, then tanh) within 1e-6; a replica's weights equal the donor's
exactly, and its ffn outputs (bf16 dense layers in each package) within 2e-2
relative. Each test runs under a wall-clock deadline."""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import time

import flax.linen as jnn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.moe.server.checkpoints import load_experts as jax_load_experts
from hivemind_tpu.moe.server.checkpoints import store_experts as jax_store_experts
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.layers import name_to_input as jax_inputs
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.moe.server.replication import ReplicationPolicy as JaxReplicationPolicy
from hivemind_tpu.moe.server.server import Server as JaxServer
from hivemind_tpu_torch.convert import to_flax_tree
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe import RemoteExpert, Server, get_experts
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
from hivemind_tpu_torch.moe.server import ConnectionHandler, ModuleBackend, Runtime, load_experts, store_experts
from hivemind_tpu_torch.moe.server.layers import name_to_block, name_to_input
from hivemind_tpu_torch.moe.server.layers.common import Dense
from hivemind_tpu_torch.moe.server.module_backend import optax_state
from hivemind_tpu_torch.moe.server.replication import ReplicationPolicy, fetch_replica_state
from hivemind_tpu_torch.moe.server.server import default_optimizer
from hivemind_tpu_torch.moe.server.task_pool import TaskPool
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.resilience import reset_all_boards
from hivemind_tpu_torch.utils import flax_msgpack
from hivemind_tpu_torch.utils.loop import get_loop_runner
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

HID = 16
STEP_TOL = 1e-6
BF16_RTOL = 2e-2
DIRECTIONS = ["jax-to-port", "port-to-jax"]


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
    reset_all_boards()


def wait_for(predicate, timeout: float = 20.0, what: str = "condition"):
    started = time.monotonic()
    while not predicate():
        if time.monotonic() - started > timeout:
            raise TimeoutError(f"{what} not reached in {timeout} s")
        time.sleep(0.05)


def leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def on_host(tree):
    """``tree`` with its JAX arrays as numpy arrays, every container and key order kept."""
    if isinstance(tree, dict):
        return {key: on_host(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_host(value) for value in tree)
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


# ------------------------------------------------------------------ experts


class JaxLinearTanh(jnn.Module):
    hid: int

    @jnn.compact
    def __call__(self, x):
        return jnp.tanh(jnn.Dense(self.hid, dtype=jnp.float32, param_dtype=jnp.float32)(x))


class LinearTanh(nn.Module):
    """fp32 end to end, so both packages' Adam steps agree to float rounding."""

    def __init__(self, hid: int):
        super().__init__()
        self.Dense_0 = Dense(hid, hid, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.Dense_0(x))


def jax_expert(kind: str, seed: int, quantization=None, optimizer=None, hid: int = HID):
    module = JaxLinearTanh(hid) if kind == "linear" else jax_blocks[kind](hid)
    sample = np.zeros((4, hid), np.float32) if kind == "linear" else jax_inputs[kind](4, hid)
    return JaxModuleBackend(f"{kind}.0", module, optimizer=optimizer or optax.adam(1e-3), sample_input=sample,
                            rng_seed=seed, weight_quantization=quantization)


def port_expert(kind: str, seed: int, quantization=None, optimizer=default_optimizer, hid: int = HID):
    module = LinearTanh(hid) if kind == "linear" else name_to_block[kind](hid)
    sample = np.zeros((4, hid), np.float32) if kind == "linear" else name_to_input[kind](4, hid)
    return ModuleBackend(f"{kind}.0", module, optimizer=optimizer, sample_input=sample, rng_seed=seed,
                         weight_quantization=quantization, device="cpu")


def make_pair(direction: str, kind: str = "ffn", quantization=None, hid: int = HID):
    """(donor, recipient): the donor stepped once (a trainable one), the recipient
    built in the other package from another seed."""
    rng = np.random.RandomState(7)
    x, g = rng.randn(5, hid).astype(np.float32), rng.randn(5, hid).astype(np.float32)
    jax_side = jax_expert(kind, 3, quantization, hid=hid)
    port_side = port_expert(kind, 5, quantization, hid=hid)
    donor, recipient = (jax_side, port_side) if direction == DIRECTIONS[0] else (port_side, jax_side)
    if quantization is None:
        donor.backward(x, g)
    return donor, recipient, (x, g)


# ------------------------------------------------------------------ flax's msgpack format


def flax_trees():
    rng = np.random.RandomState(0)
    ffn = jax_expert("ffn", 1)
    ffn.backward(rng.randn(3, HID).astype(np.float32), rng.randn(3, HID).astype(np.float32))
    return {
        "ffn_adam": {"params": ffn.params, "opt_state": ffn.opt_state, "updates": ffn.update_count},
        "leaves": {
            "bf16": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "int32": np.arange(-4, 8, dtype=np.int32).reshape(3, 4),
            "count": jnp.asarray(7, jnp.int32),
            "scalars": (np.float32(2.5), np.int64(-3), np.bool_(True)),
            "plain": [1, -200, 2**40, 1.5, True, None, "text", b"bytes"],
            "empty": {},
        },
    }


@pytest.mark.parametrize("case", ["ffn_adam", "leaves"])
def test_flax_msgpack_bytes_equal_flax_to_bytes(case):
    tree = flax_trees()[case]
    theirs = flax.serialization.to_bytes(tree)
    host = on_host(flax.serialization.to_state_dict(tree))  # optax's namedtuples as flax writes them
    if case == "leaves":  # the port holds bf16 as a torch tensor (no numpy bfloat16 on the card's machine)
        host["bf16"] = torch.from_numpy(np.asarray(tree["bf16"], np.float32)).to(torch.bfloat16)
    assert flax_msgpack.to_bytes(host) == theirs
    # each package restores the other's blob
    ours = flax_msgpack.msgpack_restore(theirs)
    restored = flax.serialization.msgpack_restore(flax_msgpack.to_bytes(host))
    expected = flax.serialization.msgpack_restore(theirs)
    if case == "leaves":
        assert ours["bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.pop("bf16").float().numpy(), np.asarray(expected["bf16"], np.float32))
        assert restored["bf16"].dtype == jnp.bfloat16
        for tree_ in (restored, expected):
            tree_.pop("bf16")
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(expected)
    for a, b, c in zip(leaves(ours), leaves(expected), leaves(restored)):
        assert type(a) is type(b) or np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_flax_msgpack_chunks_oversized_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 24)
    tree = {"big": np.arange(35, dtype=np.float32).reshape(5, 7), "small": np.ones(3, np.float32)}
    blob = flax.serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == blob
    np.testing.assert_array_equal(flax_msgpack.msgpack_restore(blob)["big"], tree["big"])


# ------------------------------------------------------------------ state dicts


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_adam_state_blob_restores_across_packages_byte_for_byte(direction):
    """The ffn tree with Adam state (params in flax layout, optax count, mu and nu):
    the recipient's blob after the restore is the donor's, so params, moments, the
    count and the update counter all crossed exactly."""
    donor, recipient, _ = make_pair(direction)
    blob = donor.state_dict()
    tree = flax.serialization.msgpack_restore(blob)
    assert sorted(tree) == ["opt_state", "params", "updates"] and sorted(tree["opt_state"]) == ["0", "1"]
    assert sorted(tree["opt_state"]["0"]) == ["count", "mu", "nu"] and int(tree["opt_state"]["0"]["count"]) == 1
    recipient.load_state_dict(blob)
    assert recipient.state_dict() == blob
    assert recipient.update_count == 1


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_one_more_adam_step_after_a_cross_package_restore_agrees(direction):
    donor, recipient, (x, g) = make_pair(direction, kind="linear")
    recipient.load_state_dict(donor.state_dict())
    donor.backward(x * 0.5, g)
    recipient.backward(x * 0.5, g)
    ours, theirs = (flax.serialization.msgpack_restore(b.state_dict()) for b in (donor, recipient))
    assert int(ours["opt_state"]["0"]["count"]) == int(theirs["opt_state"]["0"]["count"]) == 2
    for a, b in zip(leaves(ours), leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_int8_codes_are_identical_after_a_round_trip(direction):
    """An int8 blob holds the dense weights and no optimizer state; a port and a JAX
    backend that load it quantize it again to the same codes and absmax (the
    donor's codes; its absmax may move by an ulp, since the blob holds
    codes x absmax / 127). Their blobs then hold the same dense weights to an ulp:
    XLA computes the division by 127 as a product with its reciprocal."""
    donor, _recipient, _ = make_pair(direction, quantization="int8", hid=64)
    blob = donor.state_dict()
    assert flax.serialization.msgpack_restore(blob)["opt_state"] == {}
    port, theirs = port_expert("ffn", 11, "int8", hid=64), jax_expert("ffn", 13, "int8", hid=64)
    port.load_state_dict(blob)
    theirs.load_state_dict(blob)
    donor_codes = {name: np.asarray((donor.params[name] if direction == DIRECTIONS[1] else
                                     donor.params[name.split(".")[0]]["kernel"]).codes)
                   for name in ("Dense_0.weight", "Dense_1.weight")}
    for name in ("Dense_0.weight", "Dense_1.weight"):
        ours, expected = port.params[name], theirs.params[name.split(".")[0]]["kernel"]
        np.testing.assert_array_equal(ours.codes.numpy(), np.asarray(expected.codes))
        np.testing.assert_array_equal(ours.codes.numpy(), donor_codes[name])
        np.testing.assert_array_equal(ours.absmax.numpy(), np.asarray(expected.absmax))
    ours, expected = (flax.serialization.msgpack_restore(b.state_dict()) for b in (port, theirs))
    for a, b in zip(leaves(ours), leaves(expected)):
        np.testing.assert_allclose(a, b, rtol=2.0**-22, atol=0)  # one ulp


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_state_is_optax_sgds_and_other_optimizers_write_none(momentum):
    rng = np.random.RandomState(3)
    x, g = rng.randn(4, HID).astype(np.float32), rng.randn(4, HID).astype(np.float32)
    port = port_expert("linear", 2, optimizer=lambda tensors: torch.optim.SGD(tensors, lr=0.1, momentum=momentum))
    theirs = jax_expert("linear", 2, optimizer=optax.sgd(0.1, momentum=momentum or None))
    theirs.load_params(jax.tree_util.tree_map(jnp.asarray, to_flax_tree(port.params)))
    for backend in (port, theirs):
        backend.backward(x, g)
    ours, expected = (flax.serialization.msgpack_restore(b.state_dict()) for b in (port, theirs))
    assert jax.tree_util.tree_structure(ours["opt_state"]) == jax.tree_util.tree_structure(expected["opt_state"])
    for a, b in zip(leaves(ours), leaves(expected)):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_TOL)
    rmsprop = port_expert("linear", 2, optimizer=lambda tensors: torch.optim.RMSprop(tensors, lr=0.1))
    rmsprop.backward(x, g)
    assert optax_state(rmsprop.optimizer, rmsprop.params) == {}
    assert flax.serialization.msgpack_restore(rmsprop.state_dict())["opt_state"] == {}


# ------------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_store_experts_loads_in_the_other_package(tmp_path, direction):
    donor, recipient, _ = make_pair(direction)
    store, load = (jax_store_experts, load_experts) if direction == DIRECTIONS[0] else (store_experts, jax_load_experts)
    store({"ffn.0": donor}, tmp_path)
    last = tmp_path / "ffn.0" / "checkpoint_last.flax"
    assert last.is_symlink() and os.readlink(last).startswith("checkpoint_") and os.readlink(last).endswith(".flax")
    assert load({"ffn.0": recipient, "missing.0": recipient}, tmp_path) == 1
    assert recipient.state_dict() == donor.state_dict()


def test_server_create_restores_a_jax_checkpoint_and_keeps_saving(tmp_path):
    donors = {f"ck.{i}": jax_expert("ffn", 10 + i) for i in range(2)}
    rng = np.random.RandomState(4)
    donors["ck.0"].backward(rng.randn(3, HID).astype(np.float32), rng.randn(3, HID).astype(np.float32))
    jax_store_experts(donors, tmp_path)
    with deadline(60):
        dht = DHT(start=False)
        server = Server.create(expert_uids=list(donors), hidden_dim=HID, dht=dht, device="cpu", checkpoint_dir=tmp_path)
        assert server.checkpoint_saver is not None and server.checkpoint_saver.update_period == 300.0
        for uid, donor in donors.items():
            assert server.backends[uid].state_dict() == donor.state_dict()
            assert server.backends[uid].replication_spec == {"expert_cls": "ffn", "hidden_dim": HID,
                                                             "expert_kwargs": {}, "max_batch_size": 4096}
        store_experts(server.backends, tmp_path / "again")
        restored = {uid: jax_expert("ffn", 99) for uid in donors}
        assert jax_load_experts(restored, tmp_path / "again") == 2
        for uid in donors:
            assert restored[uid].state_dict() == donors[uid].state_dict()


# ------------------------------------------------------------------ replication


@pytest.mark.parametrize("direction", ["port-volunteer-jax-donor", "jax-volunteer-port-donor"])
def test_volunteer_acquires_a_hot_expert_across_packages(direction):
    """The whole loop: traffic makes the donor's expert hot, the donor advertises it
    under replica_wanted.<grid>, the volunteer fetches spec and state over
    rpc_replica_state, serves and declares it; the client then resolves two
    replicas whose weights are equal."""
    port_policy = ReplicationPolicy(qps_threshold=1.0, period=0.5)
    jax_policy = JaxReplicationPolicy(qps_threshold=1.0, period=0.5)
    uid = "hot.0"
    with deadline(90):
        port_dht = DHT(start=True)
        maddrs = [str(m) for m in port_dht.get_visible_maddrs()]
        jax_dht = JaxDHT(initial_peers=maddrs, start=True)
        client = DHT(initial_peers=maddrs, start=True)
        servers = []
        try:
            if direction == "port-volunteer-jax-donor":
                donor = JaxServer.create(expert_uids=[uid], hidden_dim=HID, dht=jax_dht, start=True,
                                         activation_compression="none", replicate_hot_experts=True,
                                         replication_policy=jax_policy, optim_factory=lambda: optax.sgd(0.0))
                volunteer = Server.create(dht=port_dht, start=True, replica_slots=1, replication_policy=port_policy,
                                          replication_watch_grids=["hot"], device="cpu",
                                          activation_compression="none")
            else:
                donor = Server.create(expert_uids=[uid], hidden_dim=HID, dht=port_dht, start=True, device="cpu",
                                      activation_compression="none", replicate_hot_experts=True,
                                      replication_policy=port_policy)
                volunteer = JaxServer.create(dht=jax_dht, start=True, replica_slots=1, replication_policy=jax_policy,
                                             replication_watch_grids=["hot"], activation_compression="none",
                                             optim_factory=lambda: optax.sgd(0.0))
            servers = [donor, volunteer]
            assert volunteer.backends == {}
            wait_for(lambda: get_experts(client, [uid])[0] is not None, what="the donor's declaration")
            x = np.random.RandomState(0).randn(4, HID).astype(np.float32)
            expert = RemoteExpert(get_experts(client, [uid])[0], client.node.p2p)
            started = time.monotonic()
            while True:
                for _ in range(5):
                    expert.forward_np(x)
                [info] = get_experts(client, [uid])
                if len(info.replica_set) == 2 or time.monotonic() - started > 60:
                    break
                time.sleep(0.2)
            assert len(info.replica_set) == 2, "the replica was never acquired"
            assert list(volunteer.backends) == [uid] and volunteer.replication.acquired == [uid]
            donor_params = leaves(flax.serialization.msgpack_restore(donor.backends[uid].state_dict())["params"])
            replica_params = leaves(flax.serialization.msgpack_restore(volunteer.backends[uid].state_dict())["params"])
            for a, b in zip(donor_params, replica_params):
                np.testing.assert_array_equal(a, b)
            outputs = [RemoteExpert(ExpertInfo(uid, replica.peer_id, replica.compression), client.node.p2p)
                       .forward_np(x)[0] for replica in info.replica_set]
            scale = np.abs(outputs[0]).max()
            assert np.abs(outputs[0] - outputs[1]).max() / scale < BF16_RTOL
        finally:
            for server in servers:
                server.shutdown()
            client.shutdown()
            jax_dht.shutdown()
            port_dht.shutdown()


class _FaultyDonor:
    """Stands in for a donor handler whose replica stream is corrupt (a wrong
    digest) or cut short (a chunk missing); every other RPC is the handler's."""

    def __init__(self, handler: ConnectionHandler, fault: str):
        self.handler, self.fault = handler, fault

    def __getattr__(self, name):
        return getattr(self.handler, name)

    async def rpc_replica_state(self, request, context):
        first = True
        async for message in self.handler.rpc_replica_state(request, context):
            if first and self.fault == "digest":
                meta = MSGPackSerializer.loads(message.metadata)
                message = runtime_pb2.ExpertResponse(metadata=MSGPackSerializer.dumps({**meta, "digest": "0" * 32}))
            elif not first and self.fault == "truncated":
                return
            first = False
            yield message


@pytest.mark.parametrize("fault", ["digest", "truncated"])
def test_corrupt_or_truncated_transfer_builds_no_backend(fault):
    uid = "bad.0"
    backend = port_expert("ffn", 1)
    backend.replication_spec = {"expert_cls": "ffn", "hidden_dim": HID, "expert_kwargs": {}, "max_batch_size": 64}
    runner = get_loop_runner()
    with deadline(60):
        donor_dht = DHT(start=True)
        volunteer_dht = DHT(initial_peers=[str(m) for m in donor_dht.get_visible_maddrs()], start=True)
        try:
            handler = ConnectionHandler({uid: backend}, activation_compression="none")
            runner.run_coroutine(handler.add_p2p_handlers(donor_dht.node.p2p, wrapper=_FaultyDonor(handler, fault)))
            error = ValueError if fault == "digest" else ConnectionError
            with pytest.raises(error, match="digest" if fault == "digest" else "truncated"):
                runner.run_coroutine(fetch_replica_state(volunteer_dht.node.p2p, donor_dht.peer_id, uid))
            # the whole acquisition: an advert for the faulty donor's expert, and a
            # volunteer tick that must build and serve nothing
            record = f"{donor_dht.peer_id.to_base58()}|none"
            assert donor_dht.store("replica_wanted.bad", record, get_dht_time() + 30, subkey=uid)
            volunteer = Server(volunteer_dht, {}, replica_slots=1, replication_watch_grids=["bad"], device="cpu")
            runner.run_coroutine(volunteer.replication._acquire_one())
            assert volunteer.backends == {} and volunteer.replication.acquired == []
            assert volunteer.handler.forward_pools == {}
        finally:
            volunteer_dht.shutdown()
            donor_dht.shutdown()


# ------------------------------------------------------------------ Runtime.add_pool


def test_request_to_a_pool_added_at_runtime_answers_within_a_second():
    """A Runtime started with no pools waits on its pools-changed event; a pool
    added later is drained at once, with no polling delay."""
    backend = port_expert("ffn", 1)
    runtime = Runtime([])
    runner = get_loop_runner()
    x = np.random.RandomState(1).randn(3, HID).astype(np.float32)

    async def scenario():
        runtime.start()
        await asyncio.sleep(0.2)  # the drain loop now waits with no pool
        pool = TaskPool(backend.forward, "late_forward", max_batch_size=64)
        runtime.add_pool(pool)
        runtime.add_pool(pool)  # idempotent
        started = time.perf_counter()
        [out] = await asyncio.wait_for(pool.submit_task(x), timeout=1.0)
        elapsed = time.perf_counter() - started
        await runtime.shutdown()
        return out, elapsed

    with deadline(30):
        out, elapsed = runner.run_coroutine(scenario())
    assert elapsed < 1.0 and len(runtime.pools) == 1
    np.testing.assert_array_equal(out, backend.forward(x)[0])
