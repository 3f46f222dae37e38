"""The port's averaging against the JAX package's, piece by piece and without a swarm:
every ``averaging.proto`` message byte for byte (uint64 values above 2**32 and the
``absolute_part`` leg included), the part counts of ``load_balance_peers`` exactly
(HiGHS on the same arrays), the schema hash, the container's serialized parts for
every codec, the reducer's in-place average bit for bit, the error-feedback planes,
the wire-tier negotiation and its straggler policy, group-key rebucketing, state
manifests, and ``amap_in_executor``'s prefetch window."""

from __future__ import annotations

import asyncio
import random
import threading

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hivemind_tpu.averaging import averager as jax_averager
from hivemind_tpu.averaging import key_manager as jax_key_manager
from hivemind_tpu.averaging import load_balancing as jax_load_balancing
from hivemind_tpu.averaging import partition as jax_partition
from hivemind_tpu.averaging import residual as jax_residual
from hivemind_tpu.averaging import state_sync as jax_state_sync
from hivemind_tpu.averaging import wire_codec as jax_wire_codec
from hivemind_tpu.compression import get_codec as jax_get_codec
from hivemind_tpu.compression import serialize_tensor as jax_serialize_tensor
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.proto import averaging_pb2 as jax_pb2
from hivemind_tpu.utils import asyncio_utils as jax_asyncio_utils
from hivemind_tpu_torch.averaging import averager, key_manager, load_balancing, partition, residual, state_sync
from hivemind_tpu_torch.averaging import wire_codec
from hivemind_tpu_torch.averaging.control import AveragingStage, StepControl
from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.compression import get_codec, serialize_tensor
from hivemind_tpu_torch.p2p import PeerID
from hivemind_tpu_torch.proto import averaging_pb2
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.utils import asyncio_utils

SETTINGS = settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
ALL_CODECS = sorted(runtime_pb2.CompressionType.values())

# ------------------------------------------------------------------ averaging.proto

doubles = st.floats(allow_nan=False) | st.sampled_from([0.0, -0.0, float("inf"), 5e-324])
uint32s = st.integers(0, 2**32 - 1)
uint64s = st.integers(0, 2**64 - 1) | st.sampled_from([2**32, 2**32 + 1, 2**63, 2**64 - 1])
codes = st.sampled_from(averaging_pb2.MessageCode.values())
tensor_fields = st.fixed_dictionaries({}, optional={
    "buffer": st.binary(max_size=64), "size": st.lists(uint32s, max_size=3), "dtype": st.text(max_size=8),
    "requires_grad": st.booleans(), "compression": st.sampled_from(ALL_CODECS), "chunks": uint32s})
manifest_entry = st.fixed_dictionaries({}, optional={"num_bytes": uint64s, "digest": st.binary(max_size=16)})
MESSAGES = ("JoinRequest", "MessageFromLeader", "AveragingData", "DownloadRequest", "DownloadData",
            "TensorManifest", "StateManifest")


@st.composite
def message_fields(draw, name):
    # a message field is left out, set empty, or set with fields
    maybe_tensor = st.one_of(st.just(None), st.just({}), tensor_fields)
    optional = {
        "JoinRequest": {"group_key": st.binary(max_size=32), "expiration": doubles, "gather": st.binary(max_size=64),
                        "client_mode": st.booleans(), "schema_hash": st.text(max_size=32)},
        "MessageFromLeader": {"code": codes, "group_id": st.binary(max_size=16),
                              "suggested_leader": st.binary(max_size=40),
                              "ordered_peer_ids": st.lists(st.binary(max_size=40), max_size=4),
                              "gathered": st.lists(st.binary(max_size=40), max_size=4)},
        "AveragingData": {"code": codes, "group_id": st.binary(max_size=16), "part_index": uint32s,
                          "weight": doubles, "absolute_part": st.booleans()},
        "DownloadRequest": {"have_tensors": st.lists(uint32s, max_size=6), "manifest_only": st.booleans()},
        "DownloadData": {"metadata": st.binary(max_size=32), "tensor_index": uint32s},
        "TensorManifest": {"num_bytes": uint64s, "digest": st.binary(max_size=16)},
        "StateManifest": {"schema_hash": st.text(max_size=32), "epoch": uint64s, "state_unavailable": st.booleans(),
                          "tensors": st.lists(manifest_entry, max_size=3), "metadata": st.binary(max_size=32)},
    }[name]
    fields = draw(st.fixed_dictionaries({}, optional=optional))
    if name in ("AveragingData", "DownloadData"):
        tensor = draw(maybe_tensor)
        if tensor is not None:
            fields["tensor_part"] = tensor
    if name == "DownloadData":
        manifest = draw(st.one_of(st.just(None), st.just({}), message_fields("StateManifest")))
        if manifest is not None:
            fields["manifest"] = manifest
    return fields


def build(module, name, fields, tensor_module):
    fields = dict(fields)
    if "tensor_part" in fields:
        fields["tensor_part"] = tensor_module.Tensor(**fields["tensor_part"])
    if "manifest" in fields:
        fields["manifest"] = build(module, "StateManifest", fields["manifest"], tensor_module)
    if "tensors" in fields:
        fields["tensors"] = [module.TensorManifest(**entry) for entry in fields["tensors"]]
    return getattr(module, name)(**fields)


@pytest.mark.parametrize("name", MESSAGES)
@SETTINGS
@given(data=st.data())
def test_every_averaging_message_is_byte_identical_both_ways(name, data):
    from hivemind_tpu.proto import runtime_pb2 as jax_runtime_pb2

    fields = data.draw(message_fields(name))
    ours, theirs = build(averaging_pb2, name, fields, runtime_pb2), build(jax_pb2, name, fields, jax_runtime_pb2)
    encoded = theirs.SerializeToString()
    assert ours.SerializeToString() == encoded
    assert ours.ByteSize() == theirs.ByteSize() == len(encoded)
    parsed = getattr(averaging_pb2, name).FromString(encoded)
    assert parsed.SerializeToString() == encoded
    assert getattr(jax_pb2, name).FromString(ours.SerializeToString()).SerializeToString() == encoded
    for field in ("tensor_part", "manifest"):
        if field in getattr(averaging_pb2, name)._FIELDS_BY_NAME:
            assert parsed.HasField(field) == theirs.HasField(field) == (field in fields)


def test_uint64_fields_and_the_absolute_part_leg():
    """Values above 2**32 both ways, the range's ends, refusals out of range, and the
    quantized leg's field 6."""
    for value in (2**32, 2**32 + 7, 2**53 + 1, 2**63, 2**64 - 1):
        for module in (averaging_pb2, jax_pb2):
            manifest = module.StateManifest(epoch=value)
            manifest.tensors.add(num_bytes=value, digest=b"\x01" * 16)
            encoded = manifest.SerializeToString()
            for reader in (averaging_pb2, jax_pb2):
                parsed = reader.StateManifest.FromString(encoded)
                assert parsed.epoch == value and parsed.tensors[0].num_bytes == value
        assert (averaging_pb2.TensorManifest(num_bytes=value).SerializeToString()
                == jax_pb2.TensorManifest(num_bytes=value).SerializeToString())
    for module in (averaging_pb2, jax_pb2):
        for bad in (-1, 2**64):
            with pytest.raises(ValueError):
                module.TensorManifest(num_bytes=bad)
        with pytest.raises(TypeError):
            module.StateManifest(epoch=1.5)
    ours = averaging_pb2.AveragingData(code=averaging_pb2.PART_DATA, absolute_part=True,
                                       tensor_part=runtime_pb2.Tensor(buffer=b"\x00" * 8, size=[2], dtype="float32"))
    theirs = jax_pb2.AveragingData.FromString(ours.SerializeToString())
    assert theirs.absolute_part and theirs.code == jax_pb2.PART_DATA and theirs.tensor_part.size == [2]
    assert averaging_pb2.AveragingData.FromString(theirs.SerializeToString()).absolute_part


def test_field_tables_and_message_codes_match_the_generated_descriptors():
    from google.protobuf.descriptor import FieldDescriptor

    kinds = {"bytes": FieldDescriptor.TYPE_BYTES, "string": FieldDescriptor.TYPE_STRING,
             "bool": FieldDescriptor.TYPE_BOOL, "enum": FieldDescriptor.TYPE_ENUM,
             "message": FieldDescriptor.TYPE_MESSAGE, "double": FieldDescriptor.TYPE_DOUBLE,
             "uint32": FieldDescriptor.TYPE_UINT32, "uint64": FieldDescriptor.TYPE_UINT64}
    assert set(averaging_pb2.DESCRIPTOR.message_types_by_name) == set(jax_pb2.DESCRIPTOR.message_types_by_name)
    for name, descriptor in jax_pb2.DESCRIPTOR.message_types_by_name.items():
        theirs = [(f.name, f.number, f.type, f.message_type.name if f.message_type else None,
                   f.label == FieldDescriptor.LABEL_REPEATED) for f in descriptor.fields]
        ours = [(f.name, f.number, kinds[f.type], f.message_type.__name__ if f.message_type else None, f.repeated)
                for f in averaging_pb2.DESCRIPTOR.message_types_by_name[name].FIELDS]
        assert ours == theirs, name
    codes = jax_pb2.DESCRIPTOR.enum_types_by_name["MessageCode"]
    assert len(codes.values) == 19
    assert averaging_pb2.MessageCode.items() == [(v.name, v.number) for v in codes.values]
    for name, number in averaging_pb2.MessageCode.items():
        assert getattr(averaging_pb2, name) == getattr(jax_pb2, name) == number


# ------------------------------------------------------------------ load balancing


def _bandwidth_cases():
    rng = np.random.RandomState(2024)
    cases = []
    for _ in range(120):
        n = int(rng.randint(2, 9))
        bandwidths = list(np.exp(rng.uniform(np.log(1e6), np.log(1e9), n)))
        for index in rng.choice(n, int(rng.randint(0, n)), replace=False):
            bandwidths[index] = 0.0  # client-mode peers
        if not any(bandwidths):
            bandwidths[0] = 1e8
        cases.append((int(rng.randint(1, 10**7)), bandwidths, 0))
    cases += [(size, [1.0, 2.0, 3.0], 0) for size in (1, 7, 100, 12345, 10**8)]  # degenerate LP
    cases += [(size, [1e8] * n, 0) for n in (2, 3, 4, 7, 8) for size in (10, 999, 65537, 10**6 + 3, 10**8)]
    cases += [(10**5, [0.0, 1e8, 0.0, 2e8], 0), (10**5, [None, 1e8, 5e7], 0)]  # client-mode zeros and Nones
    cases += [(1000, [1e8, 1e8, 1e6], min_size) for min_size in (1, 10, 400, 2000)]  # starved reducers
    cases += [(5000, [3e8, 1e7, 2e7, 1e8], 600), (97, [1e8] * 5, 30)]
    return cases


def test_load_balance_peers_gives_the_jax_packages_part_counts_exactly():
    """Every peer computes the counts itself: a mixed group agrees only if both
    packages return the same tuple, bit for bit."""
    def outcome(module, *args):
        try:
            return module.load_balance_peers(*args)
        except (AssertionError, ValueError) as e:  # a min_size that starves every reducer
            return type(e)

    answered = 0
    for case in _bandwidth_cases():
        ours, theirs = outcome(load_balancing, *case), outcome(jax_load_balancing, *case)
        assert ours == theirs, case
        if isinstance(ours, tuple):
            assert sum(ours) == case[0]
            answered += 1
    assert answered >= 140
    for module in (load_balancing, jax_load_balancing):
        with pytest.raises(ValueError):
            module.load_balance_peers(10, [0.0, None])


def test_scipy_is_imported_at_module_load():
    """A cold ``scipy.optimize`` import on the loop stalls a round: the port binds the
    solver when the module loads."""
    import scipy.optimize

    assert load_balancing.linprog is scipy.optimize.linprog


# ------------------------------------------------------------------ schema hash


@pytest.mark.parametrize("codec_type", ALL_CODECS)
def test_schema_hash_is_the_jax_packages(codec_type):
    arrays = [np.zeros((3, 4), np.float32), np.zeros(5, np.float64), np.zeros((2, 1, 3), np.float16)]
    theirs = jax_averager.DecentralizedAverager(arrays, None, prefix="schema", compression=jax_get_codec(codec_type))
    for tensors in (arrays, [torch.from_numpy(array) for array in arrays]):
        ours = averager.DecentralizedAverager(tensors, None, prefix="schema", compression=get_codec(codec_type))
        assert ours.schema_hash == theirs.schema_hash
        with ours.get_tensors() as mirrors:
            assert [str(mirror.dtype) for mirror in mirrors] == ["torch.float32", "torch.float64", "torch.float16"]
    other = averager.DecentralizedAverager([np.zeros((3, 5), np.float32)], None, prefix="schema",
                                           compression=get_codec(codec_type))
    assert other.schema_hash != theirs.schema_hash


def test_get_tensors_shares_the_mirrors_memory():
    source = torch.arange(6, dtype=torch.float32)
    ours = averager.DecentralizedAverager([source], None, prefix="mirror")
    source.zero_()  # the averager holds its own copy
    with ours.get_tensors() as tensors:
        assert tensors[0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
        tensors[0].copy_(torch.full((6,), 2.5))
    assert ours._snapshot_tensors()[0].tolist() == [2.5] * 6
    bf16 = averager.DecentralizedAverager([torch.ones(3, dtype=torch.bfloat16)], None, prefix="mirror")
    assert bf16._snapshot_tensors()[0].dtype == np.float32


# ------------------------------------------------------------------ partition


def _tensors():
    """Mixed shapes and dtypes, with values beyond the fp16 range so the FLOAT16 clip
    path is exercised, a float64 tensor (the conversion-copy path), and parts that
    straddle tensor boundaries."""
    rng = np.random.RandomState(7)
    return [
        rng.randn(1111).astype(np.float32) * 1e5,
        rng.randn(64, 32).astype(np.float32),
        rng.randn(501).astype(np.float64),
        rng.randn(3, 5, 7).astype(np.float32),
    ]


async def _parts(module, tensors, counts, **kwargs):
    container = module.TensorPartContainer(tensors, counts, part_size_bytes=1024, **kwargs)
    produced = []
    for peer_index in range(len(counts)):
        async for serialized in container.iterate_input_parts_for(peer_index):
            produced.append(serialized.SerializeToString())
    return container, produced


@pytest.mark.parametrize("codec_type", ALL_CODECS)
async def test_container_parts_are_the_jax_packages_bytes(codec_type):
    arrays = _tensors()
    total = sum(array.size for array in arrays)
    counts = [total // 3, total // 5, total - total // 3 - total // 5]
    _, theirs = await _parts(jax_partition, arrays, counts, compression=jax_get_codec(codec_type))
    for tensors in (arrays, [torch.from_numpy(array.copy()) for array in arrays]):
        container, ours = await _parts(partition, tensors, counts, compression=get_codec(codec_type))
        assert ours == theirs
        assert container.num_parts_by_peer == jax_partition.TensorPartContainer(arrays, counts, part_size_bytes=1024).num_parts_by_peer
    for array, original in zip(arrays, _tensors()):
        assert np.array_equal(array, original), "the container changed a caller's tensor"


@pytest.mark.parametrize("tier", ["uniform8", "blockwise8"])
async def test_error_feedback_links_send_the_jax_packages_bytes(tier):
    """A lossy link compresses through the send-leg residual plane: two rounds in a
    row give the same bytes and leave the same plane as the JAX package's."""
    arrays = _tensors()
    total = sum(array.size for array in arrays)
    counts = [total // 2, total - total // 2]
    stores = residual.ResidualStore(), jax_residual.ResidualStore()
    links = ([None, wire_codec.WireLink.for_tier(tier)], [None, jax_wire_codec.WireLink.for_tier(tier)])
    for _round in range(2):
        _, ours = await _parts(partition, arrays, counts, peer_links=links[0], residuals=stores[0])
        _, theirs = await _parts(jax_partition, arrays, counts, peer_links=links[1], residuals=stores[1])
        assert ours == theirs
        assert np.array_equal(stores[0].view("send", 0, total), stores[1].view("send", 0, total))
    assert stores[0].footprint_bytes() == stores[1].footprint_bytes() == total * 4


@pytest.mark.parametrize("weights,failed", [((1.0, 1.0, 1.0), None), ((0.3, 1.0, 2.5), None), ((0.5, 2.0, 1.0), 1)])
async def test_reducer_average_is_bit_identical_for_the_same_arrival_order(weights, failed):
    rng = np.random.RandomState(3)
    parts = [rng.randn(1000).astype(np.float32) for _ in range(3)]
    results = []
    for module in (partition, jax_partition):
        reducer = module.TensorPartReducer([(1000,)], num_senders=3)
        senders = [i for i in range(3) if i != failed]
        tasks = []
        for sender in senders:  # one at a time: the arrival order is the senders' order
            tasks.append(asyncio.ensure_future(reducer.accumulate_part(sender, 0, parts[sender], weights[sender])))
            await asyncio.sleep(0)
        if failed is not None:
            reducer.on_sender_failed(failed)
        results.append(await asyncio.gather(*tasks))
    for ours, theirs in zip(*results):
        assert ours.tobytes() == theirs.tobytes()
    assert results[0][0].tobytes() == results[0][-1].tobytes()


async def test_processed_parts_give_the_jax_packages_deltas():
    """Deltas, absolute parts (the quantized leg) and a failed reducer's parts land in
    the output tensors exactly as in the JAX package."""
    arrays = _tensors()
    total = sum(array.size for array in arrays)
    counts = [total // 2, total - total // 2]
    rng = np.random.RandomState(5)
    containers = [module.TensorPartContainer(arrays, counts, part_size_bytes=1024) for module in (partition, jax_partition)]
    for part_index, (start, stop) in enumerate(containers[0].parts_by_peer[0]):
        delta, value = rng.randn(stop - start).astype(np.float32), rng.randn(stop - start).astype(np.float32)
        if part_index % 2:
            for container in containers:
                container.register_processed_part(0, part_index, delta)
        else:
            for container in containers:
                container.register_processed_absolute(0, part_index, value)
    for container in containers:
        container.register_failed_reducer(1)
    outputs = [[out.copy() async for out in container.iterate_output_tensors()] for container in containers]
    assert containers[0].failed_size == containers[1].failed_size == counts[1]
    for ours, theirs in zip(*outputs):
        assert ours.tobytes() == theirs.tobytes() and ours.shape == theirs.shape


def test_compute_span_part_sizes_and_error_feedback_match():
    assert partition.TensorPartContainer([np.zeros(64, np.float32)], [64], prefetch=2).prefetch == 2
    with pytest.raises(AssertionError):
        partition.TensorPartContainer([np.zeros(64, np.float32)], [64], prefetch=0)
    for count, part_bytes in ((0, 1024), (1, 4), (1000, 1024), (2**20 + 3, 2**21), (5, 3)):
        assert partition.compute_span_part_sizes(count, part_bytes) == jax_partition.compute_span_part_sizes(count, part_bytes)
    rng = np.random.RandomState(9)
    part = rng.randn(5000).astype(np.float32)
    for tier in ("uniform8", "blockwise8"):
        planes = [rng.randn(5000).astype(np.float32) * 1e-2] * 2
        planes = [planes[0].copy(), planes[1].copy()]
        ours = residual.compress_with_feedback(part, wire_codec.WireLink.for_tier(tier).codec, planes[0])
        theirs = jax_residual.compress_with_feedback(part, jax_wire_codec.WireLink.for_tier(tier).codec, planes[1])
        assert ours.SerializeToString() == theirs.SerializeToString()
        assert planes[0].tobytes() == planes[1].tobytes()


# ------------------------------------------------------------------ wire tiers


def test_wire_tier_negotiation_is_the_jax_packages():
    rng = random.Random(11)
    tiers = list(wire_codec.WIRE_TIERS)
    peers = [f"peer{i}" for i in range(4)]
    adverts = [None, {}, {"t": "x"}, {"t": ["none"], "d": "float16"}, {"t": [1, "uniform8"], "d": "uniform8", "m": []}]
    for _ in range(200):
        supported = rng.sample(tiers, rng.randint(1, 4))
        demotions = {peer: rng.choice(tiers + ["bogus"]) for peer in rng.sample(peers, rng.randint(0, 2))}
        adverts.append(wire_codec.make_advert(supported, rng.choice(supported), demotions))
    for advert in adverts:
        assert wire_codec.parse_advert(advert) == jax_wire_codec.parse_advert(advert)
    parsed = [wire_codec.parse_advert(advert) for advert in adverts]
    for _ in range(500):
        local, remote = rng.choice(parsed), rng.choice(parsed)
        a, b = rng.sample(peers, 2)
        ours = wire_codec.negotiate_link(local, remote, a, b)
        assert ours == jax_wire_codec.negotiate_link(local, remote, a, b)
        assert ours == wire_codec.negotiate_link(remote, local, b, a)  # both ends agree
    for codec_type in ALL_CODECS:
        assert wire_codec.tier_of_codec(get_codec(codec_type)) == jax_wire_codec.tier_of_codec(jax_get_codec(codec_type))


class _Ledger:
    """The straggler scores a RoundLedger would report, fed by hand."""

    def __init__(self):
        self.scores, self.events = {}, []

    def straggler_scores(self):
        return {peer: dict(score) for peer, score in self.scores.items()}

    def record_codec_event(self, peer, action, tier=None):
        self.events.append((peer, action, tier))


def test_link_policy_demotes_and_promotes_as_the_jax_package():
    ledgers = _Ledger(), _Ledger()
    policies = (wire_codec.LinkCodecPolicy(ledgers[0], default_tier="float16", promote_after=3),
                jax_wire_codec.LinkCodecPolicy(ledgers[1], default_tier="float16", promote_after=3))
    rng = random.Random(5)
    totals = {peer: [0, 0.0] for peer in ("a", "b", "c")}
    for step in range(40):
        slow = rng.choice(["a", "a", "b", None]) if step < 20 else None
        if slow is not None:
            totals[slow][0] += 1
            totals[slow][1] += rng.uniform(0.0, 0.5)
        for ledger in ledgers:
            ledger.scores = {peer: {"rounds_slowest": t[0], "excess_s": t[1]} for peer, t in totals.items()}
        assert policies[0].refresh(exclude=("c",)) == policies[1].refresh(exclude=("c",))
    assert ledgers[0].events == ledgers[1].events and ledgers[0].events


# ------------------------------------------------------------------ group keys, control, manifests


class _Node:
    def __init__(self, peer_id):
        self.peer_id = peer_id


async def test_rebucketing_lands_in_the_jax_packages_buckets():
    rng = random.Random(3)
    for bits in ("0", "01", "1101"):
        for _ in range(20):
            ids = [_random_peer(rng).to_bytes() for _ in range(rng.randint(2, 6))]
            group_id = rng.randbytes(16)
            ours = [key_manager.GroupKeyManager(_Node(PeerID(raw)), "p", bits) for raw in ids]
            theirs = [jax_key_manager.GroupKeyManager(_Node(JaxPeerID(raw)), "p", bits) for raw in ids]
            for manager in ours:
                await manager.update_key_on_group_assembled(GroupInfo(group_id, tuple(PeerID(raw) for raw in ids), ()))
            for manager in theirs:
                await manager.update_key_on_group_assembled(
                    jax_key_manager.GroupInfo(group_id, tuple(JaxPeerID(raw) for raw in ids), ()))
            assert [m.group_bits for m in ours] == [m.group_bits for m in theirs]
            assert ours[0].current_key == theirs[0].current_key
    manager = key_manager.GroupKeyManager(_Node(None), "p", "10")
    await manager.update_key_on_not_enough_peers()
    assert manager.current_key == "p.0b1" and key_manager.is_valid_group("p.0b1") and not key_manager.is_valid_group("p.x")


def _random_peer(rng: random.Random) -> PeerID:
    return PeerID(b"\x00\x24\x08\x01\x12\x20" + rng.randbytes(32))


def test_step_control_two_phase_trigger_and_result():
    control = StepControl(scheduled_time=0.0, deadline=None, allow_retries=True, weight=1.0)
    waiter_done = threading.Event()

    async def _wait():
        await control.wait_for_trigger()
        waiter_done.set()

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_until_complete, args=(_wait(),))
    thread.start()
    assert not control.triggered and not waiter_done.wait(0.1)
    control.weight = 2.0
    control.allow_allreduce()
    thread.join(5)
    loop.close()
    assert waiter_done.is_set() and control.triggered
    control.began_allreduce = True
    with pytest.raises(RuntimeError):
        control.weight = 3.0
    control.set_result({"x": 1})
    assert control.result(0) == {"x": 1} and control.stage == AveragingStage.FINISHED
    cancelled = StepControl(scheduled_time=0.0, deadline=None, allow_retries=False, weight=1.0)
    assert cancelled.cancel() and cancelled.cancelled and cancelled.triggered


def test_state_manifests_are_the_jax_packages():
    rng = np.random.RandomState(1)
    arrays = [rng.randn(1000).astype(np.float32), rng.randn(7, 3).astype(np.float64)]
    codec_types = (runtime_pb2.CompressionType.NONE, runtime_pb2.CompressionType.FLOAT16)
    for codec_type in codec_types:
        ours = [serialize_tensor(torch.from_numpy(a), get_codec(codec_type)) for a in arrays]
        theirs = [jax_serialize_tensor(a, jax_get_codec(codec_type)) for a in arrays]
        for epoch in (0, 3, 2**40):
            manifest = state_sync.build_state_manifest(ours, schema_hash="s", epoch=epoch, metadata=b"m")
            jax_manifest = jax_state_sync.build_state_manifest(theirs, schema_hash="s", epoch=epoch, metadata=b"m")
            assert manifest.SerializeToString() == jax_manifest.SerializeToString()
    assert state_sync.payload_digest(b"abc") == jax_state_sync.payload_digest(b"abc")
    assembly = state_sync.StateAssembly(expected_tensors=2, min_epoch=1)
    with pytest.raises(state_sync.StaleDonor):
        assembly.pin_manifest(state_sync.build_state_manifest(ours, schema_hash="s", epoch=0), "d")
    with pytest.raises(state_sync.StateUnavailable):
        assembly.pin_manifest(averaging_pb2.StateManifest(state_unavailable=True), "d")
    assembly.pin_manifest(state_sync.build_state_manifest(ours, schema_hash="s", epoch=1), "d")
    corrupt = runtime_pb2.Tensor()
    corrupt.CopyFrom(ours[0])
    corrupt.buffer = bytes(len(ours[0].buffer))
    with pytest.raises(state_sync.DigestMismatch):
        assembly.feed(0, corrupt)
    for index, tensor in enumerate(ours):
        assembly.feed(index, tensor)
    result = assembly.result(["d"])
    assert result.verified and result.epoch == 1
    for got, array in zip(result.tensors, arrays):
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), array.astype(np.float16).astype(array.dtype))


# ------------------------------------------------------------------ asyncio helpers


@pytest.mark.parametrize("max_prefetch", [1, 2, 4])
async def test_amap_in_executor_keeps_the_prefetch_window(max_prefetch):
    """With the consumer stalled after one item, the blocking fn runs exactly as
    often in both packages: ``max_prefetch`` results queued plus one in flight."""
    calls = []
    for module in (asyncio_utils, jax_asyncio_utils):
        count = [0]

        def fn(x, _count=count):
            _count[0] += 1
            return x * 2

        iterator = module.amap_in_executor(fn, module.as_aiter(*range(20)), max_prefetch=max_prefetch)
        assert await iterator.__anext__() == 0
        await asyncio.sleep(0.2)
        calls.append(count[0])
        rest = [item async for item in iterator]
        assert rest == [2 * x for x in range(1, 20)]
    assert calls[0] == calls[1] <= max_prefetch + 2


async def test_async_iterator_helpers():
    assert [x async for x in asyncio_utils.azip(asyncio_utils.as_aiter(1, 2, 3), asyncio_utils.as_aiter("a", "b"))] == [
        (1, "a"), (2, "b")]
    assert [x async for x in asyncio_utils.achain(asyncio_utils.as_aiter(1), asyncio_utils.as_aiter(2, 3))] == [1, 2, 3]
    assert [x async for x in asyncio_utils.aenumerate(asyncio_utils.as_aiter("a", "b"), start=5)] == [(5, "a"), (6, "b")]
    event = asyncio.Event()
    assert [x async for x in asyncio_utils.attach_event_on_finished(asyncio_utils.as_aiter(1), event)] == [1]
    assert event.is_set()
    task = asyncio.ensure_future(asyncio.sleep(10))
    assert await asyncio_utils.cancel_and_wait(task)
    done = asyncio.ensure_future(asyncio.sleep(0))
    await done
    assert not await asyncio_utils.cancel_and_wait(done)
    cancelled = asyncio.ensure_future(asyncio.sleep(10))
    cancelled.cancel()
    assert await asyncio_utils.await_cancelled(cancelled)
