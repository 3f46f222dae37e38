"""Port and JAX averagers in one swarm: a two-peer all-reduce between a port runner
and a JAX runner is bit-identical to the numpy replay of the wire for the lossless
tiers (``none``, ``float16``) and within the JAX tests' tolerance for the 8-bit tiers;
a group of two port and two JAX ``DecentralizedAverager``s at unequal bandwidths
completes and lands on the exact mean; state downloads cross the packages both ways,
striped across a port and a JAX donor and resumed after a donor dies mid-stream; and
client mode, auxiliary peers, the two-phase trigger and rebucketing run on a port-only
swarm. Each swarm test runs under a wall-clock deadline."""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from hivemind_tpu.averaging import DecentralizedAverager as JaxAverager
from hivemind_tpu.averaging import allreduce as jax_allreduce
from hivemind_tpu.averaging import residual as jax_residual
from hivemind_tpu.averaging import state_sync as jax_state_sync
from hivemind_tpu.averaging import wire_codec as jax_wire_codec
from hivemind_tpu.compression import get_codec as jax_get_codec
from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.p2p import P2P as JaxP2P
from hivemind_tpu.p2p import PeerID as JaxPeerID
from hivemind_tpu.proto import averaging_pb2 as jax_pb2
from hivemind_tpu.resilience import CHAOS as JAX_CHAOS
from hivemind_tpu_torch.averaging import DecentralizedAverager, allreduce, residual, state_sync, wire_codec
from hivemind_tpu_torch.averaging.control import AveragingStage
from hivemind_tpu_torch.compression import get_codec
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.p2p import P2P, PeerID
from hivemind_tpu_torch.proto import averaging_pb2, runtime_pb2
from hivemind_tpu_torch.resilience import CHAOS

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_partition_equivalence import _replay_two_peer_allreduce  # noqa: E402

U16 = 2.0**-11  # fp16's unit roundoff
U32 = 2.0**-24


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
def clean_port_chaos():
    yield
    CHAOS.clear()


# ------------------------------------------------------------------ one all-reduce, one peer of each package

PACKAGES = {
    "port": dict(p2p=P2P, peer_id=PeerID, pb2=averaging_pb2, allreduce=allreduce, codec=get_codec,
                 link=wire_codec.WireLink, store=residual.ResidualStore),
    "jax": dict(p2p=JaxP2P, peer_id=JaxPeerID, pb2=jax_pb2, allreduce=jax_allreduce, codec=jax_get_codec,
                link=jax_wire_codec.WireLink, store=jax_residual.ResidualStore),
}


class _Harness:
    """A stand-in for the averager's ``rpc_aggregate_part`` in either package: it routes
    each sender's stream to this peer's runner."""

    def __init__(self, p2p, package: dict):
        self.p2p, self.package, self.runner = p2p, package, None

    async def register(self):
        async def rpc_aggregate_part(requests, context):
            first = await requests.__anext__()
            async for message in self.runner.handle_aggregate_stream(first, requests, context):
                yield message

        await self.p2p.add_protobuf_handler("DecentralizedAverager.rpc_aggregate_part", rpc_aggregate_part,
                                            self.package["pb2"].AveragingData, stream_input=True, stream_output=True)

    def get_stub(self, peer_id):
        p2p, message_type = self.p2p, self.package["pb2"].AveragingData

        class _Stub:
            def rpc_aggregate_part(self, requests, timeout=None):
                return p2p.iterate_protobuf_handler(peer_id, "DecentralizedAverager.rpc_aggregate_part",
                                                    requests, message_type)

        return _Stub()


async def _mixed_round(order, flats, counts, part_size_bytes, codec_type=None, tier=None):
    """One all-reduce between a port runner and a JAX runner (``order`` names the package
    of each rank); the per-tensor deltas each rank yields."""
    packages = [PACKAGES[name] for name in order]
    p2ps = [await package["p2p"].create() for package in packages]
    try:
        await p2ps[1].connect(str(p2ps[0].get_visible_maddrs()[0]))
        await p2ps[0].connect(str(p2ps[1].get_visible_maddrs()[0]))
        raw_ids = [p2p.peer_id.to_bytes() for p2p in p2ps]
        harnesses = [_Harness(p2p, package) for p2p, package in zip(p2ps, packages)]
        for harness in harnesses:
            await harness.register()
        for rank, (harness, package) in enumerate(zip(harnesses, packages)):
            links = {1 - rank: package["link"].for_tier(tier)} if tier is not None else None
            harness.runner = package["allreduce"].AllReduceRunner(
                p2p=harness.p2p,
                group_id=b"mixed-group",
                tensors=[flats[rank].copy()],
                ordered_peer_ids=[package["peer_id"](raw) for raw in raw_ids],
                peer_element_counts=counts,
                modes=[package["allreduce"].AveragingMode.NODE] * 2,
                get_stub=harness.get_stub,
                compression=package["codec"](codec_type if codec_type is not None else runtime_pb2.CompressionType.FLOAT16),
                part_size_bytes=part_size_bytes,
                sender_timeout=10.0,
                reducer_timeout=20.0,
                links=links,
                residuals=package["store"]() if tier is not None else None,
            )

        async def run(harness):
            return [delta async for delta in harness.runner.run()]

        return await asyncio.gather(*(run(harness) for harness in harnesses))
    finally:
        for p2p in p2ps:
            await p2p.shutdown()


@pytest.mark.parametrize("order", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("codec_type", [runtime_pb2.CompressionType.NONE, runtime_pb2.CompressionType.FLOAT16])
async def test_two_peer_mixed_allreduce_is_bit_identical_to_the_replay(order, codec_type):
    """The wire pipeline replayed op by op in numpy (the JAX package's own oracle,
    ``test_partition_equivalence.py``) predicts both ranks' deltas bit for bit."""
    rng = np.random.RandomState(11)
    n, part_size_bytes = 800, 600  # several parts a span
    flats = [rng.randn(n).astype(np.float32) * 3.0 for _ in range(2)]
    counts = [n // 2, n - n // 2]
    deltas = await _mixed_round(order, flats, counts, part_size_bytes, codec_type=codec_type)
    expected = _replay_two_peer_allreduce(flats, counts, codec_type, part_size_bytes)
    for rank in range(2):
        assert deltas[rank][0].reshape(-1).tobytes() == expected[rank].tobytes(), (order, rank)


@pytest.mark.parametrize("order", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("tier", ["uniform8", "blockwise8"])
async def test_two_peer_mixed_quantized_allreduce_within_tolerance(order, tier):
    """An 8-bit link with error feedback (the ``absolute_part`` leg) in both directions:
    each rank within 0.05 of the true average, the JAX tests' limit."""
    rng = np.random.RandomState(13)
    n = 4000
    flats = [rng.randn(n).astype(np.float32) for _ in range(2)]
    deltas = await _mixed_round(order, flats, [n // 2, n - n // 2], 600, tier=tier)
    average = (flats[0] + flats[1]) / 2
    for rank in range(2):
        assert np.abs(flats[rank] + deltas[rank][0].reshape(-1) - average).max() < 0.05, (order, rank)


# ------------------------------------------------------------------ a mixed swarm of averagers


@pytest.fixture(scope="module")
def mixed_dhts():
    """Two port and two JAX DHT peers, each bootstrapped from a peer of the other package."""
    with deadline(90):
        first = DHT(start=True)
        jax_first = JaxDHT(initial_peers=[str(m) for m in first.get_visible_maddrs()], start=True)
        second = DHT(initial_peers=[str(m) for m in jax_first.get_visible_maddrs()], start=True)
        jax_second = JaxDHT(initial_peers=[str(m) for m in second.get_visible_maddrs()], start=True)
    yield {"port": (first, second), "jax": (jax_first, jax_second)}
    for dht in (jax_second, second, jax_first, first):
        dht.shutdown()


def _make(package: str, dht, tensors, **kwargs):
    if package == "port":
        return DecentralizedAverager([torch.from_numpy(t.copy()) for t in tensors], dht, start=True, **kwargs)
    return JaxAverager([t.copy() for t in tensors], dht, start=True, **kwargs)


def _values(averager):
    with averager.get_tensors() as tensors:
        return [np.array(t, copy=True) for t in tensors]


@pytest.mark.parametrize("codec_type", [runtime_pb2.CompressionType.NONE, runtime_pb2.CompressionType.FLOAT16])
def test_four_peer_mixed_group_at_unequal_bandwidths(mixed_dhts, codec_type):
    """Each peer balances the group's load itself from the gathered bandwidths, so the
    round completes only if both packages cut the same spans. Every element lands
    within the exact float64 mean's rounding bound: 8 u32 of the group's largest input
    on the lossless wire; 4 u16 more on fp16 (an input and a delta rounding, each at
    most 2 u16 of that magnitude)."""
    layout = [("port", 0, 2e8), ("jax", 0, 5e7), ("port", 1, 1e9), ("jax", 1, 1e8)]
    rng = np.random.RandomState(21)
    tensors = [[rng.randn(1500).astype(np.float32), rng.randn(40, 25).astype(np.float32)] for _ in layout]
    prefix = f"mixed{codec_type}"
    with deadline(120):
        averagers = [
            _make(package, mixed_dhts[package][index], tensors[rank], prefix=prefix, target_group_size=4,
                  min_group_size=4, min_matchmaking_time=1.0, request_timeout=1.0, sender_timeout=5.0,
                  reducer_timeout=10.0, part_size_bytes=2048, bandwidth=bandwidth,
                  compression=(get_codec if package == "port" else jax_get_codec)(codec_type))
            for rank, (package, index, bandwidth) in enumerate(layout)
        ]
        try:
            assert len({averager.schema_hash for averager in averagers}) == 1
            controls = [averager.step(gather=rank, wait=False, timeout=60) for rank, averager in enumerate(averagers)]
            for control in controls:
                gathered = control.result(timeout=90)
                assert sorted(gathered.values()) == [0, 1, 2, 3]
            for k in range(2):
                stacked = np.stack([t[k].astype(np.float64) for t in tensors])
                mean, scale = stacked.mean(axis=0), np.abs(stacked).max(axis=0)
                limit = (8 * U32 + (4 * U16 if codec_type == runtime_pb2.CompressionType.FLOAT16 else 0)) * scale
                for averager in averagers:
                    got = _values(averager)[k].astype(np.float64)
                    assert np.all(np.abs(got - mean) <= limit), (type(averager).__module__, np.abs(got - mean).max())
        finally:
            for averager in averagers:
                averager.shutdown()


# ------------------------------------------------------------------ state downloads across packages

STATE = [np.random.RandomState(31).randn(600_000).astype(np.float32),
         np.random.RandomState(32).randn(500_000).astype(np.float32),
         np.random.RandomState(33).randn(8, 8).astype(np.float32)]  # 4.4 MB: above the striping floor


@pytest.fixture(scope="module")
def state_swarm(mixed_dhts):
    """A port and a JAX donor of the same state (``declare_state_period`` 1 s), and a
    port and a JAX receiver that share nothing."""
    common = dict(prefix="statesync", target_group_size=2, declare_state_period=1.0)
    donors = {"port": _make("port", mixed_dhts["port"][0], STATE, **common),
              "jax": _make("jax", mixed_dhts["jax"][0], STATE, **common)}
    zeros = [np.zeros_like(t) for t in STATE]
    receivers = {"port": _make("port", mixed_dhts["port"][1], zeros, allow_state_sharing=False, **common),
                 "jax": _make("jax", mixed_dhts["jax"][1], zeros, allow_state_sharing=False, **common)}
    declared_by = time.monotonic() + 30
    while time.monotonic() < declared_by:
        record = mixed_dhts["port"][1].get("statesync.all_averagers", latest=True)
        if record is not None and len([v for v in record.value.values() if v.value is not None]) == 2:
            break
        time.sleep(0.1)
    yield donors, receivers
    for averager in (*receivers.values(), *donors.values()):
        averager.shutdown()


def _download(receiver, package: str, **kwargs):
    """``download_state_verified`` of the receiver's package, on its loop."""
    if package == "port":
        coro = state_sync.download_state_verified(
            receiver.dht, receiver.p2p, "statesync", DecentralizedAverager.get_stub,
            exclude_peer_id=receiver.peer_id, timeout=30, **kwargs)
    else:
        coro = jax_state_sync.download_state_verified(
            receiver.dht, receiver.p2p, "statesync", JaxAverager.get_stub,
            exclude_peer_id=receiver.peer_id, timeout=30, **kwargs)
    return receiver._runner.run_coroutine(coro, return_future=True).result(60)


@pytest.mark.parametrize("receiver_package", ["port", "jax"])
def test_state_download_striped_across_a_port_and_a_jax_donor(state_swarm, receiver_package):
    """The two donors' manifests are bit-identical (schema hash, epoch, digests), so one
    download stripes its tensors across both packages; every tensor is verified."""
    donors, receivers = state_swarm
    receiver = receivers[receiver_package]
    with deadline(90):
        metadata, tensors = receiver.load_state_from_peers(timeout=30)
        assert metadata is None and len(tensors) == len(STATE)
        for got, expected in zip(tensors, STATE):
            assert np.asarray(got).tobytes() == expected.tobytes()
        result = _download(receiver, receiver_package)
    assert result.verified and result.bytes_received == sum(t.nbytes for t in STATE)
    assert sorted(result.donors) == sorted(str(donor.peer_id) for donor in donors.values())


@pytest.mark.parametrize("receiver_package", ["port", "jax"])
def test_state_download_resumes_from_the_other_package_after_a_donor_dies(state_swarm, receiver_package):
    """The other package's donor (the first candidate by priority) aborts after three
    1 MiB chunks, which complete tensor 0; the receiver fails over to its own package's
    donor and asks only for the rest (``have_tensors``), so no byte moves twice."""
    donors, receivers = state_swarm
    dying_package = "jax" if receiver_package == "port" else "port"
    dying, surviving = donors[dying_package], donors[receiver_package]
    dying.state_sharing_priority, surviving.state_sharing_priority = 2.0, 1.0
    engine = CHAOS if dying_package == "port" else JAX_CHAOS
    with deadline(90):
        time.sleep(2.5)  # two declare periods carry the priorities
        engine.add_rule("state.download.send", "abort", after=3, times=1, scope=str(dying.peer_id))
        try:
            result = _download(state_swarm[1][receiver_package], receiver_package, max_stripes=1)
            aborted = engine.stats()["state.download.send:abort"]
        finally:
            engine.clear()
            dying.state_sharing_priority = surviving.state_sharing_priority = 0.0
    assert aborted == 1  # the rule fired in the dying donor's own package
    assert result.verified and result.donors == [str(surviving.peer_id)]
    assert result.bytes_received == sum(t.nbytes for t in STATE)
    for got, expected in zip(result.tensors, STATE):
        assert np.asarray(got).tobytes() == expected.tobytes()


# ------------------------------------------------------------------ port-only modes


def _port_swarm(n: int):
    first = DHT(start=True)
    maddrs = [str(m) for m in first.get_visible_maddrs()]
    return [first] + [DHT(initial_peers=maddrs, start=True) for _ in range(n - 1)]


def test_port_client_and_auxiliary_peers_in_one_group():
    """Two nodes, a client (sends, reduces nothing) and an auxiliary peer (reduces, weight
    0): every sender lands on the mean of the three senders; the aux keeps its tensors."""
    with deadline(90):
        dhts = _port_swarm(4)
        rng = np.random.RandomState(41)
        values = [rng.randn(300).astype(np.float32) for _ in range(4)]
        common = dict(prefix="modes", start=True, target_group_size=4, min_group_size=4, min_matchmaking_time=1.0,
                      request_timeout=1.0, sender_timeout=5.0, reducer_timeout=10.0)
        averagers = [DecentralizedAverager([torch.from_numpy(values[0])], dhts[0], **common),
                     DecentralizedAverager([torch.from_numpy(values[1])], dhts[1], **common),
                     DecentralizedAverager([torch.from_numpy(values[2])], dhts[2], client_mode=True, **common),
                     DecentralizedAverager([torch.from_numpy(values[3])], dhts[3], auxiliary=True, **common)]
        try:
            controls = [averager.step(wait=False, timeout=40) for averager in averagers]
            for control in controls:
                assert control.result(timeout=60) is not None
            expected = np.mean(values[:3], axis=0)
            for averager in averagers[:3]:
                np.testing.assert_allclose(_values(averager)[0], expected, atol=1e-5)
            assert _values(averagers[3])[0].tobytes() == values[3].tobytes()
        finally:
            for averager in averagers:
                averager.shutdown()
            for dht in dhts:
                dht.shutdown()


def test_port_two_phase_trigger_and_group_bit_rebucketing():
    """Matchmaking runs ahead of the trigger; the all-reduce waits for
    ``allow_allreduce``; the group id then rebuckets both peers' two group bits."""
    with deadline(90):
        dhts = _port_swarm(2)
        averagers = [DecentralizedAverager([torch.full((64,), float(i))], dht, prefix="trigger", start=True,
                                           target_group_size=2, initial_group_bits="00", min_matchmaking_time=1.0,
                                           request_timeout=1.0)
                     for i, dht in enumerate(dhts)]
        try:
            controls = [averager.step(wait=False, require_trigger=True, timeout=40) for averager in averagers]
            waited_until = time.monotonic() + 20
            while time.monotonic() < waited_until and not all(
                    c.stage == AveragingStage.AWAITING_TRIGGER for c in controls):
                time.sleep(0.05)
            assert all(c.stage == AveragingStage.AWAITING_TRIGGER and not c.began_allreduce for c in controls)
            time.sleep(0.3)
            assert _values(averagers[0])[0][0] == 0.0  # nothing ran before the trigger
            for control in controls:
                control.allow_allreduce()
            for control in controls:
                assert control.result(timeout=60) is not None and control.began_allreduce
            for averager in averagers:
                assert _values(averager)[0].tolist() == [0.5] * 64
                bits = averager.get_group_bits()
                assert len(bits) == 2 and set(bits) <= {"0", "1"}
        finally:
            for averager in averagers:
                averager.shutdown()
            for dht in dhts:
                dht.shutdown()
