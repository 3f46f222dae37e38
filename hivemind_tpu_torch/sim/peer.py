"""One lightweight simulated peer: real logic layers, descriptor-stubbed compute.

A :class:`SimPeer` owns a :class:`~hivemind_tpu_torch.sim.network.SimP2P` transport
face and runs the **real** :class:`~hivemind_tpu_torch.dht.node.DHTNode` (routing,
storage, validation, blacklist breakers) on it. Optional layers bolt on the
real implementations too: matchmaking runs the actual
:class:`~hivemind_tpu_torch.averaging.matchmaking.Matchmaking` +
:class:`~hivemind_tpu_torch.averaging.key_manager.GroupKeyManager` state machines
(the schema hash is computed from :class:`TensorDescriptor` placeholders the
same way the averager computes it from live tensors — no arrays are ever
allocated), and expert declarations ride the real
``moe.server.dht_handler.declare_experts`` prefix encoding so
:class:`~hivemind_tpu_torch.moe.client.beam_search.MoEBeamSearcher` searches real
records. What never runs in the sim: tensor math, all-reduce data planes,
expert forward/backward — compute stays a descriptor.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
from typing import AsyncIterator, Optional, Sequence, Tuple

from hivemind_tpu_torch.averaging.key_manager import GroupKeyManager
from hivemind_tpu_torch.averaging.matchmaking import Matchmaking
from hivemind_tpu_torch.dht.node import DHTNode
from hivemind_tpu_torch.dht.routing import DHTID
from hivemind_tpu_torch.p2p import P2PContext, PeerID
from hivemind_tpu_torch.p2p.servicer import ServicerBase
from hivemind_tpu_torch.proto import averaging_pb2
from hivemind_tpu_torch.sim.network import SimNetwork, SimP2P
from hivemind_tpu_torch.telemetry.tracing import trace
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.tensor_descr import TensorDescriptor

logger = get_logger(__name__)

DEFAULT_SIM_DESCRIPTORS = (TensorDescriptor(shape=(1024, 1024)), TensorDescriptor(shape=(1024,)))


def descriptor_schema_hash(descriptors: Sequence[TensorDescriptor]) -> str:
    """The same schema fingerprint DecentralizedAverager computes from live
    tensors (averager.py ``_compute_schema_hash``), derived from descriptors
    alone — sim peers with matching descriptors would interoperate with real
    averagers of the same schema."""
    schema = [[list(d.shape), str(d.dtype)] for d in descriptors]
    payload = MSGPackSerializer.dumps([schema, "NoCompression", "v1"])
    return hashlib.sha256(payload).hexdigest()[:32]


class SimDHT:
    """The thin slice of the :class:`~hivemind_tpu_torch.dht.dht.DHT` facade that
    GroupKeyManager / declare_experts / beam search touch. Everything already
    runs on the sim loop, so ``run_coroutine`` schedules a task instead of
    bridging threads — callers inside the sim must pass ``return_future=True``
    (``wait=False`` at the declare_experts level) and await it."""

    def __init__(self, node: DHTNode):
        self.node = node

    @property
    def peer_id(self) -> PeerID:
        return self.node.peer_id

    def run_coroutine(self, coro, return_future: bool = False):
        task = asyncio.get_event_loop().create_task(coro(self, self.node))
        if return_future:
            return task
        raise RuntimeError(
            "SimDHT.run_coroutine cannot block inside the sim loop; "
            "call with return_future=True (declare_experts/get_experts: wait=False) and await the result"
        )

    async def replicate_p2p(self):
        return self.node.p2p


class _SimAveragerService(ServicerBase):
    """Bridges rpc_join_group onto the peer's Matchmaking instance — the same
    delegation DecentralizedAverager does, minus the data plane."""

    def __init__(self, matchmaking: Matchmaking):
        self._matchmaking = matchmaking

    async def rpc_join_group(
        self, request: averaging_pb2.JoinRequest, context: P2PContext
    ) -> AsyncIterator[averaging_pb2.MessageFromLeader]:
        async for message in self._matchmaking.rpc_join_group(request, context):
            yield message


class SimPeer:
    """A DHT participant in the simulated swarm; create with ``await SimPeer.create(...)``."""

    def __init__(self):
        raise RuntimeError("use `await SimPeer.create(...)`")

    @classmethod
    async def create(
        cls,
        network: SimNetwork,
        name: str,
        region: str = "default",
        *,
        bootstrap: Sequence[str] = (),
        **dht_kwargs,
    ) -> "SimPeer":
        self = object.__new__(cls)
        self.network = network
        self.name = name
        self.region = region
        self.p2p: SimP2P = network.spawn(name, region)
        node_id = DHTID.generate(source=f"{network.seed}|node|{name}".encode())
        self.node = await DHTNode.create(
            p2p=self.p2p,
            node_id=node_id,
            initial_peers=list(bootstrap),
            **dht_kwargs,
        )
        self.dht = SimDHT(self.node)
        self.matchmaking: Optional[Matchmaking] = None
        self._service: Optional[_SimAveragerService] = None
        return self

    @property
    def peer_id(self) -> PeerID:
        return self.p2p.peer_id

    def bootstrap_maddrs(self) -> Tuple[str, ...]:
        return (str(self.p2p.maddr),)

    # ------------------------------------------------------------------ matchmaking

    async def enable_matchmaking(
        self,
        prefix: str = "sim_averager",
        *,
        target_group_size: Optional[int] = 4,
        min_group_size: int = 2,
        min_matchmaking_time: float = 5.0,
        request_timeout: float = 3.0,
        initial_group_bits: str = "",
        descriptors: Sequence[TensorDescriptor] = DEFAULT_SIM_DESCRIPTORS,
    ) -> None:
        """Attach the real matchmaking state machine (leader + follower sides)
        over descriptor-stubbed tensors."""
        key_manager = GroupKeyManager(
            self.dht, prefix, initial_group_bits=initial_group_bits, target_group_size=target_group_size
        )
        self.matchmaking = Matchmaking(
            self.p2p,
            key_manager,
            get_stub=lambda peer_id: _SimAveragerService.get_stub(self.p2p, peer_id),
            schema_hash=descriptor_schema_hash(descriptors),
            target_group_size=target_group_size,
            min_group_size=min_group_size,
            min_matchmaking_time=min_matchmaking_time,
            request_timeout=request_timeout,
        )
        self._service = _SimAveragerService(self.matchmaking)
        await self._service.add_p2p_handlers(self.p2p)

    async def look_for_group(self, *, timeout: Optional[float] = None):
        assert self.matchmaking is not None, "call enable_matchmaking() first"
        return await self.matchmaking.look_for_group(data_for_gather=b"", timeout=timeout)

    async def simulate_allreduce_round(
        self,
        group,
        *,
        descriptors: Sequence[TensorDescriptor] = DEFAULT_SIM_DESCRIPTORS,
        reduce_throughput: float = 2e9,
    ) -> None:
        """Synthesize one butterfly all-reduce round as REAL telemetry spans
       : an ``allreduce.round`` span wrapping ``local_reduce`` plus
        one ``peer_exchange`` per partner, with durations derived from the
        seeded :class:`~hivemind_tpu_torch.sim.network.LinkMatrix` — so the round
        ledger and the black-box spool see the same span shapes a live
        averager emits, in virtual time, bit-identically per seed. No tensor
        math runs: the sleeps ARE the data plane here.
        """
        peer_ids = list(group.peer_ids)
        # rank by canonical member order, NOT leader order: the leader shuffles
        # with an os.urandom group id (real protocol, deliberately unseeded),
        # and same-seed sim runs must spool bit-identical ledger records
        canonical = sorted(peer_ids, key=str)
        rank = canonical.index(self.peer_id) if self.peer_id in canonical else -1
        total_bytes = sum(d.nbytes for d in descriptors)
        # butterfly all-reduce: each peer owns 1/group_size of the vector and
        # exchanges its part with every partner
        part_bytes = total_bytes / max(1, len(peer_ids))

        async def _exchange(remote_id: PeerID) -> None:
            remote = self.network.get_peer(remote_id)
            remote_name = remote.name if remote is not None else str(remote_id)
            remote_region = remote.region if remote is not None else self.region
            spec = self.network.links.spec(self.name, remote_name, self.region, remote_region)
            with trace("allreduce.peer_exchange", peer=self.name, remote=remote_name):
                await asyncio.sleep(spec.delay + part_bytes / spec.bandwidth)

        with trace(
            "allreduce.round", peer=self.name, group_size=len(peer_ids), rank=rank
        ):
            with trace("allreduce.local_reduce", peer=self.name):
                await asyncio.sleep(total_bytes / reduce_throughput)
            remotes = [pid for pid in peer_ids if pid != self.peer_id]
            # sequential, not gathered: the task-interleave order of concurrent
            # sleeps would depend on sibling peers sharing the loop, and the
            # ledger's late-exchange path is already exercised by live tests.
            # Virtual time makes the sequential walk free.
            for remote_id in remotes:
                await _exchange(remote_id)

    # ------------------------------------------------------------------ lifecycle

    def crash(self) -> None:
        """Die without cleanup: declarations dangle, peers discover the corpse
        through failed RPCs and their blacklists — exactly like a killed
        process. Background tasks are cancelled (a dead process runs nothing)."""
        self.network.kill(self.p2p)
        if self.node._refresh_task is not None:
            self.node._refresh_task.cancel()
        for task in list(self.node.protocol._handoff_tasks):
            task.cancel()

    async def shutdown(self) -> None:
        with contextlib.suppress(Exception):
            await self.node.shutdown()
        await self.p2p.shutdown()

    def __repr__(self):
        return f"<SimPeer {self.name} region={self.region}>"
