"""Hot-expert replication (the port of hivemind_tpu/moe/server/replication.py): the
control loop that turns one-server experts into replica sets, on the JAX package's
DHT keys and wire, so a port volunteer replicates a JAX server's expert and the
reverse.

- **Advertise** (every server with replication on): experts whose recent
  ServingLedger QPS or batch occupancy crosses the policy's thresholds, and whose
  DHT replica set is still below ``max_replicas``, are advertised under
  ``replica_wanted.<grid_root>`` (subkey = the expert's uid, value = the
  advertising server's ``peer|codec`` record, a short expiration).
- **Acquire** (servers with ``replica_slots > 0``): the watched grids' adverts are
  scanned; for the first wanted uid this server does not host (and whose replica
  set is still short), the expert's spec and ``state_dict`` blob stream over the
  donor's ``rpc_replica_state`` (digest-verified), a ModuleBackend is built from
  the layer registry on this server's device, registered live
  (``Server.add_backend``) and declared. One acquisition per tick.

A replica serves the donor's weights as they were at transfer. The spec carries no
``weight_quantization``, so a replica of an int8 expert serves dense fp32, as the
reference's does. Backward traffic trains whichever replica it reaches.

Besides the reference's metrics (``hivemind_moe_replication_*``), the manager keeps
``advertised`` (uid -> wall time of its first advert from this server) and
``acquisitions`` (one record per acquired replica: source, bytes, fetch and build
seconds, wall time of the declaration), which time the loop end to end.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from hivemind_tpu_torch.moe.expert_uid import UID_DELIMITER
from hivemind_tpu_torch.moe.server.dht_handler import make_expert_record, parse_expert_record, parse_expert_replicas
from hivemind_tpu_torch.moe.server.layers import name_to_block, name_to_input
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER
from hivemind_tpu_torch.utils import flax_msgpack
from hivemind_tpu_torch.utils.asyncio_utils import aiter_with_timeout, run_in_executor, spawn
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

REPLICA_WANTED_PREFIX = "replica_wanted."

_HOT_EXPERTS = _TELEMETRY.gauge(
    "hivemind_moe_replication_hot_experts",
    "locally served experts currently over the replication policy's QPS/occupancy thresholds",
)
_ADVERTS = _TELEMETRY.counter(
    "hivemind_moe_replication_adverts_total",
    "replica_wanted adverts stored for hot local experts",
)
_ACQUIRED = _TELEMETRY.counter(
    "hivemind_moe_replication_acquired_total",
    "expert replicas acquired over rpc_replica_state and registered live",
)


class ReplicationPolicy(NamedTuple):
    """When is an expert hot, and how far may it replicate."""

    qps_threshold: float = 4.0  # recent requests/s that make an expert hot
    occupancy_threshold: float = 0.5  # or: mean device-batch occupancy this hot
    max_replicas: int = 2  # replica-set ceiling (adverts stop here)
    period: float = 10.0  # control-loop cadence, seconds


def grid_root(uid: str) -> str:
    return uid.split(UID_DELIMITER, 1)[0]


def build_backend_from_spec(uid: str, spec: Dict[str, Any], blob: bytes,
                            device: Union[str, torch.device] = "cuda") -> ModuleBackend:
    """Rebuild a donor's expert from its replication spec and state blob on
    ``device``: the module from the layer registry, the weights from the verified
    blob (bit-equal to the donor's at transfer). Only the parameters move: the
    donor's optimizer state has whatever layout its optimizer chose, so the
    replica's Adam (optax's, 1e-3) starts fresh, as the reference's does."""
    from hivemind_tpu_torch.convert import from_flax_albert_params
    from hivemind_tpu_torch.moe.server.server import default_optimizer

    expert_cls = spec["expert_cls"]
    hidden_dim = int(spec["hidden_dim"])
    module = name_to_block[expert_cls](hidden_dim, **(spec.get("expert_kwargs") or {}))
    sample = name_to_input[expert_cls](4, hidden_dim)
    sample_kwargs = {"sample_inputs": sample} if isinstance(sample, tuple) else {"sample_input": sample}
    restored = flax_msgpack.msgpack_restore(blob)
    backend = ModuleBackend(uid, module, optimizer=default_optimizer, params=from_flax_albert_params(restored["params"]),
                            max_batch_size=int(spec.get("max_batch_size", 4096)), device=device, **sample_kwargs)
    backend.update_count = int(restored.get("updates", 0))
    backend.replication_spec = dict(spec)
    return backend


async def fetch_replica_state(p2p, source_peer_id, uid: str, chunk_timeout: float = 30.0):
    """Stream ``rpc_replica_state`` from the donor; returns ``(spec, blob)`` after
    the length and digest checks (a truncated or corrupt transfer builds no
    backend). ``chunk_timeout`` bounds each gap between two messages, not the
    whole transfer."""
    stream = p2p.iterate_protobuf_handler(
        source_peer_id, "ConnectionHandler.rpc_replica_state", runtime_pb2.ExpertUID(uid=uid),
        runtime_pb2.ExpertResponse,
    )
    meta: Optional[Dict] = None
    chunks: List[bytes] = []
    async for message in aiter_with_timeout(stream, chunk_timeout):
        if meta is None:
            meta = MSGPackSerializer.loads(message.metadata)
            continue
        chunks.extend(bytes(tensor.buffer) for tensor in message.tensors)
    if meta is None:
        raise ConnectionError(f"replica state stream for {uid!r} ended before metadata")
    blob = b"".join(chunks)
    if len(blob) != int(meta["total_bytes"]):
        raise ConnectionError(f"replica state for {uid!r} truncated: {len(blob)}/{meta['total_bytes']} bytes")
    if hashlib.blake2b(blob, digest_size=16).hexdigest() != meta["digest"]:
        raise ValueError(f"replica state for {uid!r} failed digest verification")
    return meta["spec"], blob


class ReplicationManager:
    """One per Server (started by ``Server._start`` when replication is on); runs
    on the server's loop."""

    def __init__(self, server, *, replica_slots: int = 0, policy: Optional[ReplicationPolicy] = None,
                 watch_grids: Optional[Sequence[str]] = None):
        self.server = server
        self.replica_slots = replica_slots
        self.policy = policy or ReplicationPolicy()
        self._explicit_watch = list(watch_grids) if watch_grids is not None else None
        self.acquired: List[str] = []
        self.advertised: Dict[str, float] = {}
        self.acquisitions: List[Dict[str, Any]] = []
        self._last_requests: Dict[str, float] = {}
        self._last_check: Optional[float] = None
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._task = spawn(self._loop(), name="replication.loop")

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def _loop(self) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning(f"replication tick failed: {e!r}")
            await asyncio.sleep(self.policy.period)

    def watched_grids(self) -> List[str]:
        if self._explicit_watch is not None:
            return self._explicit_watch
        return sorted({grid_root(uid) for uid in self.server.backends})

    # ------------------------------------------------------------ hot detection

    def hot_experts(self) -> List[str]:
        """Locally served experts over the policy's thresholds, judged on the
        ServingLedger: QPS as the request-count delta since the last tick, and the
        mean device-batch occupancy over the recent records."""
        stats = SERVING_LEDGER.expert_stats()
        now = time.monotonic()
        interval = (now - self._last_check) if self._last_check is not None else None
        self._last_check = now
        occupancy: Dict[str, List[float]] = {}
        for record in SERVING_LEDGER.records(limit=128):
            if "occupancy" in record:
                occupancy.setdefault(record["expert"], []).append(float(record["occupancy"]))
        hot = []
        for uid, entry in stats.items():
            if uid not in self.server.backends:
                continue
            requests = float(entry.get("requests", 0))
            previous = self._last_requests.get(uid, requests if interval is None else 0.0)
            self._last_requests[uid] = requests
            if interval is None or interval <= 0:
                continue
            qps = max(requests - previous, 0.0) / interval
            mean_occupancy = sum(occupancy[uid]) / len(occupancy[uid]) if occupancy.get(uid) else 0.0
            if qps >= self.policy.qps_threshold or (qps > 0 and mean_occupancy >= self.policy.occupancy_threshold):
                hot.append(uid)
        _HOT_EXPERTS.set(len(hot))
        return hot

    # ------------------------------------------------------------ control loop

    async def tick(self) -> None:
        hot = self.hot_experts()
        if hot:
            await self._advertise(hot)
        if self.replica_slots > len(self.acquired):
            await self._acquire_one()

    async def _on_dht(self, coro):
        return await asyncio.wrap_future(self.server.dht.run_coroutine(coro, return_future=True))

    async def _replica_counts(self, uids: Sequence[str]) -> Dict[str, int]:
        async def _count(_dht, node):
            found = await node.get_many(list(uids))
            return {uid: len(parse_expert_replicas(found[uid].value)) if found.get(uid) is not None else 0
                    for uid in uids}

        return await self._on_dht(_count)

    async def _advertise(self, hot: Sequence[str]) -> None:
        """Store replica_wanted adverts for hot experts still short of
        ``max_replicas`` (the DHT read doubles as the replica-count check)."""
        counts = await self._replica_counts(hot)
        wanted = [uid for uid in hot if counts.get(uid, 0) < self.policy.max_replicas]
        if not wanted:
            return
        record = make_expert_record(self.server.dht.peer_id.to_base58(), self.server.handler.activation_compression)
        expiration = get_dht_time() + self.policy.period * 3
        keys = [REPLICA_WANTED_PREFIX + grid_root(uid) for uid in wanted]

        async def _store(_dht, node):
            return await node.store_many(keys, [record] * len(wanted), [expiration] * len(wanted),
                                         subkeys=list(wanted))

        await self._on_dht(_store)
        _ADVERTS.inc(len(wanted))
        now = time.time()
        for uid in wanted:
            self.advertised.setdefault(uid, now)
        logger.info(f"advertised replica_wanted for hot experts: {wanted}")

    async def _acquire_one(self) -> None:
        """Scan the watched grids' adverts; acquire the first wanted expert this
        server does not host (one per tick: an acquisition moves weights)."""
        grids = self.watched_grids()
        if not grids:
            return

        async def _scan(_dht, node):
            found = await node.get_many([REPLICA_WANTED_PREFIX + grid for grid in grids])
            wanted = {}
            for entry in found.values():
                if entry is None or not isinstance(entry.value, dict):
                    continue
                for subkey, stored in entry.value.items():
                    parsed = parse_expert_record(getattr(stored, "value", stored))
                    if parsed is not None and isinstance(subkey, str):
                        wanted[subkey] = parsed
            return wanted

        wanted = await self._on_dht(_scan)
        candidates = {uid: source for uid, source in wanted.items()
                      if uid not in self.server.backends and source[0] != self.server.dht.peer_id}
        if not candidates:
            return
        counts = await self._replica_counts(sorted(candidates))
        for uid in sorted(candidates):
            if counts.get(uid, 0) >= self.policy.max_replicas:
                continue
            source_peer, _compression = candidates[uid]
            try:
                started = time.perf_counter()
                p2p = await self.server.dht.replicate_p2p()
                spec, blob = await fetch_replica_state(p2p, source_peer, uid)
                fetched = time.perf_counter()
                backend = await run_in_executor(build_backend_from_spec, uid, spec, blob, self.server.device)
                built = time.perf_counter()
            except Exception as e:
                logger.warning(f"could not acquire replica of {uid!r} from {source_peer}: {e!r}")
                continue
            await self.server.add_backend(uid, backend)
            self.acquired.append(uid)
            self.acquisitions.append(dict(uid=uid, source=source_peer.to_base58(), bytes=len(blob),
                                          fetch_s=fetched - started, build_s=built - fetched,
                                          declared_at=time.time()))
            _ACQUIRED.inc()
            logger.info(f"acquired replica of {uid!r} from {source_peer} ({len(blob)} state bytes, "
                        f"digest-verified); now serving + declared")
            return
