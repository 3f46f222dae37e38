"""The expert server (the port of hivemind_tpu/moe/server/server.py).

Owns a DHT peer, the ModuleBackends, the batching Runtime, the RPC handler, a
periodic expert-declaration task and, when asked, a CheckpointSaver and a
ReplicationManager, all asyncio components on the port's loop thread in the one
process that owns the card. Clients find the experts through the DHT records it
declares (``dht_handler.declare_experts``), in the JAX package's format, so JAX
clients resolve and call a port server and the reverse.

- ``checkpoint_dir``: ``create`` restores each expert's ``checkpoint_last.flax``
  (either package's), and a CheckpointSaver stores them all every 300 s.
- ``replicate_hot_experts``: advertise this server's hot experts for replication;
  ``replica_slots``: acquire up to that many hot experts of other servers (a
  replica-only volunteer starts with none). See ``replication.py``."""

from __future__ import annotations

import asyncio
import contextlib
import random
import re
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import torch

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe.expert_uid import UID_DELIMITER, is_valid_uid
from hivemind_tpu_torch.moe.server.checkpoints import CheckpointSaver, load_experts
from hivemind_tpu_torch.moe.server.connection_handler import ConnectionHandler
from hivemind_tpu_torch.moe.server.dht_handler import declare_experts, get_experts
from hivemind_tpu_torch.moe.server.layers import name_to_block, name_to_input
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.replication import ReplicationManager, ReplicationPolicy
from hivemind_tpu_torch.moe.server.runtime import Runtime
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.device import resolve_device
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.loop import LoopRunner, get_loop_runner
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def default_optimizer(params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """Adam at learning rate 1e-3, as ``optax.adam(1e-3)``: betas (0.9, 0.999), eps
    1e-8 added to the bias-corrected root of the second moment, both moments
    bias-corrected."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


class Server:
    """Create with ``Server(dht, backends)`` or ``Server.create(...)``; call
    ``.run_in_background()`` and ``.shutdown()``.

    :param device: where replicas acquired at runtime are built; defaults to the
        device of the first backend, else ``"cuda"``
    """

    def __init__(
        self,
        dht: DHT,
        backends: Dict[str, ModuleBackend],
        *,
        update_period: float = 30.0,
        checkpoint_dir: Optional[Path] = None,
        decode_max_len: int = 256,
        decode_max_sessions: int = 64,
        max_queue_size: int = 1024,
        activation_compression: str = "float16",
        client_rate: Optional[float] = None,
        client_burst: Optional[float] = None,
        replica_slots: int = 0,
        replicate_hot_experts: bool = False,
        replication_policy: Optional[ReplicationPolicy] = None,
        replication_watch_grids: Optional[Sequence[str]] = None,
        device: Union[str, torch.device, None] = None,
        loop_runner: Optional[LoopRunner] = None,
    ):
        self.dht, self.backends = dht, backends
        self.update_period = update_period
        self.handler = ConnectionHandler(
            backends, decode_max_len=decode_max_len, decode_max_sessions=decode_max_sessions,
            max_queue_size=max_queue_size, activation_compression=activation_compression,
            client_rate=client_rate, client_burst=client_burst,
        )
        self.runtime = Runtime(self.handler.all_pools())
        if device is None and backends:
            device = next(iter(backends.values())).device
        self.device = resolve_device(device)
        self.checkpoint_saver = CheckpointSaver(backends, checkpoint_dir) if checkpoint_dir is not None else None
        self.replication: Optional[ReplicationManager] = None
        if replicate_hot_experts or replica_slots > 0:
            self.replication = ReplicationManager(self, replica_slots=replica_slots, policy=replication_policy,
                                                  watch_grids=replication_watch_grids)
        self._runner = loop_runner if loop_runner is not None else get_loop_runner()
        self._declare_task: Optional[asyncio.Task] = None
        self._ready = threading.Event()

    @classmethod
    def create(
        cls,
        *,
        num_experts: Optional[int] = None,
        expert_uids: Optional[Sequence[str]] = None,
        expert_pattern: Optional[str] = None,
        expert_cls: str = "ffn",
        hidden_dim: int = 1024,
        expert_kwargs: Optional[dict] = None,
        optim_factory: Optional[OptimizerFactory] = None,
        max_batch_size: int = 4096,
        initial_peers: Sequence[str] = (),
        dht: Optional[DHT] = None,
        checkpoint_dir: Optional[Path] = None,
        decode_max_len: int = 256,
        decode_max_sessions: int = 64,
        max_queue_size: int = 1024,
        activation_compression: str = "float16",
        client_rate: Optional[float] = None,
        client_burst: Optional[float] = None,
        replica_slots: int = 0,
        replicate_hot_experts: bool = False,
        replication_policy: Optional[ReplicationPolicy] = None,
        replication_watch_grids: Optional[Sequence[str]] = None,
        device: Union[str, torch.device] = "cuda",
        start: bool = False,
        **backend_kwargs,
    ) -> "Server":
        """Build a server with experts from the layer registry on ``device`` (``"cuda"``
        unless the caller asks for the CPU); UIDs are either given or sampled from
        ``expert_pattern`` (e.g. 'ffn.[0:256].[0:256]') and deduplicated against the DHT;
        with ``replica_slots`` and neither, the server starts with no experts.

        ``optim_factory`` builds each expert's optimizer over its parameter tensors
        (default: :func:`default_optimizer`, Adam at 1e-3). ``expert_kwargs`` are
        forwarded to the expert class, e.g. ``expert_cls='llama_block',
        expert_kwargs={'num_kv_heads': 2}`` serves grouped-query Llama blocks."""
        device = resolve_device(device)  # before anything starts: no card, no server
        if dht is None:
            dht = DHT(initial_peers=initial_peers, start=True)
        if expert_uids is None:
            if num_experts is None and replica_slots > 0:
                expert_uids = []  # a replica-only volunteer: starts empty, acquires hot experts
            elif num_experts is None:
                raise ValueError("provide either expert_uids or num_experts")
            else:
                expert_uids = _generate_uids(num_experts, expert_pattern or f"expert.[0:{2**30}]", dht)
        optim_factory = optim_factory or default_optimizer

        backends = {}
        for uid in expert_uids:
            module = name_to_block[expert_cls](hidden_dim, **(expert_kwargs or {}))
            sample = name_to_input[expert_cls](4, hidden_dim)
            # multi-tensor experts (e.g. det_dropout) declare a tuple of inputs
            sample_kwargs = {"sample_inputs": sample} if isinstance(sample, tuple) else {"sample_input": sample}
            backends[uid] = ModuleBackend(uid, module, optimizer=optim_factory, max_batch_size=max_batch_size,
                                          device=device, **sample_kwargs, **backend_kwargs)
            # a registry-built expert replicates over rpc_replica_state: the spec lets
            # an acquiring server rebuild the module before it loads the state blob
            backends[uid].replication_spec = {"expert_cls": expert_cls, "hidden_dim": hidden_dim,
                                              "expert_kwargs": dict(expert_kwargs or {}),
                                              "max_batch_size": max_batch_size}
        if checkpoint_dir is not None:
            loaded = load_experts(backends, checkpoint_dir)
            if loaded:
                logger.info(f"restored {loaded} experts from {checkpoint_dir}")
        server = cls(dht, backends, checkpoint_dir=checkpoint_dir, decode_max_len=decode_max_len,
                     decode_max_sessions=decode_max_sessions, max_queue_size=max_queue_size,
                     activation_compression=activation_compression, client_rate=client_rate,
                     client_burst=client_burst, replica_slots=replica_slots,
                     replicate_hot_experts=replicate_hot_experts, replication_policy=replication_policy,
                     replication_watch_grids=replication_watch_grids, device=device)
        if start:
            server.run_in_background(await_ready=True)
        return server

    # ------------------------------------------------------------------ lifecycle

    def run_in_background(self, await_ready: bool = True, timeout: Optional[float] = None) -> None:
        future = self._runner.run_coroutine(self._start(), return_future=True)
        if await_ready:
            future.result(timeout)

    async def _start(self) -> None:
        # a stalled loop stops expert RPC dispatch AND batch draining at once:
        # arm the watchdog with the server (idempotent; the DHT shares the loop)
        from hivemind_tpu_torch.telemetry.watchdog import ensure_watchdog

        ensure_watchdog(asyncio.get_event_loop())
        await self.handler.add_p2p_handlers(await self.dht.replicate_p2p())
        self.runtime.start()
        if self.checkpoint_saver is not None:
            self.checkpoint_saver.start()
        if self.replication is not None:
            self.replication.start()
        self._declare_task = spawn(self._declare_periodically(), name="server.declare_periodically")
        self._ready.set()

    async def add_backend(self, uid: str, backend: ModuleBackend) -> None:
        """Serve an expert acquired at runtime (replication): the handler's pools,
        the Runtime, and a declaration at once, so clients resolve the grown
        replica set without waiting a full update period. Runs on the server's
        loop."""
        for pool in self.handler.add_backend(uid, backend):
            self.runtime.add_pool(pool)
        declare_experts(self.dht, [uid], expiration_time=get_dht_time() + self.update_period * 3, wait=False,
                        compression=self.handler.activation_compression)

    async def _declare_periodically(self) -> None:
        while True:
            with contextlib.suppress(Exception):
                declare_experts(
                    self.dht, list(self.backends.keys()),
                    expiration_time=get_dht_time() + self.update_period * 3,
                    wait=False,
                    # the declaration carries the wire dtype, so clients learn
                    # the negotiated codec from discovery alone
                    compression=self.handler.activation_compression,
                )
            await asyncio.sleep(self.update_period)

    def shutdown(self) -> None:
        async def _stop():
            if self._declare_task is not None:
                self._declare_task.cancel()
            if self.replication is not None:
                self.replication.shutdown()
            if self.checkpoint_saver is not None:
                self.checkpoint_saver.shutdown()
            await self.runtime.shutdown()
            with contextlib.suppress(Exception):
                await self.handler.remove_p2p_handlers(await self.dht.replicate_p2p())

        with contextlib.suppress(Exception):
            self._runner.run_coroutine(_stop(), return_future=True).result(5.0)

    def __enter__(self):
        if not self._ready.is_set():
            self.run_in_background(await_ready=True)
        return self

    def __exit__(self, *args):
        self.shutdown()


def _generate_uids(num_experts: int, expert_pattern: str, dht: DHT, attempts_per_expert: int = 10) -> List[str]:
    """Sample unique UIDs matching 'prefix.[0:N].[0:M]'-style patterns, skipping UIDs
    already claimed in the DHT."""

    def sample_uid() -> str:
        out = []
        for block in expert_pattern.split(UID_DELIMITER):
            match = re.fullmatch(r"\[(\d+):(\d+)\]", block)
            out.append(str(random.randint(int(match.group(1)), int(match.group(2)) - 1)) if match else block)
        return UID_DELIMITER.join(out)

    chosen: List[str] = []
    attempts = 0
    while len(chosen) < num_experts and attempts < num_experts * attempts_per_expert:
        attempts += 1
        candidates = list({sample_uid() for _ in range(num_experts - len(chosen))} - set(chosen))
        if not candidates:
            continue
        existing = get_experts(dht, candidates)
        for uid, info in zip(candidates, existing):
            if info is None and is_valid_uid(uid):
                chosen.append(uid)
    if len(chosen) < num_experts:
        raise RuntimeError(f"could only allocate {len(chosen)}/{num_experts} unique uids for {expert_pattern!r}")
    return chosen[:num_experts]


@contextlib.contextmanager
def background_server(**kwargs):
    """Spin up a server for tests and benchmarks; yields (dht, server)."""
    server = Server.create(start=True, **kwargs)
    try:
        yield server.dht, server
    finally:
        server.shutdown()
        server.dht.shutdown()
