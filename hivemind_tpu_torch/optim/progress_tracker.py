"""Swarm-wide training progress accounting (the port of
hivemind_tpu/optim/progress_tracker.py; upstream: hivemind/optim/progress_tracker.py).

Every peer publishes LocalTrainingProgress (signed with its key) as a subkey of
``{run_id}_progress``; the tracker aggregates all records into GlobalTrainingProgress
and estimates when the swarm will finish the current virtual epoch. Epoch-based
accounting makes hyperparameters invariant to swarm size (upstream optimizer.py:63-69).
The records are plain dataclasses validated as the JAX package's pydantic models are
(``dht/schema.py``), and their msgpack bytes are the JAX package's."""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import math
import threading
from typing import Optional

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.dht.crypto import Ed25519SignatureValidator
from hivemind_tpu_torch.dht.schema import BytesWithEd25519PublicKey, Record, SchemaValidator, dict_of
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.loop import LoopRunner, get_loop_runner
from hivemind_tpu_torch.utils.performance_ema import PerformanceEMA
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

logger = get_logger(__name__)

# layer-4 telemetry. Hot path: report_local_progress runs
# once per optimizer step, so the label-less children are bound once here —
# each update is one lock + one float store.
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY

_G_LOCAL_EPOCH = _TELEMETRY.gauge(
    "hivemind_optim_local_epoch", "this peer's local epoch"
).labels()
_G_LOCAL_SAMPLES = _TELEMETRY.gauge(
    "hivemind_optim_local_samples_accumulated", "samples this peer accumulated toward the current epoch"
).labels()
_G_GLOBAL_EPOCH = _TELEMETRY.gauge(
    "hivemind_optim_global_epoch", "swarm-wide epoch (max over peers)"
).labels()
_G_GLOBAL_SAMPLES = _TELEMETRY.gauge(
    "hivemind_optim_global_samples_accumulated", "swarm-wide samples toward target_batch_size"
).labels()
_G_NUM_PEERS = _TELEMETRY.gauge(
    "hivemind_optim_num_peers", "peers reporting progress on this run"
).labels()
_G_SAMPLES_PER_SECOND = _TELEMETRY.gauge(
    "hivemind_optim_swarm_samples_per_second", "aggregate swarm throughput estimate"
).labels()


@dataclasses.dataclass
class LocalTrainingProgress(Record):
    peer_id: bytes
    epoch: int
    samples_accumulated: int
    samples_per_second: float
    time: float
    client_mode: bool

    def check(self) -> None:
        if self.epoch < 0 or self.samples_accumulated < 0:
            raise ValueError("epoch and samples_accumulated must be non-negative")
        if not (self.samples_per_second >= 0 and not math.isnan(self.samples_per_second)):
            raise ValueError("samples_per_second must be a non-negative number")


@dataclasses.dataclass
class GlobalTrainingProgress:
    global_epoch: int
    samples_accumulated: int
    target_batch_size: int
    num_peers: int
    num_clients: int
    eta_next_epoch: float
    next_fetch_time: float

    @property
    def ready_to_update_epoch(self) -> bool:
        return (
            self.samples_accumulated >= self.target_batch_size
            or get_dht_time() >= self.eta_next_epoch
        )


class ProgressTracker:
    """Publishes local progress and aggregates the swarm's; runs reporter + fetcher
    tasks on the shared event loop (upstream uses a thread,
    progress_tracker.py:44-363)."""

    def __init__(
        self,
        dht: DHT,
        prefix: str,
        target_batch_size: int,
        *,
        client_mode: bool = False,
        min_refresh_period: float = 0.5,
        max_refresh_period: float = 10.0,
        default_refresh_period: float = 3.0,
        expected_drift_peers: float = 3.0,
        expected_drift_rate: float = 0.2,
        performance_ema_alpha: float = 0.1,
        metadata_expiration: float = 60.0,
        private_key: Optional[Ed25519PrivateKey] = None,
        start: bool = True,
        loop_runner: Optional[LoopRunner] = None,
    ):
        self.dht, self.prefix = dht, prefix
        self.target_batch_size = target_batch_size
        self.client_mode = client_mode
        self.min_refresh_period, self.max_refresh_period = min_refresh_period, max_refresh_period
        self.default_refresh_period = default_refresh_period
        self.expected_drift_peers, self.expected_drift_rate = expected_drift_peers, expected_drift_rate
        self.metadata_expiration = metadata_expiration
        self.performance_ema = PerformanceEMA(alpha=performance_ema_alpha, paused=True)
        self._runner = loop_runner if loop_runner is not None else get_loop_runner()

        if private_key is None:
            # sign with THIS peer's transport identity (not the process-wide singleton:
            # several in-process peers would collide on one subkey)
            private_key = self._runner.run_coroutine(dht.replicate_p2p()).identity
        signature_validator = Ed25519SignatureValidator(private_key)
        progress_key_name = f"{prefix}_progress"
        schema = {progress_key_name: dict_of(BytesWithEd25519PublicKey, LocalTrainingProgress)}
        self.dht.add_validators([SchemaValidator(schema, allow_extra_keys=True), signature_validator])
        self._local_public_key = signature_validator.local_public_key
        self.progress_key = progress_key_name

        self.local_progress = LocalTrainingProgress(
            peer_id=dht.peer_id.to_bytes(),
            epoch=0,
            samples_accumulated=0,
            samples_per_second=0.0,
            time=get_dht_time(),
            client_mode=client_mode,
        )
        self.global_progress = GlobalTrainingProgress(
            global_epoch=0,
            samples_accumulated=0,
            target_batch_size=target_batch_size,
            num_peers=0,
            num_clients=0,
            eta_next_epoch=get_dht_time() + max_refresh_period,
            next_fetch_time=get_dht_time(),
        )
        self._lock = threading.Lock()
        self._report_event: Optional[asyncio.Event] = None
        self._fetch_soon: Optional[asyncio.Event] = None
        self._reporter_task = None
        self._fetcher_task = None
        self.shutdown_requested = False
        if start:
            self._runner.run_coroutine(self._start_tasks())

    async def _start_tasks(self) -> None:
        self._report_event = asyncio.Event()
        self._fetch_soon = asyncio.Event()
        self._reporter_task = spawn(self._reporter(), name="progress_tracker.reporter")
        self._fetcher_task = spawn(self._fetcher(), name="progress_tracker.fetcher")

    # ------------------------------------------------------------------ local side

    @property
    def global_epoch(self) -> int:
        return self.global_progress.global_epoch

    @property
    def ready_to_update_epoch(self) -> bool:
        # a peer whose swarm already advanced transitions ITSELF right away
        # (upstream progress_tracker.py:128-134) — without this clause, peers
        # that see a groupmate bump the epoch first would mistake the normal
        # lack of network synchrony for having fallen behind
        return (
            self.global_progress.global_epoch > self.local_progress.epoch
            or self.global_progress.ready_to_update_epoch
        )

    def report_local_progress(self, local_epoch: int, samples_accumulated: int, update_ema: bool = True) -> None:
        """Update the local record and wake the reporter
        (upstream progress_tracker.py:153-168)."""
        with self._lock:
            previous_local_samples = self.local_progress.samples_accumulated
            extra_samples = samples_accumulated - previous_local_samples
            if update_ema and extra_samples > 0:
                if self.performance_ema.paused:
                    self.performance_ema.paused = False
                    self.performance_ema.reset_timer()
                else:
                    self.performance_ema.update(extra_samples)
            self.local_progress = LocalTrainingProgress(
                peer_id=self.dht.peer_id.to_bytes(),
                epoch=local_epoch,
                samples_accumulated=samples_accumulated,
                samples_per_second=self.performance_ema.samples_per_second,
                time=get_dht_time(),
                client_mode=self.client_mode,
            )
        _G_LOCAL_EPOCH.set(local_epoch)
        _G_LOCAL_SAMPLES.set(samples_accumulated)
        self._wake_reporter()
        # our own progress may be what completes the epoch (always true for small
        # swarms): re-aggregate NOW instead of sleeping out the adaptive refresh —
        # otherwise a lone peer stalls for max_refresh_period after every report.
        # The snapshot already counts our PREVIOUS contribution, so subtract it,
        # or every tail-of-epoch report would re-wake the fetcher (a fetch storm).
        global_snapshot = self.global_progress
        if local_epoch != global_snapshot.global_epoch:
            # a straggler's samples are not part of the global sum (and ours were
            # not subtracted from it): the arithmetic below would either storm the
            # fetcher or never fire, so the early wake only applies when aligned
            return
        remote_samples = max(global_snapshot.samples_accumulated - previous_local_samples, 0)
        if not global_snapshot.ready_to_update_epoch and (
            samples_accumulated + remote_samples >= global_snapshot.target_batch_size
        ):
            self._wake_fetcher()

    def update_epoch(self, new_epoch: int) -> None:
        with self._lock:
            self.local_progress = self.local_progress.model_copy(
                update=dict(epoch=new_epoch, samples_accumulated=0, time=get_dht_time())
            )
            if new_epoch > self.global_progress.global_epoch:
                self.global_progress.global_epoch = new_epoch
                self.global_progress.samples_accumulated = 0
            self.global_progress.next_fetch_time = get_dht_time()
        self.performance_ema.paused = True
        self._wake_reporter()
        self._wake_fetcher()

    def _wake_reporter(self) -> None:
        if self._report_event is not None:
            self._runner.call_soon(self._report_event.set)

    def _wake_fetcher(self) -> None:
        if self._fetch_soon is not None:
            self._runner.call_soon(self._fetch_soon.set)

    # ------------------------------------------------------------------ tasks

    async def _reporter(self) -> None:
        """Store the local progress record whenever it changes (plus heartbeats)."""
        assert self._report_event is not None
        while not self.shutdown_requested:
            # clear BEFORE snapshotting: an update arriving mid-store must survive
            # into the next iteration, not be silently dropped
            self._report_event.clear()  # lint: single-writer — reporter clears its own wake event
            with contextlib.suppress(Exception):
                with self._lock:
                    record = self.local_progress
                await self.dht.node.store(
                    self.progress_key,
                    subkey=self._local_public_key,
                    value=record.model_dump(),
                    expiration_time=get_dht_time() + self.metadata_expiration,
                )
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._report_event.wait(), timeout=self.metadata_expiration / 2)

    async def _fetcher(self) -> None:
        """Aggregate everyone's records into GlobalTrainingProgress
        (upstream progress_tracker.py:231-273)."""
        while not self.shutdown_requested:
            assert self._fetch_soon is not None
            wait_time = max(0.0, self.global_progress.next_fetch_time - get_dht_time())
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._fetch_soon.wait(), timeout=wait_time)
            self._fetch_soon.clear()  # lint: single-writer — fetcher clears its own wake event
            with contextlib.suppress(Exception):
                await self._fetch_global_progress()

    async def _fetch_global_progress(self) -> None:
        response = await self.dht.node.get(self.progress_key, latest=True)
        records = []
        current_time = get_dht_time()
        if response is not None and isinstance(response.value, dict):
            for _subkey, entry in response.value.items():
                try:
                    record = LocalTrainingProgress.model_validate(entry.value)
                    if current_time - record.time <= self.metadata_expiration:
                        records.append(record)
                except Exception:
                    continue
        with self._lock:
            local = self.local_progress
        # the in-memory record is always fresher than the DHT's copy of ourselves
        # (the reporter may not have re-stored yet): never aggregate a stale self
        records = [r for r in records if r.peer_id != local.peer_id]
        records.append(local)

        global_epoch = max((r.epoch for r in records), default=local.epoch)
        samples = sum(r.samples_accumulated for r in records if r.epoch == global_epoch)
        samples_per_second = sum(r.samples_per_second for r in records if r.epoch == global_epoch) or 1e-9
        num_peers = len(records)
        num_clients = sum(r.client_mode for r in records)
        remaining = max(0, self.target_batch_size - samples)
        eta_seconds = remaining / samples_per_second
        # adaptive refresh: fetch more often as the epoch end approaches, accounting
        # for expected peer churn (upstream progress_tracker.py:321-331)
        drift = self.expected_drift_peers + self.expected_drift_rate * num_peers
        refresh = max(
            self.min_refresh_period,
            min(self.max_refresh_period, eta_seconds / max(drift, 1.0)),
        )
        with self._lock:
            self.global_progress = GlobalTrainingProgress(
                global_epoch=global_epoch,
                samples_accumulated=samples,
                target_batch_size=self.target_batch_size,
                num_peers=num_peers,
                num_clients=num_clients,
                eta_next_epoch=get_dht_time() + eta_seconds,
                next_fetch_time=get_dht_time() + refresh,
            )
        _G_GLOBAL_EPOCH.set(global_epoch)
        _G_GLOBAL_SAMPLES.set(samples)
        _G_NUM_PEERS.set(num_peers)
        _G_SAMPLES_PER_SECOND.set(samples_per_second)

    async def fetch_global_progress_now(self) -> GlobalTrainingProgress:
        await self._fetch_global_progress()
        return self.global_progress

    def shutdown(self, timeout: float = 2.0) -> None:
        self.shutdown_requested = True
        self._wake_reporter()
        self._wake_fetcher()

        async def _cancel():
            for task in (self._reporter_task, self._fetcher_task):
                if task is not None:
                    task.cancel()

        with contextlib.suppress(Exception):
            self._runner.run_coroutine(_cancel(), return_future=True).result(timeout)
