"""DecentralizedAverager: iteratively average tensors with random groups of peers
(the port of hivemind_tpu/averaging/averager.py; upstream: hivemind/averaging/averager.py).

The averager is an asyncio component on the port's shared loop thread. It takes
torch tensors on any device (a CUDA tensor is copied to the host once) or numpy
arrays, and holds numpy host mirrors of them under a threading lock, in their own
dtype (bfloat16 as float32): the reduction runs in numpy on the host, in the JAX
package's operations and order, so lossless rounds are byte-identical across the two
packages. ``get_tensors()`` yields the mirrors as CPU torch tensors that share their
memory (``torch.from_numpy``): a caller copies results to the card with ``.to(device)``
and writes new values with ``.copy_()``. ``step()`` is the sync entrypoint; it returns a
StepControl whose two-phase trigger lets callers pre-schedule matchmaking before
gradients are ready (upstream averager.py:367-419 + control.py)."""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import hashlib
import os
import threading
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from hivemind_tpu_torch.averaging.allreduce import AllReduceRunner, AveragingMode
from hivemind_tpu_torch.averaging.control import AveragingStage, StepControl
from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.averaging.key_manager import GroupKeyManager
from hivemind_tpu_torch.averaging.load_balancing import load_balance_peers
from hivemind_tpu_torch.averaging.matchmaking import Matchmaking, MatchmakingException
from hivemind_tpu_torch.averaging.partition import DEFAULT_PART_SIZE_BYTES, AllreduceException, host_array
from hivemind_tpu_torch.averaging.residual import ResidualStore
from hivemind_tpu_torch.averaging.wire_codec import (
    WIRE_TIERS,
    LinkCodecPolicy,
    WireLink,
    make_advert,
    negotiate_link,
    parse_advert,
    publish_link_gauges,
    tier_of_codec,
)
from hivemind_tpu_torch.averaging.state_sync import (
    STATE_CHUNK_BYTES,
    STATE_SYNC_BYTES_SENT as _STATE_SYNC_BYTES_SENT,
    StateDownloadResult,
    build_state_manifest,
    download_state_verified,
)
from hivemind_tpu_torch.compression import (
    CompressionBase,
    NoCompression,
    serialize_tensor,
    split_tensor_for_streaming,
)
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.p2p import P2P, P2PContext, PeerID, ServicerBase
from hivemind_tpu_torch.proto import averaging_pb2
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.resilience import Deadline, RetryPolicy
from hivemind_tpu_torch.utils.asyncio_utils import anext_safe, enter_asynchronously
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.loop import LoopRunner, get_loop_runner
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

logger = get_logger(__name__)

GatheredData = Dict[PeerID, Any]

# layer-3 telemetry: internal errors
# this module used to swallow silently, now logged AND counted by site
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span

_AVERAGER_INTERNAL_ERRORS = _TELEMETRY.counter(
    "hivemind_averaging_internal_errors_total",
    "errors in averager plumbing that do not fail a step",
    ("site",),
)

# retry pacing for failed averaging attempts: base 1.6 with equal jitter yields
# exactly the historical U(0.8, 1.6) window multiplier, but through the shared
# policy (resilience/policy.py) so the backoff shape is declared, not hand-rolled
_STEP_RETRY = RetryPolicy(
    max_attempts=None, base_delay=1.6, backoff=1.0, jitter="equal", name="averager_step"
)


class DecentralizedAverager(ServicerBase):
    """See module docstring.

    :param averaged_tensors: tensors (torch on any device, or numpy) whose values will
        be averaged; the averager keeps dtype-preserving numpy mirrors (bfloat16 as
        float32), accessible as CPU torch tensors via get_tensors()
    :param dht: a running DHT instance for matchmaking and state declaration
    :param prefix: swarm-unique namespace; peers with the same prefix average together
    """

    _class_handle_name = "DecentralizedAverager"  # all subclasses share the wire name

    def __init__(
        self,
        averaged_tensors: Sequence,
        dht: DHT,
        *,
        prefix: str,
        start: bool = False,
        target_group_size: Optional[int] = None,
        min_group_size: int = 2,
        initial_group_bits: str = "",
        min_matchmaking_time: float = 5.0,
        request_timeout: float = 3.0,
        allreduce_timeout: Optional[float] = None,
        sender_timeout: float = 30.0,
        reducer_timeout: float = 60.0,
        compression: CompressionBase = NoCompression(),
        part_size_bytes: int = DEFAULT_PART_SIZE_BYTES,
        wire_tiers: Optional[Sequence[str]] = None,
        adaptive_link_codec: bool = False,
        link_policy: Optional[LinkCodecPolicy] = None,
        bandwidth: Optional[float] = None,
        client_mode: bool = False,
        auxiliary: bool = False,
        allow_state_sharing: Optional[bool] = None,
        state_compression: Optional[CompressionBase] = None,
        declare_state_period: float = 30.0,
        shutdown_timeout: float = 5.0,
        blackbox_dir: Optional[Any] = None,
        loop_runner: Optional[LoopRunner] = None,
    ):
        assert "." not in prefix, "prefix may not contain '.'"
        self.dht = dht
        if blackbox_dir is not None:
            # crash-durable flight recorder: arm the
            # process-wide spool before the first round; idempotent per directory
            from hivemind_tpu_torch.telemetry.blackbox import arm_blackbox

            arm_blackbox(blackbox_dir, peer=str(dht.peer_id))
        self.prefix = prefix
        self.client_mode, self.auxiliary = client_mode, auxiliary
        self.mode = (
            AveragingMode.CLIENT if client_mode else AveragingMode.AUX if auxiliary else AveragingMode.NODE
        )
        self.target_group_size, self.min_group_size = target_group_size, min_group_size
        self.min_matchmaking_time = min_matchmaking_time
        self.request_timeout, self.allreduce_timeout = request_timeout, allreduce_timeout
        self.sender_timeout, self.reducer_timeout = sender_timeout, reducer_timeout
        self.compression, self.part_size_bytes = compression, part_size_bytes
        self.state_compression = state_compression if state_compression is not None else compression
        # per-link wire-codec negotiation: advertise the tiers we
        # support + our default (= the configured codec's tier) in every
        # matchmaking gather blob. A configured codec outside the tier ladder
        # (meanstd/quantile) disables negotiation — links use it as-is.
        self._wire_tier = tier_of_codec(self.compression)
        tiers = tuple(wire_tiers) if wire_tiers is not None else WIRE_TIERS
        if self._wire_tier is not None and self._wire_tier not in tiers:
            tiers = (*tiers, self._wire_tier)
        self._wire_tiers = tuple(t for t in tiers if t in WIRE_TIERS)
        self._wire_residuals = ResidualStore()
        if link_policy is not None:
            self._link_policy: Optional[LinkCodecPolicy] = link_policy
            if self._link_policy.default_tier is None:
                self._link_policy.default_tier = self._wire_tier
        else:
            self._link_policy = (
                LinkCodecPolicy(default_tier=self._wire_tier)
                if adaptive_link_codec and self._wire_tier is not None
                else None
            )
        self.bandwidth = bandwidth if bandwidth is not None else (0.0 if client_mode else 1.0e8)
        self.declare_state_period = declare_state_period
        self.shutdown_timeout = shutdown_timeout

        self._averaged_tensors: List[np.ndarray] = [np.array(host_array(t), copy=True) for t in averaged_tensors]
        self.lock_averaged_tensors = threading.Lock()
        self._allow_state_sharing = (
            allow_state_sharing if allow_state_sharing is not None else not (client_mode or auxiliary)
        )
        self._state_sharing_priority = 0.0

        self.schema_hash = self._compute_schema_hash()
        self._runner = loop_runner if loop_runner is not None else get_loop_runner()
        self._running_allreduces: Dict[bytes, AllReduceRunner] = {}
        self._allreduce_registered = asyncio.Condition()  # created lazily on loop? see _setup
        self._ready = threading.Event()
        self._shutdown = False
        self.matchmaking: Optional[Matchmaking] = None
        self.key_manager: Optional[GroupKeyManager] = None
        self._declare_state_task: Optional[asyncio.Task] = None
        # the steps in flight on the loop: shutdown cancels them, else a step that finds no
        # group (its DHT gone) keeps looking, on a loop other averagers and tests share
        self._running_steps: Set[concurrent.futures.Future] = set()
        self.initial_group_bits = initial_group_bits

        if start:
            self.run_in_background(await_ready=True)

    # ------------------------------------------------------------------ lifecycle

    def run_in_background(self, await_ready: bool = True, timeout: Optional[float] = None) -> None:
        future = self._runner.run_coroutine(self._setup(), return_future=True)
        if await_ready:
            future.result(timeout)

    async def _setup(self) -> None:
        if self._ready.is_set():
            return
        # the shared loop carries every RPC/matchmaking/allreduce await of this
        # peer: arm the stall watchdog before any of them can run (idempotent —
        # the DHT usually armed it already)
        from hivemind_tpu_torch.telemetry.watchdog import ensure_watchdog

        ensure_watchdog(asyncio.get_event_loop())
        self.p2p: P2P = await self.dht.replicate_p2p()
        self.peer_id: PeerID = self.p2p.peer_id
        self._allreduce_registered = asyncio.Condition()
        self.key_manager = GroupKeyManager(
            self.dht, self.prefix, self.initial_group_bits, self.target_group_size
        )
        self.matchmaking = Matchmaking(
            self.p2p,
            self.key_manager,
            self._get_peer_stub,
            schema_hash=self.schema_hash,
            target_group_size=self.target_group_size,
            min_group_size=self.min_group_size,
            min_matchmaking_time=self.min_matchmaking_time,
            request_timeout=self.request_timeout,
            client_mode=self.client_mode,
        )
        await self.add_p2p_handlers(self.p2p, namespace=self.prefix)
        if self._allow_state_sharing:
            self._declare_state_task = spawn(self._declare_for_download_periodically(), name="averager.declare_state")
        # opportunistic: never gates readiness (fire-and-forget task)
        self._warmup_task = spawn(self._warm_data_path(), name="averager.warmup")
        self._ready.set()

    async def _warm_data_path(self) -> None:
        """Spin up the lazy machinery the first all-reduce round would otherwise pay
        for inside its measured window: executor threads, the AEAD worker pool and
        cipher context, numpy's allocator, and protobuf serialization. Runs in the
        background; failures are cosmetic (the round would just warm things itself)."""
        try:
            import concurrent.futures

            # the channel's own resolved cipher binding (wheel or libcrypto shim),
            # so the warmup heats the implementation SecureChannel actually uses
            from hivemind_tpu_torch.p2p.crypto_channel import ChaCha20Poly1305, _get_aead_executor
            from hivemind_tpu_torch.utils.asyncio_utils import _blocking_executor

            def _touch() -> None:
                block = np.zeros(1 << 16, np.float32)
                serialize_tensor(block.astype(np.float32, copy=False), self.compression)

            warm_futures = [_blocking_executor.submit(_touch) for _ in range(4)]
            aead_executor = _get_aead_executor()
            if aead_executor is not None:
                aead = ChaCha20Poly1305(bytes(32))
                warm_futures += [
                    aead_executor.submit(aead.encrypt, bytes(12), b"\x00" * (1 << 17), None)
                    for _ in range(2)
                ]
            await asyncio.get_event_loop().run_in_executor(
                None, concurrent.futures.wait, warm_futures, 2.0
            )
        except Exception as e:
            logger.debug(f"data-path warmup skipped: {e!r}")

    @property
    def is_alive(self) -> bool:
        return self._ready.is_set() and not self._shutdown

    @property
    def allow_state_sharing(self) -> bool:
        return self._allow_state_sharing

    @allow_state_sharing.setter
    def allow_state_sharing(self, value: bool) -> None:
        self._allow_state_sharing = value
        if value and self._ready.is_set() and not self._shutdown:
            # the declare loop may never have been started (e.g. sharing was off at
            # construction); without it peers can never discover our state
            async def _ensure_declare_task():
                if self._declare_state_task is None or self._declare_state_task.done():
                    self._declare_state_task = spawn(
                        self._declare_for_download_periodically(), name="averager.declare_state"
                    )

            self._runner.run_coroutine(_ensure_declare_task(), return_future=True)

    @property
    def state_sharing_priority(self) -> float:
        return self._state_sharing_priority

    @state_sharing_priority.setter
    def state_sharing_priority(self, value: float) -> None:
        self._state_sharing_priority = value

    def shutdown(self) -> None:
        if self._shutdown or not self._ready.is_set():
            self._shutdown = True
            return
        self._shutdown = True
        for running in list(self._running_steps):
            running.cancel()  # its StepControl is cancelled with it (_step)

        async def _teardown():
            if self._declare_state_task is not None:
                self._declare_state_task.cancel()
                await self._retract_state_declaration()
            warmup_task = getattr(self, "_warmup_task", None)
            if warmup_task is not None:
                warmup_task.cancel()
            with contextlib.suppress(Exception):
                await self.remove_p2p_handlers(self.p2p, namespace=self.prefix)

        coro = _teardown()
        try:
            future = self._runner.run_coroutine(coro, return_future=True)
        except Exception as e:
            # the loop is already gone (interpreter teardown / runner shut down):
            # shutdown still succeeds, but say so — a silent pass here hid real
            # teardown bugs
            logger.warning(f"averager teardown could not be scheduled: {e!r}")
            _AVERAGER_INTERNAL_ERRORS.inc(site="shutdown_schedule")
            coro.close()  # never scheduled: release the un-awaited coroutine cleanly
        else:
            try:
                future.result(self.shutdown_timeout)
            except Exception as e:
                logger.warning(f"averager teardown did not finish cleanly: {e!r}")
                _AVERAGER_INTERNAL_ERRORS.inc(site="shutdown_teardown")

    def __enter__(self):
        if not self._ready.is_set():
            self.run_in_background(await_ready=True)
        return self

    def __exit__(self, *args):
        self.shutdown()

    def __del__(self):
        with contextlib.suppress(Exception):
            if self.is_alive:
                self.shutdown()

    # ------------------------------------------------------------------ tensors

    @contextlib.contextmanager
    def get_tensors(self):
        """Host-side access to the averaged tensors (lock-guarded, upstream
        averager.py:564-572): CPU torch tensors that share the mirrors' memory, so an
        in-place write (``.copy_()``) changes what the next round averages."""
        with self.lock_averaged_tensors:
            yield [torch.from_numpy(t) for t in self._averaged_tensors]

    def _compute_schema_hash(self) -> str:
        # the mirrors' numpy dtype names ("float32", never "torch.float32"), as the JAX
        # package hashes its own mirrors: the two packages' peers must match groups
        schema = [[list(t.shape), str(t.dtype)] for t in self._averaged_tensors]
        payload = MSGPackSerializer.dumps([schema, type(self.compression).__name__, "v1"])
        return hashlib.sha256(payload).hexdigest()[:32]

    def _suggested_lead(self) -> float:
        """Adaptive matchmaking lead time: when the caller does not
        pin a scheduled_time, use the matchmaking layer's observed declare→fill
        latency + failure backoff instead of the raw ``min_matchmaking_time``."""
        if self.matchmaking is not None:
            return self.matchmaking.suggested_lead_time()
        return self.min_matchmaking_time

    def _get_peer_stub(self, peer_id: PeerID):
        return type(self).get_stub(self.p2p, peer_id, namespace=self.prefix)

    # ------------------------------------------------------------------ stepping

    def step(
        self,
        gather: Any = None,
        *,
        weight: Optional[float] = None,
        scheduled_time: Optional[DHTExpiration] = None,
        timeout: Optional[float] = None,
        allow_retries: bool = True,
        require_trigger: bool = False,
        wait: bool = True,
    ) -> Union[Optional[GatheredData], StepControl]:
        """Try to average tensors with a group of peers.

        :param gather: opaque metadata exchanged with groupmates (returned as a dict)
        :param require_trigger: two-phase mode — matchmaking may start now, but the
            all-reduce waits for control.allow_allreduce()
        :param wait: block and return gathered data; else return the StepControl
        """
        if self.mode == AveragingMode.AUX and weight is not None and weight != 0:
            logger.warning("auxiliary peers always have weight 0; ignoring")
            weight = 0.0
        weight = weight if weight is not None else float(self.mode != AveragingMode.AUX)
        now = get_dht_time()
        control = StepControl(
            scheduled_time=scheduled_time if scheduled_time is not None else now + self._suggested_lead(),
            deadline=now + timeout if timeout is not None else None,
            allow_retries=allow_retries,
            weight=weight,
            data_for_gather=MSGPackSerializer.dumps(
                [self.bandwidth, self.mode.value, gather, self._wire_advert()]
            ),
        )
        if not require_trigger:
            control.allow_allreduce()
        running = self._runner.run_coroutine(self._step(control), return_future=True)
        self._running_steps.add(running)
        running.add_done_callback(self._running_steps.discard)
        return control.result(timeout) if wait else control

    async def _step(self, control: StepControl) -> None:
        try:
            while not control.done():
                try:
                    control.stage = AveragingStage.LOOKING_FOR_GROUP
                    assert self.matchmaking is not None
                    group_info = await self.matchmaking.look_for_group(
                        data_for_gather=control.data_for_gather,
                        scheduled_time=control.scheduled_time,
                        timeout=control.get_timeout(),
                    )
                    if control.cancelled:
                        return
                    if group_info is None:
                        raise MatchmakingException("could not find a group this attempt")
                    control.stage = AveragingStage.AWAITING_TRIGGER
                    await control.wait_for_trigger()
                    if control.cancelled:
                        return
                    control.began_allreduce = True
                    control.stage = AveragingStage.RUNNING_ALLREDUCE
                    gathered = await self._aggregate_with_group(group_info, control.weight)
                    control.set_result(gathered)
                    return
                except (
                    MatchmakingException,
                    AllreduceException,
                    AssertionError,
                    asyncio.TimeoutError,
                    ConnectionError,
                ) as e:
                    deadline_passed = control.deadline is not None and get_dht_time() >= control.deadline
                    if not control.allow_retries or deadline_passed:
                        logger.info(f"averaging step failed: {e!r}")
                        control.set_exception(e)
                        return
                    logger.debug(f"averaging attempt failed: {e!r}; retrying")
                    # fresh matchmaking window with jitter: symmetric failures would
                    # otherwise re-synchronize and livelock (everyone re-declares the
                    # same deadline and nobody becomes anyone's leader)
                    control.reset_for_retry(
                        get_dht_time() + self._suggested_lead() * _STEP_RETRY.delay(0)
                    )
        except asyncio.CancelledError:
            control.cancel()
            raise
        except Exception as e:
            control.set_exception(e)

    def _wire_advert(self) -> Optional[Dict[str, Any]]:
        """The codec advert riding this peer's matchmaking gather blob — the
        zero-extra-round-trip negotiation channel (every groupmate sees every
        advert at BEGIN_ALLREDUCE, mirroring the serving path's ``peer|codec``
        DHT records). Carries the straggler policy's current demotions."""
        if self._wire_tier is None:
            return None
        demotions: Dict[str, str] = {}
        if self._link_policy is not None:
            try:
                local = str(self.peer_id) if hasattr(self, "peer_id") else None
                demotions = self._link_policy.refresh(exclude=(local,) if local else ())
            except Exception as e:
                logger.warning(f"link-codec policy refresh failed: {e!r}")
                _AVERAGER_INTERNAL_ERRORS.inc(site="link_policy")
        return make_advert(self._wire_tiers, self._wire_tier, demotions)

    def _decode_gathered(self, group_info: GroupInfo):
        """(bandwidths, modes, user_gathered, adverts) from the gather blobs.
        Slot 3 — the wire-codec advert — is optional and tolerant
        (``parse_advert`` maps anything malformed to None: that peer's links
        just fall back to the configured codec); slots 0-2 are load-bearing
        and a blob without them fails the round, exactly as before."""
        bandwidths, modes, user_gathered = [], [], {}
        adverts: Dict[PeerID, Optional[Dict[str, Any]]] = {}
        for peer_id, blob in zip(group_info.peer_ids, group_info.gathered):
            decoded = MSGPackSerializer.loads(blob)
            peer_bandwidth, peer_mode, user_data = decoded[0], decoded[1], decoded[2]
            bandwidths.append(float(peer_bandwidth))
            modes.append(AveragingMode(peer_mode))
            user_gathered[peer_id] = user_data
            adverts[peer_id] = parse_advert(decoded[3]) if len(decoded) > 3 else None
        return bandwidths, modes, user_gathered, adverts

    def _negotiate_links(
        self, group_info: GroupInfo, adverts: Dict[PeerID, Optional[Dict[str, Any]]]
    ) -> Optional[Dict[int, WireLink]]:
        """Resolve the wire link for every groupmate from the gathered adverts.
        Symmetric by construction: both endpoints evaluate the same pure
        function over the same two adverts (ours is read back from the gather,
        i.e. exactly what the remote saw). Returns None when negotiation is
        disabled or nobody advertised — the byte-identical legacy path."""
        if self._wire_tier is None:
            return None
        local_advert = adverts.get(self.peer_id)
        if local_advert is None:
            return None
        links: Dict[int, WireLink] = {}
        tiers_by_remote: Dict[str, str] = {}
        for index, peer_id in enumerate(group_info.peer_ids):
            if peer_id == self.peer_id:
                continue
            tier = negotiate_link(local_advert, adverts.get(peer_id), str(self.peer_id), str(peer_id))
            if tier is None:
                continue
            links[index] = WireLink.for_tier(tier)
            tiers_by_remote[str(peer_id)] = tier
        if not links:
            return None
        publish_link_gauges(tiers_by_remote)
        from hivemind_tpu_torch.telemetry.tracing import current_span

        span = current_span()
        if span is not None:
            for remote, tier in tiers_by_remote.items():
                if tier != self._wire_tier:  # only negotiated-away links are events
                    span.add_event("link_codec", remote=remote, tier=tier)
        return links

    async def _pre_allreduce(self) -> None:
        """Hook: refresh the host tensor mirrors just before an all-reduce round.
        An averager of a multi-card tier stages the device-resident state here; the
        default host-resident averager needs nothing."""

    async def _post_allreduce(self) -> None:
        """Hook: propagate the averaged host mirrors after a round (a multi-card tier
        scatters them back to its devices)."""

    async def _aggregate_with_group(self, group_info: GroupInfo, weight: float) -> GatheredData:
        """Decode gathered metadata, balance load, run the all-reduce, apply deltas
        (upstream averager.py:514-562)."""
        with _tracing_span(
            "averaging.aggregate",
            peer=str(self.peer_id),
            group_size=len(group_info.peer_ids),
        ):
            return await self._aggregate_with_group_traced(group_info, weight)

    async def _aggregate_with_group_traced(self, group_info: GroupInfo, weight: float) -> GatheredData:
        bandwidths, modes, user_gathered, adverts = self._decode_gathered(group_info)
        await self._pre_allreduce()

        with self.lock_averaged_tensors:
            total_elements = sum(int(np.prod(t.shape)) for t in self._averaged_tensors)
        reducer_bandwidths = [
            bandwidth if mode != AveragingMode.CLIENT else 0.0
            for bandwidth, mode in zip(bandwidths, modes)
        ]
        peer_element_counts = load_balance_peers(total_elements, reducer_bandwidths)

        if _CHAOS.enabled:  # injection point: die between matchmaking and the round
            await _CHAOS.inject("allreduce.setup", scope=str(self.peer_id))
        links = self._negotiate_links(group_info, adverts)
        runner = self._make_allreduce_runner(group_info, peer_element_counts, modes, weight, links=links)
        async with self._allreduce_registered:
            self._running_allreduces[group_info.group_id] = runner  # lint: single-writer — holds _allreduce_registered's lock
            self._allreduce_registered.notify_all()
        try:
            iterator = runner.run()
            if self.allreduce_timeout is not None:
                from hivemind_tpu_torch.utils.asyncio_utils import aiter_with_timeout

                iterator = aiter_with_timeout(iterator, self.allreduce_timeout)
            index = 0
            async for delta in iterator:
                await self._apply_delta(index, delta)
                index += 1
            if runner.container is not None and runner.container.failed_size:
                logger.warning(
                    f"allreduce degraded: {runner.container.failed_size}/{runner.container.total_elements} "
                    f"elements kept local values (failed reducers)"
                )
            await self._post_allreduce()
            return user_gathered
        finally:
            self._running_allreduces.pop(group_info.group_id, None)

    async def _run_manual_allreduce(
        self,
        group_info: GroupInfo,
        tensors: List[np.ndarray],
        *,
        group_id_suffix: bytes,
        modes: Sequence[AveragingMode],
        bandwidths: Sequence[float],
        weight: float,
    ) -> List[np.ndarray]:
        """One all-reduce over arbitrary tensors within an already-matched group —
        the building block for multi-phase schemes like PowerSGD (which chains two
        rounds per group, upstream power_sgd_averager.py:117-178). Returns the
        averaged tensors (inputs are not mutated)."""
        group_id = group_info.group_id + group_id_suffix
        total_elements = sum(int(np.prod(t.shape)) for t in tensors)
        reducer_bandwidths = [
            bandwidth if mode != AveragingMode.CLIENT else 0.0
            for bandwidth, mode in zip(bandwidths, modes)
        ]
        peer_element_counts = load_balance_peers(total_elements, reducer_bandwidths)
        runner = AllReduceRunner(
            p2p=self.p2p,
            group_id=group_id,
            tensors=tensors,
            ordered_peer_ids=group_info.peer_ids,
            peer_element_counts=peer_element_counts,
            modes=modes,
            get_stub=self._get_peer_stub,
            weight=weight,
            compression=self.compression,
            part_size_bytes=self.part_size_bytes,
            sender_timeout=self.sender_timeout,
            reducer_timeout=self.reducer_timeout,
        )
        async with self._allreduce_registered:
            self._running_allreduces[group_id] = runner  # lint: single-writer — holds _allreduce_registered's lock
            self._allreduce_registered.notify_all()
        try:
            averaged = [np.array(t, dtype=np.float32, copy=True) for t in tensors]
            index = 0
            async for delta in runner.run():
                averaged[index] += delta.reshape(averaged[index].shape)
                index += 1
            return averaged
        finally:
            self._running_allreduces.pop(group_id, None)

    def _make_allreduce_runner(
        self,
        group_info: GroupInfo,
        peer_element_counts: Sequence[int],
        modes: Sequence[AveragingMode],
        weight: float,
        links: Optional[Dict[int, WireLink]] = None,
    ) -> AllReduceRunner:
        """Overridable factory — the designed-in fault-injection seam (upstream's
        tests override the equivalent to inject mid-stream failures, SURVEY §4)."""
        return AllReduceRunner(
            p2p=self.p2p,
            group_id=group_info.group_id,
            tensors=self._snapshot_tensors(),
            ordered_peer_ids=group_info.peer_ids,
            peer_element_counts=peer_element_counts,
            modes=modes,
            get_stub=self._get_peer_stub,
            weight=weight,
            compression=self.compression,
            part_size_bytes=self.part_size_bytes,
            sender_timeout=self.sender_timeout,
            reducer_timeout=self.reducer_timeout,
            links=links,
            residuals=self._wire_residuals,
        )

    def _snapshot_tensors(self) -> List[np.ndarray]:
        with self.lock_averaged_tensors:
            return [t.copy() for t in self._averaged_tensors]

    async def _apply_delta(self, index: int, delta: np.ndarray) -> None:
        async with enter_asynchronously(self.lock_averaged_tensors):
            tensor = self._averaged_tensors[index]
            tensor += delta.astype(tensor.dtype, copy=False)

    # ------------------------------------------------------------------ RPCs

    async def rpc_join_group(
        self, request: averaging_pb2.JoinRequest, context: P2PContext
    ) -> AsyncIterator[averaging_pb2.MessageFromLeader]:
        assert self.matchmaking is not None
        async for message in self.matchmaking.rpc_join_group(request, context):
            yield message

    async def rpc_aggregate_part(
        self, requests: AsyncIterator[averaging_pb2.AveragingData], context: P2PContext
    ) -> AsyncIterator[averaging_pb2.AveragingData]:
        """Route one sender's part stream to the matching allreduce runner; tolerates
        the sender arriving before our own group registration (the race at upstream
        averager.py:585-590)."""
        first = await anext_safe(requests.__aiter__() if hasattr(requests, "__aiter__") else requests)
        if not isinstance(first, averaging_pb2.AveragingData):
            return
        runner = await self._find_runner(first.group_id)
        if runner is None:
            yield averaging_pb2.AveragingData(code=averaging_pb2.PROTOCOL_VIOLATION)
            return
        async for message in runner.handle_aggregate_stream(first, requests, context):
            yield message

    async def _find_runner(self, group_id: bytes, timeout: Optional[float] = None) -> Optional[AllReduceRunner]:
        budget = Deadline(timeout if timeout is not None else self.request_timeout * 2)
        async with self._allreduce_registered:
            while group_id not in self._running_allreduces:
                try:
                    await budget.wait_for(self._allreduce_registered.wait())
                except asyncio.TimeoutError:  # includes DeadlineExceeded
                    return None
            return self._running_allreduces[group_id]

    # ------------------------------------------------------------------ state sharing

    async def _get_current_state(self) -> Tuple[Any, List[np.ndarray]]:
        """Overridable: the state downloadable by joining peers. Default: no metadata,
        the averaged tensors (upstream get_current_state)."""
        return None, self._snapshot_tensors()

    # serialized-state snapshots are shared across concurrent downloads for this
    # long: striping probes + two stripe streams pay ONE serialize+digest pass,
    # and the manifest always matches the exact bytes streamed
    state_snapshot_ttl: float = 1.0

    async def _serialized_state_snapshot(self):
        """(metadata_blob, serialized tensors, manifest), built at most once per
        TTL window. Concurrent callers (striping probes + stripe streams + other
        joiners) await ONE shared task instead of each running their own full
        serialize+digest pass — otherwise N concurrent downloads would hold N
        serialized state copies in donor memory. The expiry is anchored at pass
        COMPLETION (a multi-GB pass takes seconds; anchoring at the start would
        publish an already-expired cache), and the pass runs in an executor so
        the event loop keeps serving matchmaking/allreduce meanwhile."""
        entry = getattr(self, "_state_snapshot_entry", None)
        if entry is not None:
            task, expiry_box = entry
            if not task.done():
                reusable = True  # join the in-flight pass
            elif task.cancelled() or task.exception() is not None:
                reusable = False  # failed pass: rebuild for this caller
            else:
                reusable = expiry_box[0] is not None and time.monotonic() < expiry_box[0]
            if reusable:
                return await task
        expiry_box: List[Optional[float]] = [None]
        task = asyncio.get_event_loop().create_task(self._build_state_snapshot(expiry_box))
        self._state_snapshot_entry = (task, expiry_box)
        return await task

    async def _build_state_snapshot(self, expiry_box):
        metadata, tensors = await self._get_current_state()
        metadata_blob = MSGPackSerializer.dumps(metadata)
        epoch = int(metadata["epoch"]) if isinstance(metadata, dict) and "epoch" in metadata else 0

        def _serialize_and_digest():
            serialized = [serialize_tensor(tensor, self.state_compression) for tensor in tensors]
            manifest = build_state_manifest(
                serialized, schema_hash=self.schema_hash, epoch=epoch, metadata=metadata_blob
            )
            return serialized, manifest

        loop = asyncio.get_event_loop()
        serialized, manifest = await loop.run_in_executor(None, _serialize_and_digest)
        expiry_box[0] = time.monotonic() + self.state_snapshot_ttl

        # the cache must not pin a full serialized state copy forever: drop the
        # entry shortly after its TTL unless a newer snapshot replaced it
        def _drop_if_expired():
            current = getattr(self, "_state_snapshot_entry", None)
            if (
                current is not None
                and current[1][0] is not None
                and time.monotonic() >= current[1][0]
            ):
                self._state_snapshot_entry = None

        loop.call_later(self.state_snapshot_ttl + 0.1, _drop_if_expired)
        return metadata_blob, serialized, manifest

    async def rpc_download_state(
        self, request: averaging_pb2.DownloadRequest, context: P2PContext
    ) -> AsyncIterator[averaging_pb2.DownloadData]:
        """Manifest-first state stream (upstream averager.py:628-651, hardened per
        the port keeps it): the first message carries a :class:`StateManifest` — schema
        fingerprint, donor epoch, per-tensor length + digest — so the receiver can
        verify every tensor as it lands, resume across donors, and distinguish
        "sharing disabled" from a truncated stream. ``request.have_tensors`` names
        already-verified tensors the receiver does not need again."""
        if not self._allow_state_sharing:
            # explicit refusal: a clean "no" must never look like a dead donor
            yield averaging_pb2.DownloadData(
                manifest=averaging_pb2.StateManifest(state_unavailable=True)
            )
            return
        metadata_blob, serialized, manifest = await self._serialized_state_snapshot()
        # legacy ``metadata`` field kept alongside the manifest for old readers
        yield averaging_pb2.DownloadData(manifest=manifest, metadata=metadata_blob)
        if request.manifest_only:
            return
        have = set(request.have_tensors)
        donor_scope = str(self.peer_id)
        for index, tensor in enumerate(serialized):
            if index in have:
                continue
            for chunk in split_tensor_for_streaming(tensor, STATE_CHUNK_BYTES):
                if _CHAOS.enabled:  # injection point: donor dies / corrupts mid-stream
                    payload = chunk.buffer
                    injected = await _CHAOS.inject(
                        "state.download.send", payload=payload, scope=donor_scope
                    )
                    if injected is not payload:
                        chunk.buffer = injected
                _STATE_SYNC_BYTES_SENT.inc(len(chunk.buffer))
                yield averaging_pb2.DownloadData(tensor_part=chunk, tensor_index=index)

    @classmethod
    async def _download_verified_async(
        cls,
        dht: DHT,
        p2p: P2P,
        prefix: str,
        *,
        exclude_peer_id: Optional[PeerID] = None,
        timeout: Optional[float] = None,
        expected_tensors: Optional[int] = None,
        schema_hash: Optional[str] = None,
        min_epoch: Optional[int] = None,
    ) -> Optional[StateDownloadResult]:
        """Verified, resumable, optionally striped state download from the donors
        declared under ``{prefix}.all_averagers`` (state_sync.py).
        Classmethod on purpose: peers that do not yet KNOW the tensor schema
        (auxiliary helpers) can bootstrap it from the swarm before constructing
        their averager (upstream aux peers are schema-free)."""

        def _count_donor_failure(donor, exc) -> None:
            # a swarm where EVERY donor fails must be visible —
            # each failed attempt is counted (state_sync already logs a warning).
            # Clean protocol answers (sharing disabled / stale epoch) are not
            # errors and carry their own dedicated counters.
            from hivemind_tpu_torch.averaging.state_sync import StaleDonor, StateUnavailable

            if not isinstance(exc, (StaleDonor, StateUnavailable)):
                _AVERAGER_INTERNAL_ERRORS.inc(site="state_download")

        result = await download_state_verified(
            dht, p2p, prefix, cls.get_stub,
            exclude_peer_id=exclude_peer_id,
            timeout=timeout,
            expected_tensors=expected_tensors,
            schema_hash=schema_hash,
            min_epoch=min_epoch,
            on_donor_failure=_count_donor_failure,
        )
        if result is None:
            logger.warning(f"could not download state for {prefix!r} from any peer")
            return None
        logger.info(
            f"downloaded state for {prefix!r} from {result.donors} at epoch {result.epoch} "
            f"({'digest-verified' if result.verified else 'UNVERIFIED legacy stream'}, "
            f"{result.bytes_received} bytes)"
        )
        return result

    @classmethod
    async def _download_state_async(
        cls,
        dht: DHT,
        p2p: P2P,
        prefix: str,
        *,
        exclude_peer_id: Optional[PeerID] = None,
        timeout: Optional[float] = None,
        expected_tensors: Optional[int] = None,
    ) -> Optional[Tuple[Any, List[np.ndarray]]]:
        """(metadata, tensors) view of :meth:`_download_verified_async` — the
        schema-free entry point used by aux bootstrap and old call sites."""
        result = await cls._download_verified_async(
            dht, p2p, prefix, exclude_peer_id=exclude_peer_id, timeout=timeout,
            expected_tensors=expected_tensors,
        )
        return None if result is None else (result.metadata, result.tensors)

    async def _load_state_from_peers_async(
        self, timeout: Optional[float] = None, min_epoch: Optional[int] = None
    ) -> Optional[StateDownloadResult]:
        # an averager KNOWS its schema: donors serving a different tensor count
        # (truncated mid-download or mismatched run) are rejected at the manifest,
        # and stale donors (epoch < min_epoch) are skipped before any bytes move.
        # The manifest's schema fingerprint is NOT pinned here: it embeds the
        # donor's codec, and heterogeneous-but-compatible donors (e.g. an aux
        # NoCompression donor feeding a Float16 state averager) are a designed
        # pattern — integrity comes from the per-tensor digests + tensor count.
        with self.get_tensors() as tensors:
            expected = len(tensors)
        return await type(self)._download_verified_async(
            self.dht, self.p2p, self.prefix, exclude_peer_id=self.peer_id, timeout=timeout,
            expected_tensors=expected, min_epoch=min_epoch,
        )

    def load_state_from_peers(self, timeout: Optional[float] = None, wait: bool = True):
        """Fetch (metadata, tensors) from the best-priority peer sharing state; the
        tensors are CPU torch tensors, every one digest-verified against the donor's
        manifest (a legacy donor's stream is unverified and counted)."""

        async def _tuple_view():
            result = await self._load_state_from_peers_async(timeout)
            return None if result is None else (result.metadata, result.tensors)

        future = self._runner.run_coroutine(_tuple_view(), return_future=True)
        return future.result(timeout) if wait else future

    @classmethod
    def download_state_from_swarm(
        cls, dht: DHT, prefix: str, timeout: Optional[float] = None, wait: bool = True
    ):
        """Schema-free state download: no averager instance required (used by aux
        peers to learn the gradient schema before joining)."""

        async def _run(_dht, _node):
            p2p = await _dht.replicate_p2p()
            return await cls._download_state_async(_dht, p2p, prefix, timeout=timeout)

        future = dht.run_coroutine(_run, return_future=True)
        return future.result(timeout) if wait else future

    async def _declare_for_download_periodically(self) -> None:
        key = f"{self.prefix}.all_averagers"
        while True:
            if self._allow_state_sharing:
                try:
                    expiration = get_dht_time() + self.declare_state_period * 2
                    await self.dht.node.store(
                        key,
                        value=self._state_sharing_priority,
                        expiration_time=expiration,
                        subkey=self.peer_id.to_base58(),
                    )
                    # remembered so shutdown can retract with a FRESHER record
                    # (per-subkey stores are newest-expiration-wins; an older
                    # tombstone would simply be ignored)
                    self._declared_state_expiration = expiration
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # failing to declare is survivable (peers just cannot download
                    # state from us until the next period) but must be counted
                    logger.warning(f"could not declare state under {key!r}: {e!r}")
                    _AVERAGER_INTERNAL_ERRORS.inc(site="declare_state")
            await asyncio.sleep(self.declare_state_period)

    async def _retract_state_declaration(self) -> None:
        """A cleanly-departing donor overwrites its
        ``{prefix}.all_averagers`` record with a ``None`` tombstone, so joiners
        stop spending a dial + timeout on a peer that is provably gone. The DHT
        refuses past-expiration and older-than-existing stores, so the tombstone
        must be *fresher* than the last declaration; readers filter ``None``."""
        declared = getattr(self, "_declared_state_expiration", None)
        if declared is None:
            return
        try:
            # strictly fresher than ANY declaration the loop could have issued —
            # including one still in flight when the task was cancelled, whose
            # expiration (its now + 2*period) exceeds the last RECORDED one
            tombstone_expiration = get_dht_time() + self.declare_state_period * 2 + 1.0
            await asyncio.wait_for(
                self.dht.node.store(
                    f"{self.prefix}.all_averagers",
                    value=None,
                    expiration_time=max(tombstone_expiration, declared + 1.0),
                    subkey=self.peer_id.to_base58(),
                ),
                timeout=max(0.5, self.shutdown_timeout / 2),
            )
        except Exception as e:
            # best-effort: joiners fall back to the dial-timeout path they
            # always had — but a chronically failing retract should be visible
            logger.warning(f"could not retract state declaration: {e!r}")
            _AVERAGER_INTERNAL_ERRORS.inc(site="state_retract")

    def get_group_bits(self) -> str:
        assert self.key_manager is not None
        return self.key_manager.group_bits

    def set_group_bits(self, bits: str) -> None:
        assert self.key_manager is not None
        self.key_manager.group_bits = bits

    def __repr__(self):
        return f"{type(self).__name__}(prefix={self.prefix!r}, mode={self.mode.name}, alive={self.is_alive})"
