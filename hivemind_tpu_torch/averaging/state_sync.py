"""Verified, resumable, striped state downloads (the port of
hivemind_tpu/averaging/state_sync.py).

The paper's fault-tolerance story rests on newcomers bootstrapping model and
optimizer state from the swarm (upstream averager.py:628-651). The original
port of that path trusted the network completely: no integrity check on the
payload, a whole-transfer restart when a donor died mid-stream, and no
freshness validation on the donor's epoch. This module is the hardened
receiver side of the manifest-first protocol:

- **Manifest-first.** Every ``rpc_download_state`` stream begins with a
  :class:`averaging_pb2.StateManifest`: the donor's schema fingerprint, epoch,
  per-tensor byte length + blake2b-16 digest, and an explicit
  ``state_unavailable`` marker so "sharing disabled" can never be mistaken for
  a truncated stream.
- **Verified.** Each tensor's digest is checked the moment its last byte
  lands; a corrupt tensor fails THAT donor, never the download — and a
  corrupted payload is never adopted.
- **Resumable.** Per-tensor completion is tracked in a :class:`StateAssembly`
  that outlives any one donor: failover re-requests only the missing tensors
  (``DownloadRequest.have_tensors``), so a donor dying after tensor 40 of 50
  costs 10 tensors, not 50.
- **Striped.** When several donors advertise bit-identical manifests, the
  missing tensors are split between up to ``max_stripes`` of them and
  downloaded concurrently (PAPERS: cross-replica sharding of weight updates) —
  large state syncs are no longer bottlenecked on one donor's uplink.
- **Bounded.** One :class:`~hivemind_tpu_torch.resilience.Deadline` governs the
  whole download; failover pacing between candidate sweeps comes from a shared
  :class:`~hivemind_tpu_torch.resilience.RetryPolicy`.

Chaos points ``state.download.send`` (donor side, per message, scoped by the
donor's peer id) and ``state.download.recv`` (receiver side, per message,
scoped by the donor's peer id) let the soak corrupt, drop, or stall the sync
path deterministically; the digests turn every injected corruption into a
counted failover instead of silently poisoned weights.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from hivemind_tpu_torch.compression import deserialize_tensor
from hivemind_tpu_torch.compression.serialization import _clone_tensor_metadata
from hivemind_tpu_torch.proto import averaging_pb2
from hivemind_tpu_torch.resilience import CHAOS as _CHAOS
from hivemind_tpu_torch.resilience import Deadline, RetryPolicy
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import current_span as _current_span
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

DIGEST_SIZE = 16  # blake2b-16: plenty for integrity, cheap on the wire
STATE_CHUNK_BYTES = 2**20
# striping is only worth two streams when there is real payload to split
MIN_STRIPE_BYTES = 4 * STATE_CHUNK_BYTES

_STATE_SYNC_BYTES = _TELEMETRY.counter(
    "hivemind_state_sync_bytes_total", "state-sync payload bytes by direction", ("direction",)
)
# cached child for the donor-side hot loop (one inc per streamed chunk)
STATE_SYNC_BYTES_SENT = _STATE_SYNC_BYTES.labels(direction="sent")
_STATE_SYNC_FAILOVERS = _TELEMETRY.counter(
    "hivemind_state_sync_failovers_total", "state downloads that moved on to another donor"
)
_STATE_SYNC_DIGEST_FAILURES = _TELEMETRY.counter(
    "hivemind_state_sync_digest_failures_total",
    "state payloads rejected by digest verification",
    ("site",),  # download | checkpoint
)
_STATE_SYNC_UNVERIFIED = _TELEMETRY.counter(
    "hivemind_state_sync_unverified_adoptions_total",
    "state adopted from a donor that sent no manifest (legacy stream, digests unavailable)",
)
_STATE_SYNC_STALE_DONORS = _TELEMETRY.counter(
    "hivemind_state_sync_stale_donors_total",
    "donors rejected because their manifest epoch was behind the required minimum",
)

# failover pacing BETWEEN candidate sweeps (within a sweep, moving to the next
# donor is immediate); unlimited attempts — the Deadline is the real bound
_FAILOVER_RETRY = RetryPolicy(
    max_attempts=None, base_delay=0.5, backoff=1.5, max_delay=5.0, jitter="full",
    name="state_sync_failover",
)


def payload_digest(payload) -> bytes:
    """blake2b-16 over one serialized tensor payload (the ``Tensor.buffer``)."""
    return hashlib.blake2b(bytes(payload), digest_size=DIGEST_SIZE).digest()


def build_state_manifest(
    serialized_tensors: Sequence,
    *,
    schema_hash: str,
    epoch: int,
    metadata: bytes = b"",
) -> averaging_pb2.StateManifest:
    """The donor-side manifest: one digest entry per serialized tensor."""
    manifest = averaging_pb2.StateManifest(
        schema_hash=schema_hash, epoch=max(0, int(epoch)), metadata=metadata
    )
    for serialized in serialized_tensors:
        manifest.tensors.add(
            num_bytes=len(serialized.buffer), digest=payload_digest(serialized.buffer)
        )
    return manifest


class StateSyncError(Exception):
    """Base for receiver-side protocol failures (always scoped to ONE donor)."""


class DigestMismatch(StateSyncError):
    """A tensor's bytes did not match its manifest digest: corruption in flight
    or a donor mutating state mid-stream. The tensor is discarded, never adopted."""


class ManifestMismatch(StateSyncError):
    """A donor's manifest disagrees with the one this download already pinned
    (different digests/epoch): it cannot contribute to the same assembly."""


class StaleDonor(StateSyncError):
    """The donor's manifest epoch is behind the receiver's required minimum."""


class StateUnavailable(StateSyncError):
    """The donor explicitly declared state sharing disabled (NOT a truncation)."""


@dataclass
class StateDownloadResult:
    metadata: Any
    tensors: List[torch.Tensor]  # CPU tensors, as the port's codecs decode them
    epoch: int = 0
    verified: bool = False  # every adopted tensor passed digest verification
    donors: List[str] = field(default_factory=list)
    bytes_received: int = 0


class _TensorSlot:
    """Reassembly buffer for one in-flight tensor."""

    __slots__ = ("head", "buffer")

    def __init__(self):
        self.head: Optional[object] = None  # first chunk proto (carries dtype/codec)
        self.buffer = bytearray()


class StateAssembly:
    """Cross-donor download state. The manifest is pinned by the first donor that
    provides one; every later donor must match it bit-for-bit, and per-tensor
    verification progress survives donor failover."""

    def __init__(
        self,
        *,
        schema_hash: Optional[str] = None,
        min_epoch: Optional[int] = None,
        expected_tensors: Optional[int] = None,
    ):
        self.schema_hash = schema_hash
        self.min_epoch = min_epoch
        self.expected_tensors = expected_tensors
        self.manifest: Optional[averaging_pb2.StateManifest] = None
        self.metadata: Any = None
        self.verified: Dict[int, torch.Tensor] = {}
        self.bytes_received = 0
        self.digest_failures = 0
        self.generation = 0  # bumped on every (re)pin — callers detect mid-stream repins
        self._slots: Dict[int, _TensorSlot] = {}

    # ---------------------------------------------------------------- manifest

    def pin_manifest(
        self, manifest: averaging_pb2.StateManifest, donor: str, allow_repin: bool = True
    ) -> None:
        """Validate a donor's manifest and adopt it (first donor) or compare it to
        the pinned one. A failover donor whose (valid) manifest diverges — normal
        in a live swarm, donors keep training between rounds — RESETS the assembly
        to its manifest (``allow_repin``); a striping donor must match bit-for-bit
        (``allow_repin=False``), because stripes of two different states would
        interleave into a tensor soup no digest could bless."""
        if manifest.state_unavailable:
            raise StateUnavailable(f"donor {donor} is not sharing state")
        if self.min_epoch is not None and manifest.epoch < self.min_epoch:
            _STATE_SYNC_STALE_DONORS.inc()
            raise StaleDonor(
                f"donor {donor} serves epoch {manifest.epoch} < required {self.min_epoch}"
            )
        if self.schema_hash is not None and manifest.schema_hash != self.schema_hash:
            raise ManifestMismatch(
                f"donor {donor} schema {manifest.schema_hash[:8]}… does not match ours"
            )
        if self.expected_tensors is not None and len(manifest.tensors) != self.expected_tensors:
            raise ManifestMismatch(
                f"donor {donor} manifests {len(manifest.tensors)} tensors, "
                f"expected {self.expected_tensors}"
            )
        if self.manifest is None:
            self._adopt_manifest(manifest)
            return
        ours = [(entry.num_bytes, entry.digest) for entry in self.manifest.tensors]
        theirs = [(entry.num_bytes, entry.digest) for entry in manifest.tensors]
        if ours != theirs or manifest.epoch != self.manifest.epoch:
            if not allow_repin:
                raise ManifestMismatch(f"donor {donor} manifest diverges from the pinned one")
            # resume progress only transfers between IDENTICAL states; this donor
            # is valid but different, so the download restarts on its manifest
            logger.debug(
                f"donor {donor} serves a different (valid) state; "
                f"re-pinning and discarding {len(self.verified)} verified tensors"
            )
            self.verified.clear()
            self._slots.clear()
            self._adopt_manifest(manifest)

    def _adopt_manifest(self, manifest: averaging_pb2.StateManifest) -> None:
        self.manifest = manifest
        self.metadata = MSGPackSerializer.loads(manifest.metadata) if manifest.metadata else None
        self.generation += 1

    # ---------------------------------------------------------------- tensor parts

    def feed(self, tensor_index: int, tensor_part) -> None:
        """Ingest one chunk. When a tensor's last byte lands its digest is checked
        immediately: a mismatch discards the tensor and raises (failing only the
        donor that sent it)."""
        assert self.manifest is not None, "manifest must be pinned before tensor parts"
        if tensor_index in self.verified:
            return  # duplicate delivery after a failover re-request: already safe
        if not 0 <= tensor_index < len(self.manifest.tensors):
            raise StateSyncError(f"tensor index {tensor_index} outside the manifest")
        entry = self.manifest.tensors[tensor_index]
        slot = self._slots.setdefault(tensor_index, _TensorSlot())
        if slot.head is None:
            slot.head = _clone_tensor_metadata(tensor_part)
        payload = tensor_part.buffer
        slot.buffer += payload
        self.bytes_received += len(payload)
        _STATE_SYNC_BYTES.inc(len(payload), direction="received")
        if len(slot.buffer) > entry.num_bytes:
            self._slots.pop(tensor_index, None)
            raise StateSyncError(
                f"tensor {tensor_index} overflowed its manifest length "
                f"({len(slot.buffer)} > {entry.num_bytes} bytes)"
            )
        if len(slot.buffer) < entry.num_bytes:
            return
        digest = payload_digest(slot.buffer)
        if digest != entry.digest:
            self._slots.pop(tensor_index, None)
            self.digest_failures += 1
            _STATE_SYNC_DIGEST_FAILURES.inc(site="download")
            raise DigestMismatch(f"tensor {tensor_index} failed digest verification")
        combined = _clone_tensor_metadata(slot.head)
        combined.buffer = bytes(slot.buffer)
        self._slots.pop(tensor_index, None)
        self.verified[tensor_index] = deserialize_tensor(combined)

    def drop_partial(self, indices: Optional[Sequence[int]] = None) -> None:
        """Discard in-flight (unverified) buffers — called when a donor's stream
        dies so a failover donor restarts those tensors from byte zero."""
        if indices is None:
            self._slots.clear()
        else:
            for index in indices:
                self._slots.pop(index, None)

    # ---------------------------------------------------------------- progress

    def missing(self) -> List[int]:
        if self.manifest is None:
            return []
        return [i for i in range(len(self.manifest.tensors)) if i not in self.verified]

    def complete(self) -> bool:
        return self.manifest is not None and not self.missing()

    def result(self, donors: List[str]) -> StateDownloadResult:
        assert self.complete()
        tensors = [self.verified[i] for i in range(len(self.manifest.tensors))]
        return StateDownloadResult(
            metadata=self.metadata,
            tensors=tensors,
            epoch=int(self.manifest.epoch),
            verified=True,
            donors=donors,
            bytes_received=self.bytes_received,
        )


# -------------------------------------------------------------------- receiver


# same family the averager counts its internal errors into (get-or-create):
# a malformed declaration is a swarm-hygiene problem, not a download failure
_DECLARATION_PARSE_ERRORS = _TELEMETRY.counter(
    "hivemind_averaging_internal_errors_total",
    "errors in averager plumbing that do not fail a step",
    ("site",),
).labels(site="state_declaration_parse")


async def _list_donor_candidates(dht, prefix: str, exclude_peer_id) -> List:
    """Donors declared under ``{prefix}.all_averagers``, best priority first.
    ``None`` values are retraction tombstones from cleanly-departed donors."""
    from hivemind_tpu_torch.p2p import PeerID

    key = f"{prefix}.all_averagers"
    result = await dht.node.get(key, latest=True)
    candidates = []
    if result is not None and isinstance(result.value, dict):
        for subkey, entry in result.value.items():
            try:
                if entry.value is None:
                    continue  # retracted on shutdown: do not waste a dial on it
                peer_id = PeerID.from_base58(subkey)
                priority = entry.value
                if peer_id != exclude_peer_id and isinstance(priority, (int, float, list, tuple)):
                    candidates.append((priority, random.random(), peer_id))
            except Exception as e:
                # skipping is correct, but it must be visible: a swarm full of
                # these means someone is publishing junk under our prefix
                # (no silent swallowing)
                logger.warning(f"ignoring malformed averager declaration {subkey!r}: {e!r}")
                _DECLARATION_PARSE_ERRORS.inc()
    candidates.sort(reverse=True)
    return [peer_id for _priority, _jitter, peer_id in candidates]


async def _stream_from_donor(
    stub,
    assembly: StateAssembly,
    donor,
    *,
    want: Optional[Sequence[int]],
    deadline: Deadline,
    manifest_only: bool = False,
    allow_repin: bool = True,
    legacy_sink: Optional[list] = None,
) -> None:
    """One donor's stream into the shared assembly. ``want=None`` means "send
    everything we do not already hold verified"; a striping donor gets an explicit
    subset. Raises a :class:`StateSyncError` subclass (or transport error) on any
    failure; the assembly keeps whatever was verified before the failure."""
    if want is None:
        have = sorted(assembly.verified)
    else:
        total = len(assembly.manifest.tensors) if assembly.manifest is not None else 0
        have = sorted(set(range(total)) - set(want))
    request = averaging_pb2.DownloadRequest(have_tensors=have, manifest_only=manifest_only)
    per_message_timeout = deadline.remaining_or(30.0)
    if per_message_timeout <= 0:
        raise asyncio.TimeoutError("state-sync deadline expired before the dial")
    stream = stub.rpc_download_state(request, timeout=per_message_timeout)
    donor_scope = str(donor)
    saw_manifest = False
    touched: set = set()
    try:
        async for message in stream:
            deadline.require("state download stream")
            if _CHAOS.enabled:
                payload = message.tensor_part.buffer if message.HasField("tensor_part") else None
                injected = await _CHAOS.inject(
                    "state.download.recv", payload=payload, scope=donor_scope
                )
                if payload is not None and injected is not payload:
                    message.tensor_part.buffer = injected
            if message.HasField("manifest"):
                assembly.pin_manifest(message.manifest, donor_scope, allow_repin=allow_repin)
                saw_manifest = True
                if manifest_only:
                    return
                continue
            if not saw_manifest:
                # pre-manifest donor (legacy stream): hand the raw messages to the
                # caller's unverified-path sink; nothing lands in the assembly
                if legacy_sink is None:
                    raise StateSyncError(f"donor {donor_scope} sent data before any manifest")
                legacy_sink.append(message)
                continue
            if message.HasField("tensor_part"):
                index = int(message.tensor_index)
                touched.add(index)
                assembly.feed(index, message.tensor_part)
    except BaseException:
        # this donor's in-flight tensors restart from zero at the next donor;
        # everything already VERIFIED is kept — that is the resume guarantee
        assembly.drop_partial(sorted(touched))
        raise
    if manifest_only and not saw_manifest:
        raise StateSyncError(f"donor {donor_scope} ended a manifest probe without a manifest")
    if saw_manifest and not manifest_only:
        remaining = set(want) & set(assembly.missing()) if want is not None else set(assembly.missing())
        if remaining:
            raise StateSyncError(
                f"donor {donor_scope} ended its stream with {len(remaining)} tensors still missing"
            )


def _split_for_striping(assembly: StateAssembly, n_stripes: int) -> List[List[int]]:
    """Greedy balance of the missing tensors across ``n_stripes`` donors by
    manifest byte size (largest first), so stripes finish together."""
    sizes = sorted(
        ((int(assembly.manifest.tensors[i].num_bytes), i) for i in assembly.missing()),
        reverse=True,
    )
    loads = [0] * n_stripes
    stripes: List[List[int]] = [[] for _ in range(n_stripes)]
    for size, index in sizes:
        slot = loads.index(min(loads))
        stripes[slot].append(index)
        loads[slot] += size
    return [sorted(stripe) for stripe in stripes if stripe]


async def _legacy_collect(messages: List, assembly: StateAssembly) -> StateDownloadResult:
    """Assemble a pre-manifest donor's stream (old wire format: ``metadata`` blob
    + chunked tensors delimited by ``chunks``). Unverifiable — counted, so a swarm
    quietly full of legacy donors is visible in the monitor."""
    from hivemind_tpu_torch.compression import deserialize_tensor_stream

    metadata = None
    for message in messages:
        if message.metadata:
            metadata = MSGPackSerializer.loads(message.metadata)
            break

    async def _parts():
        for message in messages:
            if message.HasField("tensor_part"):
                yield [message.tensor_part]

    tensors = await deserialize_tensor_stream(_parts())
    if assembly.expected_tensors is not None and len(tensors) != assembly.expected_tensors:
        raise StateSyncError(
            f"legacy donor sent {len(tensors)}/{assembly.expected_tensors} tensors (truncated)"
        )
    if not tensors and metadata is None:
        raise StateSyncError("legacy donor sent an empty stream")
    epoch = int(metadata["epoch"]) if isinstance(metadata, dict) and "epoch" in metadata else 0
    if assembly.min_epoch is not None and epoch < assembly.min_epoch:
        _STATE_SYNC_STALE_DONORS.inc()
        raise StaleDonor(f"legacy donor serves epoch {epoch} < required {assembly.min_epoch}")
    _STATE_SYNC_UNVERIFIED.inc()
    return StateDownloadResult(metadata=metadata, tensors=tensors, epoch=epoch, verified=False)


async def download_state_verified(
    dht,
    p2p,
    prefix: str,
    get_stub,
    *,
    exclude_peer_id=None,
    timeout: Optional[float] = None,
    expected_tensors: Optional[int] = None,
    schema_hash: Optional[str] = None,
    min_epoch: Optional[int] = None,
    max_stripes: int = 2,
    retry_policy: RetryPolicy = _FAILOVER_RETRY,
    on_donor_failure=None,
) -> Optional[StateDownloadResult]:
    """Download (metadata, tensors) from the swarm with digest verification,
    per-tensor resume across donor failover, and optional 2-way striping.

    Returns ``None`` only when no donor could serve a complete verified (or,
    for legacy donors, length-consistent) state within the deadline.
    ``on_donor_failure(donor, exc)`` observes every failed donor attempt.
    """
    deadline = Deadline(timeout)
    assembly = StateAssembly(
        schema_hash=schema_hash, min_epoch=min_epoch, expected_tensors=expected_tensors
    )
    used_donors: List[str] = []
    sweep = 0

    async def _full_stream(stub, donor, legacy_sink=None) -> None:
        """Full (non-striped) stream with one repin retry: the request's
        ``have_tensors`` was computed against the OLD manifest — if this donor's
        (valid, divergent) manifest re-pins the assembly mid-stream, the donor
        was told to skip tensors the repin just discarded, so one immediate
        retry re-requests against the fresh (now-empty) verified set instead of
        failing over and repeating the same inversion against the next donor."""
        for attempt in range(2):
            # only a REPIN (a manifest replacing an already-pinned one) warrants
            # the same-donor retry; the first pin also bumps the generation, and
            # retrying on it would hand every failing donor a free second stream
            had_pinned_manifest = assembly.manifest is not None
            generation_before = assembly.generation
            try:
                await _stream_from_donor(
                    stub, assembly, donor, want=None, deadline=deadline, legacy_sink=legacy_sink
                )
                return
            except StateSyncError:
                if (
                    attempt == 0
                    and had_pinned_manifest
                    and assembly.generation != generation_before
                    and not assembly.complete()
                ):
                    continue
                raise

    with _tracing_span("state_sync.download", prefix=prefix, min_epoch=min_epoch or 0) as span:
        while not deadline.expired:
            candidates = await _list_donor_candidates(dht, prefix, exclude_peer_id)
            for position, donor in enumerate(candidates):
                if deadline.expired:
                    break
                stub = get_stub(p2p, donor, namespace=prefix)
                legacy_sink: List = []
                try:
                    if (
                        assembly.manifest is None
                        and position + 1 < len(candidates)
                        and max_stripes >= 2
                    ):
                        # probe first so striping can be decided before bytes move
                        await _stream_from_donor(
                            stub, assembly, donor, want=None, deadline=deadline,
                            manifest_only=True,
                        )
                    if assembly.manifest is not None:
                        striped = await _try_striped_fetch(
                            assembly, donor, candidates[position + 1:], get_stub, p2p, prefix,
                            deadline=deadline, max_stripes=max_stripes,
                            used_donors=used_donors, on_donor_failure=on_donor_failure,
                        )
                        if not striped and not assembly.complete():
                            await _full_stream(stub, donor)
                            if str(donor) not in used_donors:
                                used_donors.append(str(donor))
                    else:
                        # sole candidate: stream directly (legacy donors allowed)
                        await _full_stream(stub, donor, legacy_sink=legacy_sink)
                        if str(donor) not in used_donors:
                            used_donors.append(str(donor))
                    if assembly.complete():
                        result = assembly.result(used_donors)
                        if span is not None:
                            span.set("donors", len(used_donors))
                            span.set("bytes", result.bytes_received)
                            span.set("epoch", result.epoch)
                        return result
                    if legacy_sink and assembly.manifest is None:
                        result = await _legacy_collect(legacy_sink, assembly)
                        result.donors = [str(donor)]
                        if span is not None:
                            span.set("legacy", True)
                        return result
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    if on_donor_failure is not None:
                        on_donor_failure(donor, e)
                    if assembly.verified or assembly.manifest is not None:
                        _STATE_SYNC_FAILOVERS.inc()
                        if span is not None:
                            span.add_event(
                                "state_sync.failover",
                                donor=str(donor),
                                error=type(e).__name__,
                                verified=len(assembly.verified),
                            )
                    level = (
                        logger.debug
                        if isinstance(e, (StateUnavailable, StaleDonor))
                        else logger.warning
                    )
                    level(f"state download from {donor} failed: {e!r}")
            if not candidates and span is not None:
                span.add_event("state_sync.no_candidates", sweep=sweep)
            remaining = deadline.remaining()
            pause = retry_policy.delay(sweep)
            if remaining is not None and remaining <= pause:
                return None
            if remaining is None and sweep >= 2:
                # unbounded download that keeps finding nothing usable: give up
                # rather than spin forever (callers decide whether to re-enter)
                return None
            retry_policy._account_retry(sweep)
            await asyncio.sleep(pause)
            sweep += 1
    return None


async def _try_striped_fetch(
    assembly: StateAssembly,
    primary,
    rest: List,
    get_stub,
    p2p,
    prefix: str,
    *,
    deadline: Deadline,
    max_stripes: int,
    used_donors: List[str],
    on_donor_failure=None,
) -> bool:
    """Attempt a striped fetch of the missing tensors across ``primary`` plus
    donors from ``rest`` whose manifests match the pinned one. Returns True when
    striping ran (the assembly may still be incomplete if a stripe died — the
    caller's failover loop finishes the remainder); False when striping is not
    worth a second stream."""
    missing = assembly.missing()
    missing_bytes = sum(int(assembly.manifest.tensors[i].num_bytes) for i in missing)
    if max_stripes < 2 or len(missing) < 2 or missing_bytes < MIN_STRIPE_BYTES or not rest:
        return False
    donors = [primary]
    for candidate in rest:
        if len(donors) >= max_stripes:
            break
        try:
            # pin_manifest on the SHARED assembly validates the candidate's
            # manifest matches the pinned one bit-for-bit (no repin: stripes
            # of two different states must never interleave)
            await _stream_from_donor(
                get_stub(p2p, candidate, namespace=prefix), assembly, candidate,
                want=None, deadline=deadline, manifest_only=True, allow_repin=False,
            )
            donors.append(candidate)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.debug(f"striping probe of {candidate} failed: {e!r}")
    if len(donors) < 2:
        return False
    stripes = _split_for_striping(assembly, len(donors))
    span = _current_span()
    if span is not None:
        span.add_event("state_sync.striped", donors=len(stripes), tensors=len(missing))

    async def _one(donor, want):
        # no repin mid-stripe: a donor whose state moved since the probe fails
        # its stripe rather than resetting the other stripe's verified tensors
        await _stream_from_donor(
            get_stub(p2p, donor, namespace=prefix), assembly, donor,
            want=want, deadline=deadline, allow_repin=False,
        )
        if str(donor) not in used_donors:
            used_donors.append(str(donor))

    outcomes = await asyncio.gather(
        *(_one(donor, want) for donor, want in zip(donors, stripes)),
        return_exceptions=True,
    )
    for donor, outcome in zip(donors, outcomes):
        if isinstance(outcome, asyncio.CancelledError):
            raise outcome
        if isinstance(outcome, BaseException):
            _STATE_SYNC_FAILOVERS.inc()
            if on_donor_failure is not None:
                on_donor_failure(donor, outcome)
            logger.warning(f"striped state download from {donor} failed: {outcome!r}")
    return True
