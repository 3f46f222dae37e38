"""Black-box flight recorder: crash-durable telemetry spools (the port's copy of
hivemind_tpu/telemetry/blackbox.py). Its frames are msgpack, so it stays off the
card's path and ``hivemind_tpu_torch.telemetry`` does not import it.

The in-memory observability stack (metrics, the span ring, the round/serving
ledgers) is live-only: a crash-killed peer takes its evidence with it, exactly
when attribution matters most. This module spools the same signals to disk as
they happen, so a post-mortem (``hivemind-blackbox``, ``hivemind-top
--from-spool``) can rebuild a dead peer's final round and name its last
in-flight span.

Spool format — bounded, segment-rotated, torn-tail tolerant:

- a spool is a directory of segments: ``spool-NNNNNNNN.seg`` (complete,
  published atomically: fsync → rename → fsync(dir))
  plus at most one ``spool-NNNNNNNN.open`` (the active segment, flushed per
  frame — a kill-9 loses at most the frame being written, which the reader
  truncates as a torn tail);
- each frame is ``>II`` (payload length, crc32) + a msgpack map
  ``{"t": wall_ts, "k": kind, "d": data}``. Kinds: ``header`` (first frame of
  every segment: peer, segment index, wall anchor + drift estimate, clock
  model), ``span`` (finished), ``span_start`` (open — the only way a victim's
  last operation reaches disk), ``ledger_round``, ``ledger_epoch``,
  ``serving``, ``metrics``, ``device`` (compile / recompile-storm /
  device-memory / leak / overlap events — device telemetry is process-scoped,
  so these frames bypass ``peer_filter`` and land in every co-resident box);
- retention is a segment-count cap: the oldest ``.seg`` is deleted when the
  cap is exceeded, so a spool is O(retention × segment_bytes) forever.

Feeding is listener-based — span start/finish hooks (tracing), record hooks
on the round/serving ledgers, and an optional metrics-snapshot thread — so
arming a :class:`BlackBox` costs the hot path one extra listener call (a
msgpack pack + buffered write, single-digit µs). ``peer_filter`` scopes a box
to one peer's frames when many peers share a process (tests, the chaos soak,
the sim). Under the sim's virtual clock (``set_telemetry_time_source``) all
frame timestamps are virtual and the segment header says so — per-peer spools
from one seeded scenario are bit-identical across same-seed runs.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from hivemind_tpu_torch.telemetry.registry import REGISTRY
from hivemind_tpu_torch.telemetry.tracing import (
    Span,
    add_span_listener,
    add_span_start_listener,
    remove_span_listener,
    remove_span_start_listener,
    wall_anchor,
    wall_anchor_info,
    wall_time,
)
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

_FRAME_HEADER = struct.Struct(">II")  # (payload length, crc32(payload))
# a frame length beyond this is garbage, not data (a torn length field would
# otherwise send the reader seeking gigabytes past the end)
_MAX_FRAME_BYTES = 16 * 1024 * 1024
SPOOL_VERSION = 1

FRAMES_WRITTEN = REGISTRY.counter(
    "hivemind_blackbox_frames_total",
    "telemetry frames appended to the black-box spool, by frame kind",
    ("kind",),
)
BYTES_WRITTEN = REGISTRY.counter(
    "hivemind_blackbox_bytes_total",
    "bytes appended to the black-box spool (frame headers included)",
)
ROTATIONS = REGISTRY.counter(
    "hivemind_blackbox_rotations_total",
    "spool segments rotated out (published as .seg) by the black-box writer",
)
READ_SKIPPED = REGISTRY.counter(
    "hivemind_blackbox_read_skipped_total",
    "unreadable spool frames skipped by the reader (torn tails, crc mismatches)",
    ("reason",),
)


# ------------------------------------------------------------------- writing


class SpoolWriter:
    """Append-only segment-rotated frame writer. Thread-safe: listeners fire
    from arbitrary threads, every append holds one lock around a pack + write
    + flush. Durability model: flush-per-frame keeps frames in the OS page
    cache (survives process kill-9), fsync happens at segment publication
    (rotation/close), published atomically."""

    def __init__(
        self,
        directory: os.PathLike,
        peer: Optional[str] = None,
        segment_bytes: int = 4 * 1024 * 1024,
        retention_segments: int = 8,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.peer = str(peer) if peer is not None else None
        self.segment_bytes = int(segment_bytes)
        self.retention_segments = int(retention_segments)
        self._lock = threading.Lock()
        self._file = None
        self._written = 0
        # a restarted peer must not clobber its pre-crash evidence: publish
        # any leftover .open from the previous incarnation, continue numbering
        self._segment = 0
        for stale in sorted(self.directory.glob("spool-*.open")):
            stale.rename(stale.with_suffix(".seg"))
        for seg in self.directory.glob("spool-*.seg"):
            try:
                self._segment = max(self._segment, int(seg.stem.split("-")[1]))
            except (IndexError, ValueError):
                continue
        self._open_segment()

    # lock held for everything below --------------------------------------

    def _segment_path(self, index: int, suffix: str) -> Path:
        return self.directory / f"spool-{index:08d}{suffix}"

    def _open_segment(self) -> None:
        self._segment += 1
        self._file = open(self._segment_path(self._segment, ".open"), "wb")
        self._written = 0
        self._append_locked(
            "header",
            {
                "version": SPOOL_VERSION,
                "peer": self.peer,
                "segment": self._segment,
                "created": round(wall_time(), 6),
                **wall_anchor_info(),
            },
        )

    def _append_locked(self, kind: str, data: Dict[str, Any]) -> None:
        payload = MSGPackSerializer.dumps({"t": round(wall_time(), 6), "k": kind, "d": data})
        self._file.write(_FRAME_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._file.write(payload)
        self._file.flush()
        self._written += _FRAME_HEADER.size + len(payload)
        FRAMES_WRITTEN.inc(kind=kind)
        BYTES_WRITTEN.inc(_FRAME_HEADER.size + len(payload))

    def _publish_locked(self) -> None:
        """fsync → atomic rename .open → .seg → fsync(dir): after this the
        segment is complete-by-construction for any reader/merger."""
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        open_path = self._segment_path(self._segment, ".open")
        open_path.rename(self._segment_path(self._segment, ".seg"))
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._file = None
        ROTATIONS.inc()

    def _enforce_retention_locked(self) -> None:
        segments = sorted(self.directory.glob("spool-*.seg"))
        for stale in segments[: max(0, len(segments) - self.retention_segments)]:
            stale.unlink(missing_ok=True)

    # public ----------------------------------------------------------------

    def append(self, kind: str, data: Dict[str, Any]) -> None:
        with self._lock:
            if self._file is None:
                return  # closed writer: late listener fire after disarm
            self._append_locked(kind, data)
            if self._written >= self.segment_bytes:
                self._publish_locked()
                self._enforce_retention_locked()
                self._open_segment()

    def close(self) -> None:
        with self._lock:
            if self._file is None:
                return
            self._publish_locked()
            self._enforce_retention_locked()


# ------------------------------------------------------------------- reading


def _iter_file_frames(path: Path, stats: Dict[str, int]) -> Iterator[Dict[str, Any]]:
    with open(path, "rb") as f:
        while True:
            header = f.read(_FRAME_HEADER.size)
            if not header:
                return
            if len(header) < _FRAME_HEADER.size:
                stats["torn_tail"] += 1
                READ_SKIPPED.inc(reason="torn-tail")
                return
            length, crc = _FRAME_HEADER.unpack(header)
            if length > _MAX_FRAME_BYTES:
                # a corrupt length field: nothing after it is frame-aligned
                stats["corrupt"] += 1
                READ_SKIPPED.inc(reason="bad-length")
                return
            payload = f.read(length)
            if len(payload) < length:
                stats["torn_tail"] += 1
                READ_SKIPPED.inc(reason="torn-tail")
                return
            if zlib.crc32(payload) != crc:
                stats["corrupt"] += 1
                READ_SKIPPED.inc(reason="crc")
                continue  # length was intact: the NEXT frame is still aligned
            try:
                frame = MSGPackSerializer.loads(payload)
            except Exception:
                stats["corrupt"] += 1
                READ_SKIPPED.inc(reason="decode")
                continue
            if isinstance(frame, dict) and "k" in frame:
                yield frame


def read_spool(directory: os.PathLike) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """All frames of one peer's spool in write order, plus reader stats
    ``{"frames", "segments", "torn_tail", "corrupt"}``. Torn tails (a crash
    mid-frame) are truncated silently-but-counted; frames with a bad crc are
    skipped individually; a corrupt length field ends that segment."""
    directory = Path(directory)
    stats = {"frames": 0, "segments": 0, "torn_tail": 0, "corrupt": 0}
    frames: List[Dict[str, Any]] = []
    paths = sorted(directory.glob("spool-*.seg")) + sorted(directory.glob("spool-*.open"))
    paths.sort(key=lambda p: int(p.stem.split("-")[1]))
    for path in paths:
        stats["segments"] += 1
        for frame in _iter_file_frames(path, stats):
            frames.append(frame)
            stats["frames"] += 1
    return frames, stats


# ------------------------------------------------------------------- feeding


def _span_data(span: Span) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "name": span.name,
        "trace": f"{span.trace_id:016x}",
        "span": f"{span.span_id:016x}",
        "start": round(span.start + wall_anchor(), 6),
    }
    if span.parent_id:
        out["parent"] = f"{span.parent_id:016x}"
    if span.end is not None:
        out["dur_s"] = round(span.duration, 6)
    if span.attributes:
        out["attrs"] = {
            k: v for k, v in span.attributes.items() if isinstance(v, (str, int, float, bool))
        }
    if span.events:
        anchor = wall_anchor()
        out["events"] = [
            [round(when + anchor, 6), name] for when, name, _attrs in span.events
        ]
    return out


class BlackBox:
    """One armed flight recorder: a :class:`SpoolWriter` subscribed to the
    span hooks and both ledgers, with an optional metrics-snapshot thread.

    ``peer_filter`` keeps only frames attributable to that peer (matched
    against the ``peer`` span attribute / record field) — the multi-peer-in-
    one-process harnesses (chaos soak, sim) arm one box per peer on a shared
    telemetry plane. ``metrics_interval=None`` disables the snapshot thread
    (the sim does: a wall-interval thread is non-deterministic by nature)."""

    def __init__(
        self,
        directory: os.PathLike,
        peer: Optional[str] = None,
        peer_filter: Optional[str] = None,
        segment_bytes: int = 4 * 1024 * 1024,
        retention_segments: int = 8,
        metrics_interval: Optional[float] = None,
        spool_span_starts: bool = True,
        ledger: Optional[Any] = None,
        serving_ledger: Optional[Any] = None,
    ):
        self.writer = SpoolWriter(
            directory,
            peer=peer if peer is not None else peer_filter,
            segment_bytes=segment_bytes,
            retention_segments=retention_segments,
        )
        self.peer_filter = str(peer_filter) if peer_filter is not None else None
        self._spool_span_starts = spool_span_starts
        self._closed = False
        self._stop = threading.Event()
        self._metrics_thread: Optional[threading.Thread] = None
        # default to the process-wide ledgers; the sim passes its own private
        # RoundLedger so per-peer spools see only deterministic virtual-time
        # records (imports deferred to dodge the telemetry import cycle)
        if ledger is None:
            from hivemind_tpu_torch.telemetry.ledger import LEDGER as ledger
        if serving_ledger is None:
            from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER as serving_ledger
        self._ledger = ledger
        self._serving_ledger = serving_ledger
        add_span_listener(self._on_span_finish)
        if spool_span_starts:
            add_span_start_listener(self._on_span_start)
        self._ledger.add_record_listener(self._on_ledger_record)
        self._serving_ledger.add_record_listener(self._on_serving_record)
        # device telemetry is process-scoped (one jit cache, one
        # HBM pool), so device frames deliberately BYPASS peer_filter: every
        # co-resident box carries the compile/memory state a post-mortem needs
        from hivemind_tpu_torch.telemetry.device import add_device_listener

        self._last_device_memory_frame = 0.0
        add_device_listener(self._on_device_record)
        if metrics_interval is not None:
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop,
                args=(float(metrics_interval),),
                name="hmtpu-blackbox-metrics",
                daemon=True,
            )
            self._metrics_thread.start()

    # ------------------------------------------------------------- listeners

    def _peer_of_span(self, span: Span) -> Optional[str]:
        if span.attributes is None:
            return None
        peer = span.attributes.get("peer")
        return str(peer) if peer is not None else None

    def _on_span_start(self, span: Span) -> None:
        if self.peer_filter is not None and self._peer_of_span(span) != self.peer_filter:
            return
        self.writer.append("span_start", _span_data(span))

    def _on_span_finish(self, span: Span) -> None:
        if self.peer_filter is not None and self._peer_of_span(span) != self.peer_filter:
            return
        self.writer.append("span", _span_data(span))

    def _on_ledger_record(self, kind: str, record: Dict[str, Any]) -> None:
        if self.peer_filter is not None and str(record.get("peer")) != self.peer_filter:
            return
        self.writer.append(f"ledger_{kind}", record)

    def _on_serving_record(self, _kind: str, record: Dict[str, Any]) -> None:
        if self.peer_filter is not None and str(record.get("peer")) != self.peer_filter:
            return
        self.writer.append("serving", record)

    def _on_device_record(self, kind: str, record: Dict[str, Any]) -> None:
        # memory samples arrive on every watchdog tick — throttle them so a
        # long-lived box doesn't rotate its whole retention on gauge chatter;
        # the rare kinds (compile/storm/leak/overlap) always spool
        if kind == "memory":
            now = time.monotonic()
            if now - self._last_device_memory_frame < 5.0:
                return
            self._last_device_memory_frame = now
        frame = dict(record)
        # overlap records carry their comm span's name under "kind" — keep it
        # as "span" so the frame's own kind discriminator survives the merge
        inner = frame.pop("kind", None)
        if inner is not None:
            frame["span"] = inner
        frame["kind"] = kind
        self.writer.append("device", frame)

    def _metrics_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.snapshot_metrics()

    def _unsubscribe(self) -> None:
        remove_span_listener(self._on_span_finish)
        if self._spool_span_starts:
            remove_span_start_listener(self._on_span_start)
        self._ledger.remove_record_listener(self._on_ledger_record)
        self._serving_ledger.remove_record_listener(self._on_serving_record)
        from hivemind_tpu_torch.telemetry.device import remove_device_listener

        remove_device_listener(self._on_device_record)
        if self._metrics_thread is not None:
            self._metrics_thread.join(timeout=2.0)
            self._metrics_thread = None

    # --------------------------------------------------------------- public

    def snapshot_metrics(self) -> None:
        """Append one metrics snapshot frame (called periodically by the
        metrics thread; harnesses without the thread call it at checkpoints)."""
        try:
            self.writer.append("metrics", {"metrics": REGISTRY.snapshot()})
        except Exception as e:  # pragma: no cover - spooling must stay harmless
            logger.debug(f"blackbox metrics snapshot failed: {e!r}")

    def close(self) -> None:
        """Unsubscribe, stop the metrics thread, publish the active segment."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._unsubscribe()
        self.writer.close()

    def abandon(self) -> None:
        """Kill-9 semantics for harnesses: unsubscribe WITHOUT publishing the
        active segment — the .open file stays exactly as the dead peer left
        it, torn tail and all. What a real crash leaves behind."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._unsubscribe()
        with self.writer._lock:
            if self.writer._file is not None:
                self.writer._file.flush()
                self.writer._file.close()
                self.writer._file = None


# ------------------------------------------------------------ process global

# the one CLI-armed box (run_server/run_dht/Optimizer --blackbox_dir); tests
# and the soak build private BlackBox instances instead
_ACTIVE: Optional[BlackBox] = None
_ACTIVE_LOCK = threading.Lock()


def arm_blackbox(
    directory: os.PathLike,
    peer: Optional[str] = None,
    metrics_interval: Optional[float] = 15.0,
    **kwargs: Any,
) -> BlackBox:
    """Arm (or re-arm) the process-wide black box writing under ``directory``.
    Idempotent per directory: re-arming the same path returns the existing
    box, so run_server + Optimizer can both pass ``--blackbox_dir`` without
    double-spooling every span."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and not _ACTIVE._closed:
            if _ACTIVE.writer.directory == Path(directory):
                return _ACTIVE
            _ACTIVE.close()
        _ACTIVE = BlackBox(directory, peer=peer, metrics_interval=metrics_interval, **kwargs)
        return _ACTIVE


def disarm_blackbox() -> None:
    """Close and forget the process-wide box (conftest resets through here)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
            _ACTIVE = None


def active_blackbox() -> Optional[BlackBox]:
    return _ACTIVE


__all__ = [
    "BlackBox",
    "SpoolWriter",
    "read_spool",
    "arm_blackbox",
    "disarm_blackbox",
    "active_blackbox",
    "SPOOL_VERSION",
]
