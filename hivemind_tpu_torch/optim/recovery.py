"""Crash-safe local state recovery (the port of hivemind_tpu/optim/recovery.py; its
checkpoint files are the JAX package's, so either package restores the other's).

The swarm can rebuild a peer's state over the network, but a machine reboot
should cost a file read, not a multi-donor download: the Optimizer saves its
``state_dict`` into a :class:`LocalCheckpointStore` on an epoch cadence and
restores from it at startup. The restore order is

    local-verified checkpoint  →  swarm download  →  fresh initialization

where the swarm leg is the existing catch-up path (the restored local epoch is
still validated against the progress tracker — a stale checkpoint merely
shortens the download that follows).

Crash safety is mechanical, not probabilistic:

- **Atomic publication.** Every save writes to a temp file in the same
  directory, flushes + fsyncs it, computes a blake2b-16 digest of the file
  bytes, then atomically renames it into a digest-stamped name and fsyncs the
  directory. A ``kill -9`` at ANY instant leaves either the previous
  checkpoint set intact or the new one fully published — never a torn file
  under a valid name.
- **Verified restore.** ``load_latest`` re-digests each candidate file and
  compares against the digest in its name, walking from the newest epoch down:
  a corrupt or truncated file is rejected (counted under
  ``hivemind_state_sync_digest_failures_total{site="checkpoint"}``) and the
  previous checkpoint is used instead.
- **Bounded retention.** Only the newest ``keep_last`` checkpoints survive a
  save; stray temp files from interrupted saves are swept as well.

The JAX package's docs/state_recovery.md describes the recovery state machine.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DIGEST_SIZE = 16  # matches state_sync.DIGEST_SIZE: one integrity currency repo-wide

_STATE_RESTORES = _TELEMETRY.counter(
    "hivemind_state_sync_restores_total",
    "state restores by source (local checkpoint / swarm download / fresh init)",
    ("source",),
)
_CHECKPOINT_DIGEST_FAILURES = _TELEMETRY.counter(
    "hivemind_state_sync_digest_failures_total",
    "state payloads rejected by digest verification",
    ("site",),
).labels(site="checkpoint")
_CHECKPOINT_SAVES = _TELEMETRY.counter(
    "hivemind_checkpoint_saves_total", "local checkpoints published atomically"
)

_CHECKPOINT_PATTERN = re.compile(
    r"^(?P<prefix>[\w.-]+)-e(?P<epoch>\d{12})-(?P<digest>[0-9a-f]{32})\.ckpt\.npz$"
)
_TMP_SUFFIX = ".tmp"


def _file_digest(path: Path) -> str:
    digest = hashlib.blake2b(digest_size=DIGEST_SIZE)
    with path.open("rb") as handle:
        for block in iter(lambda: handle.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


class CheckpointError(Exception):
    """A checkpoint could not be written (restores never raise: they fall back)."""


class LocalCheckpointStore:
    """Digest-stamped, atomically-published checkpoints of an Optimizer's
    ``state_dict`` (epoch + tensors + optax step counters).

    :param directory: where checkpoints live (created if missing)
    :param prefix: filename prefix — one store directory can host several peers
        as long as their prefixes differ
    :param keep_last: newest checkpoints kept after every save (older pruned)
    """

    def __init__(self, directory, *, prefix: str = "state", keep_last: int = 3):
        assert keep_last >= 1, "retention must keep at least one checkpoint"
        assert _CHECKPOINT_PATTERN.match(f"{prefix}-e{0:012d}-{'0' * 32}.ckpt.npz"), (
            f"prefix {prefix!r} must be filename-safe ([\\w.-])"
        )
        self.directory = Path(directory)
        self.prefix = prefix
        self.keep_last = keep_last
        self.directory.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, state: Dict) -> Path:
        """Atomically publish one ``state_dict`` checkpoint; returns its path."""
        epoch = int(state["epoch"])
        tensors = state["tensors"]
        payload = {
            "epoch": np.asarray(epoch, dtype=np.int64),
            "opt_counts": np.asarray(list(state.get("opt_counts") or []), dtype=np.int64),
            "num_tensors": np.asarray(len(tensors), dtype=np.int64),
        }
        for index, tensor in enumerate(tensors):
            payload[f"tensor_{index:05d}"] = np.asarray(tensor)

        fd, tmp_name = tempfile.mkstemp(
            prefix=f".{self.prefix}-save-", suffix=_TMP_SUFFIX, dir=self.directory
        )
        tmp_path = Path(tmp_name)
        try:
            with os.fdopen(fd, "wb") as handle:
                np.savez(handle, **payload)
                handle.flush()
                os.fsync(handle.fileno())
            digest = _file_digest(tmp_path)
            final = self.directory / f"{self.prefix}-e{epoch:012d}-{digest}.ckpt.npz"
            os.replace(tmp_path, final)  # atomic on POSIX: old checkpoints untouched
            self._fsync_directory()
        except BaseException as e:
            with contextlib.suppress(OSError):
                tmp_path.unlink()
            raise CheckpointError(f"could not publish checkpoint at epoch {epoch}: {e!r}") from e
        _CHECKPOINT_SAVES.inc()
        self.prune()
        logger.debug(f"published checkpoint {final.name}")
        return final

    def _fsync_directory(self) -> None:
        # the rename itself must be durable, or a crash right after save() could
        # roll the directory back to a state where the new name never existed
        with contextlib.suppress(OSError):
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)

    # ------------------------------------------------------------------ load

    def checkpoints(self) -> List[Path]:
        """All well-named checkpoints, newest epoch first (NOT yet verified)."""
        found = []
        for path in self.directory.iterdir():
            match = _CHECKPOINT_PATTERN.match(path.name)
            if match is not None and match.group("prefix") == self.prefix:
                found.append((int(match.group("epoch")), path))
        found.sort(reverse=True)
        return [path for _epoch, path in found]

    def load_latest(self) -> Optional[Dict]:
        """The newest checkpoint whose file digest matches its name, as a
        ``state_dict``; corrupt/torn files are skipped (and counted), never
        adopted."""
        for path in self.checkpoints():
            expected = _CHECKPOINT_PATTERN.match(path.name).group("digest")
            try:
                actual = _file_digest(path)
                if actual != expected:
                    _CHECKPOINT_DIGEST_FAILURES.inc()
                    logger.warning(
                        f"checkpoint {path.name} failed digest verification; trying an older one"
                    )
                    continue
                return self._read(path)
            except Exception as e:
                logger.warning(f"checkpoint {path.name} unreadable ({e!r}); trying an older one")
        return None

    @staticmethod
    def _read(path: Path) -> Dict:
        with np.load(path) as archive:
            num_tensors = int(archive["num_tensors"])
            tensors = [archive[f"tensor_{index:05d}"] for index in range(num_tensors)]
            return {
                "epoch": int(archive["epoch"]),
                "tensors": tensors,
                "opt_counts": [int(count) for count in archive["opt_counts"]],
            }

    # ------------------------------------------------------------------ retention

    # temp files older than this are interrupted saves from a dead process; a
    # younger one may belong to a LIVE concurrent writer and must not be swept
    STALE_TMP_AGE_S = 600.0

    def prune(self) -> None:
        """Keep the newest ``keep_last`` checkpoints; sweep interrupted temp files
        (age-gated so a concurrent save's in-flight temp file is never touched)."""
        for stale in self.checkpoints()[self.keep_last:]:
            with contextlib.suppress(OSError):
                stale.unlink()
        cutoff = time.time() - self.STALE_TMP_AGE_S
        for path in self.directory.glob(f".{self.prefix}-save-*{_TMP_SUFFIX}"):
            with contextlib.suppress(OSError):
                if path.stat().st_mtime < cutoff:
                    path.unlink()


def restore_from_local(state_averager, store: Optional[LocalCheckpointStore]) -> Optional[int]:
    """The first leg of the recovery order: adopt the newest verified local
    checkpoint into ``state_averager``. Returns the restored epoch, or ``None``
    when no usable checkpoint exists (the caller falls through to the swarm /
    fresh legs). Counts ``hivemind_state_sync_restores_total{source=...}``."""
    if store is None:
        return None
    with _tracing_span("state_sync.restore_local"):
        state = store.load_latest()
        if state is None:
            # a store was configured but held nothing usable: this peer starts
            # fresh (the swarm leg may still catch it up later)
            _STATE_RESTORES.inc(source="fresh")
            return None
        try:
            state_averager.load_state_dict(state)
        except Exception as e:
            logger.warning(f"local checkpoint could not be adopted ({e!r}); starting fresh")
            _STATE_RESTORES.inc(source="fresh")
            return None
        _STATE_RESTORES.inc(source="local")
        logger.info(f"restored local checkpoint at epoch {state['epoch']}")
        return int(state["epoch"])
