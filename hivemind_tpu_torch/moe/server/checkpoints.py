"""Periodic expert checkpoints on disk (the port of
hivemind_tpu/moe/server/checkpoints.py), in the JAX package's layout:
``{dir}/{uid}/checkpoint_<timestamp>.flax`` holds one ``ModuleBackend.state_dict()``
blob (flax's msgpack format), and ``checkpoint_last.flax`` is a relative symlink to
the newest, swapped in with ``os.replace``. Either package restores the other's
checkpoints."""

from __future__ import annotations

import asyncio
import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional

from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor, spawn
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def store_experts(backends: Dict[str, ModuleBackend], checkpoint_dir: Path) -> None:
    """Write every backend's state blob and point its ``checkpoint_last.flax`` at it."""
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    for uid, backend in backends.items():
        expert_dir = Path(checkpoint_dir) / uid
        expert_dir.mkdir(parents=True, exist_ok=True)
        checkpoint = expert_dir / f"checkpoint_{timestamp}.flax"
        checkpoint.write_bytes(backend.state_dict())
        tmp = expert_dir / ".checkpoint_last.tmp"
        with contextlib.suppress(OSError):
            tmp.unlink()
        tmp.symlink_to(checkpoint.name)
        os.replace(tmp, expert_dir / "checkpoint_last.flax")


def load_experts(backends: Dict[str, ModuleBackend], checkpoint_dir: Path) -> int:
    """Restore every backend that has a ``checkpoint_last.flax``; returns how many
    loaded (a checkpoint that fails to load is logged and skipped)."""
    loaded = 0
    for uid, backend in backends.items():
        last = Path(checkpoint_dir) / uid / "checkpoint_last.flax"
        if last.exists():
            try:
                backend.load_state_dict(last.read_bytes())
                loaded += 1
            except Exception as e:
                logger.warning(f"could not load checkpoint for {uid}: {e!r}")
    return loaded


class CheckpointSaver:
    """Stores all experts every ``update_period`` seconds from a task on the port's
    loop (``start`` and ``shutdown`` are called there, by the Server); the
    writing itself runs on the executor."""

    def __init__(self, backends: Dict[str, ModuleBackend], checkpoint_dir: Path, update_period: float = 300.0):
        self.backends, self.checkpoint_dir, self.update_period = backends, Path(checkpoint_dir), update_period
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = spawn(self._loop(), name="checkpoints.loop")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.update_period)
            try:
                await run_in_executor(store_experts, self.backends, self.checkpoint_dir)
            except Exception as e:
                logger.warning(f"storing the expert checkpoints failed: {e!r}")

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
