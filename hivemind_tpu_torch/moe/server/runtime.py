"""The device executor: drains task pools by priority and runs their processing
functions (the port of hivemind_tpu/moe/server/runtime.py; its telemetry comes
with the telemetry slice). An asyncio task picks the most urgent pool and runs
one batch at a time on an executor thread, so device work never blocks the loop."""

from __future__ import annotations

import asyncio
from typing import Optional, Sequence

from hivemind_tpu_torch.moe.server.task_pool import TaskPool
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor, spawn
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class Runtime:
    def __init__(self, pools: Sequence[TaskPool]):
        if not pools:
            raise ValueError("a Runtime drains at least one pool")
        self.pools = list(pools)
        self._task: Optional[asyncio.Task] = None
        self.batches_processed = 0

    def start(self) -> None:
        self._task = spawn(self._run(), name="runtime.run")

    async def _run(self) -> None:
        while True:
            waiters = [asyncio.create_task(pool.wait_for_tasks()) for pool in self.pools]
            try:
                await asyncio.wait(waiters, return_when=asyncio.FIRST_COMPLETED)
            finally:
                for waiter in waiters:
                    waiter.cancel()
                await asyncio.gather(*waiters, return_exceptions=True)
            pool = min(self.pools, key=lambda p: p.priority)
            batch = pool.pop_batch()
            if not batch:
                continue
            try:
                await run_in_executor(pool.process_batch, batch)
            except Exception as e:
                logger.warning(f"pool {pool.name}: batch failed with {e!r}")
                pool.fail_batch(batch, e)
                continue
            self.batches_processed += 1

    async def shutdown(self) -> None:
        """Stop the drain loop and wait until it has stopped."""
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
