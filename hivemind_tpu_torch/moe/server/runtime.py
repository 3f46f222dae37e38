"""The device executor: drains task pools by priority and runs their processing
functions (the port of hivemind_tpu/moe/server/runtime.py). An asyncio task picks
the most urgent pool and runs one batch at a time on an executor thread, so device
work never blocks the loop.

Telemetry, under the JAX package's metric names: per-pool batches, samples,
failures and batch latency, and the drain loop's utilization. Every
``STATS_REPORT_INTERVAL`` seconds a log line reports each pool's batches, mean
batch size and throughput as deltas of those counters, and the card's memory in
use."""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Sequence, Tuple

from hivemind_tpu_torch.moe.server.task_pool import TaskPool
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor, spawn
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.profiling import device_memory_stats

logger = get_logger(__name__)

_BATCHES = _TELEMETRY.counter(
    "hivemind_moe_batches_total", "batches processed by the runtime", ("pool",)
)
_SAMPLES = _TELEMETRY.counter(
    "hivemind_moe_samples_total", "samples processed by the runtime", ("pool",)
)
_BATCH_FAILURES = _TELEMETRY.counter(
    "hivemind_moe_batch_failures_total", "batches whose processing function raised", ("pool",)
)
_BATCH_LATENCY = _TELEMETRY.histogram(
    "hivemind_moe_batch_latency_seconds", "device time of one batch", ("pool",)
)
_UTILIZATION = _TELEMETRY.gauge(
    "hivemind_moe_runtime_utilization",
    "fraction of the drain loop's recent wall time spent processing batches "
    "(1.0 = the device executor never idles; sampled over ~5 s windows)",
)
STATS_REPORT_INTERVAL = 60.0  # seconds between two of the runtime's log reports


class Runtime:
    def __init__(self, pools: Sequence[TaskPool]):
        if not pools:
            raise ValueError("a Runtime drains at least one pool")
        self.pools = list(pools)
        self._task: Optional[asyncio.Task] = None
        self.batches_processed = 0
        self._last_report = time.perf_counter()
        # drain-loop utilization: busy seconds over a rolling window. 1.0 with
        # growing queues means the device executor is the bottleneck; low
        # utilization with deep queues points at dispatch, not compute
        self._utilization_window = 5.0
        self._busy_s = 0.0
        self._busy_anchor = time.perf_counter()
        # cached metric children: pool names are stable for the Runtime's lifetime
        self._children = {
            pool.name: (_BATCHES.labels(pool.name), _SAMPLES.labels(pool.name), _BATCH_LATENCY.labels(pool.name))
            for pool in self.pools
        }
        # cumulative (batches, samples, seconds) at the last report, per pool, seeded
        # from the current totals: the counters are process-global, so a second
        # Runtime reusing a pool name must not report its predecessor's work
        self._reported: Dict[str, Tuple[float, float, float]] = {
            name: (batches.value, samples.value, latency.sum)
            for name, (batches, samples, latency) in self._children.items()
        }

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
            batches_counter, samples_counter, latency_histogram = self._children[pool.name]
            start = time.perf_counter()
            try:
                await run_in_executor(pool.process_batch, batch)
            except Exception as e:
                logger.warning(f"pool {pool.name}: batch failed with {e!r}")
                _BATCH_FAILURES.inc(pool=pool.name)
                pool.fail_batch(batch, e)
                self._account_busy(time.perf_counter() - start)
                continue
            elapsed = time.perf_counter() - start
            # counted after the callers' results: process_batch resolves their
            # futures from the executor thread, so a reader that needs these
            # counts waits for them rather than for its own result
            self.batches_processed += 1
            batches_counter.inc()
            samples_counter.inc(sum(t.batch_size for t in batch))
            latency_histogram.observe(elapsed)
            self._account_busy(elapsed)
            self._maybe_report_stats()

    def _account_busy(self, elapsed: float) -> None:
        """Utilization gauge: busy seconds / wall seconds over ~5 s windows. The
        idle time before a batch falls into the window that batch closes."""
        self._busy_s += elapsed
        now = time.perf_counter()
        window = now - self._busy_anchor
        if window >= self._utilization_window:
            _UTILIZATION.set(round(min(self._busy_s / window, 1.0), 4))
            self._busy_s = 0.0
            self._busy_anchor = now

    def _maybe_report_stats(self) -> None:
        """Periodic per-pool batch size / throughput log line, computed as deltas
        over the registry's cumulative counters, and the card's memory."""
        now = time.perf_counter()
        if now - self._last_report < STATS_REPORT_INTERVAL:
            return
        self._last_report = now
        for name in sorted(self._children):
            batches_counter, samples_counter, latency_histogram = self._children[name]
            totals = (batches_counter.value, samples_counter.value, latency_histogram.sum)
            batches, samples, seconds = (t - last for t, last in zip(totals, self._reported[name]))
            self._reported[name] = totals
            if batches:
                logger.info(
                    f"[{name}] {int(batches)} batches, avg size {samples / batches:.1f}, "
                    f"{samples / max(seconds, 1e-9):.0f} samples/s device time"
                )
        memory = device_memory_stats()
        if memory.get("bytes_in_use"):
            used, limit = memory["bytes_in_use"], memory["bytes_limit"]
            logger.info(f"[device] HBM {used / 2**30:.2f} GiB in use / {limit / 2**30:.2f} GiB")

    async def shutdown(self) -> None:
        """Stop the drain loop and wait until it has stopped."""
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
