"""Batching queues between request handlers and the device runtime (the port of
hivemind_tpu/moe/server/task_pool.py).

The queue is BOUNDED: past ``max_queue_size`` waiting tasks a submit is shed with
a typed :class:`ServerOverloadedError` (counted in ``hivemind_moe_shed_total``).
A batch merges consecutive tasks whose inputs share trailing shapes (requests of
different sequence lengths run as separate batches, where the JAX pool would
have failed the merged batch) and is assembled into reused buffers; outputs are
checked to cover the batch before they are split per task.

Telemetry, under the JAX package's metric names: queue depth and oldest-task age
are gauged on submit AND drain; each task is stamped with its queue-wait /
batch-assembly / device-compute phases, which ``submit_task`` accrues onto the
caller's active ``serving.request`` span for the ServingLedger; every batch
observes the occupancy it ran at (samples ÷ max_batch_size)."""

from __future__ import annotations

import asyncio
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from hivemind_tpu_torch.moe.server.module_backend import bucket_batch_size
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.serving import accrue_span_phase
from hivemind_tpu_torch.telemetry.tracing import current_span
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

# sampled on the submit/drain path, so the queue is visible while it GROWS, not
# only after a drain happens to run
_QUEUE_DEPTH = _TELEMETRY.gauge(
    "hivemind_moe_pool_queue_depth", "tasks waiting in a pool (sampled on submit and drain)",
    ("pool",),
)
_QUEUE_AGE = _TELEMETRY.gauge(
    "hivemind_moe_queue_age_seconds", "age of the oldest task waiting in a pool", ("pool",)
)
_QUEUE_WAIT = _TELEMETRY.histogram(
    "hivemind_moe_queue_wait_seconds", "submit-to-drain wait of one task", ("pool",)
)
_SHEDS = _TELEMETRY.counter(
    "hivemind_moe_shed_total",
    "tasks shed because the pool's bounded queue was full (ServerOverloadedError)",
    ("pool",),
)
_OCCUPANCY = _TELEMETRY.histogram(
    "hivemind_moe_batch_occupancy",
    "samples per device batch / max_batch_size (1.0 = the batch dimension is full)",
    ("pool",),
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
_CANCELLED_SKIPPED = _TELEMETRY.counter(
    "hivemind_moe_pool_cancelled_skipped_total",
    "queued tasks dropped at drain time because their caller already gave up "
    "(hedge loser cancelled through the mux, abandoned deadline) — compute saved",
    ("pool",),
)


class ServerOverloadedError(RuntimeError):
    """The pool's bounded queue is full: this request was shed. Clients should
    back off (the expert's circuit breaker counts sheds as failures)."""


# every live pool, so read-time consumers (the serving ledger's saturation view)
# can refresh the gauges on demand: during a FULL stall nothing submits or
# drains, and event-driven sampling alone would freeze the age gauge
_LIVE_POOLS: "weakref.WeakSet[TaskPool]" = weakref.WeakSet()


def sample_all_pool_gauges() -> None:
    """Refresh depth/age gauges for every live pool (thread-safe best effort)."""
    for pool in list(_LIVE_POOLS):
        pool._sample_gauges()


@dataclass
class _Task:
    args: Tuple[np.ndarray, ...]
    future: asyncio.Future
    timestamp: float = field(default_factory=get_dht_time)
    # phase stamps (perf_counter): queue-wait is submitted -> popped; assembly,
    # compute and occupancy are shared by the tasks of one device batch. Set on
    # the executor thread, read by submit_task on the loop thread after the result.
    submitted_pc: float = field(default_factory=time.perf_counter)
    popped_pc: Optional[float] = None
    assembly_s: Optional[float] = None
    compute_s: Optional[float] = None
    occupancy: Optional[float] = None

    @property
    def batch_size(self) -> int:
        return self.args[0].shape[0]

    @property
    def trailing_shapes(self) -> tuple:
        return tuple((a.shape[1:], a.dtype.str) for a in self.args)


class TaskPool:
    """Collects tasks for one processing function; the Runtime drains the
    highest-priority pool (priority = oldest undispatched task)."""

    def __init__(
        self,
        process_func: Callable[..., Sequence[np.ndarray]],
        name: str,
        *,
        max_batch_size: int = 4096,
        max_queue_size: int = 1024,
    ):
        self.process_func = process_func
        self.name = name
        self.max_batch_size = max_batch_size
        self.max_queue_size = max_queue_size  # queued tasks beyond this are SHED
        self._queue: Deque[_Task] = deque()
        # reused batch-assembly buffers, keyed (arg index, bucket, trailing shape, dtype)
        self._batch_buffers: dict = {}
        self._task_added: Optional[asyncio.Event] = None
        # cached metric children (pool names are stable for the pool's lifetime)
        self._depth_gauge = _QUEUE_DEPTH.labels(name)
        self._age_gauge = _QUEUE_AGE.labels(name)
        self._wait_histogram = _QUEUE_WAIT.labels(name)
        self._shed_counter = _SHEDS.labels(name)
        self._occupancy_histogram = _OCCUPANCY.labels(name)
        self._cancelled_counter = _CANCELLED_SKIPPED.labels(name)
        _LIVE_POOLS.add(self)

    def _event(self) -> asyncio.Event:
        if self._task_added is None:
            self._task_added = asyncio.Event()
        return self._task_added

    def _sample_gauges(self) -> None:
        self._depth_gauge.set(len(self._queue))
        try:
            # may run off-loop (sample_all_pool_gauges): guard the popleft race
            oldest = self._queue[0].timestamp
        except IndexError:
            oldest = None
        self._age_gauge.set(max(get_dht_time() - oldest, 0.0) if oldest is not None else 0.0)

    async def submit_task(self, *args: np.ndarray) -> Sequence[np.ndarray]:
        """Enqueue one task; resolves with its slice of the batched output.
        Sheds (ServerOverloadedError) when the bounded queue is full."""
        batch_size = args[0].shape[0]
        if batch_size > self.max_batch_size:
            raise ValueError(f"task of {batch_size} items exceeds max_batch_size={self.max_batch_size}")
        if len(self._queue) >= self.max_queue_size:
            self._shed_counter.inc()
            self._sample_gauges()
            raise ServerOverloadedError(
                f"pool {self.name!r} is overloaded: {len(self._queue)} tasks queued "
                f"(max_queue_size={self.max_queue_size}); request shed"
            )
        task = _Task(tuple(np.asarray(a) for a in args), asyncio.get_running_loop().create_future())
        self._queue.append(task)
        self._sample_gauges()
        self._event().set()
        outputs = await task.future
        # phase attribution onto the caller's serving.request span (on the loop
        # thread: the span is the caller's contextvar, never the executor's)
        if task.popped_pc is not None:
            queue_wait = max(task.popped_pc - task.submitted_pc, 0.0)
            self._wait_histogram.observe(queue_wait)
            accrue_span_phase("queue_wait_s", queue_wait)
        if task.assembly_s is not None:
            accrue_span_phase("assembly_s", task.assembly_s)
        if task.compute_s is not None:
            accrue_span_phase("compute_s", task.compute_s)
        if task.occupancy is not None:
            span = current_span()
            if span is not None:
                # a chain of pools accumulates phases, but occupancy and pool keep
                # the WORST-occupancy hop: the under-filled batch is the lever
                previous = (span.attributes or {}).get("occupancy")
                if previous is None or task.occupancy < float(previous):
                    span.set("occupancy", task.occupancy)
                    span.set("pool", self.name)
        return outputs

    @property
    def priority(self) -> float:
        """Lower is more urgent: timestamp of the oldest queued task (inf when empty)."""
        return self._queue[0].timestamp if self._queue else float("inf")

    def pop_batch(self) -> List[_Task]:
        """Remove up to max_batch_size samples' worth of consecutive tasks that
        share the first live task's trailing shapes. Tasks whose future is already
        done (the caller gave up) are dropped instead of burning a batch slot."""
        batch, total = [], 0
        popped_at = time.perf_counter()
        while self._queue and total + self._queue[0].batch_size <= self.max_batch_size:
            head = self._queue[0]
            if head.future.done():
                self._queue.popleft()
                self._cancelled_counter.inc()
                continue
            if batch and head.trailing_shapes != batch[0].trailing_shapes:
                break
            head.popped_pc = popped_at
            batch.append(self._queue.popleft())
            total += head.batch_size
        self._sample_gauges()
        if self._task_added is not None and not self._queue:
            self._task_added.clear()
        return batch

    async def wait_for_tasks(self) -> None:
        await self._event().wait()

    def _batch_buffer(self, arg_index: int, bucket: int, sample: np.ndarray) -> np.ndarray:
        """The reusable assembly buffer for one argument position at one
        power-of-two bucket size. Safe to reuse: batches run one at a time on the
        Runtime's executor, and process_func copies to the device before the next
        batch overwrites it."""
        key = (arg_index, bucket, sample.shape[1:], sample.dtype.str)
        buffer = self._batch_buffers.get(key)
        if buffer is None:
            if len(self._batch_buffers) >= 32:
                # trailing shapes are request-controlled (e.g. per-client seq
                # lengths): bound retention — these are pure caches
                self._batch_buffers.clear()
            buffer = self._batch_buffers[key] = np.zeros((bucket, *sample.shape[1:]), sample.dtype)
        return buffer

    def process_batch(self, tasks: List[_Task]) -> None:
        """Run process_func on the assembled batch; split outputs per task.
        Called from the Runtime's executor thread."""
        num_args = len(tasks[0].args)
        assembly_start = time.perf_counter()
        total = sum(t.batch_size for t in tasks)
        if len(tasks) == 1:
            joined: List[np.ndarray] = list(tasks[0].args)  # zero copies for one task
        else:
            bucket = bucket_batch_size(total, self.max_batch_size)
            joined = []
            for i in range(num_args):
                buffer = self._batch_buffer(i, bucket, tasks[0].args[i])
                offset = 0
                for task in tasks:
                    buffer[offset : offset + task.batch_size] = task.args[i]
                    offset += task.batch_size
                joined.append(buffer[:total])  # eager PyTorch: no need to compute padding rows
        compute_start = time.perf_counter()
        outputs = self.process_func(*joined)
        compute_end = time.perf_counter()
        if isinstance(outputs, np.ndarray):
            outputs = [outputs]
        # a process_func returning the wrong leading dim would mis-slice per-task
        # outputs: fail the whole batch loudly instead (the Runtime routes this
        # into fail_batch)
        for index, out in enumerate(outputs):
            out_len = np.asarray(out).shape[0] if np.ndim(out) else 0
            if out_len != total:
                raise ValueError(
                    f"pool {self.name!r}: process_func output {index} has leading dim "
                    f"{out_len} but the batch holds {total} samples ({len(tasks)} tasks) "
                    f"— refusing to mis-slice per-task outputs"
                )
        occupancy = round(total / max(self.max_batch_size, 1), 4)
        self._occupancy_histogram.observe(occupancy)
        offset = 0
        for task in tasks:
            size = task.batch_size
            task.assembly_s = compute_start - assembly_start
            task.compute_s = compute_end - compute_start
            task.occupancy = occupancy
            task_out = [np.asarray(out[offset : offset + size]) for out in outputs]
            offset += size
            task.future.get_loop().call_soon_threadsafe(
                lambda t=task, o=task_out: t.future.done() or t.future.set_result(o)
            )

    def fail_batch(self, tasks: List[_Task], exc: BaseException) -> None:
        for task in tasks:
            task.future.get_loop().call_soon_threadsafe(
                lambda t=task: t.future.done() or t.future.set_exception(exc)
            )
