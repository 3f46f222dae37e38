"""Batching queues between request handlers and the device runtime (the port of
hivemind_tpu/moe/server/task_pool.py; its telemetry hooks come with the telemetry
slice).

The queue is BOUNDED: past ``max_queue_size`` waiting tasks a submit is shed with
a typed :class:`ServerOverloadedError`. A batch merges consecutive tasks whose
inputs share trailing shapes (requests of different sequence lengths run as
separate batches, where the JAX pool would have failed the merged batch) and is
assembled into reused buffers; outputs are checked to cover the batch before they
are split per task."""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from hivemind_tpu_torch.moe.server.module_backend import bucket_batch_size
from hivemind_tpu_torch.utils.timed_storage import get_dht_time


class ServerOverloadedError(RuntimeError):
    """The pool's bounded queue is full: this request was shed. Clients should
    back off (the expert's circuit breaker counts sheds as failures)."""


@dataclass
class _Task:
    args: Tuple[np.ndarray, ...]
    future: asyncio.Future
    timestamp: float = field(default_factory=get_dht_time)

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

    def _event(self) -> asyncio.Event:
        if self._task_added is None:
            self._task_added = asyncio.Event()
        return self._task_added

    async def submit_task(self, *args: np.ndarray) -> Sequence[np.ndarray]:
        """Enqueue one task; resolves with its slice of the batched output.
        Sheds (ServerOverloadedError) when the bounded queue is full."""
        batch_size = args[0].shape[0]
        if batch_size > self.max_batch_size:
            raise ValueError(f"task of {batch_size} items exceeds max_batch_size={self.max_batch_size}")
        if len(self._queue) >= self.max_queue_size:
            raise ServerOverloadedError(
                f"pool {self.name!r} is overloaded: {len(self._queue)} tasks queued "
                f"(max_queue_size={self.max_queue_size}); request shed"
            )
        task = _Task(tuple(np.asarray(a) for a in args), asyncio.get_running_loop().create_future())
        self._queue.append(task)
        self._event().set()
        return await task.future

    @property
    def priority(self) -> float:
        """Lower is more urgent: timestamp of the oldest queued task (inf when empty)."""
        return self._queue[0].timestamp if self._queue else float("inf")

    def pop_batch(self) -> List[_Task]:
        """Remove up to max_batch_size samples' worth of consecutive tasks that
        share the first live task's trailing shapes. Tasks whose future is already
        done (the caller gave up) are dropped instead of burning a batch slot."""
        batch, total = [], 0
        while self._queue and total + self._queue[0].batch_size <= self.max_batch_size:
            head = self._queue[0]
            if head.future.done():
                self._queue.popleft()
                continue
            if batch and head.trailing_shapes != batch[0].trailing_shapes:
                break
            batch.append(self._queue.popleft())
            total += head.batch_size
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
        outputs = self.process_func(*joined)
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
        offset = 0
        for task in tasks:
            size = task.batch_size
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
